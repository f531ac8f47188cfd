// Hand-written Hopper (sm_90a) kernel for the tree level histogram. It
// replaces the Pallas TPU kernel of the JAX package's ops/pallas_hist.py:
//
//   hist_level_histogram  <- level_histogram_pallas  (pallas_hist.py:106)
//
// For every lane l (a (trial, split) fit), node m, feature f, bin b and stat
// column k:
//
//   H[l, m, f, b, k] = sum_r [local[l, r] == m] * SC[l, r, k] * [xb[r, f] == b]
//
// Rows whose node id lies outside [0, n_nodes) are dropped; the bin codes
// xb [n, d] are shared by every lane.
//
// Translation. The TPU kernel contracts a node-by-stat one-hot against a
// bin one-hot on the MXU because scatters serialize there. On Hopper a
// scatter into shared memory is the natural form: each row adds its stats
// to d cells, O(n * d * kk) adds instead of the one-hot product's
// O(n * n_nodes * d * n_bins * kk) multiply-adds.
//
// Bound. The function must read xb (n*d*4 B), the node ids (L*n*4 B) and
// the stats (L*n*kk*4 B) once and write the histogram (L*n_nodes*d*n_bins*
// kk*4 B) once; its adds are a few per row and feature. At the deep
// arena's widest covertype level (L 6, n 116,202, 1536 nodes, d 54,
// 16 bins, kk 7) that is ~0.27 GB, ~81 us at 3.35 TB/s: bytes bound it.
//
// What bounds this design. A page must find its own rows without reading
// the rest of the lane's, so the rows are bucketed by node first (below);
// a page then costs its own rows plus its histogram write, and the level
// as a whole reads each live row once a feature block and writes the
// histogram once. At narrow levels (a few hundred nodes) the three
// bucketing launches and the page writes are most of the time.
//
// Design. The entry point first buckets each lane's rows by node, with
// three small kernels and a memset on the caller's stream:
//   1. bucket_count: the live rows of each node (a live row has a node id
//      in [0, n_nodes) and a nonzero stat; the others add nothing);
//   2. bucket_scan: one CTA a lane takes the exclusive scan of the counts,
//      off[L, n_nodes + 1], and cuts the lane's nodes into pages (below);
//   3. bucket_scatter: each live row's index goes to its node's segment of
//      a node-sorted row list rows[L, n] (its place in the segment is
//      whatever order the atomics give: the sums below do not depend on it
//      for integer stats).
// Then level_hist reads, for its page, only the contiguous segment
// [off[m0], off[m1]) of the row list: one pass over those rows, no listing
// and no barriers between tiles. All scratch comes from the caller.
//
// Pages. A page is a run of consecutive nodes and a block of Fb features,
// held in shared memory (int32 for integer stats, f32 otherwise) and
// written once. Its cost is its own rows, and real levels hold very uneven
// row counts, so the runs are cut on the device where the rows are known:
// a page starts at every Mb-th node (so it fits its shared memory) and at
// every node whose first row crosses a multiple of T rows (so no page
// carries many more than T rows beside its largest node). The grid is
// sized for the most pages that rule can give (Mb and T come from the
// wrapper), and CTAs past a lane's page count return at once.
//
// Exactness. No global atomics into the histogram and no order across
// CTAs: every output element is written by exactly one CTA. Integer stats
// (RF classification: one-hot class columns times bootstrap counts, all
// below 128) accumulate in int32 shared atomics, which is order-free, so
// the histogram is bit-exact whatever order the rows come in. Float stats
// accumulate in f32 in whatever order the atomics land: within f32
// summation-order tolerance, not bit-stable.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kScanThreads = 1024;
constexpr int kMaxStats = 16;
constexpr int kMaxBins = 256;
// features a thread adds per item
constexpr int kFeatChunk = 8;
// dynamic shared memory one CTA may use on Hopper
constexpr int kSmemLimit = 232448;

// A row adds to the histogram iff its node id is in range and one of its
// stats is nonzero; bucketing drops every other row.
__device__ __forceinline__ int live_node(const int* __restrict__ loc,
                                         const float* __restrict__ st, int r,
                                         int kk, int n_nodes) {
  const int m = loc[r];
  if ((unsigned)m >= (unsigned)n_nodes) return -1;
  for (int k = 0; k < kk; ++k)
    if (st[(size_t)r * kk + k] != 0.f) return m;
  return -1;
}

__global__ void __launch_bounds__(256)
bucket_count(const int* __restrict__ local, const float* __restrict__ sc,
             int* __restrict__ cnt, int n, int kk, int n_nodes) {
  const int lane = blockIdx.y;
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= n) return;
  const int m = live_node(local + (size_t)lane * n, sc + (size_t)lane * n * kk, r,
                          kk, n_nodes);
  if (m >= 0) atomicAdd(cnt + (size_t)lane * n_nodes + m, 1);
}

// Exclusive scan of one value a thread over the CTA; returns the thread's
// prefix and sets `total` (the same in every thread).
__device__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // warp_sums is free
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    total += s;
  }
  return before + x - v;
}

// One CTA a lane: off = exclusive scan of the counts (and the counts
// become the scatter's cursors, cnt[m] = off[m]); then the lane's page
// starts (node m starts a page if m % Mb == 0 or floor(off[m] / T) >
// floor(off[m - 1] / T)), compacted into pstart[0 .. np], pstart[np] =
// n_nodes, and np into n_pages.
__global__ void __launch_bounds__(kScanThreads)
bucket_scan(int* __restrict__ cnt, int* __restrict__ off, int* __restrict__ pstart,
            int* __restrict__ n_pages, int n_nodes, int Mb, int T, int max_pages) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = blockIdx.x;
  int* c = cnt + (size_t)lane * n_nodes;
  int* o = off + (size_t)lane * (n_nodes + 1);
  int* ps = pstart + (size_t)lane * (max_pages + 1);
  int carry = 0, total;
  for (int m0 = 0; m0 < n_nodes; m0 += kScanThreads) {
    const int m = m0 + threadIdx.x;
    const int v = m < n_nodes ? c[m] : 0;
    const int pre = carry + block_exclusive_scan(v, warp_sums, total);
    if (m < n_nodes) {
      o[m] = pre;
      c[m] = pre;
    }
    carry += total;
  }
  if (threadIdx.x == 0) o[n_nodes] = carry;
  __syncthreads();  // off is complete and visible to the CTA
  int pages = 0;
  for (int m0 = 0; m0 < n_nodes; m0 += kScanThreads) {
    const int m = m0 + threadIdx.x;
    const int flag = m < n_nodes && (m % Mb == 0 || o[m] / T > o[m - 1] / T);
    const int pre = pages + block_exclusive_scan(flag, warp_sums, total);
    if (flag) ps[pre] = m;
    pages += total;
  }
  if (threadIdx.x == 0) {
    ps[pages] = n_nodes;
    n_pages[lane] = pages;
  }
}

__global__ void __launch_bounds__(256)
bucket_scatter(const int* __restrict__ local, const float* __restrict__ sc,
               int* __restrict__ cursor, int* __restrict__ rows, int n, int kk,
               int n_nodes) {
  const int lane = blockIdx.y;
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= n) return;
  const int m = live_node(local + (size_t)lane * n, sc + (size_t)lane * n * kk, r,
                          kk, n_nodes);
  if (m >= 0) {
    const int pos = atomicAdd(cursor + (size_t)lane * n_nodes + m, 1);
    rows[(size_t)lane * n + pos] = r;
  }
}

template <bool kInteger>
__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const int* __restrict__ xb, const int* __restrict__ local,
                  const float* __restrict__ sc, const int* __restrict__ off,
                  const int* __restrict__ rows, const int* __restrict__ pstart,
                  const int* __restrict__ n_pages, float* __restrict__ out, int n,
                  int d, int kk, int n_nodes, int n_bins, int Fb, int n_fblocks,
                  int max_pages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = blockIdx.y;
  const int p = blockIdx.x / n_fblocks;
  if (p >= n_pages[lane]) return;  // the lane's rows made fewer pages
  const int* ps = pstart + (size_t)lane * (max_pages + 1);
  const int m0 = ps[p];
  const int mb = ps[p + 1] - m0;
  const int f0 = (blockIdx.x % n_fblocks) * Fb;
  const int fb = min(Fb, d - f0);
  const int cell = n_bins * kk;   // one (node, feature) cell: bins x stats
  const int row_len = fb * cell;  // one node's slice of the page
  const int page = mb * row_len;
  int* ipage = reinterpret_cast<int*>(smem);
  float* fpage = reinterpret_cast<float*>(smem);

  for (int e = threadIdx.x; e < page; e += kThreads) ipage[e] = 0;  // 0 == 0.0f
  __syncthreads();

  const int* o = off + (size_t)lane * (n_nodes + 1);
  const int r0 = o[m0];
  const int n_rows = o[m0 + mb] - r0;
  const int* seg = rows + (size_t)lane * n + r0;
  const int* loc = local + (size_t)lane * n;
  const float* st = sc + (size_t)lane * n * kk;
  const int chunks = (fb + kFeatChunk - 1) / kFeatChunk;
  // every (segment row, chunk of kFeatChunk features) is one item: its
  // stats and codes are loaded together, then added to the page
  const int items = n_rows * chunks;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int i = it / chunks;
    const int fc = (it - i * chunks) * kFeatChunk;
    const int r = seg[i];
    float s[kMaxStats];
#pragma unroll
    for (int k = 0; k < kMaxStats; ++k) s[k] = k < kk ? st[(size_t)r * kk + k] : 0.f;
    const int* row = xb + (size_t)r * d + f0 + fc;
    int b[kFeatChunk];
#pragma unroll
    for (int f = 0; f < kFeatChunk; ++f) b[f] = fc + f < fb ? row[f] : -1;
    const int base = (loc[r] - m0) * row_len + fc * cell;
#pragma unroll
    for (int f = 0; f < kFeatChunk; ++f) {
      if ((unsigned)b[f] >= (unsigned)n_bins) continue;  // no bin: no cell
      const int c = base + (f * n_bins + b[f]) * kk;
#pragma unroll
      for (int k = 0; k < kMaxStats; ++k) {
        if (k < kk && s[k] != 0.f) {
          if (kInteger)
            atomicAdd(ipage + c + k, __float2int_rn(s[k]));
          else
            atomicAdd(fpage + c + k, s[k]);
        }
      }
    }
  }
  __syncthreads();

  // a node's slice of the page is contiguous in the output too
  for (int e = threadIdx.x; e < page; e += kThreads) {
    const int m = e / row_len;
    const size_t idx =
        (((size_t)lane * n_nodes + m0 + m) * d + f0) * cell + (e - m * row_len);
    out[idx] = kInteger ? (float)ipage[e] : fpage[e];
  }
}

long long page_bytes(int Mb, int Fb, int n_bins, int kk) {
  return (long long)Mb * Fb * n_bins * kk * 4;
}

// Scratch ints: cursors [L, n_nodes], offsets [L, n_nodes + 1], the row
// list [L, n], page starts [L, max_pages + 1], page counts [L].
long long scratch_ints(int L, int n, int n_nodes, int max_pages) {
  return (long long)L * ((long long)n_nodes + (n_nodes + 1) + n + (max_pages + 1) + 1);
}

template <bool kInteger>
cudaError_t launch(const int* xb, const int* local, const float* sc, float* out,
                   int* scratch, int n, int d, int kk, int L, int n_nodes,
                   int n_bins, int Mb, int Fb, int T, int max_pages,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(level_hist_kernel<kInteger>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemLimit);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  int* cnt = scratch;
  int* off = cnt + (size_t)L * n_nodes;
  int* rows = off + (size_t)L * (n_nodes + 1);
  int* pstart = rows + (size_t)L * n;
  int* n_pages = pstart + (size_t)L * (max_pages + 1);
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)L * n_nodes, stream);
  if (err != cudaSuccess) return err;
  const dim3 rgrid((unsigned)((n + 255) / 256), (unsigned)L);
  bucket_count<<<rgrid, 256, 0, stream>>>(local, sc, cnt, n, kk, n_nodes);
  bucket_scan<<<L, kScanThreads, 0, stream>>>(cnt, off, pstart, n_pages, n_nodes, Mb, T,
                                              max_pages);
  bucket_scatter<<<rgrid, 256, 0, stream>>>(local, sc, cnt, rows, n, kk, n_nodes);
  const int fbe = Fb < d ? Fb : d;
  const int mbe = Mb < n_nodes ? Mb : n_nodes;
  const int n_fblocks = (d + Fb - 1) / Fb;
  const dim3 grid((unsigned)(max_pages * n_fblocks), (unsigned)L);
  const size_t smem = (size_t)page_bytes(mbe, fbe, n_bins, kk);
  level_hist_kernel<kInteger><<<grid, kThreads, smem, stream>>>(
      xb, local, sc, off, rows, pstart, n_pages, out, n, d, kk, n_nodes, n_bins, Fb,
      n_fblocks, max_pages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one CTA's page and the scratch ints of one call;
// the Python geometry mirrors both.
long long hist_page_bytes(int Mb, int Fb, int n_bins, int kk) {
  return page_bytes(Mb, Fb, n_bins, kk);
}
long long hist_scratch_ints(int L, int n, int n_nodes, int max_pages) {
  return scratch_ints(L, n, n_nodes, max_pages);
}

// xb [n, d] i32, local [L, n] i32, sc [L, n, kk] f32 -> out [L, n_nodes, d,
// n_bins, kk] f32. Pages hold at most Mb nodes and Fb features; a page also
// starts where a lane's live rows cross a multiple of T; max_pages bounds a
// lane's pages (ceil(n_nodes / Mb) + n / T). scratch: hist_scratch_ints.
int hist_level_histogram(const void* xb, const void* local, const void* sc,
                         void* out, void* scratch, int n, int d, int kk, int L,
                         int n_nodes, int n_bins, int Mb, int Fb, int T,
                         int max_pages, int integer_stats, void* stream) {
  if (n <= 0 || d <= 0 || kk <= 0 || kk > kMaxStats || L <= 0 || L > 65535 ||
      n_nodes <= 0 || n_bins <= 0 || n_bins > kMaxBins || Mb <= 0 || Fb <= 0 ||
      T <= 0 || max_pages < (n_nodes + Mb - 1) / Mb + n / T ||
      page_bytes(Mb < n_nodes ? Mb : n_nodes, Fb < d ? Fb : d, n_bins, kk) >
          kSmemLimit - 1024 ||
      (long long)max_pages * ((d + Fb - 1) / Fb) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* x = static_cast<const int*>(xb);
  const int* l = static_cast<const int*>(local);
  const float* c = static_cast<const float*>(sc);
  float* o = static_cast<float*>(out);
  int* w = static_cast<int*>(scratch);
  if (integer_stats)
    return (int)launch<true>(x, l, c, o, w, n, d, kk, L, n_nodes, n_bins, Mb, Fb, T,
                             max_pages, s);
  return (int)launch<false>(x, l, c, o, w, n, d, kk, L, n_nodes, n_bins, Mb, Fb, T,
                            max_pages, s);
}

}  // extern "C"
