// Hand-written Hopper (sm_90a) kernels for the tree level histogram. They
// replace the Pallas TPU kernel of the JAX package's ops/pallas_hist.py:
//
//   hist_level_histogram      <- level_histogram_pallas  (pallas_hist.py:106),
//                                integer stats
//   hist_level_histogram_f32  <- the same kernel, float stats
//
// For every lane l (a (trial, split) fit), node m, feature f, bin b and stat
// column k:
//
//   H[l, m, f, b, k] = sum_r [local[l, r] == m] * SC[l, r, k] * [xb[r, f] == b]
//
// Rows whose node id lies outside [0, n_nodes) are dropped; the bin codes
// xb [n, d] are shared by every lane.
//
// ---- Integer stats (RF classification) ---------------------------------
//
// Translation. The TPU kernel contracts a node-by-stat one-hot against a
// bin one-hot on the MXU because scatters serialize there. For integer
// stats a scatter into shared memory is the natural form on Hopper: each
// row adds its stats to d cells, O(n * d * kk) adds instead of the one-hot
// product's O(n * n_nodes * d * n_bins * kk) multiply-adds, and int32
// shared atomics are order-free, so the histogram is bit-exact.
//
// Bound. The function must read xb (n*d*4 B), the node ids (L*n*4 B) and
// the stats (L*n*kk*4 B) once and write the histogram (L*n_nodes*d*n_bins*
// kk*4 B) once; its adds are a few per row and feature. At the deep
// arena's widest covertype level (L 6, n 116,202, 1536 nodes, d 54,
// 16 bins, kk 7) that is ~0.27 GB, ~81 us at 3.35 TB/s: bytes bound it.
//
// Design. The entry point first buckets each lane's rows by node, with
// three small kernels and a memset on the caller's stream:
//   1. bucket_count: the live rows of each node (a live row has a node id
//      in [0, n_nodes) and a nonzero stat; the others add nothing);
//   2. bucket_scan: one CTA a lane takes the exclusive scan of the counts,
//      off[L, n_nodes + 1], and cuts the lane's nodes into pages (below);
//   3. bucket_scatter: each live row's index goes to its node's segment of
//      a node-sorted row list rows[L, n] (its place in the segment is
//      whatever order the atomics give: integer sums do not depend on it).
// Then level_hist reads, for its page, only the contiguous segment
// [off[m0], off[m1]) of the row list. A page is a run of consecutive nodes
// and a block of Fb features, held in shared memory as int32 and written
// once; a page starts at every Mb-th node (so it fits its shared memory)
// and at every node whose first row crosses a multiple of T rows (so no
// page carries many more than T rows beside its largest node). The grid is
// sized for the most pages that rule can give, and CTAs past a lane's page
// count return at once. Every output element is written by exactly one CTA.
//
// ---- Float stats (boosting, RandomForestRegressor, DecisionTreeRegressor)
//
// What bounds it. The scatter form costs one f32 shared atomic a (lane,
// row, feature, nonzero stat): at boosting's root (168 lanes x 116,202
// rows x 54 features x 2 stats) that is ~1.9e9 atomics on one node's page,
// and f32 atomics add in whatever order they land, so two launches differ
// in the last bits. Written as the TPU kernel's contraction,
//
//   H[(l, m, k), (f, b)] = sum_r A[(l, m, k), r] * onehot(xb[r, f])[b],
//   A[(l, m, k), r] = [local[l, r] == m] * SC[l, r, k],
//
// it is a product of M = L * n_nodes * kk by K = n by N = d * n_bins in
// which every lane shares the one-hot factor: the reuse the tensor cores
// need. At the root that is 2 * 336 * 116,202 * 6,912 multiply-adds a term.
//
// The exact split. The one-hot is exact in bf16. An f32 stat s splits
// exactly into three bf16 terms, hi = bf16(s), mid = bf16(s - hi), lo =
// bf16(s - hi - mid) (each difference is exact in f32, and lo a normal bf16
// for |s| above ~1e-33; two terms alone miss by up to ~8e-6 relative), so
// every product of the three wgmma terms is exact and only the f32 sums'
// order remains. The three bf16 products run at 3 * 2 * M * K * N / 989
// TFLOP/s: 1.64 ms at boosting's root. The accumulators are f32 in the
// tensor cores, in a fixed order: per K step of 64 rows, its four k16
// slices in order, each hi, mid, lo into the same registers; the K steps
// in row order; the K splits summed in split order by a second pass. No
// atomics touch a sum, so every launch on the same inputs gives the same
// bits. A non-finite stat is not supported: its terms would multiply the
// one-hot's zeros too.
//
// What bounds this design: the products, 3 * 2 * M * K * N bf16 operations
// with M padded to whole 64-row tiles (1.94 ms at boosting's root) against
// the function's own bound, its bytes (~0.08 ms there): the one-hot's
// zeros are the price of the tensor cores and a fixed order.
//
// Body (hist_f32_kernel). A CTA of two warpgroups owns a tile of 64 (lane,
// node, stat) rows by 512 (feature, bin) columns (Fn whole features); the
// warpgroups share the A terms and take 256 columns each (m64n256k16,
// both operands K-major in 128-byte-swizzled shared memory). The A terms
// of each (M tile, K step of 64 rows) are written once a call by a
// pre-pass in that shared-memory image (24 KB), with the step's codes
// [Fn][64] u16; thread 0 streams both with cp.async.bulk on mbarriers into
// a ring of three slots, three steps ahead. The bin one-hot B [512][64]
// bf16 is built in shared memory and never written to device memory: a
// row has one 1 a feature, so each of two B slots keeps the codes it was
// last built from and each thread moves its rows' ones (clear the old
// column, set the new). Step t + 1's B is built while step t's 12 wgmma
// run. Two routes feed it (ops/cuda_hist.py::f32_plan prices both over the
// whole launch and picks; a call's lanes run in launches whose scratch
// stays within a cap, each launch one call of hist_level_histogram_f32):
//   dense  (shallow levels) K runs over every row in order, lanes and
//          nodes batched into M (hist_f32_dense_prep); the grid is N tiles
//          x M tiles x K splits, each split writing a partial page of the
//          whole output, and hist_f32_reduce sums the partials in split
//          order. Rows with zero stats cost a product and add 0.
//   page   (deep levels) each lane's live rows are bucketed by node into a
//          STABLE row list (ascending row within a node: stable_count,
//          stable_scan, stable_place, one warp a 1024-row block placing its
//          rows in order); a page is a run of 64 / kk nodes, its K the
//          page's segment of the list (hist_f32_page_prep writes its A
//          images and codes), one CTA a (page, N tile), writing the output
//          directly (every output element by exactly one CTA).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

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

  for (int e = threadIdx.x; e < page; e += kThreads) ipage[e] = 0;
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
        if (k < kk && s[k] != 0.f) atomicAdd(ipage + c + k, __float2int_rn(s[k]));
      }
    }
  }
  __syncthreads();

  // a node's slice of the page is contiguous in the output too
  for (int e = threadIdx.x; e < page; e += kThreads) {
    const int m = e / row_len;
    const size_t idx =
        (((size_t)lane * n_nodes + m0 + m) * d + f0) * cell + (e - m * row_len);
    out[idx] = (float)ipage[e];
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

cudaError_t launch(const int* xb, const int* local, const float* sc, float* out,
                   int* scratch, int n, int d, int kk, int L, int n_nodes,
                   int n_bins, int Mb, int Fb, int T, int max_pages,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(level_hist_kernel,
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
  level_hist_kernel<<<grid, kThreads, smem, stream>>>(
      xb, local, sc, off, rows, pstart, n_pages, out, n, d, kk, n_nodes, n_bins, Fb,
      n_fblocks, max_pages);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Float stats: the split one-hot contraction on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // two warpgroups, each 256 of the tile's columns
constexpr int kF32M = 64;         // (lane, node, stat) rows a tile
constexpr int kF32N = 512;        // (feature, bin) columns a tile: 256 a warpgroup
constexpr int kF32K = 64;         // rows a K step: one 128-byte bf16 row
constexpr int kF32MaxFeatures = 32;                       // whole features a tile
constexpr int kF32ATerm = kF32M * kF32K * 2;              // one bf16 A term, 8 KB
constexpr int kF32AImage = 3 * kF32ATerm;                 // hi, mid, lo: 24 KB
constexpr int kF32BBytes = kF32N * kF32K * 2;             // the one-hot B, 64 KB
constexpr int kF32ASlots = 3;     // A images (and codes) in flight
constexpr int kF32BSlots = 2;     // one-hot tiles: step t's products, step t + 1's build
constexpr int kRowBlock = 1024;   // rows a warp places in the stable bucketing
constexpr unsigned short kNoBin = 0xFFFF;

// Shared memory of one CTA (host and device): alignment slack, the A image
// slots, the one-hot slots, the codes slots [Fn][64] u16, each one-hot
// slot's codes of its last step [Fn][64] u16 and the A slots' mbarriers.
__host__ __device__ inline long long f32_smem(int Fn) {
  return 1024 + (long long)kF32ASlots * kF32AImage + (long long)kF32BSlots * kF32BBytes +
         (long long)(kF32ASlots + kF32BSlots) * Fn * kF32K * 2 + kF32ASlots * 8;
}
__host__ __device__ inline int f32_features(int d, int n_bins) {
  int fn = kF32N / n_bins;
  fn = fn < kF32MaxFeatures ? fn : kF32MaxFeatures;
  return fn < 1 ? 1 : (fn < d ? fn : d);
}

// One contraction's arguments (passed by value).
struct F32Args {
  const unsigned char* aimg;    // [A steps] A images (hist_f32_dense_prep / _page_prep)
  const unsigned short* codes;  // [code steps][Fn][64] codes, likewise
  const int* psb;     // page route: [L, pages + 1] each page's first step of its lane
  float* dst;         // the output, or (dense, splits > 1) the partial pages
  long long split_stride;  // dense: floats between two splits' partial pages
  int d, kk, L, n_nodes, n_bins, Fn, n_tiles;
  int ksteps;         // dense: K steps over all rows; page: a lane's most steps
  int Mb;             // page route: nodes a page
  int split_steps;    // dense: K steps a split
};

// The split of one stat into its three bf16 terms, at tile element (i, j)
// of an A image (three [64][64] bf16 terms, 128-byte swizzled).
__device__ __forceinline__ void put_split(unsigned char* img, int i, int j, float s) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(s);
  const float r1 = __fsub_rn(s, __bfloat162float(hi));
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const __nv_bfloat16 lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
  const uint32_t o = sw128_off(i, j);
  *reinterpret_cast<__nv_bfloat16*>(img + o) = hi;
  *reinterpret_cast<__nv_bfloat16*>(img + kF32ATerm + o) = mid;
  *reinterpret_cast<__nv_bfloat16*>(img + 2 * kF32ATerm + o) = lo;
}

__device__ __forceinline__ void copy_out(unsigned char* dst, const unsigned char* img,
                                         int bytes) {
  __syncthreads();
  const uint4* s4 = reinterpret_cast<const uint4*>(img);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (int e = threadIdx.x; e < bytes / 16; e += 256) d4[e] = s4[e];
}

// The codes of one K step's rows (ridx, -1 for none) for one tile's Fn
// features, kNoBin outside [0, n_bins) and past the features.
__device__ __forceinline__ void put_codes(unsigned short* dst, const int* __restrict__ xb,
                                          const int* ridx, int d, int n_bins, int Fn, int f0) {
  for (int e = threadIdx.x; e < Fn * kF32K; e += 256) {
    const int fl = e / kF32K, r = ridx[e - fl * kF32K];
    int v = -1;
    if (r >= 0 && f0 + fl < d) v = xb[(size_t)r * d + f0 + fl];
    dst[e] = (unsigned)v < (unsigned)n_bins ? (unsigned short)v : kNoBin;
  }
}

// The dense route's operands, once a call. CTA (K step, y): y < M tiles
// writes the A image of M tile y, the three split terms of its 64 (lane,
// node, stat) rows over the step's 64 rows in order (rows past n, lanes
// past L and other nodes' rows are 0), as the contraction's shared memory
// holds them (thread t takes row t / 4 and 16 rows from 16 (t % 4), its
// loads independent); y >= M tiles writes the codes of N tile y - M tiles.
// Layouts: A [M tiles][K steps], codes [N tiles][K steps][Fn][64].
__global__ void __launch_bounds__(256)
hist_f32_dense_prep(const int* __restrict__ xb, const int* __restrict__ local,
                    const float* __restrict__ sc, unsigned char* __restrict__ aimg,
                    unsigned short* __restrict__ codes, int n, int d, int kk, int L,
                    int n_nodes, int n_bins, int Fn, int ksteps, int m_tiles) {
  __shared__ __align__(128) unsigned char img[kF32AImage];
  __shared__ int ridx[kF32K];
  const int step = blockIdx.x, y = blockIdx.y, t = threadIdx.x;
  if (y >= m_tiles) {
    const int tile = y - m_tiles;
    if (t < kF32K) ridx[t] = step * kF32K + t < n ? step * kF32K + t : -1;
    __syncthreads();
    put_codes(codes + ((size_t)tile * ksteps + step) * Fn * kF32K, xb, ridx, d, n_bins, Fn,
              tile * Fn);
    return;
  }
  const int i = t >> 2, j0 = (t & 3) * 16;
  const int per_lane = n_nodes * kk;
  const int ig = y * kF32M + i;
  const int lane = ig / per_lane;
  const int rem = ig - lane * per_lane;
  const int node = rem / kk, k = rem - node * kk;
  const int p0 = step * kF32K + j0;
  float v[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int r = p0 + u;
    v[u] = 0.0f;
    if (lane < L && r < n) {
      const size_t lr = (size_t)lane * n + r;
      const float s = sc[lr * kk + k];
      v[u] = local[lr] == node ? s : 0.0f;
    }
  }
#pragma unroll
  for (int u = 0; u < 16; ++u) put_split(img, i, j0 + u, v[u]);
  copy_out(aimg + ((size_t)y * ksteps + step) * kF32AImage, img, kF32AImage);
}

// The page route's operands, once a call. CTA (s, lane) takes the lane's
// step s: its page p (psb[p] <= s < psb[p + 1]) and the page's rows
// off[p * Mb] + 64 (s - psb[p]) .. of the stable row list; it writes the A
// image of the page's (node, stat) rows (node p * Mb + i / kk) and the
// codes of every N tile. Layouts: A [L][ksteps], codes [L][ksteps][N
// tiles][Fn][64]; steps past the lane's last are not written.
__global__ void __launch_bounds__(256)
hist_f32_page_prep(const int* __restrict__ xb, const int* __restrict__ local,
                   const float* __restrict__ sc, const int* __restrict__ off,
                   const int* __restrict__ rows, const int* __restrict__ psb,
                   unsigned char* __restrict__ aimg, unsigned short* __restrict__ codes, int n,
                   int d, int kk, int n_nodes, int n_bins, int Fn, int n_tiles, int ksteps,
                   int Mb, int pages) {
  __shared__ __align__(128) unsigned char img[kF32AImage];
  __shared__ int ridx[kF32K];
  const int s = blockIdx.x, lane = blockIdx.y, t = threadIdx.x;
  const int* ps = psb + (size_t)lane * (pages + 1);
  if (s >= ps[pages]) return;
  int lo = 0, hi = pages;  // the last p with ps[p] <= s
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (ps[mid] <= s) lo = mid; else hi = mid;
  }
  const int p = lo, m0 = p * Mb, m1 = min(n_nodes, m0 + Mb);
  const int* o = off + (size_t)lane * (n_nodes + 1);
  const int q0 = o[m0] + (s - ps[p]) * kF32K, q1 = o[m1];
  uint4* i4 = reinterpret_cast<uint4*>(img);
  for (int e = t; e < kF32AImage / 16; e += 256) i4[e] = make_uint4(0, 0, 0, 0);
  if (t < kF32K) ridx[t] = q0 + t < q1 ? rows[(size_t)lane * n + q0 + t] : -1;
  __syncthreads();
  if (t < kF32K) {
    const int r = ridx[t];
    if (r >= 0) {
      const size_t lr = (size_t)lane * n + r;
      const int m = local[lr] - m0;  // the row list holds the page's rows only
      if ((unsigned)m < (unsigned)(m1 - m0))
        for (int k = 0; k < kk; ++k) put_split(img, m * kk + k, t, sc[lr * kk + k]);
    }
  }
  const size_t step = (size_t)lane * ksteps + s;
  for (int tile = 0; tile < n_tiles; ++tile)
    put_codes(codes + (step * n_tiles + tile) * Fn * kF32K, xb, ridx, d, n_bins, Fn, tile * Fn);
  copy_out(aimg + step * kF32AImage, img, kF32AImage);
}

// B: the bin one-hot of the step's 64 rows, [512 columns][64 rows] bf16,
// column fl * n_bins + b. A row has one 1 a feature, so the slot keeps the
// codes it was last built from (last) and each thread moves its own (row,
// feature) entries' ones: it clears the old column and sets the new one (in
// that order, so an unchanged code stays set). bf16 1.0 is 0x3F80.
__device__ __forceinline__ void f32_onehot(unsigned char* B, const unsigned short* codes,
                                           unsigned short* last, int Fn, int n_bins) {
  for (int e = threadIdx.x; e < Fn * kF32K; e += kF32Threads) {
    const int fl = e / kF32K, j = e - fl * kF32K;
    const unsigned short was = last[e], now = codes[e];
    if (was != kNoBin)
      *reinterpret_cast<unsigned short*>(B + sw128_off(fl * n_bins + was, j)) = 0;
    if (now != kNoBin)
      *reinterpret_cast<unsigned short*>(B + sw128_off(fl * n_bins + now, j)) = 0x3F80;
    last[e] = now;
  }
  fence_proxy_async_shared();  // generic-proxy writes become visible to wgmma
}

// One step's products: per k16 slice, hi, mid and lo of the 64 rows times
// this warpgroup's 256 one-hot columns, into one accumulator (a fixed order).
__device__ __forceinline__ void f32_products(float (&acc)[128], const unsigned char* A,
                                             const unsigned char* B, int wg) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kF32K / 16; ++ks) {
    const uint64_t db = sw128_desc(B + wg * (256 * 128) + ks * 32, 16, 1024);
#pragma unroll
    for (int term = 0; term < 3; ++term)
      Wgmma<256>::mma<0>(acc, sw128_desc(A + term * kF32ATerm + ks * 32, 16, 1024), db);
  }
  wgmma_commit();
}

// grid (N tiles, M tiles | pages, splits | lanes), 256 threads. A CTA's
// tile is 64 (lane, node, stat) rows by 512 (feature, bin) columns; the
// two warpgroups share the A terms and take 256 columns each. Thread 0
// streams each step's A image and codes (prepared once a call) with bulk
// copies on mbarriers, three steps ahead; the threads build step t + 1's
// one-hot while step t's products run.
template <bool kPage>
__global__ void __launch_bounds__(kF32Threads, 1)
hist_f32_kernel(const __grid_constant__ F32Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Aslot = smem;
  unsigned char* Bslot = smem + kF32ASlots * kF32AImage;
  unsigned short* codes =
      reinterpret_cast<unsigned short*>(Bslot + kF32BSlots * kF32BBytes);
  const int cwords = a.Fn * kF32K;  // u16 codes a step
  unsigned short* last = codes + kF32ASlots * cwords;
  uint64_t* full = reinterpret_cast<uint64_t*>(last + kF32BSlots * cwords);
  const int tid = threadIdx.x, wg = tid / 128;
  const int f0 = blockIdx.x * a.Fn;
  const int fn = min(a.Fn, a.d - f0);
  // both one-hot slots start all zero, with no code set
  for (int e = tid; e < kF32BSlots * kF32BBytes / 16; e += kF32Threads)
    reinterpret_cast<uint4*>(Bslot)[e] = make_uint4(0, 0, 0, 0);
  for (int e = tid; e < kF32BSlots * cwords; e += kF32Threads) last[e] = kNoBin;

  // the CTA's steps: A image abase + s and codes cbase + s * cstride for s
  // in [0, steps). Dense: M tile blockIdx.y, split blockIdx.z's K steps;
  // page: page blockIdx.y of lane blockIdx.z.
  int steps, lane = 0, m0 = 0;
  size_t abase, cbase, cstride;
  if (kPage) {
    lane = blockIdx.z;
    m0 = blockIdx.y * a.Mb;
    const int* ps = a.psb + (size_t)lane * (gridDim.y + 1);
    steps = ps[blockIdx.y + 1] - ps[blockIdx.y];
    abase = (size_t)lane * a.ksteps + ps[blockIdx.y];
    cbase = (abase * a.n_tiles + blockIdx.x) * cwords;
    cstride = (size_t)a.n_tiles * cwords;
  } else {
    const int s0 = blockIdx.z * a.split_steps;
    steps = max(0, min(a.split_steps, a.ksteps - s0));
    abase = (size_t)blockIdx.y * a.ksteps + s0;
    cbase = ((size_t)blockIdx.x * a.ksteps + s0) * cwords;
    cstride = cwords;
  }
  if (tid == 0) {
    for (int s = 0; s < kF32ASlots; ++s) mbar_init(&full[s], 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  // thread 0: step s's A image and codes into slot s % 3
  auto request = [&](int s) {
    uint64_t* bar = &full[s % kF32ASlots];
    mbar_expect_tx(bar, kF32AImage + cwords * 2);
    bulk_load(Aslot + (s % kF32ASlots) * kF32AImage, a.aimg + (abase + s) * kF32AImage,
              kF32AImage, bar);
    bulk_load(codes + (s % kF32ASlots) * cwords, a.codes + cbase + s * cstride, cwords * 2,
              bar);
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  if (tid == 0)
    for (int s = 0; s < kF32ASlots && s < steps; ++s) request(s);
  if (steps > 0) {
    mbar_wait(&full[0], 0);
    f32_onehot(Bslot, codes, last, a.Fn, a.n_bins);
  }
  for (int t = 0; t < steps; ++t) {
    __syncthreads();  // step t's one-hot is built; its A image has landed
    f32_products(acc, Aslot + (t % kF32ASlots) * kF32AImage, Bslot + (t & 1) * kF32BBytes, wg);
    if (t + 1 < steps) {  // the other one-hot slot was read by step t - 1, which is done
      const int u = (t + 1) % kF32ASlots;
      mbar_wait(&full[u], ((t + 1) / kF32ASlots) & 1);
      f32_onehot(Bslot + ((t + 1) & 1) * kF32BBytes, codes + u * cwords,
                 last + ((t + 1) & 1) * cwords, a.Fn, a.n_bins);
    }
    wgmma_wait_all();
    fence_operand(acc);
    if (t + kF32ASlots < steps) {
      __syncthreads();  // both warpgroups are past step t's products
      if (tid == 0) request(t + kF32ASlots);
    }
  }

  // acc[4 j + 2 h + e] is tile row 16 warp + g + 8 h, column 256 wg + 8 j +
  // 2 q + e; output [lane, node, f0 + c / n_bins, c % n_bins, k] is
  // ((lane * n_nodes + node) * d * n_bins + f0 * n_bins + c) * kk + k
  float* dst = a.dst + (kPage ? 0 : (size_t)blockIdx.z * a.split_stride);
  const int wl = tid % 128, warp = wl / 32, g = (wl % 32) / 4, q = wl % 4;
  const int cols = fn * a.n_bins;
  const int per_lane = a.n_nodes * a.kk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 16 * warp + g + 8 * h;
    int node, k;
    bool ok;
    if (kPage) {
      node = m0 + i / a.kk;
      k = i % a.kk;
      ok = i / a.kk < a.Mb && node < a.n_nodes;
    } else {
      const int ig = blockIdx.y * kF32M + i;
      lane = ig / per_lane;
      const int rem = ig - lane * per_lane;
      node = rem / a.kk;
      k = rem - node * a.kk;
      ok = lane < a.L;
    }
    if (!ok) continue;
    float* row = dst + (((size_t)lane * a.n_nodes + node) * a.d * a.n_bins +
                        (size_t)f0 * a.n_bins) * a.kk + k;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 256 * wg + 8 * j + 2 * q + e;
        if (c < cols) row[(size_t)c * a.kk] = acc[4 * j + 2 * h + e];
      }
  }
}

// out = the partial pages summed in split order (fixed, no atomics)
__global__ void __launch_bounds__(256)
hist_f32_reduce(const float* __restrict__ part, float* __restrict__ out, long long size,
                int splits) {
  for (long long o = (long long)blockIdx.x * 256 + threadIdx.x; o < size;
       o += (long long)gridDim.x * 256) {
    float s = part[o];
    for (int p = 1; p < splits; ++p) s = __fadd_rn(s, part[p * size + o]);
    out[o] = s;
  }
}

// Stable bucketing of the page route: cnt [L][n_nodes][nblk] (the live rows
// of each node in each 1024-row block), scanned node-major, block-minor into
// each (node, block)'s first place; off [L][n_nodes + 1]; rows [L][n].
__global__ void __launch_bounds__(256)
stable_count(const int* __restrict__ local, const float* __restrict__ sc,
             int* __restrict__ cnt, int n, int kk, int n_nodes, int nblk) {
  const int lane = blockIdx.y;
  const int r = blockIdx.x * 256 + threadIdx.x;
  if (r >= n) return;
  const int m = live_node(local + (size_t)lane * n, sc + (size_t)lane * n * kk, r, kk,
                          n_nodes);
  if (m >= 0) atomicAdd(cnt + ((size_t)lane * n_nodes + m) * nblk + r / kRowBlock, 1);
}

// One CTA a lane. With psb, also each page's K steps (a page is Mb
// consecutive nodes; its rows padded to whole steps), scanned into psb
// [pages + 1]: the page's first step among the lane's.
__global__ void __launch_bounds__(kScanThreads)
stable_scan(int* __restrict__ cnt, int* __restrict__ off, int* __restrict__ psb, int n_nodes,
            int nblk, int Mb, int pages) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = blockIdx.x;
  int* c = cnt + (size_t)lane * n_nodes * nblk;
  int* o = off + (size_t)lane * (n_nodes + 1);
  const int total_n = n_nodes * nblk;
  int carry = 0, total;
  for (int e0 = 0; e0 < total_n; e0 += kScanThreads) {
    const int e = e0 + threadIdx.x;
    const int v = e < total_n ? c[e] : 0;
    const int pre = carry + block_exclusive_scan(v, warp_sums, total);
    if (e < total_n) {
      c[e] = pre;
      if (e % nblk == 0) o[e / nblk] = pre;
    }
    carry += total;
  }
  if (threadIdx.x == 0) o[n_nodes] = carry;
  if (psb == nullptr) return;
  __syncthreads();  // off is complete and visible to the CTA
  int* ps = psb + (size_t)lane * (pages + 1);
  carry = 0;
  for (int p0 = 0; p0 < pages; p0 += kScanThreads) {
    const int p = p0 + threadIdx.x;
    const int v = p < pages
                      ? (o[min(n_nodes, (p + 1) * Mb)] - o[p * Mb] + kF32K - 1) / kF32K
                      : 0;
    const int pre = carry + block_exclusive_scan(v, warp_sums, total);
    if (p < pages) ps[p] = pre;
    carry += total;
  }
  if (threadIdx.x == 0) ps[pages] = carry;
}

// One warp a (1024-row block, lane): 32 rows at a time in row order, the
// rows of one node (__match_any_sync) take consecutive places from the
// (node, block)'s cursor in lane order, and the group's first thread
// advances the cursor. Rows come out ascending within each node.
__global__ void __launch_bounds__(32)
stable_place(const int* __restrict__ local, const float* __restrict__ sc, int* cursor,
             int* __restrict__ rows, int n, int kk, int n_nodes, int nblk) {
  const int lane = blockIdx.y, blk = blockIdx.x, t = threadIdx.x;
  volatile int* cur = cursor + (size_t)lane * n_nodes * nblk + blk;
  const unsigned before = (1u << t) - 1u;
  for (int c = 0; c < kRowBlock / 32; ++c) {
    const int r = blk * kRowBlock + c * 32 + t;
    const int m = r < n ? live_node(local + (size_t)lane * n, sc + (size_t)lane * n * kk, r,
                                    kk, n_nodes)
                        : -1;
    const unsigned mask = __match_any_sync(0xffffffffu, m);
    int base = 0;
    if (m >= 0) {
      base = cur[(size_t)m * nblk];
      rows[(size_t)lane * n + base + __popc(mask & before)] = r;
    }
    __syncwarp();
    if (m >= 0 && (mask & before) == 0) cur[(size_t)m * nblk] = base + __popc(mask);
    __syncwarp();
  }
}

// The f32 mode's scratch, in ints. Dense: the A images [M tiles][K steps]
// (24 KB each), the codes [N tiles][K steps][Fn][64] u16, then the partial
// pages when splits > 1. Page: cnt [L][n_nodes][nblk], off [L][n_nodes +
// 1], rows [L][n], psb [L][pages + 1] (padded to 16 bytes), the A images
// [L][ksteps] and the codes [L][ksteps][N tiles][Fn][64] u16, ksteps =
// ceil(n / 64) + pages bounding a lane's steps.
struct F32Scratch {
  long long aimg, codes, part, total;  // int offsets, and the count
  int ksteps, pages, m_tiles, n_tiles, Fn;
};

inline F32Scratch f32_scratch(int L, int n, int d, int n_bins, int kk, int n_nodes, int page,
                              int splits) {
  F32Scratch s;
  s.Fn = f32_features(d, n_bins);
  s.n_tiles = (d + s.Fn - 1) / s.Fn;
  s.m_tiles = (int)(((long long)L * n_nodes * kk + kF32M - 1) / kF32M);
  s.pages = (n_nodes + kF32M / kk - 1) / (kF32M / kk);
  const long long steps = (n + kF32K - 1) / kF32K;
  if (page) {
    const long long nblk = (n + kRowBlock - 1) / kRowBlock;
    s.ksteps = (int)(steps + s.pages);
    s.aimg = ((long long)L * ((long long)n_nodes * nblk + n_nodes + 1 + n + s.pages + 1) + 3) /
             4 * 4;
    s.codes = s.aimg + (long long)L * s.ksteps * (kF32AImage / 4);
    s.part = s.codes + (long long)L * s.ksteps * s.n_tiles * s.Fn * (kF32K / 2);
    s.total = s.part;
  } else {
    s.ksteps = (int)steps;
    s.aimg = 0;
    s.codes = (long long)s.m_tiles * s.ksteps * (kF32AImage / 4);
    s.part = s.codes + (long long)s.n_tiles * s.ksteps * s.Fn * (kF32K / 2);
    s.total = s.part + (splits > 1 ? (long long)splits * L * n_nodes * d * n_bins * kk : 0);
  }
  return s;
}

// The stable bucketing (and, with psb, the pages' steps) into scratch:
// cnt, off and rows at its start, psb after them.
cudaError_t stable_rows(const int* local, const float* sc, int* scratch, int* psb, int n, int kk,
                        int L, int n_nodes, int Mb, int pages, cudaStream_t stream) {
  const int nblk = (n + kRowBlock - 1) / kRowBlock;
  int* cnt = scratch;
  int* off = cnt + (size_t)L * n_nodes * nblk;
  int* rows = off + (size_t)L * (n_nodes + 1);
  cudaError_t err =
      cudaMemsetAsync(cnt, 0, sizeof(int) * (size_t)L * n_nodes * nblk, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(rows, 0xFF, sizeof(int) * (size_t)L * n, stream);  // -1: no row
  if (err != cudaSuccess) return err;
  stable_count<<<dim3((unsigned)((n + 255) / 256), (unsigned)L), 256, 0, stream>>>(
      local, sc, cnt, n, kk, n_nodes, nblk);
  stable_scan<<<L, kScanThreads, 0, stream>>>(cnt, off, psb, n_nodes, nblk, Mb, pages);
  stable_place<<<dim3((unsigned)nblk, (unsigned)L), 32, 0, stream>>>(local, sc, cnt, rows, n,
                                                                      kk, n_nodes, nblk);
  return cudaGetLastError();
}

cudaError_t launch_f32(const int* xb, const int* local, const float* sc, float* out,
                       int* scratch, int n, int d, int kk, int L, int n_nodes, int n_bins,
                       int page, int splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        hist_f32_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(hist_f32_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const F32Scratch s = f32_scratch(L, n, d, n_bins, kk, n_nodes, page, splits);
  F32Args a = {};
  a.aimg = reinterpret_cast<const unsigned char*>(scratch + s.aimg);
  a.codes = reinterpret_cast<const unsigned short*>(scratch + s.codes);
  a.d = d;
  a.kk = kk;
  a.L = L;
  a.n_nodes = n_nodes;
  a.n_bins = n_bins;
  a.Fn = s.Fn;
  a.n_tiles = s.n_tiles;
  a.ksteps = s.ksteps;
  a.Mb = kF32M / kk;
  unsigned char* aimg = reinterpret_cast<unsigned char*>(scratch + s.aimg);
  unsigned short* codes = reinterpret_cast<unsigned short*>(scratch + s.codes);
  const size_t smem = (size_t)f32_smem(s.Fn);
  if (page) {
    const int nblk = (n + kRowBlock - 1) / kRowBlock;
    const int* off = scratch + (size_t)L * n_nodes * nblk;
    const int* rows = off + (size_t)L * (n_nodes + 1);
    int* psb = scratch + (size_t)L * ((size_t)n_nodes * nblk + n_nodes + 1 + n);
    cudaError_t err = stable_rows(local, sc, scratch, psb, n, kk, L, n_nodes, a.Mb, s.pages,
                                  stream);
    if (err != cudaSuccess) return err;
    hist_f32_page_prep<<<dim3((unsigned)s.ksteps, (unsigned)L), 256, 0, stream>>>(
        xb, local, sc, off, rows, psb, aimg, codes, n, d, kk, n_nodes, n_bins, s.Fn, s.n_tiles,
        s.ksteps, a.Mb, s.pages);
    a.psb = psb;
    a.dst = out;
    const dim3 grid((unsigned)s.n_tiles, (unsigned)s.pages, (unsigned)L);
    hist_f32_kernel<true><<<grid, kF32Threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  hist_f32_dense_prep<<<dim3((unsigned)s.ksteps, (unsigned)(s.m_tiles + s.n_tiles)), 256, 0,
                        stream>>>(xb, local, sc, aimg, codes, n, d, kk, L, n_nodes, n_bins, s.Fn,
                                  s.ksteps, s.m_tiles);
  a.split_steps = (s.ksteps + splits - 1) / splits;
  const long long size = (long long)L * n_nodes * d * n_bins * kk;
  float* part = reinterpret_cast<float*>(scratch + s.part);
  a.split_stride = size;
  a.dst = splits > 1 ? part : out;
  const dim3 grid((unsigned)s.n_tiles, (unsigned)s.m_tiles, (unsigned)splits);
  hist_f32_kernel<false><<<grid, kF32Threads, smem, stream>>>(a);
  if (splits > 1) {
    const long long blocks = (size + 255) / 256;
    hist_f32_reduce<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
        part, out, size, splits);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one CTA and the scratch ints of one call, for
// both modes; the Python geometry mirrors them.
long long hist_page_bytes(int Mb, int Fb, int n_bins, int kk) {
  return page_bytes(Mb, Fb, n_bins, kk);
}
long long hist_scratch_ints(int L, int n, int n_nodes, int max_pages) {
  return scratch_ints(L, n, n_nodes, max_pages);
}
// The f32 mode's shared memory a CTA (Fn features a tile) and scratch ints.
long long hist_f32_smem_bytes(int Fn) { return f32_smem(Fn); }
long long hist_f32_scratch_ints(int L, int n, int d, int n_bins, int kk, int n_nodes, int page,
                                int splits) {
  return f32_scratch(L, n, d, n_bins, kk, n_nodes, page, splits).total;
}

// Integer stats. xb [n, d] i32, local [L, n] i32, sc [L, n, kk] f32
// (integer-valued) -> out [L, n_nodes, d, n_bins, kk] f32. Pages hold at
// most Mb nodes and Fb features; a page also starts where a lane's live
// rows cross a multiple of T; max_pages bounds a lane's pages
// (ceil(n_nodes / Mb) + n / T). scratch: hist_scratch_ints.
int hist_level_histogram(const void* xb, const void* local, const void* sc,
                         void* out, void* scratch, int n, int d, int kk, int L,
                         int n_nodes, int n_bins, int Mb, int Fb, int T,
                         int max_pages, void* stream) {
  if (n <= 0 || d <= 0 || kk <= 0 || kk > kMaxStats || L <= 0 || L > 65535 ||
      n_nodes <= 0 || n_bins <= 0 || n_bins > kMaxBins || Mb <= 0 || Fb <= 0 ||
      T <= 0 || max_pages < (n_nodes + Mb - 1) / Mb + n / T ||
      page_bytes(Mb < n_nodes ? Mb : n_nodes, Fb < d ? Fb : d, n_bins, kk) >
          kSmemLimit - 1024 ||
      (long long)max_pages * ((d + Fb - 1) / Fb) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  return (int)launch(static_cast<const int*>(xb), static_cast<const int*>(local),
                     static_cast<const float*>(sc), static_cast<float*>(out),
                     static_cast<int*>(scratch), n, d, kk, L, n_nodes, n_bins, Mb, Fb, T,
                     max_pages, (cudaStream_t)stream);
}

// Float stats, same operands: the split one-hot contraction. page 0 takes
// the dense route in `splits` K splits (their partial pages in scratch when
// splits > 1), page 1 the page route (the stable row list in scratch).
// scratch: hist_f32_scratch_ints.
int hist_level_histogram_f32(const void* xb, const void* local, const void* sc, void* out,
                             void* scratch, int n, int d, int kk, int L, int n_nodes,
                             int n_bins, int page, int splits, void* stream) {
  if (n <= 0 || d <= 0 || kk <= 0 || kk > kMaxStats || L <= 0 || L > 65535 ||
      n_nodes <= 0 || n_bins <= 0 || n_bins > kMaxBins || (page != 0 && page != 1) ||
      splits < 1 || splits > 65535 || (page && splits != 1) ||
      (long long)L * n_nodes * d * n_bins * kk > 2147483647LL ||
      (long long)n_nodes * ((n + kRowBlock - 1) / kRowBlock) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const F32Scratch s = f32_scratch(L, n, d, n_bins, kk, n_nodes, page, splits);
  if ((long long)s.m_tiles + s.n_tiles > 65535 || s.pages > 65535 ||
      (!page && splits > s.ksteps))
    return (int)cudaErrorInvalidValue;
  return (int)launch_f32(static_cast<const int*>(xb), static_cast<const int*>(local),
                         static_cast<const float*>(sc), static_cast<float*>(out),
                         static_cast<int*>(scratch), n, d, kk, L, n_nodes, n_bins, page,
                         splits, (cudaStream_t)stream);
}

// The page route's stable bucketing alone (a test aid): scratch as the
// page route's, cnt, off and rows at its start.
int hist_stable_rows(const void* local, const void* sc, void* scratch, int n, int kk, int L,
                     int n_nodes, void* stream) {
  if (n <= 0 || kk <= 0 || kk > kMaxStats || L <= 0 || L > 65535 || n_nodes <= 0 ||
      (long long)n_nodes * ((n + kRowBlock - 1) / kRowBlock) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  return (int)stable_rows(static_cast<const int*>(local), static_cast<const float*>(sc),
                          static_cast<int*>(scratch), nullptr, n, kk, L, n_nodes, 1, 0,
                          (cudaStream_t)stream);
}

}  // extern "C"
