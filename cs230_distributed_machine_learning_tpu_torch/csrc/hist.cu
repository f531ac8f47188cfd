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
// Design. One CTA owns a page of the output: one lane, a block of Mb nodes
// and a block of Fb features, every bin and stat column, held in shared
// memory (int32 for integer stats, f32 otherwise). It streams ALL rows of
// its lane in tiles of 2,048: first it lists the tile's rows that fall in
// its node block (coalesced node-id loads, a shared counter), then the
// whole CTA works through (listed row, 8 features) items, each loading its
// row's stats and 8 codes at once and adding the nonzero stats with
// shared-memory atomics; at the end it stores the page once. Listing
// first keeps the warps converged: a warp whose 32 rows hold one match
// would otherwise run that row's 54 dependent code loads alone. No
// global atomics and no order across CTAs: every output element is written
// by exactly one CTA. Integer stats (RF classification: one-hot class
// columns times bootstrap counts, all below 128) accumulate in int32,
// which is order-free, so the histogram is bit-exact whatever order the
// atomics land in. Float stats accumulate in f32 in whatever order the
// atomics land: within f32 summation-order tolerance, not bit-stable.
//
// Bound. The function must read xb (n*d*4 B), the node ids (L*n*4 B) and
// the stats (L*n*kk*4 B) once and write the histogram (L*n_nodes*d*n_bins*
// kk*4 B) once; its adds are a few per row and feature. At the deep
// arena's widest covertype level (L 6, n 116,202, 1536 nodes, d 54,
// 16 bins, kk 7) that is ~0.27 GB, ~81 us at 3.35 TB/s: bytes bound it.
// This first kernel re-reads each lane's node ids once per page (the pages
// of a wide level number in the thousands), so it sits well above that.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxStats = 16;
constexpr int kMaxBins = 256;
// rows a CTA scans per tile (4 per thread), and features a thread adds per item
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr int kFeatChunk = 8;
// dynamic shared memory one CTA may use on Hopper
constexpr int kSmemLimit = 232448;
// the tile's list of rows in the page's node block: row (int) + node (u16)
constexpr int kListBytes = kTileRows * (4 + 2);

template <bool kInteger>
__global__ void __launch_bounds__(kThreads)
level_hist_kernel(const int* __restrict__ xb, const int* __restrict__ local,
                  const float* __restrict__ sc, float* __restrict__ out, int n,
                  int d, int kk, int n_nodes, int n_bins, int Mb, int Fb,
                  int n_fblocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list_len;

  const int lane = blockIdx.y;
  const int m0 = (blockIdx.x / n_fblocks) * Mb;
  const int f0 = (blockIdx.x % n_fblocks) * Fb;
  const int mb = min(Mb, n_nodes - m0);
  const int fb = min(Fb, d - f0);
  const int cell = n_bins * kk;  // one (node, feature) cell: bins x stats
  const int row_len = fb * cell;  // one node's slice of the page
  const int page = mb * row_len;
  int* ipage = reinterpret_cast<int*>(smem);
  float* fpage = reinterpret_cast<float*>(smem);
  int* list_r = reinterpret_cast<int*>(smem + (size_t)page * 4);
  unsigned short* list_m = reinterpret_cast<unsigned short*>(list_r + kTileRows);

  for (int e = threadIdx.x; e < page; e += kThreads) ipage[e] = 0;  // 0 == 0.0f
  if (threadIdx.x == 0) list_len = 0;
  __syncthreads();

  const int* loc = local + (size_t)lane * n;
  const float* st = sc + (size_t)lane * n * kk;
  const int chunks = (fb + kFeatChunk - 1) / kFeatChunk;
  for (int tile = 0; tile < n; tile += kTileRows) {
    // 1. list the tile's rows that fall in this node block (independent,
    //    coalesced loads); dead rows (< 0 or >= n_nodes) never match
    int mrow[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = tile + j * kThreads + threadIdx.x;
      mrow[j] = r < n ? loc[r] - m0 : -1;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if ((unsigned)mrow[j] < (unsigned)mb) {
        const int pos = atomicAdd(&list_len, 1);
        list_r[pos] = tile + j * kThreads + threadIdx.x;
        list_m[pos] = (unsigned short)mrow[j];
      }
    }
    __syncthreads();
    // 2. every (listed row, chunk of kFeatChunk features) is one item: its
    //    stats and codes are loaded together, then added to the page
    const int items = list_len * chunks;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int i = it / chunks;
      const int fc = (it - i * chunks) * kFeatChunk;
      const int r = list_r[i];
      float s[kMaxStats];
      bool any = false;
#pragma unroll
      for (int k = 0; k < kMaxStats; ++k) {
        s[k] = k < kk ? st[(size_t)r * kk + k] : 0.f;
        any |= s[k] != 0.f;
      }
      if (!any) continue;
      const int* row = xb + (size_t)r * d + f0 + fc;
      int b[kFeatChunk];
#pragma unroll
      for (int f = 0; f < kFeatChunk; ++f) b[f] = fc + f < fb ? row[f] : -1;
      const int base = list_m[i] * row_len + fc * cell;
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
    if (threadIdx.x == 0) list_len = 0;
    __syncthreads();
  }

  // a node's slice of the page is contiguous in the output too
  for (int e = threadIdx.x; e < page; e += kThreads) {
    const int m = e / row_len;
    const size_t o =
        (((size_t)lane * n_nodes + m0 + m) * d + f0) * cell + (e - m * row_len);
    out[o] = kInteger ? (float)ipage[e] : fpage[e];
  }
}

long long page_bytes(int Mb, int Fb, int n_bins, int kk) {
  return (long long)Mb * Fb * n_bins * kk * 4;
}

template <bool kInteger>
cudaError_t launch(const void* xb, const void* local, const void* sc, void* out,
                   int n, int d, int kk, int L, int n_nodes, int n_bins, int Mb,
                   int Fb, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    // a CTA's static shared memory (the list counter) counts against the
    // same per-CTA limit as its dynamic page
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, level_hist_kernel<kInteger>);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(level_hist_kernel<kInteger>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int fbe = Fb < d ? Fb : d;
  const int mbe = Mb < n_nodes ? Mb : n_nodes;
  const int n_fblocks = (d + Fb - 1) / Fb;
  const int n_nblocks = (n_nodes + Mb - 1) / Mb;
  const dim3 grid((unsigned)(n_nblocks * n_fblocks), (unsigned)L);
  const size_t smem = (size_t)page_bytes(mbe, fbe, n_bins, kk) + kListBytes;
  level_hist_kernel<kInteger><<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(xb), static_cast<const int*>(local),
      static_cast<const float*>(sc), static_cast<float*>(out), n, d, kk,
      n_nodes, n_bins, Mb, Fb, n_fblocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of one CTA's page; the Python tiling mirrors it.
long long hist_page_bytes(int Mb, int Fb, int n_bins, int kk) {
  return page_bytes(Mb, Fb, n_bins, kk);
}

// xb [n, d] i32, local [L, n] i32, sc [L, n, kk] f32 -> out [L, n_nodes, d,
// n_bins, kk] f32. (Mb, Fb) is the page's node and feature block.
int hist_level_histogram(const void* xb, const void* local, const void* sc,
                         void* out, int n, int d, int kk, int L, int n_nodes,
                         int n_bins, int Mb, int Fb, int integer_stats,
                         void* stream) {
  if (n <= 0 || d <= 0 || kk <= 0 || kk > kMaxStats || L <= 0 || L > 65535 ||
      n_nodes <= 0 || n_bins <= 0 || n_bins > kMaxBins || Mb <= 0 || Fb <= 0 ||
      Mb > 65535 ||
      page_bytes(Mb < n_nodes ? Mb : n_nodes, Fb < d ? Fb : d, n_bins, kk) +
              kListBytes >
          kSmemLimit - 1024 ||
      (long long)((n_nodes + Mb - 1) / Mb) * ((d + Fb - 1) / Fb) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (integer_stats)
    return (int)launch<true>(xb, local, sc, out, n, d, kk, L, n_nodes, n_bins,
                             Mb, Fb, s);
  return (int)launch<false>(xb, local, sc, out, n, d, kk, L, n_nodes, n_bins, Mb,
                            Fb, s);
}

}  // extern "C"
