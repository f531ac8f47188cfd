// Hand-written Hopper (sm_90a) kernel for the fused k-nearest-neighbour
// search. It replaces the Pallas TPU kernel of the JAX package's
// ops/pallas_knn.py:
//
//   knn_topk  <- knn_topk  (pallas_knn.py:111; body _kernel :33)
//
// For every lane l (one split mask), query row q and training row j:
//
//   d2[q, j] = (qsq[q] + tsq[j]) - 2 * (Q[q] . Xt[j]),  then max(d2, 0),
//              then 3.4e38 where W[l, j] <= 0
//
// and the output keeps, per (l, q), the k smallest d2 by (d2, j), ascending.
// A slot no masked-in row reaches stays (3.4e38, -1). qsq and tsq are the
// rows' sums of squares, computed by the caller as the TPU wrapper does
// (pallas_knn.py:127-128); the dot is an f32 FMA chain in feature order (no
// TF32: the reference it is held to runs in f32).
//
// Translation. The TPU kernel walks training tiles as the inner, sequential
// grid axis and carries a per-query top-k in VMEM scratch across them; its
// merge is k rounds of (min, first argmin, mask), so equal distances come
// out in slot order. Here a CTA walks training tiles in index order inside
// the CTA, with the running lists on chip for the whole sweep. Each list is
// kept by one thread, which scans a tile's distances in index order and
// inserts a candidate only if it is strictly below the list's worst slot,
// shifting larger entries up; so among equal distances the lowest index is
// kept and emitted first, by construction (a documented difference from
// the TPU kernel's slot order; the votes do not depend on it). A list thus
// ends as the k smallest candidates by (d2, j): the result depends on the
// distances alone, not on how the rows were split or the lanes grouped.
//
// Design (redesigned for Hopper after the first version, which gave each
// CTA one lane and so computed the same distance product once per lane):
//
// - Lanes share the product. A CTA owns a block of 64 (or 32) queries, a
//   group of G lanes (all L of a launch where their lists fit in shared memory) and
//   a range of training rows. It stages the query block and each 128-row
//   training tile once and computes the 64 x 128 distance tile once, with
//   the same FMA chain as before (no d2 changes), into shared memory
//   without any mask. Then the G * 64 list owners (one thread a list,
//   lists tid, tid + 256, ..) scan it, each applying its own lane's mask as
//   a bit pattern OR-ed onto the distance: a masked-out row becomes +inf or
//   a NaN, which never passes `< worst`, and a masked-in distance keeps its
//   bits.
// - Rows are split to fill the card. With the lanes merged, knn_main's
//   launch (4,096 queries) has only 64 query blocks for 132 SMs. So the
//   training rows are cut into P contiguous ranges of whole tiles
//   (grid = query blocks x P x lane groups): P is the resident CTAs an SM
//   holds at this k (2 at k 5, 1 at k 25, by shared memory) times 132, over
//   the query blocks, at most 32 and leaving each range 4 tiles or more
//   (knn_plan in ops/cuda_knn.py; at knn_main's launch P = 4 at k 5 and
//   P = 2 at k 25, 256 CTAs each). Each CTA builds the partial lists of its
//   range under the insertion rule above and writes them to a [P, L, ..]
//   scratch; a second kernel in the same call merges the P lists of each
//   (lane, query) by (d2, j). A range's list is the k smallest of its rows
//   by (d2, j), so the merge gives the k smallest of all rows: the output
//   is bit-identical to the unsplit kernel's, ties and empty slots
//   included. With P = 1 the CTA writes the outputs directly.
//   (A smaller query block instead of the split would shrink the register
//   tile that carries the product; the split keeps it.)
//
// Each thread computes a 4-query x 8-row register tile of dot products with
// float4 shared-memory loads from transposed chunks of 64 features (one
// chunk at covertype's d = 54, so the query block is staged once); every
// thread fetches the next tile into registers before computing the current
// one, so the global loads overlap the FMAs. A 4-wide minimum against the
// worst slot skips most of the scan once the lists have filled.
//
// Where the lists live (knn_list_mode in ops/cuda_knn.py). Up to k = 256
// they live in shared memory, slot-major, 8 bytes a (lane, query, slot): a
// CTA of 64 queries holds 85,760 bytes of tiles plus 1,024 a lane of masks
// plus G * 64 * k * 8 of lists (107,264 at G 6, k 5: two CTAs an SM;
// 168,704 at k 25: one). A CTA of 32 queries halves the query chunk, the
// distance tile and the lists (105,088 at G 6, k 25: two an SM); each
// thread then computes a 2-query x 8-row register tile, and the plan takes
// it where it needs fewer lane groups or fits more CTAs an SM (k 8 to 31
// at six lanes, and past k 45). The lane group is the largest (at most 16
// lanes) whose lists fit in 232,448 bytes, down to one lane (k = 256). Above k = 256 the same kernel
// keeps each list in device memory instead, as a max-heap on (d2, index)
// that an insertion walks in log k accesses through L2; the owner sorts it
// at the end. Its slots are the outputs themselves when P = 1, else the
// scratch. There the heaps, not the product, set the time (PERF.md: ~30x
// the k 5 time at knn_main's launch), so a CTA serves one lane and the
// rows are split only if the grid would not fill the card: with six lanes
// sharing each tile and four ranges the heaps filled anew in every range
// and k 300 ran slower than with one lane a CTA (measured on the H100).
//
// Bound. At knn_main's launch (4,096 queries, 200,000 training rows, d 54,
// 6 lanes) the function's work is the distance product once for all lanes,
// 2 * nq * n * d = 8.85e10 f32 operations, plus one compare a (lane, query,
// row), 4.9e9: 1.39 ms at 67 TFLOP/s; its bytes (~50 MB) take 0.015 ms.
// Operations bound it, and with one lane group this design computes exactly
// that work (its own floor is the bound; the first version's was L times
// the product).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// query rows a CTA owns (the BQ template argument): 64, or 32 where that
// lets more CTAs share an SM (knn_plan)
constexpr int kBT = 128;      // training rows a tile holds
constexpr int kDC = 64;       // features a staged chunk holds
constexpr int kXS = kBT + 4;  // row strides (floats) of the transposed tile
constexpr int kDS = kBT + 4;  // chunk and distance tile (query chunk: BQ + 4);
                              // +4 keeps float4 alignment, spreads banks
constexpr int kMaxSharedK = 256;  // largest k with the lists in shared memory
constexpr int kMaxGroup = 16;     // lanes one CTA serves
constexpr int kMaxRanges = 32;    // row ranges of one launch
constexpr int kSmemLimit = 232448;
constexpr float kInf = 3.4e38f;
// OR-ed onto a masked-out row's distance: +inf or a NaN, never `< worst`
constexpr uint32_t kMaskedOut = 0x7f800000u;
// staged elements each thread fetches: a tile chunk, row masks
constexpr int kXLoads = kBT * kDC / kThreads;
constexpr int kMaskLoads = kMaxGroup * kBT / kThreads;
static_assert(kThreads == 256 && kBT == 128 && kDC == 64,
              "the thread maps below assume these sizes");

// One CTA's shared memory: the staged chunks, the distance tile, the
// tile's norms, the G lanes' row masks of this tile and the next (the
// owners scan with one while the other is stored) and (shared-memory lists
// only) the G lanes' lists.
size_t smem_bytes(int k, int G, int bq, bool device_lists) {
  return sizeof(float) * ((size_t)kDC * (bq + 4) + (size_t)kDC * kXS +
                          (size_t)bq * kDS + bq + kBT) +
         sizeof(uint32_t) * 2 * (size_t)G * kBT +
         (device_lists ? 0 : (size_t)G * bq * k * (sizeof(float) + sizeof(int)));
}

// One lane's k-slot lists for the CTA's BQ queries: slot-major in shared
// memory, or query-major in device memory (base at the CTA's first query).
template <bool kDevice, int BQ>
struct Lists {
  float* d;
  int* i;
  int k;
  __device__ __forceinline__ size_t at(int q, int p) const {
    if constexpr (kDevice)
      return (size_t)q * k + p;
    else
      return (size_t)p * BQ + q;
  }
};

// Staging map: within a warp, 8 consecutive features of 4 consecutive rows
// (32-byte runs in global memory; 32 distinct banks in the transposed
// store). Block b = warp + 8 * m covers rows 4 * (b / 8) .. +3 and features
// 8 * (b % 8) .. +7.
__device__ __forceinline__ int stage_row(int warp, int lane, int m) {
  return ((warp + 8 * m) >> 3) * 4 + (lane >> 3);
}
__device__ __forceinline__ int stage_dim(int warp, int lane, int m) {
  return ((warp + 8 * m) & 7) * 8 + (lane & 7);
}

__device__ __forceinline__ void fetch_tile(float (&xr)[kXLoads],
                                           const float* __restrict__ Xt, int n,
                                           int d, int j0, int f0, int warp,
                                           int lane) {
#pragma unroll
  for (int m = 0; m < kXLoads; ++m) {
    const int j = j0 + stage_row(warp, lane, m);
    const int f = f0 + stage_dim(warp, lane, m);
    xr[m] = (j < n && f < d) ? __ldg(Xt + (size_t)j * d + f) : 0.f;
  }
}

__device__ __forceinline__ void store_tile(const float (&xr)[kXLoads], float* Xs,
                                           int warp, int lane) {
#pragma unroll
  for (int m = 0; m < kXLoads; ++m)
    Xs[stage_dim(warp, lane, m) * kXS + stage_row(warp, lane, m)] = xr[m];
}

template <int BQ>
__device__ __forceinline__ void load_queries(float* Qs, const float* __restrict__ Q,
                                             int nq, int d, int q0, int f0,
                                             int warp, int lane) {
#pragma unroll
  for (int m = 0; m < BQ * kDC / kThreads; ++m) {
    const int r = stage_row(warp, lane, m);
    const int f = f0 + stage_dim(warp, lane, m);
    const int q = q0 + r;
    Qs[stage_dim(warp, lane, m) * (BQ + 4) + r] =
        (q < nq && f < d) ? __ldg(Q + (size_t)q * d + f) : 0.f;
  }
}

// The G lanes' masks of tile rows j0 .. j0 + 127 (element gl * kBT + c):
// 0 where W[l0 + gl, j] > 0, kMaskedOut elsewhere and past the table.
__device__ __forceinline__ void fetch_masks(uint32_t (&mr)[kMaskLoads],
                                            const float* __restrict__ W, int n,
                                            int l0, int G, int j0) {
#pragma unroll
  for (int m = 0; m < kMaskLoads; ++m) {
    const int e = threadIdx.x + m * kThreads;
    const int gl = e / kBT, j = j0 + e % kBT;
    mr[m] = (gl < G && j < n && __ldg(W + (size_t)(l0 + gl) * n + j) > 0.f) ? 0u
                                                                           : kMaskedOut;
  }
}

__device__ __forceinline__ void store_masks(const uint32_t (&mr)[kMaskLoads],
                                            uint32_t* masks, int G) {
#pragma unroll
  for (int m = 0; m < kMaskLoads; ++m) {
    const int e = threadIdx.x + m * kThreads;
    if (e < G * kBT) masks[e] = mr[m];
  }
}

// Insert v (training row j) into the list of query q; the caller has
// checked v < worst, the list's largest distance. Shared-memory lists are
// kept ascending: entries strictly greater than v move up one slot and the
// worst drops out. Device-memory lists (k above 256) are kept as a max-heap
// on (d2, index), so an insertion costs log k accesses instead of up to k;
// `finish_heap` sorts them at the end. Both keep the k smallest candidates
// by (d2, index), the same set in the same final order: candidates arrive
// in index order and enter only below the worst, so among equal distances
// the lowest index stays.
template <bool kDevice, int BQ>
__device__ __forceinline__ void insert(const Lists<kDevice, BQ>& l, int q, float v, int j,
                                       float& worst) {
  if constexpr (kDevice) {
    int p = 0;  // the root (the worst entry) is replaced, then sifted down
    for (;;) {
      int c = 2 * p + 1;
      if (c >= l.k) break;
      const float dc = l.d[l.at(q, c)];
      if (c + 1 < l.k) {
        const float dr = l.d[l.at(q, c + 1)];
        if (dr > dc || (dr == dc && l.i[l.at(q, c + 1)] > l.i[l.at(q, c)])) ++c;
      }
      const float dm = l.d[l.at(q, c)];
      if (!(dm > v)) break;  // the larger child is below v: v settles here
      l.d[l.at(q, p)] = dm;
      l.i[l.at(q, p)] = l.i[l.at(q, c)];
      p = c;
    }
    l.d[l.at(q, p)] = v;
    l.i[l.at(q, p)] = j;
    worst = l.d[l.at(q, 0)];
  } else {
    int p = l.k - 1;
    while (p > 0) {
      const float u = l.d[l.at(q, p - 1)];
      if (!(u > v)) break;
      l.d[l.at(q, p)] = u;
      l.i[l.at(q, p)] = l.i[l.at(q, p - 1)];
      --p;
    }
    l.d[l.at(q, p)] = v;
    l.i[l.at(q, p)] = j;
    worst = l.d[l.at(q, l.k - 1)];
  }
}

// Sort a device-memory list's max-heap into ascending (d2, index) order.
template <int BQ>
__device__ __forceinline__ void finish_heap(const Lists<true, BQ>& l, int q) {
  auto greater = [&](int a, int b) {
    const float da = l.d[l.at(q, a)], db = l.d[l.at(q, b)];
    return da > db || (da == db && l.i[l.at(q, a)] > l.i[l.at(q, b)]);
  };
  for (int end = l.k - 1; end > 0; --end) {
    const float d0 = l.d[l.at(q, 0)];
    const int i0 = l.i[l.at(q, 0)];
    l.d[l.at(q, 0)] = l.d[l.at(q, end)];
    l.i[l.at(q, 0)] = l.i[l.at(q, end)];
    l.d[l.at(q, end)] = d0;
    l.i[l.at(q, end)] = i0;
    int p = 0;
    for (;;) {
      int c = 2 * p + 1;
      if (c >= end) break;
      if (c + 1 < end && greater(c + 1, c)) ++c;
      if (!greater(c, p)) break;
      const float dp = l.d[l.at(q, p)];
      const int ip = l.i[l.at(q, p)];
      l.d[l.at(q, p)] = l.d[l.at(q, c)];
      l.i[l.at(q, p)] = l.i[l.at(q, c)];
      l.d[l.at(q, c)] = dp;
      l.i[l.at(q, c)] = ip;
      p = c;
    }
  }
}

// One list owner's pass over its query's row of the distance tile, in
// index order, through its lane's masks.
template <bool kDevice, int BQ>
__device__ __forceinline__ void scan_tile(const float* Ds, const uint32_t* mask,
                                          const Lists<kDevice, BQ>& l, int q, int j0,
                                          float& worst) {
  const float* row = Ds + q * kDS;
#pragma unroll 4
  for (int c = 0; c < kBT; c += 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c);
    const uint4 m = *reinterpret_cast<const uint4*>(mask + c);
    const float4 v = make_float4(__uint_as_float(u.x | m.x), __uint_as_float(u.y | m.y),
                                 __uint_as_float(u.z | m.z), __uint_as_float(u.w | m.w));
    // fminf drops a NaN; a NaN distance never passes `< worst` below
    if (fminf(fminf(v.x, v.y), fminf(v.z, v.w)) < worst) {
      if (v.x < worst) insert(l, q, v.x, j0 + c, worst);
      if (v.y < worst) insert(l, q, v.y, j0 + c + 1, worst);
      if (v.z < worst) insert(l, q, v.z, j0 + c + 2, worst);
      if (v.w < worst) insert(l, q, v.w, j0 + c + 3, worst);
    }
  }
}

// grid (query blocks, P row ranges, lane groups). CTA (x, p, z) owns
// queries BQ x .. + BQ - 1, lanes z G .. (z + 1) G - 1 (fewer in the last group)
// and the tiles p tpr .. (p + 1) tpr - 1. Its lists go to dst: with P = 1
// the [L, nq, k] outputs; else the [P, L, k, nq] (shared-memory lists,
// slot-major) or [P, L, nq, k] (device-memory lists) scratch.
template <bool kDevice, int BQ>
__global__ void __launch_bounds__(kThreads, 2)
    knn_topk_kernel(const float* __restrict__ Q, const float* __restrict__ Xt,
                    const float* __restrict__ qsq, const float* __restrict__ tsq,
                    const float* __restrict__ W, float* __restrict__ dst_d,
                    int* __restrict__ dst_i, int nq, int n, int d, int L, int k,
                    int G, int tpr) {
  // lists a thread owns: device-memory lists come one lane a CTA (the
  // plan's choice, checked by the entry point), so one
  constexpr int kLists = kDevice ? 1 : kMaxGroup * BQ / kThreads;
  constexpr int kQS = BQ + 4;
  constexpr int kRQ = BQ / 16;  // queries of a thread's register tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kDC][kQS] query chunk
  float* Xs = Qs + kDC * kQS;                  // [kDC][kXS] tile chunk
  float* Ds = Xs + kDC * kXS;                  // [BQ][kDS] distance tile
  float* qsq_s = Ds + BQ * kDS;                // [BQ]
  float* tsq_s = qsq_s + BQ;                   // [kBT] the tile's
  // [2][G][kBT]: buffer (t - t0) % 2 holds tile t's masks
  uint32_t* masks = reinterpret_cast<uint32_t*>(tsq_s + kBT);
  float* lists_d = reinterpret_cast<float*>(masks + 2 * G * kBT);  // [G][k][BQ]
  int* lists_i = reinterpret_cast<int*>(lists_d + (size_t)G * k * BQ);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int p = blockIdx.y, P = gridDim.y;
  const int l0 = blockIdx.z * G;
  const int Gh = min(G, L - l0);  // lanes of this group
  const int n_tiles = (n + kBT - 1) / kBT;
  const int t0 = p * tpr;
  const int t1 = min(n_tiles, t0 + tpr);
  const int dp = (d + 3) & ~3;  // features rounded up to the float4 step
  const int n_dc = (dp + kDC - 1) / kDC;
  const int n_stages = (t1 - t0) * n_dc;
  // the thread's kRQ x 8 register tile: queries kRQ tq .. +kRQ-1, rows
  // 4 tc .. +3 and 64 + 4 tc .. +3 (a warp covers 8 query groups x 4 row
  // groups)
  const int tc = (lane & 3) + 4 * (warp & 3);
  const int tq = (lane >> 2) + 8 * (warp >> 2);

  // lane gl's lists: shared memory, or device memory at the CTA's queries
  auto lists = [&](int gl) {
    if constexpr (kDevice) {
      const size_t o = (((size_t)p * L + l0 + gl) * nq + q0) * k;
      return Lists<true, BQ>{dst_d + o, dst_i + o, k};
    } else {
      const size_t o = (size_t)gl * k * BQ;
      return Lists<false, BQ>{lists_d + o, lists_i + o, k};
    }
  };
  for (int gl = 0; gl < Gh; ++gl) {
    const Lists<kDevice, BQ> ls = lists(gl);
    for (int i = tid; i < BQ * k; i += kThreads) {
      if (!kDevice || q0 + i / k < nq) {  // device lists: this CTA's rows only
        ls.d[i] = kInf;
        ls.i[i] = -1;
      }
    }
  }
  if (tid < BQ) qsq_s[tid] = (q0 + tid < nq) ? qsq[q0 + tid] : 0.f;
  load_queries<BQ>(Qs, Q, nq, d, q0, 0, warp, lane);
  float xr[kXLoads];
  uint32_t mr[kMaskLoads];
  fetch_tile(xr, Xt, n, d, t0 * kBT, 0, warp, lane);
  store_tile(xr, Xs, warp, lane);
  fetch_masks(mr, W, n, l0, Gh, t0 * kBT);
  store_masks(mr, masks, Gh);
  float tr = 0.f;  // the next tile's tsq (tid < kBT)
  if (tid < kBT) {
    const int j = t0 * kBT + tid;
    tsq_s[tid] = j < n ? tsq[j] : 0.f;
  }
  __syncthreads();

  float worst[kLists];  // the worst kept distance of each owned list
#pragma unroll
  for (int r = 0; r < kLists; ++r) worst[r] = kInf;
  float acc[kRQ][8];
  for (int s = 0; s < n_stages; ++s) {
    const int t = t0 + s / n_dc;
    const int ch = s % n_dc;
    const bool last_chunk = ch == n_dc - 1;
    const bool more = s + 1 < n_stages;
    if (more) {  // fetch the next stage now; store it after this one's math
      const int t_next = t0 + (s + 1) / n_dc;
      fetch_tile(xr, Xt, n, d, t_next * kBT, ((s + 1) % n_dc) * kDC, warp, lane);
      if (last_chunk) {
        fetch_masks(mr, W, n, l0, Gh, t_next * kBT);
        if (tid < kBT) {
          const int j = t_next * kBT + tid;
          tr = j < n ? tsq[j] : 0.f;
        }
      }
    }
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    }
    const int dl = min(kDC, dp - ch * kDC);
    for (int e = 0; e < dl; e += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float av[kRQ];
        if constexpr (kRQ == 4) {
          const float4 a = *reinterpret_cast<const float4*>(Qs + (e + u) * kQS + 4 * tq);
          av[0] = a.x, av[1] = a.y, av[2] = a.z, av[3] = a.w;
        } else {
          const float2 a = *reinterpret_cast<const float2*>(Qs + (e + u) * kQS + 2 * tq);
          av[0] = a.x, av[1] = a.y;
        }
        const float4 b0 = *reinterpret_cast<const float4*>(Xs + (e + u) * kXS + 4 * tc);
        const float4 b1 =
            *reinterpret_cast<const float4*>(Xs + (e + u) * kXS + 64 + 4 * tc);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kRQ; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
    }
    if (last_chunk) {  // this tile's distances, unmasked, into the distance tile
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        const int q = kRQ * tq + i;
        const float qs = qsq_s[q];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c0 = 64 * h + 4 * tc;
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float x = __fsub_rn(__fadd_rn(qs, tsq_s[c0 + c]),
                                      __fmul_rn(2.f, acc[i][4 * h + c]));
            v[c] = x < 0.f ? 0.f : x;
          }
          *reinterpret_cast<float4*>(Ds + q * kDS + c0) = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    __syncthreads();
    const int mb = (t - t0) & 1;  // this tile's mask buffer
    if (more) {  // the next stage's operands; the owners read neither
      store_tile(xr, Xs, warp, lane);
      if (n_dc > 1)
        load_queries<BQ>(Qs, Q, nq, d, q0, (ch + 1 == n_dc ? 0 : ch + 1) * kDC, warp, lane);
      if (last_chunk) {
        store_masks(mr, masks + (mb ^ 1) * G * kBT, Gh);
        if (tid < kBT) tsq_s[tid] = tr;
      }
    }
    if (last_chunk) {  // every owner scans its lists
#pragma unroll
      for (int r = 0; r < kLists; ++r) {
        const int li = tid + r * kThreads;  // a warp's 32 lists share a lane
        const int gl = li / BQ, q = li % BQ;
        if (gl < Gh && q0 + q < nq)
          scan_tile(Ds, masks + (mb * G + gl) * kBT, lists(gl), q, t * kBT, worst[r]);
      }
    }
    __syncthreads();
  }

  if constexpr (kDevice) {  // the lists are in place, once sorted
#pragma unroll
    for (int r = 0; r < kLists; ++r) {
      const int li = tid + r * kThreads;
      const int gl = li / BQ, q = li % BQ;
      if (gl < Gh && q0 + q < nq) finish_heap(lists(gl), q);
    }
  } else {
    for (int gl = 0; gl < Gh; ++gl) {
      const Lists<false, BQ> ls = lists(gl);
      const size_t lane0 = (size_t)l0 + gl;
      for (int i = tid; i < BQ * k; i += kThreads) {
        if (P == 1) {  // the outputs, query-major
          const int q = i / k, slot = i - q * k;
          if (q0 + q < nq) {
            const size_t o = (lane0 * nq + q0 + q) * k + slot;
            dst_d[o] = ls.d[ls.at(q, slot)];
            dst_i[o] = ls.i[ls.at(q, slot)];
          }
        } else {  // the scratch, slot-major: BQ consecutive queries a slot
          const int slot = i / BQ, q = i - slot * BQ;
          if (q0 + q < nq) {
            const size_t o = (((size_t)p * L + lane0) * k + slot) * nq + q0 + q;
            dst_d[o] = ls.d[ls.at(q, slot)];
            dst_i[o] = ls.i[ls.at(q, slot)];
          }
        }
      }
    }
  }
}

// One thread a (lane, query): merge the P range lists, each ascending by
// (d2, index) with its empty slots (index -1) last, into the k smallest by
// (d2, index). Ranges hold increasing indices, so a tie between two heads
// keeps the earlier range. Scratch layout as written by knn_topk_kernel.
template <bool kDevice>
__global__ void __launch_bounds__(kThreads)
    knn_merge_kernel(const float* __restrict__ sd, const int* __restrict__ si,
                     float* __restrict__ out_d, int* __restrict__ out_i, int nq, int L,
                     int k, int P) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)L * nq) return;
  const int l = (int)(e / nq), q = (int)(e % nq);
  auto at = [&](int r, int s) -> size_t {
    const size_t list0 = ((size_t)r * L + l) * nq * k;
    return kDevice ? list0 + (size_t)q * k + s : list0 + (size_t)s * nq + q;
  };
  int pos[kMaxRanges];
  float hd[kMaxRanges];
  int hi[kMaxRanges];
  for (int r = 0; r < P; ++r) {
    pos[r] = 0;
    hd[r] = sd[at(r, 0)];
    hi[r] = si[at(r, 0)];
  }
  float* od = out_d + ((size_t)l * nq + q) * k;
  int* oi = out_i + ((size_t)l * nq + q) * k;
  for (int s = 0; s < k; ++s) {
    int b = -1;
    for (int r = 0; r < P; ++r) {
      if (hi[r] < 0) continue;  // this range's list is used up
      if (b < 0 || hd[r] < hd[b]) b = r;
    }
    if (b < 0) {
      od[s] = kInf;
      oi[s] = -1;
      continue;
    }
    od[s] = hd[b];
    oi[s] = hi[b];
    if (++pos[b] < k) {
      hd[b] = sd[at(b, pos[b])];
      hi[b] = si[at(b, pos[b])];
    } else {
      hi[b] = -1;
    }
  }
}

template <bool kDevice, int BQ>
cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(knn_topk_kernel<kDevice, BQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemLimit);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(knn_topk_kernel<kDevice, BQ>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace

extern "C" {

// The largest k whose lists live in shared memory, the largest lane group
// and row-range count, and one CTA's shared memory at (k, lane group, query
// block); the Python wrapper mirrors them.
int knn_max_shared_k() { return kMaxSharedK; }
int knn_max_group() { return kMaxGroup; }
int knn_max_ranges() { return kMaxRanges; }
long long knn_smem_bytes(int k, int G, int bq) {
  return (long long)smem_bytes(k, G, bq, k > kMaxSharedK);
}

// Q [nq, d], Xt [n, d], qsq [nq], tsq [n], W [L, n] f32 -> out_d [L, nq, k]
// f32 ascending, out_i [L, nq, k] i32. bq queries (64, or 32 with the
// lists in shared memory) and G lanes a CTA, P row ranges of whole tiles
// (every range non-empty); with P > 1, scratch_d / scratch_i hold P * L *
// nq * k elements each. Above kMaxSharedK the lists live in device memory
// (the outputs, or the scratch) instead of shared memory.
int knn_topk(const void* Q, const void* Xt, const void* qsq, const void* tsq,
             const void* W, void* out_d, void* out_i, void* scratch_d, void* scratch_i,
             int nq, int n, int d, int L, int k, int G, int P, int bq, void* stream) {
  const bool device_lists = k > kMaxSharedK;
  const int n_tiles = (n + kBT - 1) / kBT;
  if (nq <= 0 || n <= 0 || d <= 0 || L <= 0 || k <= 0 || G < 1 || G > kMaxGroup ||
      G > L || (device_lists && G != 1) || P < 1 || P > kMaxRanges || P > n_tiles ||
      !(bq == 64 || (bq == 32 && !device_lists)))
    return (int)cudaErrorInvalidValue;
  const int tpr = (n_tiles + P - 1) / P;
  const int n_groups = (L + G - 1) / G;
  if ((P - 1) * tpr >= n_tiles || n_groups > 65535 ||
      smem_bytes(k, G, bq, device_lists) > (size_t)kSmemLimit ||
      (P > 1 && (scratch_d == nullptr || scratch_i == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = device_lists ? configure<true, 64>()
                          : bq == 64   ? configure<false, 64>()
                                       : configure<false, 32>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((nq + bq - 1) / bq), (unsigned)P, (unsigned)n_groups);
  const size_t smem = smem_bytes(k, G, bq, device_lists);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* q = static_cast<const float*>(Q);
  const float* x = static_cast<const float*>(Xt);
  const float* a = static_cast<const float*>(qsq);
  const float* b = static_cast<const float*>(tsq);
  const float* w = static_cast<const float*>(W);
  float* od = static_cast<float*>(P > 1 ? scratch_d : out_d);
  int* oi = static_cast<int*>(P > 1 ? scratch_i : out_i);
  if (device_lists)
    knn_topk_kernel<true, 64><<<grid, kThreads, smem, s>>>(q, x, a, b, w, od, oi, nq, n, d,
                                                           L, k, G, tpr);
  else if (bq == 64)
    knn_topk_kernel<false, 64><<<grid, kThreads, smem, s>>>(q, x, a, b, w, od, oi, nq, n, d,
                                                            L, k, G, tpr);
  else
    knn_topk_kernel<false, 32><<<grid, kThreads, smem, s>>>(q, x, a, b, w, od, oi, nq, n, d,
                                                            L, k, G, tpr);
  cudaError_t last = cudaGetLastError();
  if (last != cudaSuccess || P == 1) return (int)last;
  const unsigned merge_blocks = (unsigned)(((long long)L * nq + kThreads - 1) / kThreads);
  const float* sd = static_cast<const float*>(scratch_d);
  const int* si = static_cast<const int*>(scratch_i);
  if (device_lists)
    knn_merge_kernel<true><<<merge_blocks, kThreads, 0, s>>>(
        sd, si, static_cast<float*>(out_d), static_cast<int*>(out_i), nq, L, k, P);
  else
    knn_merge_kernel<false><<<merge_blocks, kThreads, 0, s>>>(
        sd, si, static_cast<float*>(out_d), static_cast<int*>(out_i), nq, L, k, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
