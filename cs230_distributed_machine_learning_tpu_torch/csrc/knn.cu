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
// out in slot order. Here one CTA owns (a block of 64 queries, one lane)
// and walks the training tiles in index order inside the CTA: the running
// lists live in shared memory for the whole sweep. Each list is kept by one
// thread, which scans a tile's distances in index order and inserts a
// candidate only if it is strictly below the list's worst slot, shifting
// larger entries up; so among equal distances the lowest index is kept and
// emitted first, by construction (a documented difference from the TPU
// kernel's slot order; the votes do not depend on it).
//
// Design. 256 threads, a 64-query block and 128-row training tiles. The
// query block and a tile are staged transposed in shared memory, in chunks
// of 64 features (one chunk at covertype's d = 54, so the query block is
// staged once). Each thread computes a 4-query x 8-row register tile of
// dot products with float4 shared-memory loads, then writes its distances
// to a shared distance tile; after a barrier the 64 list owners scan it
// while the other warps store the next tile, which every thread fetched
// into registers before computing the current one (so the global loads
// overlap the FMAs). A 4-wide minimum against the worst slot skips most of
// the scan once the lists have filled.
//
// Where the lists live (knn_list_mode in ops/cuda_knn.py). Up to k = 256
// they live in shared memory, slot-major, 8 bytes a (query, slot): at
// k = 5 a CTA holds ~88 KB and two fit on an SM; k = 256 takes ~217 KB.
// Above 256 a CTA could not hold them, so the same kernel keeps them in
// device memory instead: the output tensors themselves ([L, nq, k] of d2
// and of idx, allocated by the wrapper) are the lists, set to (3.4e38,
// -1) first and updated in place by the same owner threads under the
// same rule (insert only strictly below the worst slot, tiles in index
// order), so ties and empty slots come out exactly as in shared memory.
// There each list is a max-heap on (d2, index), which an insertion walks
// in log k accesses through L2 instead of shifting up to k entries, and
// the owner sorts it once at the end.
//
// Bound. At the port's main path shape (4,096 queries, 200,000 training
// rows, d 54, 6 lanes) the function's work is the distance product, once
// for all lanes: 2 * nq * n * d = 8.85e10 f32 operations, 1.32 ms at
// 67 TFLOP/s, plus one compare a (lane, query, row), 4.9e9; its bytes
// (~50 MB) take 0.015 ms. Operations bound it. This first kernel computes
// the product once per lane (its own floor is L times the bound) and
// stages tiles with plain loads between two barriers.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;       // query rows a CTA owns
constexpr int kBT = 128;      // training rows a tile holds
constexpr int kDC = 64;       // features a staged chunk holds
constexpr int kQS = kBQ + 4;  // row strides (floats) of the transposed
constexpr int kXS = kBT + 4;  // query chunk, tile chunk and distance tile;
constexpr int kDS = kBT + 4;  // +4 keeps float4 alignment, spreads banks
constexpr int kMaxSharedK = 256;  // largest k with the lists in shared memory
constexpr int kSmemLimit = 232448;
constexpr float kInf = 3.4e38f;
// staged elements each thread fetches: a tile chunk and a query chunk
constexpr int kXLoads = kBT * kDC / kThreads;
constexpr int kQLoads = kBQ * kDC / kThreads;
static_assert(kThreads == 256 && kBQ == 64 && kBT == 128 && kDC == 64,
              "the thread maps below assume these sizes");

// One CTA's shared memory: the staged chunks, the distance tile, the
// tile's norms and weights, and (shared-memory lists only) the lists.
size_t smem_bytes(int k, bool device_lists) {
  return sizeof(float) * ((size_t)kDC * kQS + (size_t)kDC * kXS +
                          (size_t)kBQ * kDS + kBQ + 2 * kBT) +
         (device_lists ? 0 : (size_t)kBQ * k * (sizeof(float) + sizeof(int)));
}

// The CTA's k-slot lists: slot-major in shared memory, or query-major in
// the [L, nq, k] outputs (base at the CTA's first query) in device memory.
template <bool kDevice>
struct Lists {
  float* d;
  int* i;
  int k;
  __device__ __forceinline__ auto at(int q, int p) const {
    if constexpr (kDevice)
      return (size_t)q * k + p;
    else
      return p * kBQ + q;
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

__device__ __forceinline__ void load_queries(float* Qs, const float* __restrict__ Q,
                                             int nq, int d, int q0, int f0,
                                             int warp, int lane) {
#pragma unroll
  for (int m = 0; m < kQLoads; ++m) {
    const int r = stage_row(warp, lane, m);
    const int f = f0 + stage_dim(warp, lane, m);
    const int q = q0 + r;
    Qs[stage_dim(warp, lane, m) * kQS + r] =
        (q < nq && f < d) ? __ldg(Q + (size_t)q * d + f) : 0.f;
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
template <bool kDevice>
__device__ __forceinline__ void insert(const Lists<kDevice>& l, int q, float v, int j,
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
__device__ __forceinline__ void finish_heap(const Lists<true>& l, int q) {
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

// One list owner's pass over its row of the distance tile, in index order.
template <bool kDevice>
__device__ __forceinline__ void scan_tile(const float* Ds, const Lists<kDevice>& l, int q,
                                          int j0, float& worst) {
  const float* row = Ds + q * kDS;
#pragma unroll 4
  for (int c = 0; c < kBT; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + c);
    // fminf drops a NaN; a NaN distance never passes `< worst` below
    if (fminf(fminf(v.x, v.y), fminf(v.z, v.w)) < worst) {
      if (v.x < worst) insert(l, q, v.x, j0 + c, worst);
      if (v.y < worst) insert(l, q, v.y, j0 + c + 1, worst);
      if (v.z < worst) insert(l, q, v.z, j0 + c + 2, worst);
      if (v.w < worst) insert(l, q, v.w, j0 + c + 3, worst);
    }
  }
}

template <bool kDevice>
__global__ void __launch_bounds__(kThreads, 2)
    knn_topk_kernel(const float* __restrict__ Q, const float* __restrict__ Xt,
                    const float* __restrict__ qsq, const float* __restrict__ tsq,
                    const float* __restrict__ W, float* __restrict__ out_d,
                    int* __restrict__ out_i, int nq, int n, int d, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [kDC][kQS] query chunk
  float* Xs = Qs + kDC * kQS;                  // [kDC][kXS] tile chunk
  float* Ds = Xs + kDC * kXS;                  // [kBQ][kDS] distance tile
  float* qsq_s = Ds + kBQ * kDS;               // [kBQ]
  float* tsq_s = qsq_s + kBQ;                  // [kBT] the tile's
  float* w_s = tsq_s + kBT;                    // [kBT] the tile's lane weights
  // the lists: [k][kBQ] after the tile weights, or the outputs themselves
  Lists<kDevice> lists;
  if constexpr (kDevice) {
    const size_t out0 = ((size_t)blockIdx.y * nq + blockIdx.x * kBQ) * k;
    lists = {out_d + out0, out_i + out0, k};
  } else {
    lists = {w_s + kBT, reinterpret_cast<int*>(w_s + kBT + kBQ * k), k};
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const float* __restrict__ Wl = W + (size_t)blockIdx.y * n;
  const int dp = (d + 3) & ~3;  // features rounded up to the float4 step
  const int n_dc = (dp + kDC - 1) / kDC;
  const int n_stages = ((n + kBT - 1) / kBT) * n_dc;
  // the thread's 4 x 8 register tile: queries 4 tq .. +3, rows 4 tc .. +3
  // and 64 + 4 tc .. +3 (a warp covers 8 query groups x 4 row groups)
  const int tc = (lane & 3) + 4 * (warp & 3);
  const int tq = (lane >> 2) + 8 * (warp >> 2);

  for (int i = tid; i < kBQ * k; i += kThreads) {
    if (!kDevice || q0 + i / k < nq) {  // device lists: this CTA's rows only
      lists.d[i] = kInf;
      lists.i[i] = -1;
    }
  }
  if (tid < kBQ) qsq_s[tid] = (q0 + tid < nq) ? qsq[q0 + tid] : 0.f;
  load_queries(Qs, Q, nq, d, q0, 0, warp, lane);
  float xr[kXLoads];
  fetch_tile(xr, Xt, n, d, 0, 0, warp, lane);
  store_tile(xr, Xs, warp, lane);
  float tr = 0.f, wr = 0.f;  // the next tile's tsq and weight (tid < kBT)
  if (tid < kBT) {
    tsq_s[tid] = tid < n ? tsq[tid] : 0.f;
    w_s[tid] = tid < n ? Wl[tid] : 0.f;
  }
  __syncthreads();

  float worst = kInf;  // list owners: the worst kept distance
  float acc[4][8];
  for (int s = 0; s < n_stages; ++s) {
    const int t = s / n_dc;
    const int ch = s - t * n_dc;
    const bool last_chunk = ch == n_dc - 1;
    const bool more = s + 1 < n_stages;
    if (more) {  // fetch the next stage now; store it after this one's math
      const int t1 = (s + 1) / n_dc;
      fetch_tile(xr, Xt, n, d, t1 * kBT, (s + 1 - t1 * n_dc) * kDC, warp, lane);
      if (last_chunk && tid < kBT) {
        const int j = t1 * kBT + tid;
        tr = j < n ? tsq[j] : 0.f;
        wr = j < n ? Wl[j] : 0.f;
      }
    }
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    }
    const int dl = min(kDC, dp - ch * kDC);
    for (int e = 0; e < dl; e += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a = *reinterpret_cast<const float4*>(Qs + (e + u) * kQS + 4 * tq);
        const float4 b0 = *reinterpret_cast<const float4*>(Xs + (e + u) * kXS + 4 * tc);
        const float4 b1 =
            *reinterpret_cast<const float4*>(Xs + (e + u) * kXS + 64 + 4 * tc);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
      }
    }
    if (last_chunk) {  // distances of this tile into the shared distance tile
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 4 * tq + i;
        const float qs = qsq_s[q];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c0 = 64 * h + 4 * tc;
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float x = __fsub_rn(__fadd_rn(qs, tsq_s[c0 + c]),
                                __fmul_rn(2.f, acc[i][4 * h + c]));
            x = x < 0.f ? 0.f : x;
            v[c] = w_s[c0 + c] > 0.f ? x : kInf;
          }
          *reinterpret_cast<float4*>(Ds + q * kDS + c0) = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    __syncthreads();
    if (more) {
      store_tile(xr, Xs, warp, lane);
      if (n_dc > 1) load_queries(Qs, Q, nq, d, q0, (ch + 1 == n_dc ? 0 : ch + 1) * kDC, warp, lane);
      if (last_chunk && tid < kBT) {
        tsq_s[tid] = tr;
        w_s[tid] = wr;
      }
    }
    if (last_chunk && tid < kBQ && q0 + tid < nq)
      scan_tile(Ds, lists, tid, t * kBT, worst);
    __syncthreads();
  }

  if constexpr (kDevice) {  // the lists are the outputs, once sorted
    if (tid < kBQ && q0 + tid < nq) finish_heap(lists, tid);
    return;
  }
  const size_t base = (size_t)blockIdx.y * nq;
  for (int i = tid; i < kBQ * k; i += kThreads) {
    const int q = i / k;
    const int slot = i - q * k;
    if (q0 + q < nq) {
      const size_t o = (base + q0 + q) * k + slot;
      out_d[o] = lists.d[lists.at(q, slot)];
      out_i[o] = lists.i[lists.at(q, slot)];
    }
  }
}

template <bool kDevice>
cudaError_t configure() {
  static bool configured = false;
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(knn_topk_kernel<kDevice>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(kMaxSharedK, kDevice));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(knn_topk_kernel<kDevice>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace

extern "C" {

// The largest k whose lists live in shared memory, and one CTA's shared
// memory at k; the Python wrapper mirrors both.
int knn_max_shared_k() { return kMaxSharedK; }
long long knn_smem_bytes(int k) { return (long long)smem_bytes(k, k > kMaxSharedK); }

// Q [nq, d], Xt [n, d], qsq [nq], tsq [n], W [L, n] f32 -> out_d [L, nq, k]
// f32 ascending, out_i [L, nq, k] i32. Above kMaxSharedK the lists live in
// out_d / out_i instead of shared memory.
int knn_topk(const void* Q, const void* Xt, const void* qsq, const void* tsq,
             const void* W, void* out_d, void* out_i, int nq, int n, int d,
             int L, int k, void* stream) {
  const bool device_lists = k > kMaxSharedK;
  if (nq <= 0 || n <= 0 || d <= 0 || L <= 0 || L > 65535 || k <= 0 ||
      smem_bytes(k, device_lists) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = device_lists ? configure<true>() : configure<false>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((nq + kBQ - 1) / kBQ), (unsigned)L);
  const size_t smem = smem_bytes(k, device_lists);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* q = static_cast<const float*>(Q);
  const float* x = static_cast<const float*>(Xt);
  const float* a = static_cast<const float*>(qsq);
  const float* b = static_cast<const float*>(tsq);
  const float* w = static_cast<const float*>(W);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  if (device_lists)
    knn_topk_kernel<true><<<grid, kThreads, smem, s>>>(q, x, a, b, w, od, oi, nq, n, d, k);
  else
    knn_topk_kernel<false><<<grid, kThreads, smem, s>>>(q, x, a, b, w, od, oi, nq, n, d, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
