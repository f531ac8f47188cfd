// Hand-written Hopper (sm_90a) kernel for the MLP search path. It replaces
// the Pallas TPU kernel of the JAX package's ops/pallas_mlp.py:
//
//   mlp_epoch  <-  build_epoch_fn  (pallas_mlp.py:239, body _epoch_kernel :77)
//
// One launch runs one whole minibatch epoch for L lanes (a lane is one
// trial x split fit). Every lane shares the epoch-shuffled batch rows; for
// each of the n_batches steps, in order, a lane runs the forward pass
// through up to 4 layers, the output gradient of its split-weighted mean
// loss (softmax minus one-hot, or the residual), the backward pass last
// layer first, and the in-place Adam or SGD update of its params and
// moments; with track_loss its batch data loss accumulates into loss[lane].
//
// Precision is the TPU kernel's (_dot, pallas_mlp.py:66): every product
// rounds both operands to bf16 and accumulates in f32 on the tensor cores
// (mma.sync m16n8k16), the bias products included, so the forward adds
// bf16(b) and the bias gradient sums bf16(dz). Activations, the softmax,
// the losses and the updates are f32.
//
// Residency. The TPU kernel keeps a lane's params and moments in VMEM for
// the whole epoch. Here they cannot stay on chip: one lane of the widest
// config-5 net (784-512-10, 406,528 params) holds 4.9 MB of f32 p + m + v,
// and an SM has 228 KB of shared memory. So the state lives in device
// memory and every step reads and writes it in the weight-gradient
// product's epilogue; the step's activations and gradients go through a
// per-lane scratch, which stays in L2.
//
// Design. One CTA per lane walks the epoch's steps in order, as the TPU
// grid's step-minor axis does; nothing is shared between CTAs, so there
// are no atomics and every sum has a fixed order. Each layer's product is
// a CTA-wide tiled GEMM (8 warps, mma.sync) whose epilogue is fused: bias
// and activation into the forward product, act' into the activation-
// gradient product, and the L2 term plus the Adam/SGD update into the
// weight-gradient product. The activation gradient is computed before the
// weight update, so both read the step's old weights, as the TPU kernel
// does.
//
// What the design does to keep the products fed and the state off their
// critical path:
//   (a) keeps every product operand in bf16 in memory: a bf16 shadow of
//       each W (written from W in the launch's prologue and by the update
//       epilogue after every step), each hidden activation in bf16 beside
//       the f32 value that act' reads, and the output gradients dz in bf16
//       only (every use of dz rounds it to bf16 first), so the products
//       read the same bf16 values as rounding on every load would. Every
//       bf16 buffer's rows are padded to a multiple of 8 with zeros, so
//       every operand but the batch rows (when d % 8 != 0) moves in 16-byte
//       pieces;
//   (b) feeds the tensor cores from a 4-stage ring of K slabs in shared
//       memory, filled by cp.async (zero-filled past the edges) over the
//       flattened (output tile, K slab) sequence, so the loads of the next
//       tile overlap the current tile's products and epilogue; transposed
//       orientations come from row-major tiles through ldmatrix(.trans);
//   (c) moves each weight-gradient output tile's W, m and v between device
//       and shared memory with the Tensor Memory Accelerator: bulk copies,
//       a row each, started when the tile's first K slab is computed and
//       counted on an mbarrier, so the state loads overlap the tile's K
//       loop and never queue behind the operand loads. The epilogue parks
//       the tile's products in shared memory; the update then runs on
//       16-byte pieces (4 parameters a thread at a time, independent), and
//       bulk copies write W, m, v and the bf16 shadow back, a row each.
//       Layers whose width is not a multiple of 8 (the 10 classes) update
//       in place in device memory instead;
//   (d) takes a narrow 128 x 16 output tile for outputs of width <= 16
//       (the 10 classes), instead of padding a 64-wide tile.
// The f32 moments and the update order are the TPU kernel's. The state
// still moves at every step: the design's floor is that traffic (plus the
// shadow's writes), 49 ms an epoch at the config-5 shape on 72 lanes.
// What bounds it: one lane alone takes nearly the time of 72 side by
// side (PERF.md), so neither the memory system nor the tensor cores
// set the pace; one CTA of 8 warps runs a lane's chain of dependent
// phases (loads started, products, epilogues, barriers) at a low
// instruction rate, with too few warps on the SM to hide their latencies.
// More SMs a lane (a cluster splitting the output tiles) or a
// warp-specialised producer/consumer loop is the next step.
//
// Bound at the config-5 shape (784-512-10, bs 256, 234 steps, 75 lanes):
// the products are 7.35 TFLOP an epoch, 7.4 ms at 989 TFLOP/s bf16; the
// state read and written once plus the batch rows read once are ~0.8 GB,
// 0.25 ms at 3.35 TB/s.
//
// mlp_epoch returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 4;
// output tile rows, K slab depth, ring depth; the output tile is 64 wide,
// or 16 for outputs of width <= 16
constexpr int BM = 128;
constexpr int BK = 32;
constexpr int kStages = 4;
constexpr int kWide = 64;
constexpr int kNarrow = 16;
// one ring stage: the A tile ([BM][BK + 8] or [BK][BM + 8]) and the B tile
// ([BK][BN + 8] or [BN][BK + 8]), bf16; leading dimensions are padded so
// that ldmatrix's 8 row addresses fall in distinct banks
constexpr int kAStage = BM * (BK + 8);
constexpr int kBStage = kWide * (BK + 8);
static_assert(kAStage >= BK * (BM + 8) && kBStage >= BK * (kWide + 8), "stage sizes");
// the weight-gradient tile's state: up to 3 f32 arrays of [BM][BN + 8],
// the updated weights' bf16 shadow [BM][BN + 8], and the tile's products
// [BM][BN + 8] f32
constexpr int kStateFloats = 3 * BM * (kWide + 8);
constexpr int kShadowFloats = BM * (kWide + 8) / 2;
constexpr int kProductFloats = BM * (kWide + 8);
constexpr size_t kSmemBytes =
    (size_t)kStages * (kAStage + kBStage) * sizeof(__nv_bfloat16) +
    (size_t)(kStateFloats + kShadowFloats + kProductFloats) * sizeof(float) +
    kWarps * sizeof(float);

enum Act { kRelu = 0, kTanh = 1, kLogistic = 2, kIdentity = 3 };

struct EpochArgs {
  const __nv_bfloat16* X;  // [R][d] shuffled rows of the epoch
  const float* Y;          // [R][c] one-hot classes or targets
  const float* Wl;         // [R][L] split weights, lane-minor
  const float* lr;         // [L]
  const float* alpha;      // [L]
  float* W[kMaxLayers];    // [L][din][dout]
  float* B[kMaxLayers];    // [L][dout]
  float* s1W[kMaxLayers];  // adam m / sgd velocity
  float* s1B[kMaxLayers];
  float* s2W[kMaxLayers];  // adam v (unused by sgd)
  float* s2B[kMaxLayers];
  float* loss;             // [L], or null
  float* scratch;          // [L][scratch]
  long long scratch_per_lane;
  int dims[kMaxLayers + 1];
  int n_layers, bs, n_batches, L, t0, act, classification, sgd, nesterov, track_loss;
  float momentum;
};

__host__ __device__ inline int pad8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline long long pad4(long long x) { return (x + 3) & ~3LL; }

// One lane's scratch, in floats (every piece starts 16-byte aligned): per
// layer the bf16 shadow of W [din][pad8(dout)]; per hidden layer its f32
// activations [bs][dout] and their bf16 copy [bs][pad8(dout)]; the f32
// logits [bs][c]; per layer the bf16 output gradient dz [bs][pad8(dout)].
struct Layout {
  long long wsh[kMaxLayers], actf[kMaxLayers], actb[kMaxLayers], logits, dzb[kMaxLayers];
  long long bf16_begin, total;  // actb .. dzb: zeroed by the prologue
};

__host__ __device__ inline Layout scratch_layout(const int* dims, int n_layers, int bs) {
  Layout s{};
  long long o = 0;
  for (int l = 0; l < n_layers; ++l) {
    s.wsh[l] = o;
    o += pad4((long long)dims[l] * pad8(dims[l + 1]) / 2);
  }
  for (int l = 0; l + 1 < n_layers; ++l) {
    s.actf[l] = o;
    o += pad4((long long)bs * dims[l + 1]);
  }
  s.logits = o;
  o += pad4((long long)bs * dims[n_layers]);
  s.bf16_begin = o;
  for (int l = 0; l + 1 < n_layers; ++l) {
    s.actb[l] = o;
    o += pad4((long long)bs * pad8(dims[l + 1]) / 2);
  }
  for (int l = 0; l < n_layers; ++l) {
    s.dzb[l] = o;
    o += pad4((long long)bs * pad8(dims[l + 1]) / 2);
  }
  s.total = o;
  return s;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float act_fn(int act, float z) {
  switch (act) {
    case kRelu: return fmaxf(z, 0.0f);
    case kTanh: return tanhf(z);
    case kLogistic: return 1.0f / (1.0f + expf(-z));
    default: return z;
  }
}

// The activation's derivative from its output a (relu: a > 0 iff z > 0).
__device__ __forceinline__ float act_grad(int act, float a) {
  switch (act) {
    case kRelu: return a > 0.0f ? 1.0f : 0.0f;
    case kTanh: return 1.0f - a * a;
    case kLogistic: return a * (1.0f - a);
    default: return 1.0f;
  }
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The Tensor Memory Accelerator's 1-D bulk stores (loads: hopper.cuh).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The bulk stores have read their shared-memory sources / are complete.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Orders this thread's generic-proxy memory accesses with the bulk copies'.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// A row-major bf16 matrix: element (r, c) at p[r * ld + c], zero outside
// [0, nr) x [0, nc). `vec`: 16-byte pieces may carry it (aligned, ld and
// nc multiples of 8, so a piece lies wholly inside or outside).
struct Mat {
  const __nv_bfloat16* p;
  int ld, nr, nc;
  bool vec;
};

__device__ __forceinline__ Mat make_mat(const __nv_bfloat16* p, int ld, int nr, int nc) {
  const bool aligned = (reinterpret_cast<uintptr_t>(p) % 16) == 0;
  return Mat{p, ld, nr, nc, aligned && ld % 8 == 0 && nc % 8 == 0};
}

// Stage the R x C block at (r0, c0) of `a` into dst[r][c] (leading
// dimension ldd): cp.async pieces where `a` allows, else element by element
// (stores the next barrier publishes).
template <int R, int C>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ldd, const Mat& a, int r0,
                                          int c0) {
  if (a.vec) {
    constexpr int kPer = C / 8;
    for (int idx = threadIdx.x; idx < R * kPer; idx += kThreads) {
      const int r = idx / kPer, c = (idx % kPer) * 8;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < a.nr && gc < a.nc;
      cp_async16(dst + r * ldd + c, ok ? a.p + (size_t)gr * a.ld + gc : a.p, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * C; idx += kThreads) {
      const int r = idx / C, c = idx % C;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * ldd + c] = (gr < a.nr && gc < a.nc) ? a.p[(size_t)gr * a.ld + gc]
                                                  : __float2bfloat16_rn(0.0f);
    }
  }
}

// mma.sync m16n8k16 fragments (PTX ISA), g = lane / 4, q = lane % 4:
//   A 16 x 16 row-major: a0 (g, 2q..2q+1)  a1 (g+8, 2q..)  a2 (g, 8+2q..)  a3 (g+8, 8+2q..)
//   B 16 x 8 (k x n):    b0 (k 2q..2q+1, n g)  b1 (k 8+2q.., n g)
//   C 16 x 8 f32:        c0 c1 (g, 2q..2q+1)  c2 c3 (g+8, 2q..2q+1)
// A fragment of the 16 x 16 block at p, stored [m][k] (leading dimension ld).
__device__ __forceinline__ void load_a_mk(uint32_t (&r)[4], const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x % 32;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p + (lane % 16) * ld + 8 * (lane / 16))));
}

// A fragment of the 16 x 16 block at p, stored [k][m]: matrix i of the x4
// load is (m block i % 2, k block i / 2), each stored k rows by 8 m.
__device__ __forceinline__ void load_a_km(uint32_t (&r)[4], const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x % 32, mat = lane / 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p + (lane % 8 + 8 * (mat / 2)) * ld + 8 * (mat % 2))));
}

// B fragment of the 16 (k) x 8 (n) block at p, stored [k][n].
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[2], const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x % 32;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p + (lane % 16) * ld)));
}

// B fragment of the 16 (k) x 8 (n) block at p, stored [n][k].
__device__ __forceinline__ void load_b_nk(uint32_t (&r)[2], const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x % 32;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p + (lane % 8) * ld + 8 * ((lane / 8) % 2))));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The weight-gradient tile's state in device memory: n f32 arrays
// [nr][ld] (W, then m, then v), moved tile by tile between device and
// shared memory by bulk copies (rows of 16-byte multiples), completion of
// the loads counted on `bar` (whose current phase parity is `phase`).
struct StateSrc {
  float* p[3];
  int n, ld, nr;
  uint64_t* bar;
  int phase;
};

// Shape of a CTA product with BN-wide output tiles; A stored [m][k] or
// (kAKM) [k][m], B stored [k][n] or (kBNK) [n][k].
template <int BN, bool kAKM, bool kBNK>
struct Geo {
  static constexpr int WM = BN == kWide ? 4 : 8;  // warps along m
  static constexpr int WN = kWarps / WM;
  static constexpr int MI = BM / (16 * WM);  // 16-row blocks a warp
  static constexpr int NI = BN / (8 * WN);   // 8-column blocks a warp
  static constexpr int LDA = kAKM ? BM + 8 : BK + 8;
  static constexpr int LDB = kBNK ? BK + 8 : BN + 8;
  static constexpr int LDS = BN + 8;  // the state tile's rows (floats)
  static_assert(MI * 16 * WM == BM && NI * 8 * WN == BN, "warp tiling");
};

// C[M][N] = A[M][K] B[K][N] over the whole CTA, bf16 operands and f32 sums
// in K order. epi(m, n, tile_m, tile_n, v0, v1, two) takes every output
// element once, in pairs along n: (m, n) and, if `two`, (m, n + 1), with n
// even. The (output tile, K slab) pairs run as one sequence through the
// ring, so the next tile's slabs load during this tile's products and
// epilogue. With `state`, each output tile's state is loaded into
// `sstate` by bulk copies started when its first slab is computed; after
// the epilogue, the wait for those copies and a barrier, flush(m0, n0)
// updates the tile and writes it back. Starts and ends with a barrier, so
// the caller's writes before it and the epilogue's writes are visible to
// the whole CTA.
template <int BN, bool kAKM, bool kBNK, class Epi, class Flush>
__device__ __forceinline__ void cta_gemm(const Mat& A, const Mat& B, int M, int N, int K,
                                         __nv_bfloat16* ring, StateSrc* state, float* sstate,
                                         Epi epi, Flush flush) {
  using G = Geo<BN, kAKM, kBNK>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % G::WM, wn = warp / G::WM;
  const int g = lane / 4, q = lane % 4;
  const int tn = (N + BN - 1) / BN, nk = (K + BK - 1) / BK;
  const int total = ((M + BM - 1) / BM) * tn * nk;

  // the next slab to load: its sequence index, stage, tile (row, column)
  // and K slab, counted forward instead of divided out
  int lj = 0, ls = 0, lm = 0, ln = 0, lk = 0;
  auto load_next = [&]() {
    if (lj < total) {
      __nv_bfloat16* As = ring + ls * (kAStage + kBStage);
      __nv_bfloat16* Bs = As + kAStage;
      const int m0 = lm * BM, n0 = ln * BN, k0 = lk * BK;
      if (kAKM)
        load_tile<BK, BM>(As, G::LDA, A, k0, m0);
      else
        load_tile<BM, BK>(As, G::LDA, A, m0, k0);
      if (kBNK)
        load_tile<BN, BK>(Bs, G::LDB, B, n0, k0);
      else
        load_tile<BK, BN>(Bs, G::LDB, B, k0, n0);
    }
    ++lj;
    if (++ls == kStages) ls = 0;
    if (++lk == nk) {
      lk = 0;
      if (++ln == tn) {
        ln = 0;
        ++lm;
      }
    }
  };

  __syncthreads();  // the ring and the state tile are free
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    load_next();
    cp_async_commit();
  }
  float acc[G::MI][G::NI][4];
  int cs = 0, cm = 0, cn = 0, kt = 0;  // the slab computed: stage, tile, K slab
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab `it` is in; every warp is done with slab it - 1
    const int m0 = cm * BM, n0 = cn * BN;
    load_next();
    cp_async_commit();
    if (state != nullptr && kt == 0) {  // the tile's state rows, by bulk copies
      const int rows = min(BM, state->nr - m0), cols = min(BN, state->ld - n0);
      if (threadIdx.x == 0)
        mbar_expect_tx(state->bar, (uint32_t)(rows * cols * 4 * state->n));
      __syncthreads();  // the expected bytes are set before any copy lands
      for (int idx = threadIdx.x; idx < rows * state->n; idx += kThreads) {
        const int a = idx / rows, r = idx - a * rows;
        const float* src = a == 0 ? state->p[0] : a == 1 ? state->p[1] : state->p[2];
        bulk_load(sstate + (a * BM + r) * G::LDS, src + (size_t)(m0 + r) * state->ld + n0,
                  (uint32_t)cols * 4, state->bar);
      }
    }
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    }
    const __nv_bfloat16* As = ring + cs * (kAStage + kBStage);
    const __nv_bfloat16* Bs = As + kAStage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[G::MI][4], bfr[G::NI][2];
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        const int r0 = wm * G::MI * 16 + mi * 16;
        if (kAKM)
          load_a_km(af[mi], As + kk * G::LDA + r0, G::LDA);
        else
          load_a_mk(af[mi], As + r0 * G::LDA + kk, G::LDA);
      }
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const int c0 = wn * G::NI * 8 + ni * 8;
        if (kBNK)
          load_b_nk(bfr[ni], Bs + c0 * G::LDB + kk, G::LDB);
        else
          load_b_kn(bfr[ni], Bs + kk * G::LDB + c0, G::LDB);
      }
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    if (kt == nk - 1) {
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = wm * G::MI * 16 + mi * 16 + g + 8 * h;
            const int lc = wn * G::NI * 8 + ni * 8 + 2 * q;
            if (m0 + lr < M && n0 + lc < N)
              epi(m0 + lr, n0 + lc, lr, lc, acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1],
                  n0 + lc + 1 < N);
          }
      if (state != nullptr) {
        mbar_wait(state->bar, state->phase);  // this tile's state is in
        state->phase ^= 1;
        __syncthreads();  // and so are its products
        flush(m0, n0);
      }
    }
    if (++cs == kStages) cs = 0;
    if (++kt == nk) {
      kt = 0;
      if (++cn == tn) {
        cn = 0;
        ++cm;
      }
    }
  }
  cp_async_wait<0>();
  if (state != nullptr) {  // the bulk stores are complete and ordered before later reads
    bulk_wait();
    fence_proxy_async();
  }
  __syncthreads();
}

// cta_gemm with the narrow tile for outputs of width <= 16.
template <bool kAKM, bool kBNK, class Epi, class Flush>
__device__ __forceinline__ void gemm(const Mat& A, const Mat& B, int M, int N, int K,
                                     __nv_bfloat16* ring, StateSrc* state, float* sstate,
                                     Epi epi, Flush flush) {
  if (N <= kNarrow)
    cta_gemm<kNarrow, kAKM, kBNK>(A, B, M, N, K, ring, state, sstate, epi, flush);
  else
    cta_gemm<kWide, kAKM, kBNK>(A, B, M, N, K, ring, state, sstate, epi, flush);
}

// Two consecutive floats at p (8-byte aligned) when `pair`, else one.
__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *p = a;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair) {
  if (pair)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else
    *p = __float2bfloat16_rn(a);
}

struct NoFlush {
  __device__ void operator()(int, int) const {}
};

// Sum of one value a thread over the CTA; every thread gets the same
// result, summed in the same order.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) s += red[i];
  return s;
}

// The per-step update constants of one lane.
struct Step {
  float lr, bc1, bc2, momentum;
  bool sgd, nesterov;
};

// Adam with f32 moments, or SGD velocity momentum (Nesterov or plain), of
// one parameter p with state s1 (m or velocity) and s2 (v) and gradient g:
// the TPU kernel's update, pallas_mlp.py:188-209.
__device__ __forceinline__ void update(const Step& s, float& p, float& s1, float& s2, float g) {
  if (!s.sgd) {
    const float b1 = 0.9f, b2 = 0.999f;
    const float omb1 = (float)(1.0 - 0.9), omb2 = (float)(1.0 - 0.999);
    const float m = b1 * s1 + omb1 * g;
    const float v = b2 * s2 + omb2 * g * g;
    s1 = m;
    s2 = v;
    p = p - s.lr * (m / s.bc1) / (sqrtf(v / s.bc2) + 1e-8f);
  } else {
    const float vel = s.momentum * s1 - s.lr * g;
    s1 = vel;
    p = s.nesterov ? p + s.momentum * vel - s.lr * g : p + vel;
  }
}

__global__ void __launch_bounds__(kThreads, 1) mlp_epoch_kernel(const EpochArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t state_bar;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sstate = reinterpret_cast<float*>(ring + kStages * (kAStage + kBStage));
  float* red = sstate + kStateFloats + kShadowFloats + kProductFloats;

  const int lane = blockIdx.x;
  const int nl = a.n_layers, bs = a.bs, L = a.L;
  const int d = a.dims[0], c = a.dims[nl];
  const int tid = threadIdx.x;

  // this lane's scratch (Layout); the per-layer pointers sit in shared
  // memory, where a runtime layer index reads them at shared-memory speed
  const Layout lay = scratch_layout(a.dims, nl, bs);
  float* base = a.scratch + (size_t)lane * a.scratch_per_lane;
  __shared__ __nv_bfloat16* wsh[kMaxLayers];
  __shared__ __nv_bfloat16* actb[kMaxLayers];
  __shared__ __nv_bfloat16* dzb[kMaxLayers];
  __shared__ float* actf[kMaxLayers];
  if (tid == 0) {
    for (int l = 0; l < nl; ++l) {
      wsh[l] = reinterpret_cast<__nv_bfloat16*>(base + lay.wsh[l]);
      dzb[l] = reinterpret_cast<__nv_bfloat16*>(base + lay.dzb[l]);
      actf[l] = l + 1 < nl ? base + lay.actf[l] : base + lay.logits;
      actb[l] = l + 1 < nl ? reinterpret_cast<__nv_bfloat16*>(base + lay.actb[l]) : nullptr;
    }
  }
  __syncthreads();

  // prologue: the bf16 shadows of W (padding columns zero), and zeros in
  // the bf16 activation and gradient buffers, whose padding stays zero
  for (int l = 0; l < nl; ++l) {
    const int din = a.dims[l], dout = a.dims[l + 1], ldo = pad8(dout);
    const float* __restrict__ W = a.W[l] + (size_t)lane * din * dout;
    for (int e = tid; e < din * ldo; e += kThreads) {
      const int i = e / ldo, j = e - i * ldo;
      wsh[l][e] = __float2bfloat16_rn(j < dout ? W[(size_t)i * dout + j] : 0.0f);
    }
  }
  for (long long e = lay.bf16_begin + tid; e < lay.total; e += kThreads) base[e] = 0.0f;
  if (tid == 0) {
    mbar_init(&state_bar, 1);
    fence_mbarrier_init();
  }
  fence_proxy_async();  // the shadows' generic writes, before any bulk store
  __syncthreads();
  int state_phase = 0;

  const float lr = a.lr[lane];
  const float alpha = a.alpha[lane];
  const float log_b1 = (float)log(0.9), log_b2 = (float)log(0.999);

  for (int step = 0; step < a.n_batches; ++step) {
    const size_t row0 = (size_t)step * bs;
    const __nv_bfloat16* xb = a.X + row0 * d;
    const float* yb = a.Y + row0 * c;
    const float* wb = a.Wl + row0 * L + lane;  // wb[r * L]
    const Mat Xm = make_mat(xb, d, bs, d);

    float wsum = 0.0f;
    for (int r = tid; r < bs; r += kThreads) wsum += wb[(size_t)r * L];
    const float bw = fmaxf(block_sum(wsum, red), 1e-12f);
    const float t = (float)(a.t0 + step + 1);
    const Step st{lr, 1.0f - expf(t * log_b1), 1.0f - expf(t * log_b2), a.momentum,
                  a.sgd != 0, a.nesterov != 0};

    // ---- forward: z = h W + bf16(b), hidden a = act(z) ----
    for (int l = 0; l < nl; ++l) {
      const int din = a.dims[l], dout = a.dims[l + 1], ldo = pad8(dout);
      const float* __restrict__ b = a.B[l] + (size_t)lane * dout;
      const Mat H = l == 0 ? Xm : make_mat(actb[l - 1], pad8(din), bs, pad8(din));
      const Mat Wm = make_mat(wsh[l], ldo, din, ldo);
      float* __restrict__ of = actf[l];
      __nv_bfloat16* __restrict__ ob = actb[l];
      const int act = a.act;
      const bool hidden = l < nl - 1;
      gemm<false, false>(
          H, Wm, bs, dout, din, ring, nullptr, sstate,
          [&](int m, int n, int, int, float v0, float v1, bool two) {
            const float z0 = v0 + bf16r(b[n]);
            const float z1 = two ? v1 + bf16r(b[n + 1]) : 0.0f;
            const bool pair = two && dout % 2 == 0;
            if (hidden) {
              const float h0 = act_fn(act, z0), h1 = act_fn(act, z1);
              store2(of + (size_t)m * dout + n, h0, h1, pair);
              if (two && !pair) of[(size_t)m * dout + n + 1] = h1;
              store2(ob + (size_t)m * ldo + n, h0, h1, two);
            } else {
              store2(of + (size_t)m * dout + n, z0, z1, pair);
              if (two && !pair) of[(size_t)m * dout + n + 1] = z1;
            }
          },
          NoFlush{});
    }

    // ---- output gradient of the mean weighted loss (bf16), and the data loss ----
    const float* logits = actf[nl - 1];
    {
      __nv_bfloat16* dz = dzb[nl - 1];
      const int ldc = pad8(c);
      float lpart = 0.0f;
      for (int r = tid; r < bs; r += kThreads) {
        const float wr = wb[(size_t)r * L];
        const float scale = wr / bw;
        const float* z = logits + (size_t)r * c;
        const float* y = yb + (size_t)r * c;
        __nv_bfloat16* g = dz + (size_t)r * ldc;
        if (a.classification) {
          float mx = -INFINITY;
          for (int j = 0; j < c; ++j) mx = fmaxf(mx, z[j]);
          float se = 0.0f;
          for (int j = 0; j < c; ++j) se += expf(z[j] - mx);
          for (int j = 0; j < c; ++j) {
            const float p = expf(z[j] - mx) / se;
            g[j] = __float2bfloat16_rn((p - y[j]) * scale);
            if (a.track_loss) lpart += y[j] * logf(fmaxf(p, 1e-12f)) * wr;
          }
        } else {
          for (int j = 0; j < c; ++j) {
            const float e = z[j] - y[j];
            g[j] = __float2bfloat16_rn(e * scale);
            lpart += e * e * wr;
          }
        }
      }
      if (a.track_loss) {
        const float tot = block_sum(lpart, red);
        if (tid == 0) a.loss[lane] += a.classification ? -tot / bw : 0.5f * tot / bw;
      }
    }
    __syncthreads();

    // ---- backward and in-place update, last layer first ----
    const float coef = alpha / bw;
    for (int l = nl - 1; l >= 0; --l) {
      const int din = a.dims[l], dout = a.dims[l + 1], ldo = pad8(dout);
      const size_t wofs = (size_t)lane * din * dout, bofs = (size_t)lane * dout;
      const Mat Gm = make_mat(dzb[l], ldo, bs, ldo);
      const Mat Wm = make_mat(wsh[l], ldo, din, ldo);
      if (l > 0) {
        // dz_prev = (dz W^T) * act'(a_prev), from the step's old weights
        const float* __restrict__ aprev = actf[l - 1];
        __nv_bfloat16* __restrict__ nxt = dzb[l - 1];
        const int ldp = pad8(din);
        const int act = a.act;
        gemm<false, true>(
            Gm, Wm, bs, din, dout, ring, nullptr, sstate,
            [&](int m, int n, int, int, float v0, float v1, bool two) {
              const float* ap = aprev + (size_t)m * din + n;
              const float g0 = v0 * act_grad(act, ap[0]);
              const float g1 = two ? v1 * act_grad(act, ap[1]) : 0.0f;
              store2(nxt + (size_t)m * ldp + n, g0, g1, two);
            },
            NoFlush{});
      }
      // gB = sum over rows of bf16(dz), and the bias update
      {
        float* __restrict__ B = a.B[l] + bofs;
        float* __restrict__ s1B = a.s1B[l] + bofs;
        float* __restrict__ s2B = a.sgd ? nullptr : a.s2B[l] + bofs;
        const __nv_bfloat16* __restrict__ g = dzb[l];
        for (int n = tid; n < dout; n += kThreads) {
          float s = 0.0f;
#pragma unroll 8
          for (int m = 0; m < bs; ++m) s += __bfloat162float(g[(size_t)m * ldo + n]);
          float p = B[n], m1 = s1B[n], v2 = s2B ? s2B[n] : 0.0f;
          update(st, p, m1, v2, s);
          B[n] = p;
          s1B[n] = m1;
          if (s2B) s2B[n] = v2;
        }
      }
      // gW = a_prev^T dz + (alpha / bw) W, the weight update and its shadow
      {
        const Mat Ht = l == 0 ? Xm : make_mat(actb[l - 1], pad8(din), bs, pad8(din));
        float* __restrict__ W = a.W[l] + wofs;
        float* __restrict__ s1W = a.s1W[l] + wofs;
        float* __restrict__ s2W = a.sgd ? nullptr : a.s2W[l] + wofs;
        __nv_bfloat16* __restrict__ sh = wsh[l];
        StateSrc src{{W, s1W, s2W}, a.sgd ? 2 : 3, dout, din, &state_bar, state_phase};
        // bulk copies where every state and shadow row is a 16-byte multiple
        const bool pre = dout % 8 == 0 && (reinterpret_cast<uintptr_t>(W) % 16) == 0 &&
                         (reinterpret_cast<uintptr_t>(s1W) % 16) == 0 &&
                         (s2W == nullptr || (reinterpret_cast<uintptr_t>(s2W) % 16) == 0);
        const int lds = dout <= kNarrow ? kNarrow + 8 : kWide + 8;
        float* sW = sstate;
        float* s1s = sstate + BM * lds;
        float* s2s = sstate + 2 * BM * lds;
        __nv_bfloat16* shs = reinterpret_cast<__nv_bfloat16*>(sstate + kStateFloats);
        float* pt = sstate + kStateFloats + kShadowFloats;  // the tile's products
        gemm<true, false>(
            Ht, Gm, din, dout, bs, ring, pre ? &src : nullptr, sstate,
            [&](int m, int n, int tm, int tn, float v0, float v1, bool two) {
              if (pre) {  // the products wait in shared memory for the state
                store2(pt + tm * lds + tn, v0, v1, two);
                return;
              }
              for (int e = 0; e < (two ? 2 : 1); ++e) {
                const size_t i = (size_t)m * dout + n + e;
                float p = W[i], m1 = s1W[i], v2 = s2W ? s2W[i] : 0.0f;
                update(st, p, m1, v2, (e ? v1 : v0) + coef * p);
                W[i] = p;
                s1W[i] = m1;
                if (s2W) s2W[i] = v2;
                sh[(size_t)m * ldo + n + e] = __float2bfloat16_rn(p);
              }
            },
            [&](int m0, int n0) {
              const int rows = min(BM, din - m0), cols = min(lds - 8, dout - n0);
              // the update, 4 parameters a thread at a time, in shared memory
              const int per = cols / 4;
              for (int idx = threadIdx.x; idx < rows * per; idx += kThreads) {
                const int si = (idx / per) * lds + (idx % per) * 4;
                float4 w = *reinterpret_cast<const float4*>(sW + si);
                float4 m1 = *reinterpret_cast<const float4*>(s1s + si);
                float4 v2 = s2W ? *reinterpret_cast<const float4*>(s2s + si) : make_float4(0, 0, 0, 0);
                const float4 g = *reinterpret_cast<const float4*>(pt + si);
                update(st, w.x, m1.x, v2.x, g.x + coef * w.x);
                update(st, w.y, m1.y, v2.y, g.y + coef * w.y);
                update(st, w.z, m1.z, v2.z, g.z + coef * w.z);
                update(st, w.w, m1.w, v2.w, g.w + coef * w.w);
                *reinterpret_cast<float4*>(sW + si) = w;
                *reinterpret_cast<float4*>(s1s + si) = m1;
                if (s2W) *reinterpret_cast<float4*>(s2s + si) = v2;
                const __nv_bfloat162 lo = __floats2bfloat162_rn(w.x, w.y);
                const __nv_bfloat162 hi = __floats2bfloat162_rn(w.z, w.w);
                uint2 packed;
                packed.x = *reinterpret_cast<const uint32_t*>(&lo);
                packed.y = *reinterpret_cast<const uint32_t*>(&hi);
                *reinterpret_cast<uint2*>(shs + si) = packed;
              }
              fence_proxy_async();  // the updated tile, before the bulk copies read it
              __syncthreads();
              // the tile back, a bulk copy a row
              for (int idx = threadIdx.x; idx < rows * (src.n + 1); idx += kThreads) {
                const int k = idx / rows, r = idx - k * rows;
                if (k < src.n)
                  bulk_store((k == 0 ? W : k == 1 ? s1W : s2W) + (size_t)(m0 + r) * dout + n0,
                             sstate + (k * BM + r) * lds, (uint32_t)cols * 4);
                else
                  bulk_store(sh + (size_t)(m0 + r) * ldo + n0, shs + r * lds, (uint32_t)cols * 2);
              }
              bulk_commit();
              bulk_wait_read();  // the tile's shared memory is free again
            });
        state_phase = src.phase;  // the barrier's phase after this product's tiles
      }
    }
  }
}

}  // namespace

extern "C" {

// f32 scratch floats one lane needs; the Python wrapper mirrors it.
long long mlp_scratch_floats(const int* dims, int n_layers, int bs) {
  return scratch_layout(dims, n_layers, bs).total;
}

int mlp_epoch(const void* X, const void* Y, const void* Wl, const void* lr,
              const void* alpha, int t0, void* const* state, void* loss,
              void* scratch, const int* dims, int n_layers, int bs,
              int n_batches, int L, int act, int classification, int sgd,
              float momentum, int nesterov, int track_loss, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || bs < 1 || n_batches < 1 || L < 1 ||
      act < 0 || act > kIdentity || (track_loss && loss == nullptr) || !X || !Y || !Wl ||
      !lr || !alpha || !scratch)
    return (int)cudaErrorInvalidValue;
  EpochArgs a{};
  a.X = static_cast<const __nv_bfloat16*>(X);
  a.Y = static_cast<const float*>(Y);
  a.Wl = static_cast<const float*>(Wl);
  a.lr = static_cast<const float*>(lr);
  a.alpha = static_cast<const float*>(alpha);
  for (int l = 0; l < n_layers; ++l) {
    void* const* s = state + 6 * l;
    a.W[l] = static_cast<float*>(s[0]);
    a.B[l] = static_cast<float*>(s[1]);
    a.s1W[l] = static_cast<float*>(s[2]);
    a.s1B[l] = static_cast<float*>(s[3]);
    a.s2W[l] = sgd ? nullptr : static_cast<float*>(s[4]);
    a.s2B[l] = sgd ? nullptr : static_cast<float*>(s[5]);
    if (!a.W[l] || !a.B[l] || !a.s1W[l] || !a.s1B[l] || (!sgd && (!a.s2W[l] || !a.s2B[l])))
      return (int)cudaErrorInvalidValue;
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return (int)cudaErrorInvalidValue;
    a.dims[l] = dims[l];
  }
  a.loss = static_cast<float*>(loss);
  a.scratch = static_cast<float*>(scratch);
  a.scratch_per_lane = scratch_layout(dims, n_layers, bs).total;
  a.n_layers = n_layers;
  a.bs = bs;
  a.n_batches = n_batches;
  a.L = L;
  a.t0 = t0;
  a.act = act;
  a.classification = classification;
  a.sgd = sgd;
  a.nesterov = nesterov;
  a.track_loss = track_loss;
  a.momentum = momentum;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  mlp_epoch_kernel<<<L, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
