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
// per-lane f32 scratch (1.6 MB at that shape), which stays in L2.
//
// Design. One CTA per lane walks the epoch's steps in order, as the TPU
// grid's step-minor axis does; nothing is shared between CTAs, so there
// are no atomics and every sum has a fixed order. Each layer's product is
// a CTA-wide tiled GEMM: 128 x 64 output tiles, 32-deep K slabs staged in
// shared memory as bf16 (rounded from f32 on the way in, with 16-byte
// loads along the operand's contiguous dimension where its shape and
// alignment allow), 8 warps of 32 x 32 warp tiles. The epilogues are fused: bias and activation into
// the forward product, act' into the activation-gradient product, and the
// L2 term plus the Adam/SGD update into the weight-gradient product. The
// activation gradient is computed before the weight update, so both read
// the step's old weights, as the TPU kernel does.
//
// Bound at the config-5 shape (784-512-10, bs 256, 234 steps, 75 lanes):
// the products are 7.35 TFLOP an epoch, 7.4 ms at 989 TFLOP/s bf16; the
// state read and written once plus the batch rows read once are ~0.8 GB,
// 0.25 ms at 3.35 TB/s. This design moves the state at every step (171 GB
// an epoch, 51 ms), so its own floor is the state traffic; the staging
// here is synchronous, so its products run well below the tensor cores'
// rate.
//
// mlp_epoch returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 4;
// CTA output tile and K slab; leading dimensions of the shared tiles are
// padded so that ldmatrix's 8 row addresses fall in distinct banks
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr size_t kSmemBytes =
    (size_t)(BM * LDA + BK * LDB) * sizeof(__nv_bfloat16) + kWarps * sizeof(float);

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

__host__ __device__ inline long long scratch_floats(const int* dims, int n_layers, int bs) {
  long long widths = 0, widest = 0;
  for (int l = 1; l <= n_layers; ++l) {
    widths += dims[l];
    if (dims[l] > widest) widest = dims[l];
  }
  return (long long)bs * (widths + 2 * widest);
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

// One GEMM operand, element (i, j) at p[i * s0 + j * s1], zero outside
// [0, n0) x [0, n1); bf16 or f32 in memory. `vec` says whether 16-byte
// loads may take it (vec_width consecutive elements along its contiguous
// dimension: 8 bf16 or 4 f32), set by `make_operand`.
struct Operand {
  const void* p;
  int s0, s1, n0, n1;
  bool is_bf16;
  bool vec;
  __device__ __forceinline__ __nv_bfloat16 load(int i, int j) const {
    if (i >= n0 || j >= n1) return __float2bfloat16_rn(0.0f);
    const size_t off = (size_t)i * s0 + (size_t)j * s1;
    if (is_bf16) return static_cast<const __nv_bfloat16*>(p)[off];
    return __float2bfloat16_rn(static_cast<const float*>(p)[off]);
  }
  __device__ __forceinline__ int vec_width() const { return is_bf16 ? 8 : 4; }
  // vec_width() elements from (i, j) along the contiguous dimension, as
  // bf16 (zero past the edge: the extents are multiples of the width)
  __device__ __forceinline__ void load_vec(int i, int j, __nv_bfloat16* out) const {
    if (i >= n0 || j >= n1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) out[e] = __float2bfloat16_rn(0.0f);
      return;
    }
    const size_t off = (size_t)i * s0 + (size_t)j * s1;
    if (is_bf16) {
      const uint4 v = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + off);
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[2 * e] = b[e].x;
        out[2 * e + 1] = b[e].y;
      }
    } else {
      const float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + off);
      out[0] = __float2bfloat16_rn(v.x);
      out[1] = __float2bfloat16_rn(v.y);
      out[2] = __float2bfloat16_rn(v.z);
      out[3] = __float2bfloat16_rn(v.w);
    }
  }
};

__device__ __forceinline__ Operand make_operand(const void* p, int s0, int s1, int n0, int n1,
                                                bool is_bf16) {
  Operand o{p, s0, s1, n0, n1, is_bf16, false};
  const int w = is_bf16 ? 8 : 4;
  const bool aligned = (reinterpret_cast<uintptr_t>(p) % 16) == 0;
  if (aligned && s1 == 1) o.vec = s0 % w == 0 && n1 % w == 0;
  if (aligned && s0 == 1) o.vec = s1 % w == 0 && n0 % w == 0;
  return o;
}

// Stage the R x C block at (r0, c0) of `o` into dst[r][c] (leading
// dimension ld), rounded to bf16. Consecutive threads take consecutive
// elements (or 16-byte vectors) along the operand's contiguous dimension.
template <int R, int C>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld, const Operand& o,
                                      int r0, int c0) {
  __nv_bfloat16 v[8];
  if (o.vec && o.s1 == 1) {
    const int w = o.vec_width(), per_row = C / w;
    for (int idx = threadIdx.x; idx < R * per_row; idx += kThreads) {
      const int r = idx / per_row, c = (idx % per_row) * w;
      o.load_vec(r0 + r, c0 + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < w) dst[r * ld + c + e] = v[e];
    }
  } else if (o.vec) {
    const int w = o.vec_width(), per_col = R / w;
    for (int idx = threadIdx.x; idx < C * per_col; idx += kThreads) {
      const int c = idx / per_col, r = (idx % per_col) * w;
      o.load_vec(r0 + r, c0 + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < w) dst[(r + e) * ld + c] = v[e];
    }
  } else if (o.s1 == 1) {
    for (int idx = threadIdx.x; idx < R * C; idx += kThreads) {
      const int r = idx / C, c = idx % C;
      dst[r * ld + c] = o.load(r0 + r, c0 + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * C; idx += kThreads) {
      const int c = idx / R, r = idx % R;
      dst[r * ld + c] = o.load(r0 + r, c0 + c);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mma.sync m16n8k16 fragments (PTX ISA), g = lane / 4, q = lane % 4:
//   A 16 x 16 row-major: a0 (g, 2q..2q+1)  a1 (g+8, 2q..)  a2 (g, 8+2q..)  a3 (g+8, 8+2q..)
//   B 16 x 8 (k x n):    b0 (k 2q..2q+1, n g)  b1 (k 8+2q.., n g)
//   C 16 x 8 f32:        c0 c1 (g, 2q..2q+1)  c2 c3 (g+8, 2q..2q+1)
// A fragment of the 16 x 16 block at p (row-major, leading dimension ld).
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x % 32;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p + (lane % 16) * ld + 8 * (lane / 16)))
               : "memory");
}

// B fragment of the 16 (k) x 8 (n) block stored k-major at p ([k][n]).
__device__ __forceinline__ void load_b_kn(uint32_t (&r)[2], const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x % 32;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p + (lane % 16) * ld))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C[M][N] = A[M][K] B[K][N] over the whole CTA, bf16 operands and f32
// sums; epi(m, n, value) takes every output element once. The warps tile
// each 128 x 64 output block 4 (m) x 2 (n). Starts and ends with a
// barrier, so the caller's writes before it and the epilogue's writes are
// visible to the whole CTA.
template <class Epi>
__device__ void cta_gemm(const Operand& A, const Operand& Bop, int M, int N, int K,
                         __nv_bfloat16* As, __nv_bfloat16* Bs, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane / 4, q = lane % 4;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += BK) {
        __syncthreads();  // every warp is done with the previous slab
        stage<BM, BK>(As, LDA, A, m0, k0);
        stage<BK, BN>(Bs, LDB, Bop, k0, n0);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          uint32_t af[2][4], bfr[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) load_a(af[mi], As + (wm * 32 + mi * 16) * LDA + kk, LDA);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) load_b_kn(bfr[ni], Bs + kk * LDB + wn * 32 + ni * 8, LDB);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + wm * 32 + mi * 16 + g + 8 * h;
            const int n = n0 + wn * 32 + ni * 8 + 2 * q;
            if (m < M) {
              if (n < N) epi(m, n, acc[mi][ni][2 * h]);
              if (n + 1 < N) epi(m, n + 1, acc[mi][ni][2 * h + 1]);
            }
          }
    }
  }
  __syncthreads();
}

// Sum of one value a thread over the CTA; every thread gets the same
// result, summed in the same order.
__device__ float block_sum(float v, float* red) {
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
// one parameter at index i: the TPU kernel's update, pallas_mlp.py:188-209.
__device__ __forceinline__ void update(const Step& s, float* p, float* s1, float* s2,
                                       size_t i, float g) {
  if (!s.sgd) {
    const float b1 = 0.9f, b2 = 0.999f;
    const float omb1 = (float)(1.0 - 0.9), omb2 = (float)(1.0 - 0.999);
    const float m = b1 * s1[i] + omb1 * g;
    const float v = b2 * s2[i] + omb2 * g * g;
    s1[i] = m;
    s2[i] = v;
    p[i] = p[i] - s.lr * (m / s.bc1) / (sqrtf(v / s.bc2) + 1e-8f);
  } else {
    const float vel = s.momentum * s1[i] - s.lr * g;
    s1[i] = vel;
    p[i] = s.nesterov ? p[i] + s.momentum * vel - s.lr * g : p[i] + vel;
  }
}

__global__ void __launch_bounds__(kThreads) mlp_epoch_kernel(const EpochArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* red = reinterpret_cast<float*>(Bs + BK * LDB);

  const int lane = blockIdx.x;
  const int nl = a.n_layers, bs = a.bs, L = a.L;
  const int d = a.dims[0], c = a.dims[nl];
  const int tid = threadIdx.x;

  // this lane's scratch: hidden activations, logits, two output gradients
  float* base = a.scratch + (size_t)lane * a.scratch_per_lane;
  float* acts[kMaxLayers];
  float* off = base;
  int widest = 0;
  for (int l = 0; l < nl; ++l) {
    acts[l] = off;  // acts[nl - 1] holds the logits
    off += (size_t)bs * a.dims[l + 1];
    if (a.dims[l + 1] > widest) widest = a.dims[l + 1];
  }
  float* dzbuf[2] = {off, off + (size_t)bs * widest};

  const float lr = a.lr[lane];
  const float alpha = a.alpha[lane];
  const float log_b1 = (float)log(0.9), log_b2 = (float)log(0.999);

  for (int step = 0; step < a.n_batches; ++step) {
    const size_t row0 = (size_t)step * bs;
    const __nv_bfloat16* xb = a.X + row0 * d;
    const float* yb = a.Y + row0 * c;
    const float* wb = a.Wl + row0 * L + lane;  // wb[r * L]

    float wsum = 0.0f;
    for (int r = tid; r < bs; r += kThreads) wsum += wb[(size_t)r * L];
    const float bw = fmaxf(block_sum(wsum, red), 1e-12f);
    const float t = (float)(a.t0 + step + 1);
    const Step st{lr, 1.0f - expf(t * log_b1), 1.0f - expf(t * log_b2), a.momentum,
                  a.sgd != 0, a.nesterov != 0};

    // ---- forward: z = h W + bf16(b), hidden a = act(z) ----
    for (int l = 0; l < nl; ++l) {
      const int din = a.dims[l], dout = a.dims[l + 1];
      const float* W = a.W[l] + (size_t)lane * din * dout;
      const float* b = a.B[l] + (size_t)lane * dout;
      float* out = acts[l];
      const bool hidden = l < nl - 1;
      const Operand H = l == 0 ? make_operand(xb, din, 1, bs, din, true)
                               : make_operand(acts[l - 1], din, 1, bs, din, false);
      const Operand Wop = make_operand(W, dout, 1, din, dout, false);
      const int act = a.act;
      cta_gemm(H, Wop, bs, dout, din, As, Bs, [&](int m, int n, float v) {
        const float z = v + bf16r(b[n]);
        out[(size_t)m * dout + n] = hidden ? act_fn(act, z) : z;
      });
    }

    // ---- output gradient of the mean weighted loss, and the data loss ----
    const float* logits = acts[nl - 1];
    float* dz = dzbuf[0];
    float lpart = 0.0f;
    for (int r = tid; r < bs; r += kThreads) {
      const float wr = wb[(size_t)r * L];
      const float scale = wr / bw;
      const float* z = logits + (size_t)r * c;
      const float* y = yb + (size_t)r * c;
      float* g = dz + (size_t)r * c;
      if (a.classification) {
        float mx = -INFINITY;
        for (int j = 0; j < c; ++j) mx = fmaxf(mx, z[j]);
        float se = 0.0f;
        for (int j = 0; j < c; ++j) se += expf(z[j] - mx);
        for (int j = 0; j < c; ++j) {
          const float p = expf(z[j] - mx) / se;
          g[j] = (p - y[j]) * scale;
          if (a.track_loss) lpart += y[j] * logf(fmaxf(p, 1e-12f)) * wr;
        }
      } else {
        for (int j = 0; j < c; ++j) {
          const float e = z[j] - y[j];
          g[j] = e * scale;
          lpart += e * e * wr;
        }
      }
    }
    if (a.track_loss) {
      const float tot = block_sum(lpart, red);
      if (tid == 0) a.loss[lane] += a.classification ? -tot / bw : 0.5f * tot / bw;
    }
    __syncthreads();

    // ---- backward and in-place update, last layer first ----
    const float coef = alpha / bw;
    int cur = 0;
    for (int l = nl - 1; l >= 0; --l) {
      const int din = a.dims[l], dout = a.dims[l + 1];
      const size_t wofs = (size_t)lane * din * dout, bofs = (size_t)lane * dout;
      float* W = a.W[l] + wofs;
      const float* g = dzbuf[cur];
      if (l > 0) {
        // dz_prev = (dz W^T) * act'(a_prev), from the step's old weights
        const float* aprev = acts[l - 1];
        float* nxt = dzbuf[cur ^ 1];
        const Operand G = make_operand(g, dout, 1, bs, dout, false);
        const Operand Wt = make_operand(W, 1, dout, dout, din, false);
        const int act = a.act;
        cta_gemm(G, Wt, bs, din, dout, As, Bs, [&](int m, int n, float v) {
          const size_t i = (size_t)m * din + n;
          nxt[i] = v * act_grad(act, aprev[i]);
        });
      }
      // gB = sum over rows of bf16(dz), and the bias update
      float* B = a.B[l] + bofs;
      float* s1B = a.s1B[l] + bofs;
      float* s2B = a.sgd ? nullptr : a.s2B[l] + bofs;
      for (int n = tid; n < dout; n += kThreads) {
        float s = 0.0f;
        for (int m = 0; m < bs; ++m) s += bf16r(g[(size_t)m * dout + n]);
        update(st, B, s1B, s2B, n, s);
      }
      // gW = a_prev^T dz + (alpha / bw) W, and the weight update
      const Operand Ht = l == 0 ? make_operand(xb, 1, din, din, bs, true)
                                : make_operand(acts[l - 1], 1, din, din, bs, false);
      const Operand G = make_operand(g, dout, 1, bs, dout, false);
      float* s1W = a.s1W[l] + wofs;
      float* s2W = a.sgd ? nullptr : a.s2W[l] + wofs;
      cta_gemm(Ht, G, din, dout, bs, As, Bs, [&](int m, int n, float v) {
        const size_t i = (size_t)m * dout + n;
        update(st, W, s1W, s2W, i, v + coef * W[i]);
      });
      cur ^= 1;
    }
  }
}

}  // namespace

extern "C" {

// f32 scratch floats one lane needs; the Python wrapper mirrors it.
long long mlp_scratch_floats(const int* dims, int n_layers, int bs) {
  return scratch_floats(dims, n_layers, bs);
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
  a.scratch_per_lane = scratch_floats(dims, n_layers, bs);
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
  mlp_epoch_kernel<<<L, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
