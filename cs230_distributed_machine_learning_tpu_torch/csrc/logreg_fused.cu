// B1's wide form, fused: a hand-written Hopper (sm_90a) kernel for the
// LogisticRegression search path, past the register-resident geometries of
// B1 and B2 (csrc/logreg.cu). It replaces the JAX package's Pallas kernel
// packed_softmax_grad (ops/pallas_logreg.py:109) there:
//
//   logreg_fused_softmax_grad    <- packed_softmax_grad   (pallas_logreg.py:109)
//
// G3[wb] = A^T (w * (softmax_c(A W3[wb]) - Y)) for every packed column,
// computed as the TPU kernel computes it (_tile_softmax_gram,
// pallas_logreg.py:41): a row tile's logits, the softmax's residual kept on
// chip, A_tile^T R added into the gradient held on chip. bf16 operands, f32
// accumulation, the weights and the residual rounded to bf16 at the
// reference's points.
//
// Bound: the two products over the real classes, 4 n_pad dpp (lanes c)
// operations. At 256 trials of a 384-feature, 10-class table (n_pad 20,480,
// dpp 448, S 6, 1,536 lanes) 0.564 TFLOP, 0.57 ms at 989 TFLOP/s bf16; at
// 128 trials of a 256-feature, 100-class table (dpp 320, 768 lanes) 2.01
// TFLOP, 2.04 ms. Its bytes (A, W3 and G3 once) take under 0.05 ms at
// 3.35 TB/s: the products bound it.
//
// Design: a CTA owns L lanes with all their classes (class-major columns
// at a pitch of 2 NC / L classes a lane, padding at -inf), its two
// warpgroups half the classes each, and walks 64-row tiles of A that TMA
// loads into a ring (no producer warp: 256 threads may hold 255 registers,
// where 288 get 168). Each tile: the logits by wgmma over every feature
// atom (V^T resident in shared memory), the softmax in registers with the
// halves' max and sum swapped through shared memory, the residual rounded
// to bf16 into shared memory, and A_tile^T R added into the warpgroup's f32
// share of G, held in registers over the whole range of rows. No residual
// goes to device memory, each A tile leaves L2 once for all of a CTA's
// classes, and rows split into at most 4 ranges (summed in order, no
// atomics: two launches equal to the bit) only where the CTAs alone leave
// the card's waves well short. A first small kernel writes W3 transposed,
// each lane's classes in rows of 64 features, so that every CTA reads its
// V^T in whole 128-byte lines. fused_plan (mirrored by ops/cuda_logreg.py)
// picks the geometry by shape. A CTA's registers and shared memory hold a
// lane's classes to 64 at dpp 512, 80 at 448, 112 at 320 and 128 at 256;
// past that a cluster of 2 or 4 CTAs shares the lanes' classes, a quarter
// a warpgroup, the softmax's pairs read from every CTA's shared memory
// across the cluster (a barrier of the cluster a tile): to 256 classes at
// every dpp. Past 256 classes csrc/logreg.cu's two passes run, their pass
// (a) in clusters of CTAs that together hold a lane's class row (to 2,048
// classes at every dpp; two sweeps of 256-class tiles past that). What the design had to
// get right, each seen on the H100 (PERF.md's findings):
// - ptxas serializes the wgmma chain when an instruction other than wgmma
//   defines an accumulator inside it: zeroing z before a chain of run-time
//   length did (C7515); WgmmaAcc's first product writes z instead.
// - A wait on an mbarrier inside phase 2's chain serialized it too; the
//   ring's set is reloaded at the next tile's exchange barrier, outside
//   any chain, where both warpgroups are past its products.
// - A producer warp caps the registers at 168 (setmaxnreg did not lift it):
//   100 classes spilled and serialized.
// - Where one CTA holds a lane's classes, clusters of two CTAs (feature
//   halves with the partial logits, or class halves with the max and sum,
//   over distributed shared memory) and TMA multicast of A across them were
//   slower: the CTAs waited on each other every tile, and each CTA still
//   read all of A. The class quarters' cluster runs only where one CTA
//   cannot hold the classes.
//
// Every entry point returns the first launch error (cudaGetLastError()
// after each launch).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"
#include "logreg_common.cuh"

namespace {

// The ring's most row-tile sets, a tile's most feature atoms (dpp 512), a
// fused CTA's threads (two warpgroups, no producer warp: 256 threads may
// hold 255 registers each, where 288 get 168), its row tile, and its most
// row ranges
constexpr int kFusedMaxSets = 4;
constexpr int kFusedMaxAtoms = kWideMaxDpp / kAtom;
constexpr int kFusedThreads = 256;
constexpr int kFusedRows = 64;
constexpr int kFusedBox = kFusedRows * 128;  // one TMA box: 64 rows x 64 features
constexpr int kFusedMaxRanges = 4;
static_assert(kFusedMaxSets * kFusedMaxAtoms * 8 <= 1024, "the full mbarriers fit their 1 KB");

// Shared memory of a fused CTA at NC columns a warpgroup and mt feature
// atoms (byte offsets from a 1024-aligned base; 1 KB more aligns the base):
//   bars  full [kFusedMaxSets][kFusedMaxAtoms]
//   vt    bf16 V^T [2][mt][NC][64]    each warpgroup's classes of the weights
//   r     bf16 R^T [2][NC][64]        each warpgroup's residual of a tile, K-major
//   xch   f32 [2][256][8]             the softmax partials, two tiles' buffers
//   ring  [stages][mt] TMA boxes of 64 rows x 64 features (a row tile a set,
//         each atom on its own full mbarrier)
struct FusedLayout {
  size_t vt, r, xch, ring, total;
  int stages;
};

__host__ __device__ inline FusedLayout fused_layout(int nc, int mt, int stages) {
  FusedLayout s;
  size_t off = 1024;
  s.vt = off;    off += (size_t)2 * mt * nc * 128;
  s.r = off;     off += (size_t)nc * 256;
  s.xch = off;   off += (size_t)2 * kFusedThreads * 32;
  s.ring = off;  off += (size_t)stages * mt * kFusedBox;
  s.stages = stages;
  s.total = off + 1024;
  return s;
}

// The ring's row-tile sets: as many as fit beside the rest, up to four (the
// plan takes two at least).
inline int fused_stages(int nc, int mt) {
  const size_t base = fused_layout(nc, mt, 0).total;
  const size_t set = (size_t)mt * kFusedBox;
  const size_t fit = base < (size_t)232448 ? ((size_t)232448 - base) / set : 0;
  return (int)(fit < (size_t)kFusedMaxSets ? fit : (size_t)kFusedMaxSets);
}

// The lane and the warpgroup-local class of accumulator column 8 j + 2 q + e
// of a warpgroup's NC columns (class-major: column a L + l). At 8 lanes a thread
// holds every class of its two lanes; at 4, 2 and 1 a lane's classes
// spread over 2, 4 and 4 threads of a quad.
template <int L>
__device__ __forceinline__ int fused_class(int j, int q, int e) {
  if constexpr (L == 8) return j;
  if constexpr (L == 4) return 2 * j + (q >> 1);
  if constexpr (L == 2) return 4 * j + q;
  return 8 * j + 2 * q + e;
}
template <int L>
__device__ __forceinline__ int fused_lane(int q, int e) {
  if constexpr (L == 8) return 2 * q + e;
  if constexpr (L == 4) return 2 * (q & 1) + e;
  if constexpr (L == 2) return e;
  return 0;
}
// Max and sum over the threads of the quad that share a lane, in the same
// order on each (so they all hold the same bits).
template <int L>
__device__ __forceinline__ float quad_max(float v) {
  if constexpr (L <= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  if constexpr (L <= 4) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}
template <int L>
__device__ __forceinline__ float quad_sum(float v) {
  if constexpr (L <= 2) v += __shfl_xor_sync(0xffffffffu, v, 1);
  if constexpr (L <= 4) v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// B1's wide form, fused. grid (blocks, P), clusters of CL CTAs along x:
// cluster x / CL owns lanes (x / CL) L .. (x / CL) L + L - 1 (L trials of
// one split of one weight block) at a pitch of 2 NC CL / L classes
// (classes past c are -inf); its CTA of rank r, warpgroup w, owns class
// quarter k = 2 r + w, the classes k NC / L .. (k + 1) NC / L - 1, NC columns
// (class a, lane l at a L + l): its part of V^T, of the logits, of R and of
// G. blockIdx.y is the row
// range p: 64-row tiles p T / P .. (p + 1) T / P - 1, whose mt feature
// atoms arrive by TMA in a ring of `stages` sets, one full mbarrier an
// atom; no producer warp. Per tile, warpgroup w:
//   phase 1  Z [64 rows x NC] = A_tile V over every atom (K-major, V^T
//            resident; the first product writes z, so no instruction zeroes
//            an accumulator);
//   softmax  in registers: over its classes of each (row, lane) the max m_w
//            and the sum s_w of exp(z - m_w); the pairs go through shared
//            memory (at CL > 1 read across the cluster) to the other
//            quarters, whose same thread holds the same (row, lane) at the
//            other classes; each takes M = max_k m_k, S = sum_k s_k e^(m_k -
//            M) in quarter order, and the residual is (e^(z - m_w) e^(m_w -
//            M) / S - y) w, rounded to bf16 into its R^T;
//   phase 2  G_w [64 features x NC] += A_tile^T R for each atom, 16 rows at
//            a time in order.
// At the next tile's exchange (a barrier of the CTA, or of the cluster,
// which also keeps a pairs buffer until every CTA has read it) both
// warpgroups are past this tile's products, and its set is reloaded from
// the tile `stages` after it.
// G stays in registers over every row tile of the range: the residual never
// leaves the SM, and each element of G is one chain over the range's rows.
// The tile is read once from L2 for all the lanes' classes. At P = 1 the
// epilogue writes G3 itself; at P > 1 the range's partial (out + p x the
// size of G3, G3's layout), which fused_sum_kernel adds in range order.
template <int NC, int L, int KU, int CL>
__global__ void __launch_bounds__(kFusedThreads, 1) fused_wide_kernel(
    const __grid_constant__ CUtensorMap tmA, const __nv_bfloat16* __restrict__ VT,
    const int* __restrict__ y, const float* __restrict__ WSP, float* __restrict__ out,
    int n_pad, int dpp, int c, int S, int n_wb, int Tw, int mt, int row_tiles, int ranges,
    int stages) {
  constexpr int kZ = NC / 2;  // accumulator floats a thread holds a product
  constexpr int kTL = L == 1 ? 1 : 2;  // lanes a thread holds
  static_assert(NC % 8 == 0 && NC <= 256, "a wgmma N");
  static_assert(L == 1 || L == 2 || L == 4 || L == 8, "lanes a block");
  static_assert(CL == 1 || (L == 1 && (CL == 2 || CL == 4)), "a cluster shares one lane");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const FusedLayout lay = fused_layout(NC, mt, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + lay.ring;
  const int rank = CL > 1 ? cluster_ctarank() : 0;  // the CTA's quarters of the classes
  const int j0 = blockIdx.x / CL * L;  // the block's first lane
  const int lb = j0 / Tw, t0 = j0 % Tw, wb = lb / S, s = lb % S;
  const int NB = c * S * Tw;
  const int p = blockIdx.y;
  const int tb = p * row_tiles / ranges, te = (p + 1) * row_tiles / ranges;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform, as ptxas can see
  const int wl = tid % 128;
  const int cls0 = (2 * rank + wg) * (NC / L);  // the warpgroup's first class

  if (tid == 0) {
    for (int i = 0; i < stages * mt; ++i) mbar_init(&full[i], 1);
    fence_mbarrier_init();
    for (int st = 0; st < stages && tb + st < te; ++st)  // the first `stages` row tiles
      for (int m = 0; m < mt; ++m) {
        const int b = st * mt + m;
        mbar_expect_tx(&full[b], kFusedBox);
        tma_load_2d(ring + (size_t)b * kFusedBox, &tmA, m * kAtom, (tb + st) * kFusedRows,
                    &full[b]);
      }
  }

  // V^T of the lanes' classes, warpgroup w's part at vt + w mt NC 128, from
  // fused_vt_kernel's VT [lane][pitch][mt 64] (zero past c and dpp) in
  // 16-byte chunks, eight to an atom's row of 64 features
  constexpr int kPitch = 2 * NC * CL / L;
  for (int i = tid; i < 2 * NC * mt * 8; i += kFusedThreads) {
    const int ch = i % 8, n = i / 8 % (2 * NC), m = i / 8 / (2 * NC);
    const int half = n / NC, nh = n % NC;
    const int a = (2 * rank + half) * (NC / L) + nh / L, l = nh % L;
    const uint4 v = *reinterpret_cast<const uint4*>(
        VT + ((size_t)(j0 + l) * kPitch + a) * (mt * kAtom) + m * kAtom + ch * 8);
    *reinterpret_cast<uint4*>(smem + lay.vt + (size_t)half * mt * NC * 128 + m * NC * 128 +
                              sw128_off(nh, ch * 8)) = v;
  }
  fence_proxy_async_shared();
  __syncthreads();

  const int warp = wl / 32, g = (wl % 32) / 4, q = wl % 4;
  const int row0 = 16 * warp + g;  // this thread's rows of a tile: row0, row0 + 8
  float4* xch = reinterpret_cast<float4*>(smem + lay.xch);
  unsigned char* Rw = smem + lay.r + wg * NC * 128;  // this warpgroup's R^T
  const uint64_t vt_desc = sw128_desc(smem + lay.vt + (size_t)wg * mt * NC * 128, 16, 1024);
  const uint64_t r_desc = sw128_desc(Rw, 16, 1024);
  float gacc[KU][kZ];
#pragma unroll
  for (int u = 0; u < KU; ++u)
#pragma unroll
    for (int i = 0; i < kZ; ++i) gacc[u][i] = 0.0f;
  float z[kZ];
  int set = 0, round = 0;  // the tile's ring set and its round's parity
  for (int tt = tb; tt < te; ++tt) {
    const int it = tt - tb;
    const int r_lo = tt * kFusedRows + row0;
    const int y_lo = r_lo < n_pad ? y[r_lo] : -1;
    const int y_hi = r_lo + 8 < n_pad ? y[r_lo + 8] : -1;
    const float w_lo = r_lo < n_pad ? WSP[(size_t)r_lo * S + s] : 0.0f;
    const float w_hi = r_lo + 8 < n_pad ? WSP[(size_t)(r_lo + 8) * S + s] : 0.0f;
    unsigned char* slots = ring + (size_t)set * mt * kFusedBox;
    const uint64_t a_desc = sw128_desc(slots, 16, 1024);           // K-major (phase 1)
    const uint64_t at_desc = sw128_desc(slots, kFusedBox, 1024);   // MN-major (phase 2)

    // phase 1: the logits of the tile's 64 rows at this warpgroup's classes
    // (the first product writes z, so no instruction zeroes an accumulator)
    wgmma_fence();
    for (int m = 0; m < mt; ++m) {
      mbar_wait(&full[set * mt + m], round);
#pragma unroll
      for (int ks = 0; ks < kAtom / 16; ++ks)
        WgmmaAcc<NC>::template mma<0>(z, a_desc + ((m * kFusedBox + ks * 32) >> 4),
                                      vt_desc + ((m * NC * 128 + ks * 32) >> 4), (m | ks) != 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(z);

    // the softmax's partials over this warpgroup's classes: z[4 j + 2 h + e]
    // is column 8 j + 2 q + e of row row0 + 8 h; mp[h][tl], sp[h][tl] are
    // lane tl's max and sum of exp(z - max), the exponentials kept in z (a
    // lane whose classes here are all padding has max -inf and sum 0)
    float mp[2][2], sp[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int tl = 0; tl < kTL; ++tl) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (L != 1 && e != tl) continue;
            float& v = z[4 * j + 2 * h + e];
            v = cls0 + fused_class<L>(j, q, e) < c ? v : -INFINITY;
            mx = fmaxf(mx, v);
          }
        mx = quad_max<L>(mx);
        const float base = mx == -INFINITY ? 0.0f : mx;
        float den = 0.0f;
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (L != 1 && e != tl) continue;
            float& v = z[4 * j + 2 * h + e];
            v = expf(v - base);
            den += v;
          }
        mp[h][tl] = mx;
        sp[h][tl] = quad_sum<L>(den);
      }
    if constexpr (kTL == 1) {
      mp[0][1] = mp[1][1] = -INFINITY;
      sp[0][1] = sp[1][1] = 0.0f;
    }

    // the exchange with the other warpgroup, whose thread wl holds the same
    // (row, lane) pairs at the other classes (two buffers by the tile's parity)
    float4* xb = xch + (size_t)(it & 1) * 2 * kFusedThreads;
    xb[2 * tid] = make_float4(mp[0][0], sp[0][0], mp[0][1], sp[0][1]);
    xb[2 * tid + 1] = make_float4(mp[1][0], sp[1][0], mp[1][1], sp[1][1]);
    if constexpr (CL > 1)
      cluster_sync();  // every CTA of the cluster has written its pairs
    else
      named_barrier(1, kFusedThreads);
    // both warpgroups are past the last tile's products: its set takes the
    // tile `stages` after it
    {
      const int last = set == 0 ? stages - 1 : set - 1, row = (tt - 1 + stages) * kFusedRows;
      const bool load = tid == 0 && it > 0 && tt - 1 + stages < te;
      for (int m = 0; m < mt; ++m) {
        const int b = last * mt + m;
        tma_load_2d_if(load, ring + (size_t)b * kFusedBox, &tmA, m * kAtom, row, &full[b],
                       kFusedBox);
      }
    }
    // f[h][tl] = e^(m_w - M) / S of the thread's (row, lane) pairs: every
    // CTA and warpgroup combines the class quarters' pairs in quarter order
    // (quarter 2 rank + w), so all hold the same M and S
    float f[2][2];
    if constexpr (CL == 1) {
      const int other = 2 * (tid ^ 128);
      const float4 o0 = xb[other], o1 = xb[other + 1];
      const float mo[2][2] = {{o0.x, o0.z}, {o1.x, o1.z}};
      const float so[2][2] = {{o0.y, o0.w}, {o1.y, o1.w}};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int tl = 0; tl < kTL; ++tl) {
          const float m0 = wg ? mo[h][tl] : mp[h][tl], s0 = wg ? so[h][tl] : sp[h][tl];
          const float m1 = wg ? mp[h][tl] : mo[h][tl], s1 = wg ? sp[h][tl] : so[h][tl];
          const float M = fmaxf(m0, m1);  // finite: class 0 is real
          const float den = s0 * expf(m0 - M) + s1 * expf(m1 - M);
          f[h][tl] = expf(mp[h][tl] - M) * recip_rn(den);
        }
    } else {
      // one lane a thread (L = 1): quarter k's pair of row half h is the
      // float2 at xb[2 ((k & 1) 128 + wl) + h] in cluster CTA k / 2
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v[2 * CL];
#pragma unroll
        for (int k = 0; k < 2 * CL; ++k) v[k] = ld_cluster_f2(&xb[2 * ((k & 1) * 128 + wl) + h], k >> 1);
        float M = v[0].x;  // finite: class 0 is real
#pragma unroll
        for (int k = 1; k < 2 * CL; ++k) M = fmaxf(M, v[k].x);
        float den = v[0].y * expf(v[0].x - M);
#pragma unroll
        for (int k = 1; k < 2 * CL; ++k) den += v[k].y * expf(v[k].x - M);
        f[h][0] = expf(mp[h][0] - M) * recip_rn(den);
      }
    }

    // the residual into R^T (this warpgroup's last products on R completed
    // at the last tile's end)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int yr = h ? y_hi : y_lo;
      const float wr = h ? w_hi : w_lo;
      const int row = row0 + 8 * h;
#pragma unroll
      for (int tl = 0; tl < kTL; ++tl) {
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (L != 1 && e != tl) continue;
            const int n7 = 2 * q + e;
            const float yv = yr == cls0 + fused_class<L>(j, q, e) ? 1.0f : 0.0f;
            *reinterpret_cast<__nv_bfloat16*>(
                Rw + (8 * j + n7) * 128 + ((((row >> 3) ^ n7) & 7) << 4) + ((row & 7) << 1)) =
                __float2bfloat16((z[4 * j + 2 * h + e] * f[h][tl] - yv) * wr);
          }
      }
    }
    fence_proxy_async_shared();
    named_barrier(2 + wg, 128);  // this warpgroup's residual is in place

    // phase 2: G += A_tile^T R at this warpgroup's classes over every atom,
    // 16 rows at a time
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      if (u < mt) {
#pragma unroll
        for (int ks = 0; ks < kFusedRows / 16; ++ks)
          Wgmma<NC>::template mma<1>(gacc[u], at_desc + ((u * kFusedBox + ks * 2048) >> 4),
                                     r_desc + ((ks * 32) >> 4));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    if (++set == stages) {
      set = 0;
      round ^= 1;
    }
  }
#pragma unroll
  for (int u = 0; u < KU; ++u) fence_operand(gacc[u]);
  if constexpr (CL > 1) cluster_sync();  // no CTA leaves while another reads its pairs

  // G into G3 (P = 1) or the range's partial: gacc[u][4 j + 2 h + e] is
  // feature 64 u + row0 + 8 h, column 8 j + 2 q + e of this warpgroup
  float* dst = out + (size_t)p * n_wb * dpp * NB;  // p is 0 at P = 1
#pragma unroll
  for (int u = 0; u < KU; ++u) {
    if (u < mt) {
#pragma unroll
      for (int i = 0; i < kZ; ++i) {
        const int j = i >> 2, h = (i >> 1) & 1, e = i & 1;
        const int k = u * kAtom + row0 + 8 * h;
        const int a = cls0 + fused_class<L>(j, q, e);
        if (k < dpp && a < c)
          dst[((size_t)wb * dpp + k) * NB + (size_t)(a * S + s) * Tw + t0 + fused_lane<L>(q, e)] =
              gacc[u][i];
      }
    }
  }
}

// W3 as the fused CTAs read it: VT[j][a][k] bf16, lane j = lb Tw + t (lane
// block lb = wb S + s), class a < pitch, feature k < mt 64, zero past c and
// dpp: a lane's classes in 128-byte rows of 64 features (a CTA's lane is
// no coalesced run of W3, whose lanes of a class and feature are). grid
// (mt, lane blocks, min(pitch, 65535)); a tile of 64 features x Tw lanes
// through shared memory.
__global__ void __launch_bounds__(256) fused_vt_kernel(
    const __nv_bfloat16* __restrict__ W3, __nv_bfloat16* __restrict__ VT, int dpp, int c,
    int pitch, int S, int Tw, int kp) {
  __shared__ __nv_bfloat16 sh[kAtom * (128 + 2)];
  const int k0 = blockIdx.x * kAtom, lb = blockIdx.y;
  const int wb = lb / S, sp = lb % S, ld = Tw + 2;
  const size_t NB = (size_t)c * S * Tw;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  for (int a = blockIdx.z; a < pitch; a += gridDim.z) {
    const __nv_bfloat16* src = W3 + ((size_t)wb * dpp + k0) * NB + (size_t)(a * S + sp) * Tw;
    for (int i = threadIdx.x; i < kAtom * Tw; i += blockDim.x) {
      const int kk = i / Tw, t = i % Tw;
      sh[kk * ld + t] = a < c && k0 + kk < dpp ? src[(size_t)kk * NB + t] : zero;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < Tw * kAtom; i += blockDim.x) {
      const int t = i / kAtom, kk = i % kAtom;
      VT[((size_t)(lb * Tw + t) * pitch + a) * kp + k0 + kk] = sh[kk * ld + t];
    }
    __syncthreads();
  }
}

// B1's fused wide form at P > 1: G3 from the ranges' partials [P][G3],
// added in range order.
__global__ void __launch_bounds__(256) fused_sum_kernel(const float* __restrict__ part,
                                                        float* __restrict__ G3, size_t elems,
                                                        int ranges) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < elems;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int p = 1; p < ranges; ++p) v += part[(size_t)p * elems + i];
    G3[i] = v;
  }
}

// The (NC, L, KU, CL) instantiations of B1's fused wide form: NC columns a
// warpgroup of L lanes, KU feature atoms at most (dpp <= 64 KU: a
// warpgroup's share of G holds every atom), CL CTAs a cluster (one lane's
// classes in 2 CL quarters), a pitch of 2 NC CL / L classes a lane. The
// plan takes the least pitch that holds the classes, the first listed at a
// tie; the logits and the share (NC / 2 * (KU + 1) floats a thread) stay at
// most 168 of a thread's 255 registers.
#define LOGREG_FUSED_GEOMETRIES(X)                                                      \
  X(32, 8, 8, 1) X(40, 8, 7, 1) X(32, 4, 8, 1) X(32, 2, 8, 1) X(32, 1, 8, 1) X(40, 1, 7, 1) \
  X(56, 1, 5, 1) X(64, 1, 4, 1) X(32, 1, 8, 2) X(40, 1, 7, 2) X(56, 1, 5, 2) X(64, 1, 4, 2) \
  X(32, 1, 8, 4)

// B1's fused wide form's plan: ops/cuda_logreg.py::fused_plan mirrors it.
// `blocks` CTAs (CL a column block) over `ranges` row ranges P <= 4: from
// P = 1, each Q = 2, 3, 4 whose partials fit kWideScratch is taken where
// its waves of blocks x Q CTAs (one an SM), a wave's time being a range's
// share of the rows, take under 0.9 of the time of the P taken so far (a
// range more costs each CTA its prologue, and the partials their sum).
// The scratch: `vt` bytes of the transposed weights (fused_vt_kernel), then
// at P > 1 the partials, P of G3's size; P = 1 writes G3 directly.
struct FusedPlan {
  int nc, L, ku, cl, pitch, mt, row_tiles, blocks, ranges, stages;
  size_t smem, vt, scratch;
};

inline bool fused_plan(int n_pad, int dpp, int c, int S, int n_wb, int Tw, FusedPlan* p) {
  if (n_pad <= 0 || dpp <= 0 || dpp % 16 || dpp > kWideMaxDpp || c < 2 || S <= 0 ||
      n_wb <= 0 || Tw <= 0 || Tw % 16 || Tw > 128)
    return false;
  const int mt = (dpp + kAtom - 1) / kAtom;
  static const int geos[][4] = {
#define LOGREG_FUSED_ROW(a, b, k, n) {a, b, k, n},
      LOGREG_FUSED_GEOMETRIES(LOGREG_FUSED_ROW)
#undef LOGREG_FUSED_ROW
  };
  int pick = -1;
  for (int i = 0; i < (int)(sizeof(geos) / sizeof(geos[0])); ++i) {
    const int nc = geos[i][0], L = geos[i][1], ku = geos[i][2], cl = geos[i][3];
    if (2 * nc * cl / L < c || Tw % L || mt > ku || fused_stages(nc, mt) < 2) continue;
    if (pick < 0 || nc * cl * geos[pick][1] < geos[pick][0] * geos[pick][3] * L) pick = i;
  }
  if (pick < 0) return false;
  p->nc = geos[pick][0];
  p->L = geos[pick][1];
  p->ku = geos[pick][2];
  p->cl = geos[pick][3];
  p->pitch = 2 * p->nc * p->cl / p->L;
  p->mt = mt;
  p->row_tiles = (n_pad + kFusedRows - 1) / kFusedRows;
  p->blocks = (int)((long long)n_wb * S * Tw / p->L * p->cl);
  const size_t g3 = (size_t)n_wb * dpp * c * S * Tw * 4;
  p->ranges = 1;
  long long best_waves = (p->blocks + kSMs - 1) / kSMs;
  for (int P = 2; P <= kFusedMaxRanges && P <= p->row_tiles && (size_t)P * g3 <= kWideScratch;
       ++P) {
    const long long waves = ((long long)p->blocks * P + kSMs - 1) / kSMs;
    if (10 * waves * p->ranges < 9 * best_waves * P) {
      p->ranges = P;
      best_waves = waves;
    }
  }
  p->stages = fused_stages(p->nc, mt);
  p->smem = fused_layout(p->nc, mt, p->stages).total;
  p->vt = ((size_t)n_wb * S * Tw * p->pitch * mt * kAtom * 2 + 1023) / 1024 * 1024;
  p->scratch = p->vt + (p->ranges > 1 ? (size_t)p->ranges * g3 : 0);
  return true;
}

// One launch of fused_wide_kernel, CL CTAs (a cluster) a column block.
struct FusedLaunch {
  CUtensorMap map;
  const void *VT, *y, *WSP;
  void* out;
  int n_pad, dpp, c, S, n_wb, Tw, mt, row_tiles, ranges, stages, blocks;
  size_t smem;
  cudaStream_t stream;

  template <int NC, int L, int KU, int CL>
  cudaError_t run() const {
    cudaError_t err = set_smem((const void*)fused_wide_kernel<NC, L, KU, CL>, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, ranges);
    cfg.blockDim = dim3(kFusedThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, fused_wide_kernel<NC, L, KU, CL>, map,
                             (const __nv_bfloat16*)VT, (const int*)y, (const float*)WSP,
                             (float*)out, n_pad, dpp, c, S, n_wb, Tw, mt, row_tiles, ranges,
                             stages);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

cudaError_t dispatch_fused(const FusedLaunch& f, int nc, int L, int ku, int cl) {
#define LOGREG_FUSED_RUN(a, b, k, n) \
  if (nc == a && L == b && ku == k && cl == n) return f.run<a, b, k, n>();
  LOGREG_FUSED_GEOMETRIES(LOGREG_FUSED_RUN)
#undef LOGREG_FUSED_RUN
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// B1's fused wide form's plan into out[0..12]: nc, L, ku, cl, pitch, mt,
// row_tiles, blocks, ranges, stages, smem, vt and scratch bytes. Returns 0 for a
// shape it has no geometry for; ops/cuda_logreg.py::fused_plan mirrors it.
int logreg_fused_plan(int n_pad, int dpp, int c, int S, int n_wb, int Tw, long long* out) {
  FusedPlan p;
  if (!fused_plan(n_pad, dpp, c, S, n_wb, Tw, &p)) return 0;
  const long long v[13] = {p.nc,     p.L,         p.ku,     p.cl,     p.pitch,
                           p.mt,     p.row_tiles, p.blocks, p.ranges, p.stages,
                           (long long)p.smem, (long long)p.vt, (long long)p.scratch};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 1;
}

// B1's fused wide form on `stream`: W3 transposed into the scratch's VT,
// the fused kernel (into G3, or at P > 1 into the ranges' partials after
// VT, then the in-order sum into G3). The scratch must hold the plan's
// bytes.
int logreg_fused_softmax_grad(const void* Ab, const void* W3, const void* y, const void* WSP,
                              void* G3, void* scratch, long long scratch_bytes, int n_pad,
                              int dpp, int c, int S, int n_wb, int Tw, void* stream) {
  FusedPlan p;
  if (!fused_plan(n_pad, dpp, c, S, n_wb, Tw, &p) || scratch_bytes < (long long)p.scratch ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  __nv_bfloat16* vt = (__nv_bfloat16*)scratch;
  float* part = (float*)((unsigned char*)scratch + p.vt);
  fused_vt_kernel<<<dim3(p.mt, n_wb * S, p.pitch < 65535 ? p.pitch : 65535), 256, 0, s>>>(
      (const __nv_bfloat16*)W3, vt, dpp, c, p.pitch, S, Tw, p.mt * kAtom);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  FusedLaunch f{{}, vt, y, WSP, p.ranges > 1 ? (void*)part : G3, n_pad, dpp, c, S, n_wb, Tw,
                p.mt, p.row_tiles, p.ranges, p.stages, p.blocks, p.smem, s};
  err = tma_map(&f.map, Ab, dpp, n_pad, kAtom, kFusedRows);
  if (err != cudaSuccess || (err = dispatch_fused(f, p.nc, p.L, p.ku, p.cl)) != cudaSuccess)
    return (int)err;
  if (p.ranges == 1) return 0;
  const size_t elems = (size_t)n_wb * dpp * c * S * Tw;
  const size_t blocks = (elems + 255) / 256;
  fused_sum_kernel<<<(unsigned)(blocks < 16 * kSMs ? blocks : 16 * kSMs), 256, 0, s>>>(
      part, (float*)G3, elems, p.ranges);
  return (int)cudaGetLastError();
}

}  // extern "C"
