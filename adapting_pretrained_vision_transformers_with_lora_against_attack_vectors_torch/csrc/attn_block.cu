// Fused attention half-block of a ViT layer, forward and input gradient, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/attn_block.py:fused_attn_block of the JAX
// package (_fwd_kernel, _bwd_kernel): for x (B, N, C) in bf16 and C = H * 64,
//   h       = LN(x) * scale + bias          (f32, two-pass mean/var; rounded to bf16)
//   q, k, v = h Wq + bq, h Wk + bk, h Wv + bv   (f32 accumulation, f32 bias; rounded to bf16)
//   P       = softmax(q k^T * 64^-1/2)      per head, f32; rounded to bf16 before P v
//   a       = P v                            (f32 accumulation; rounded to bf16)
//   out     = a Wo + bo                      (f32 accumulation, f32 bias; rounded to bf16)
// with the four weights (C, C) row-major (in, out) in bf16. The backward
// computes dx only: it recomputes h, q, k, v and P, then
//   da         = dy Wo^T                     (f32 accumulation; rounded to bf16)
//   dq, dk, dv = the softmax-attention backward (dS rounded to bf16; rounded to bf16)
//   dh         = dq Wq^T + dk Wk^T + dv Wv^T (f32)
//   dx         = the f32 LayerNorm backward of dh, rounded once.
// Parameter gradients are not computed here: the wrapper recomputes them in
// plain PyTorch only when a caller asks for them, as the JAX VJP leaves them
// to XLA.
//
// What bounds it on the H100: 8 N C^2 + 4 N^2 C FLOP per batch element
// forward (67 GFLOP at B = 64, N = 197, C = 768) against 2 N C bytes in and
// out plus 8 C^2 bytes of weights: ~1600 FLOP/byte, far above the bf16 ridge
// (~295), so the tensor cores are the limit (68 us forward, 125 us backward)
// if h, q, k, v and P stay on chip and the weights are not re-read from L2
// too often.
//
// The work of a batch element is cut in two: per-head kernels (LN, q/k/v,
// the attention; in the backward also da and the attention backward) and
// row-block kernels (the o-projection; dh and the LayerNorm backward), which
// contract over all heads. Between them `a` (and dq, dk, dv) take one round
// trip through bf16 scratch tensors (B, N, C), where the plain version
// rounds them to bf16 anyway: 2 x 2 N C bytes per batch element forward and
// 2 x 6 N C backward (77 and 232 MB at the ViT-B shape, 23 and 69 us at 3.35
// TB/s). One sum, one owner, a fixed order: no atomics, results are bitwise
// reproducible.
//
// The Hopper design (namespace wgb), chosen at every supported shape:
// * every kernel is two consumer warpgroups and a producer warpgroup, of
//   which one warp starts the TMA loads into a ring of stages (wg_ring.cuh)
//   and setmaxnreg gives its registers to the consumers; every product is
//   wgmma with both operands in 128-byte-swizzled shared memory (sm90.cuh),
//   a weight in its stored layout: row-major W (in, out) is the MN-major B
//   operand of h W and the K-major one of d W^T, so no transposed copy
//   exists;
// * heads_fwd / heads_bwd: a cluster of two CTAs per (batch element, head).
//   Each CTA projects 128 of the (up to 256, padded) token rows, a
//   warpgroup 64, in one pass over the head's 64 columns of Wq, Wk, Wv: a
//   ring stage is a 64-column slab of the CTA's x rows beside the 64 x 192
//   weight slab, so each weight slab is read once per CTA (the first design
//   read the head's whole 295 KB slice once per 32 rows, 7 times per CTA at
//   N = 197). The LayerNorm statistics are computed once per row (f32,
//   two-pass) and applied to each x slab in place on arrival, before it
//   becomes a wgmma operand (a proxy fence between). A warpgroup's q, k, v
//   (64 x 192 f32, 96 registers a thread) get their biases, are rounded and
//   written as swizzled tiles into both CTAs' shared memory (the K and V
//   halves, and in the backward Q and da too, through st.shared::cluster),
//   then the attention runs on them with the wgmma cores of attn_wgmma.cuh:
//   the forward's fwd_tile per 64-row query tile; the backward first forms
//   each row's log-sum-exp and D = rowsum(da * o) with fwd_tile (exchanged
//   through both CTAs), then dq_block per query tile and dkv_block per key
//   block, as the packed-attention backward does;
// * oproj_fwd: out = a Wo + bo over blocks of 128 rows x 192 columns (a
//   warpgroup 64 rows), K in 64-deep stages of the 128 x 64 slab of `a` and
//   the 64 x 192 slab of Wo: each weight pass serves 128 rows (the first design: 32);
// * dh_bwd: the same blocks over the three sources d Wd^T (K-major weight
//   boxes of 192 rows), in a cluster of C / 192 CTAs that together hold
//   whole rows; the LayerNorm backward runs on the accumulators, with the
//   rows' sums of dn and dn * n exchanged through every CTA of the cluster
//   and added in rank order (mean and rstd recomputed from x, f32);
// * outputs leave through swizzled staging tiles and TMA stores, which drop
//   rows past N (or T); TMA fills the rows past N of every load with zeros.
//
// The first design (namespace mma_sync: mma.sync + cp.async, a CTA per (batch
// element, head) re-reading the head's weights per 32 rows) stays reachable
// at the ViT-B width through the *_mma_sync entry points only, which
// chip_smoke.py times against the Hopper kernels; no model path calls them.
//
// Takes bf16, head dim 64, C in {192, 384, 768}, 1 <= N <= 256 (the Hopper
// kernels' shared memory does not depend on N; the first design's does). C
// interface (loaded with ctypes): each entry point returns the CUDA error
// code of its launches (cudaGetLastError), 0 on success, -1 for an
// unsupported shape, -2 if a tensor map could not be encoded, -3 if the
// compiled kernel holds fewer registers than its warpgroups' setmaxnreg
// split needs (which would hang, not fail).

#include "attn_core.cuh"
#include "attn_wgmma.cuh"
#include "wg_ring.cuh"

namespace {

using namespace apvt;

struct Args {
  const bf16 *x, *wq, *wk, *wv, *wo;
  const float *ln_s, *ln_b, *bq, *bk, *bv, *bo;
  int B, N, H;
  float eps;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// The first design: mma.sync + cp.async.

namespace mma_sync {

namespace core = apvt::tc;

constexpr int HD = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRB = 32;    // token rows per projection block (two 16-row tiles)
constexpr int kKS = 64;    // contraction rows per weight slab, head kernels
constexpr int kKS2 = 32;   // contraction rows per weight slab, row-block GEMMs
constexpr int S = core::Shape<HD>::kStride;
constexpr int kLDW = 3 * HD + 8;             // q|k|v slab row stride
constexpr int kHeadSlab = kKS * kLDW;        // elements; >= HD * (kKS + 8), the Wo slab
constexpr size_t kMaxSmem = 232448;

// ROWS x COLS block of a row-major matrix (leading dimension ld) -> a tile of
// row stride LDS, 16 bytes per thread and copy, asynchronously.
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_block(bf16* dst, const bf16* __restrict__ src, int ld) {
  constexpr int V = COLS / 8;
  for (int idx = threadIdx.x; idx < ROWS * V; idx += kThreads) {
    const int r = idx / V, c = idx % V;
    cp_async16(dst + r * LDS + c * 8, src + (size_t)r * ld + c * 8);
  }
}

// Rows [row0, row0 + kRB) of a (T, C) bf16 matrix into a row buffer of row
// stride C + 8 (rows >= T: zeros).
template <int C>
__device__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0, int T) {
  constexpr int V = C / 8;
  for (int idx = threadIdx.x; idx < kRB * V; idx += kThreads) {
    const int r = idx / V, c = idx % V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * C + c * 8));
    *reinterpret_cast<uint4*>(dst + r * (C + 8) + c * 8) = val;
  }
}

// Wait for slab i (the newest but one when slab i + 1 was just started).
__device__ __forceinline__ void wait_slab(bool newer_in_flight) {
  if (newer_in_flight)
    cp_wait<1>();
  else
    cp_wait<0>();
  __syncthreads();
}

// Rows [r0, r0 + kRB) of the head's q, k, v tiles = Xn (kRB x C, normalised
// rows) times the head's 64 columns of Wq, Wk, Wv, plus the biases in f32,
// rounded to bf16; rows >= N are stored as zeros, rows >= NP not at all.
// Warp (wr, wc) owns rows 16 wr.. and the 48 columns 48 wc.. of q|k|v.
template <int C>
__device__ void project_qkv(bf16* Qs, bf16* Ks, bf16* Vs, const bf16* Xn, bf16* slabs,
                            const bf16* __restrict__ wq, const bf16* __restrict__ wk,
                            const bf16* __restrict__ wv, const float* __restrict__ bq,
                            const float* __restrict__ bk, const float* __restrict__ bv, int h,
                            int r0, int N, int NP) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;
  constexpr int NS = C / kKS;
  auto fetch = [&](int i) {
    bf16* dst = slabs + (i & 1) * kHeadSlab;
    const size_t off = (size_t)(i * kKS) * C + h * HD;
    load_block<kKS, HD, kLDW>(dst, wq + off, C);
    load_block<kKS, HD, kLDW>(dst + HD, wk + off, C);
    load_block<kKS, HD, kLDW>(dst + 2 * HD, wv + off, C);
    cp_commit();
  };
  float acc[6][4];
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  fetch(0);
  for (int i = 0; i < NS; ++i) {
    if (i + 1 < NS) fetch(i + 1);
    wait_slab(i + 1 < NS);   // also orders the row buffer's stores before its loads
    const bf16* slab = slabs + (i & 1) * kHeadSlab;
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk) {
      uint32_t a[4];
      ldsm(a, a_addr<C + 8>(Xn, wr * 16, i * kKS + kk * 16, lane));
#pragma unroll
      for (int np = 0; np < 3; ++np) {
        uint32_t bb[4];
        ldsm_t(bb, a_addr<kLDW>(slab, kk * 16, wc * 48 + np * 16, lane));
        mma(acc[2 * np], a, bb[0], bb[1]);
        mma(acc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    const int col = wc * 48 + nt * 8 + 2 * t;   // an 8-column tile never straddles q|k|v
    const int which = col / HD, within = col % HD;
    bf16* tile = which == 0 ? Qs : (which == 1 ? Ks : Vs);
    const float* bias = which == 0 ? bq : (which == 1 ? bk : bv);
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + h * HD + within));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + wr * 16 + g + 8 * r;
      if (row < NP)
        *reinterpret_cast<uint32_t*>(tile + row * S + within) =
            row < N ? pack(acc[nt][2 * r] + b2.x, acc[nt][2 * r + 1] + b2.y) : 0u;
    }
  }
}

// Rows [r0, r0 + kRB) of the head's da tile = dY (kRB x C, cotangent rows)
// times the head's 64 rows of Wo, transposed (Wo (C, C) row-major is the
// [n][k] operand as it stands), rounded to bf16. Warp (wr, wc) owns rows
// 16 wr.. and columns 16 wc...
template <int C>
__device__ void project_da(bf16* dAs, const bf16* dYs, bf16* slabs, const bf16* __restrict__ wo,
                           int h, int r0, int NP) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;
  constexpr int NS = C / kKS;
  auto fetch = [&](int i) {
    load_block<HD, kKS, kKS + 8>(slabs + (i & 1) * kHeadSlab, wo + (size_t)(h * HD) * C + i * kKS,
                                 C);
    cp_commit();
  };
  float acc[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  fetch(0);
  for (int i = 0; i < NS; ++i) {
    if (i + 1 < NS) fetch(i + 1);
    wait_slab(i + 1 < NS);
    const bf16* slab = slabs + (i & 1) * kHeadSlab;
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk) {
      uint32_t a[4], bb[4];
      ldsm(a, a_addr<C + 8>(dYs, wr * 16, i * kKS + kk * 16, lane));
      ldsm(bb, b_addr<kKS + 8>(slab, wc * 16, kk * 16, lane));
      mma(acc[0], a, bb[0], bb[1]);
      mma(acc[1], a, bb[2], bb[3]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = wc * 16 + nt * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + wr * 16 + g + 8 * r;   // cotangent rows >= N were loaded as zeros
      if (row < NP)
        *reinterpret_cast<uint32_t*>(dAs + row * S + col) =
            pack(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// One CTA per (batch element, head): LN, the head's q/k/v, the attention
// core; `a` (B, N, C) gets the head's 64 columns.
template <int C, int KMAX>
__global__ void __launch_bounds__(kThreads)
heads_fwd(const bf16* __restrict__ x, const float* __restrict__ ln_s,
          const float* __restrict__ ln_b, const bf16* __restrict__ wq,
          const float* __restrict__ bq, const bf16* __restrict__ wk,
          const float* __restrict__ bk, const bf16* __restrict__ wv,
          const float* __restrict__ bv, bf16* __restrict__ a, int N, int H, float eps,
          float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NP = (N + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + NP * S;
  bf16* Vs = Ks + NP * S;
  bf16* Xn = Vs + NP * S;
  bf16* slabs = Xn + kRB * (C + 8);
  const bf16* xb = x + (size_t)b * N * C;
  for (int r0 = 0; r0 < NP; r0 += kRB) {
    ln_rows<C, kRB, C + 8, kWarps>(Xn, xb, ln_s, ln_b, r0, N, eps);
    project_qkv<C>(Qs, Ks, Vs, Xn, slabs, wq, wk, wv, bq, bk, bv, h, r0, N, NP);
  }
  __syncthreads();
  bf16* out = a + (size_t)b * N * C + h * HD;
  for (int r0 = warp * 16; r0 < NP; r0 += kWarps * 16) {
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) ldsm(qa[kc], a_addr<S>(Qs, r0, kc * 16, lane));
    float acc[HD / 8][4];
    core::fwd_rows<HD, KMAX>(acc, qa, Ks, Vs, N, NP, scale);
    core::store_rows<HD>(out, r0, N, C, acc);
  }
}

// One CTA per (batch element, head): LN, the head's q/k/v and da recomputed,
// then the attention backward; dq, dk, dv (B, N, C) get the head's columns.
template <int C, int KMAX>
__global__ void __launch_bounds__(kThreads)
heads_bwd(const bf16* __restrict__ x, const float* __restrict__ ln_s,
          const float* __restrict__ ln_b, const bf16* __restrict__ wq,
          const float* __restrict__ bq, const bf16* __restrict__ wk,
          const float* __restrict__ bk, const bf16* __restrict__ wv,
          const float* __restrict__ bv, const bf16* __restrict__ wo,
          const bf16* __restrict__ dy, bf16* __restrict__ dq, bf16* __restrict__ dk,
          bf16* __restrict__ dv, int N, int H, float eps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int NP = (N + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + NP * S;
  bf16* Vs = Ks + NP * S;
  bf16* dAs = Vs + NP * S;
  bf16* Xn = dAs + NP * S;
  bf16* slabs = Xn + kRB * (C + 8);
  float* stat_m = reinterpret_cast<float*>(slabs + 2 * kHeadSlab);
  float* stat_l = stat_m + NP;
  float* stat_D = stat_l + NP;
  const size_t batch = (size_t)b * N * C;
  for (int r0 = 0; r0 < NP; r0 += kRB) {
    ln_rows<C, kRB, C + 8, kWarps>(Xn, x + batch, ln_s, ln_b, r0, N, eps);
    project_qkv<C>(Qs, Ks, Vs, Xn, slabs, wq, wk, wv, bq, bk, bv, h, r0, N, NP);
    load_rows<C>(Xn, dy + batch, r0, N);   // the projection's last barrier freed the buffer
    project_da<C>(dAs, Xn, slabs, wo, h, r0, NP);
  }
  __syncthreads();
  const size_t base = batch + h * HD;
  core::bwd_phase1<HD, KMAX, kWarps>(Qs, Ks, Vs, dAs, stat_m, stat_l, stat_D, dq + base, C, N,
                                     NP, scale);
  __syncthreads();
  core::bwd_phase2<HD, kWarps>(Qs, Ks, Vs, dAs, stat_m, stat_l, stat_D, dk + base, dv + base, C,
                               N, NP, scale);
}

// acc (16 rows of warp row wr x C/4 columns of warp column wc) +=
// As[:, k0 .. k0 + kKS2) * slab; the slab is a [k][n] tile (kKS2 x C, row
// stride C + 8) or an [n][k] tile (C x kKS2, row stride kKS2 + 8).
template <int C, bool NK>
__device__ __forceinline__ void mma_rows(float (&acc)[C / 32][4], const bf16* As, int k0,
                                         const bf16* slab, int wr, int wc, int lane) {
  constexpr int NP2 = C / 64;   // column pairs per warp
#pragma unroll
  for (int kk = 0; kk < kKS2 / 16; ++kk) {
    uint32_t a[4];
    ldsm(a, a_addr<C + 8>(As, wr * 16, k0 + kk * 16, lane));
#pragma unroll
    for (int np = 0; np < NP2; ++np) {
      uint32_t bb[4];
      const int col = wc * (C / 4) + np * 16;
      if (NK)
        ldsm(bb, b_addr<kKS2 + 8>(slab, col, kk * 16, lane));
      else
        ldsm_t(bb, a_addr<C + 8>(slab, kk * 16, col, lane));
      mma(acc[2 * np], a, bb[0], bb[1]);
      mma(acc[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

template <int C>
struct RowsCfg {
  static constexpr int AS = kRB * (C + 8);                 // elements of the A row buffer
  static constexpr int SLAB_KN = kKS2 * (C + 8);
  static constexpr int SLAB_NK = C * (kKS2 + 8);
  static constexpr size_t SMEM_FWD = (size_t)(AS + 2 * SLAB_KN) * sizeof(bf16);
  static constexpr size_t SMEM_BWD = (size_t)(AS + 2 * SLAB_NK) * sizeof(bf16);
  static_assert((size_t)kRB * (C + 8) * sizeof(float) <= 2 * SLAB_NK * sizeof(bf16),
                "the f32 dh tile must fit over the weight slabs");
};

// out (T, C) = a (T, C) Wo + bo, a block of kRB rows per CTA.
template <int C>
__global__ void __launch_bounds__(kThreads)
oproj_fwd(const bf16* __restrict__ a, const bf16* __restrict__ wo, const float* __restrict__ bo,
          bf16* __restrict__ out, int T) {
  using R = RowsCfg<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* slabs = As + R::AS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;
  const int row0 = blockIdx.x * kRB;
  constexpr int NS = C / kKS2;
  auto fetch = [&](int i) {
    load_block<kKS2, C, C + 8>(slabs + (i & 1) * R::SLAB_KN, wo + (size_t)(i * kKS2) * C, C);
    cp_commit();
  };
  fetch(0);
  load_rows<C>(As, a, row0, T);
  float acc[C / 32][4];
#pragma unroll
  for (int nt = 0; nt < C / 32; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int i = 0; i < NS; ++i) {
    if (i + 1 < NS) fetch(i + 1);
    wait_slab(i + 1 < NS);
    mma_rows<C, false>(acc, As, i * kKS2, slabs + (i & 1) * R::SLAB_KN, wr, wc, lane);
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < C / 32; ++nt) {
    const int col = wc * (C / 4) + nt * 8 + 2 * t;
    const float2 bias = __ldg(reinterpret_cast<const float2*>(bo + col));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + wr * 16 + g + 8 * r;
      if (row < T)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * C + col) =
            pack(acc[nt][2 * r] + bias.x, acc[nt][2 * r + 1] + bias.y);
    }
  }
}

// dx (T, C) = LN backward of dh = dq Wq^T + dk Wk^T + dv Wv^T, a block of
// kRB rows per CTA; the three products accumulate in one f32 register tile.
template <int C>
__global__ void __launch_bounds__(kThreads)
dh_bwd(const bf16* __restrict__ dq, const bf16* __restrict__ dk, const bf16* __restrict__ dv,
       const bf16* __restrict__ wq, const bf16* __restrict__ wk, const bf16* __restrict__ wv,
       const bf16* __restrict__ x, const float* __restrict__ ln_s, bf16* __restrict__ dx, int T,
       float eps) {
  using R = RowsCfg<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* slabs = As + R::AS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & 1, wc = warp >> 1;
  const int row0 = blockIdx.x * kRB;
  constexpr int NS = C / kKS2;
  float acc[C / 32][4];
#pragma unroll
  for (int nt = 0; nt < C / 32; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int src = 0; src < 3; ++src) {
    const bf16* d = src == 0 ? dq : (src == 1 ? dk : dv);
    const bf16* w = src == 0 ? wq : (src == 1 ? wk : wv);
    // W (C, C) row-major is the [n][k] operand of d W^T: all C rows x kKS2 columns
    auto fetch = [&](int i) {
      load_block<C, kKS2, kKS2 + 8>(slabs + (i & 1) * R::SLAB_NK, w + i * kKS2, C);
      cp_commit();
    };
    fetch(0);
    load_rows<C>(As, d, row0, T);   // the last barrier of the previous source freed the buffer
    for (int i = 0; i < NS; ++i) {
      if (i + 1 < NS) fetch(i + 1);
      wait_slab(i + 1 < NS);
      mma_rows<C, true>(acc, As, i * kKS2, slabs + (i & 1) * R::SLAB_NK, wr, wc, lane);
      __syncthreads();
    }
  }
  // dh as an f32 tile over the weight slabs (the last barrier ended their use)
  float* tile = reinterpret_cast<float*>(slabs);
#pragma unroll
  for (int nt = 0; nt < C / 32; ++nt) {
    const int col = wc * (C / 4) + nt * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(tile + (wr * 16 + g + 8 * r) * (C + 8) + col) =
          make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
  __syncthreads();
  ln_bwd_rows<C, kRB, C + 8, kWarps>(tile, x, ln_s, dx, row0, T, eps);
}

template <int C>
size_t heads_smem(int N, bool bwd) {
  const size_t np = (size_t)((N + 15) & ~15);
  const size_t tiles = (bwd ? 4 : 3) * np * S;
  return (tiles + (size_t)kRB * (C + 8) + 2 * (size_t)kHeadSlab) * sizeof(bf16) +
         (bwd ? 3 * np * sizeof(float) : 0);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int C, int KMAX>
int run_fwd(const Args& p, bf16* a, bf16* out) {
  const size_t smem = heads_smem<C>(p.N, false);
  if (smem > kMaxSmem) return -1;
  cudaError_t err = opt_in(heads_fwd<C, KMAX>, smem);
  if (err != cudaSuccess) return (int)err;
  err = opt_in(oproj_fwd<C>, RowsCfg<C>::SMEM_FWD);
  if (err != cudaSuccess) return (int)err;
  heads_fwd<C, KMAX><<<p.B * p.H, kThreads, smem, p.stream>>>(
      p.x, p.ln_s, p.ln_b, p.wq, p.bq, p.wk, p.bk, p.wv, p.bv, a, p.N, p.H, p.eps, 0.125f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int T = p.B * p.N;
  oproj_fwd<C><<<(T + kRB - 1) / kRB, kThreads, RowsCfg<C>::SMEM_FWD, p.stream>>>(
      a, p.wo, p.bo, out, T);
  return (int)cudaGetLastError();
}

template <int C, int KMAX>
int run_bwd(const Args& p, const bf16* dy, bf16* dq, bf16* dk, bf16* dv, bf16* dx) {
  const size_t smem = heads_smem<C>(p.N, true);
  if (smem > kMaxSmem) return -1;
  cudaError_t err = opt_in(heads_bwd<C, KMAX>, smem);
  if (err != cudaSuccess) return (int)err;
  err = opt_in(dh_bwd<C>, RowsCfg<C>::SMEM_BWD);
  if (err != cudaSuccess) return (int)err;
  heads_bwd<C, KMAX><<<p.B * p.H, kThreads, smem, p.stream>>>(
      p.x, p.ln_s, p.ln_b, p.wq, p.bq, p.wk, p.bk, p.wv, p.bv, p.wo, dy, dq, dk, dv, p.N, p.H,
      p.eps, 0.125f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int T = p.B * p.N;
  dh_bwd<C><<<(T + kRB - 1) / kRB, kThreads, RowsCfg<C>::SMEM_BWD, p.stream>>>(
      dq, dk, dv, p.wq, p.wk, p.wv, p.x, p.ln_s, dx, T, p.eps);
  return (int)cudaGetLastError();
}

}  // namespace mma_sync

// ---------------------------------------------------------------------------
// The Hopper design: wgmma + TMA.

namespace wgb {

using namespace apvt::sm90;

constexpr int HD = 64;
constexpr int kThreads = 384;    // two consumer warpgroups and the producer's
constexpr int kTileB = 8192;     // 64 x 64 bf16, swizzled
constexpr int kSlabB = 2 * kTileB;           // 128 rows x 64 columns of the rows
constexpr int kStageB = kSlabB + 3 * kTileB; // ... beside a 64 x 192 weight slab
constexpr int kSmemMax = 232448;
// registers a thread after setmaxnreg (consumers, producer): what the two
// consumer warpgroups take and the producer keeps must fit what the CTA has
// at entry, 384 x 168, or setmaxnreg.inc waits forever; the launcher checks
// the compiled kernel's count (kRegError) before any launch
constexpr int kConsumerRegs = 232, kProducerRegs = 40, kEntryRegs = 168;
static_assert(2 * kConsumerRegs + kProducerRegs <= 3 * kEntryRegs, "setmaxnreg would wait forever");
constexpr int kRegError = -3;

template <int S>
struct Bars {
  uint64_t full[S], empty[S];
};

template <int S>
__device__ __forceinline__ void init_bars(Bars<S>* b) {
  for (int s = 0; s < S; ++s) {
    mbar_init(&b->full[s], 1);
    mbar_init(&b->empty[s], 8);   // lane 0 of each consumer warp
  }
  mbar_fence_init();
}

// Mean and rstd (f32, two-pass) of rows [row0, row0 + 64) of x (rows, C):
// warp `warp` of the warpgroup takes rows 16 warp .. 16 warp + 15, eight at
// a time with all their loads in flight; rows >= rows get 0 and 0.
template <int C>
__device__ void row_stats(float* mean, float* rstd, const bf16* __restrict__ x, int row0,
                          int rows, float eps, int warp, int lane) {
  constexpr int V = C / 8, PER = (V + 31) / 32, G = 8;
  for (int r0 = 16 * warp; r0 < 16 * warp + 16; r0 += G) {
    uint4 raw[G][PER];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int row = row0 + r0 + k;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int vec = lane + 32 * p;
        raw[k][p] = make_uint4(0u, 0u, 0u, 0u);
        if (vec < V && row < rows)
          raw[k][p] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * C + vec * 8));
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      float v[PER][8];
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        unpack8(v[p], raw[k][p]);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += v[p][e];
      }
      const float m = warp_sum(sum) * (1.f / C);
      float sq = 0.f;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        if (lane + 32 * p < V) {
#pragma unroll
          for (int e = 0; e < 8; ++e) sq += (v[p][e] - m) * (v[p][e] - m);
        }
      }
      const float rs = rsqrtf(warp_sum(sq) * (1.f / C) + eps);
      if (lane == 0) {
        const bool live = row0 + r0 + k < rows;
        mean[r0 + k] = live ? m : 0.f;
        rstd[r0 + k] = live ? rs : 0.f;
      }
    }
  }
}

// A warpgroup's 64 rows x 64 columns (columns k0..) of x, as TMA put them
// into a swizzled tile, normalised in place: (x - mean) * rstd * scale +
// bias in f32, rounded to bf16; rows that are not live (>= N) zero.
__device__ __forceinline__ void normalise_slab(unsigned char* tile, const float* mean,
                                               const float* rstd, const float* __restrict__ ln_s,
                                               const float* __restrict__ ln_b, int k0,
                                               int live_rows, int wl) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int q = wl + 128 * m, r = q >> 3, c8 = q & 7;
    uint4* p = reinterpret_cast<uint4*>(tile + r * 128 + ((c8 ^ (r & 7)) << 4));
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (r < live_rows) {
      float v[8];
      unpack8(v, *p);
      const float mu = mean[r], rs = rstd[r];
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(ln_s + k0 + 8 * c8));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(ln_s + k0 + 8 * c8 + 4));
      const float4 t0 = __ldg(reinterpret_cast<const float4*>(ln_b + k0 + 8 * c8));
      const float4 t1 = __ldg(reinterpret_cast<const float4*>(ln_b + k0 + 8 * c8 + 4));
      o.x = pack_bf16((v[0] - mu) * rs * s0.x + t0.x, (v[1] - mu) * rs * s0.y + t0.y);
      o.y = pack_bf16((v[2] - mu) * rs * s0.z + t0.z, (v[3] - mu) * rs * s0.w + t0.w);
      o.z = pack_bf16((v[4] - mu) * rs * s1.x + t1.x, (v[5] - mu) * rs * s1.y + t1.y);
      o.w = pack_bf16((v[6] - mu) * rs * s1.z + t1.z, (v[7] - mu) * rs * s1.w + t1.w);
    }
    *p = o;
  }
}

// Shared memory of the per-head kernels (offsets from a 1024-byte boundary).
template <bool BWD>
struct HeadsCfg {
  static constexpr int S = BWD ? 2 : 3;               // ring stages
  static constexpr int QT = BWD ? 4 : 2;              // Q tiles held (forward: the CTA's own)
  static constexpr int OFF_K = QT * kTileB;
  static constexpr int OFF_V = OFF_K + 4 * kTileB;
  static constexpr int OFF_DA = OFF_V + 4 * kTileB;
  static constexpr int OFF_RING = OFF_DA + (BWD ? 4 * kTileB : 0);
  static constexpr int OFF_STATS = OFF_RING + S * kStageB;   // mean, rstd of 128 rows; lse2, D of 256
  static constexpr int OFF_BARS = OFF_STATS + (BWD ? 768 : 256) * 4;
  static constexpr size_t SMEM = 1024 + OFF_BARS + sizeof(Bars<S>);
  static_assert(SMEM <= kSmemMax, "shared memory of a CTA");
};

// The q/k/v projection of a warpgroup's 64 rows: acc (64 x 192: q | k | v
// of the head) over the C / 64 ring stages, each x slab normalised first.
template <int C, int S>
__device__ __forceinline__ void project_qkv(float (&acc)[96], unsigned char* ring, Bars<S>* bars,
                                            wring::Pipe<S>& p, const float* mean,
                                            const float* rstd, const float* ln_s,
                                            const float* ln_b, int w, int live_rows, int wl,
                                            int lane) {
  for (int kt = 0; kt < C / 64; ++kt) {
    mbar_wait(&bars->full[p.s], p.ph);
    unsigned char* st = ring + p.s * kStageB;
    normalise_slab(st + w * kTileB, mean, rstd, ln_s, ln_b, 64 * kt, live_rows, wl);
    fence_async_shared();
    named_barrier(1 + w, 128);
    const uint64_t a = mdesc(st + w * kTileB), b = mdesc(st + kSlabB, kTileB, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<192>::template ss<0, 1>(acc, madvance(a, 32 * kk), madvance(b, 2048 * kk), kt | kk);
    wring::commit_stage(bars->empty, p, lane);
  }
}

// Element pair (4 jt + 2 hi, + 1) of a 64 x NW accumulator as bf16 into the
// swizzled tile, and into the peer CTA's copy of it where `remote`.
__device__ __forceinline__ void put_pair(unsigned char* tile, int r, int c, uint32_t v,
                                         bool remote, uint32_t peer) {
  unsigned char* dst = tile + swz(r, c);
  *reinterpret_cast<uint32_t*>(dst) = v;
  if (remote) st_cluster_u32(mapa(saddr(dst), peer), v);
}

// q, k, v (+ biases, rounded; rows >= N zero) into tile `ti` of Qs, Ks, Vs;
// Q into the peer's copy too where `remote_q`, K and V always.
__device__ __forceinline__ void qkv_to_tiles(const float (&acc)[96], unsigned char* Qt,
                                             unsigned char* Kt, unsigned char* Vt,
                                             const float* __restrict__ bq,
                                             const float* __restrict__ bk,
                                             const float* __restrict__ bv, int h, int live_rows,
                                             bool remote_q, uint32_t peer, int warp, int g,
                                             int t) {
#pragma unroll
  for (int jt = 0; jt < 24; ++jt) {
    const int which = jt >> 3, c = 8 * (jt & 7) + 2 * t;
    const float* bias = which == 0 ? bq : (which == 1 ? bk : bv);
    unsigned char* tile = which == 0 ? Qt : (which == 1 ? Kt : Vt);
    const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + h * HD + c));
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = warp * 16 + g + 8 * hi;
      const uint32_t v = r < live_rows ? pack_bf16(acc[4 * jt + 2 * hi] + b2.x,
                                                   acc[4 * jt + 2 * hi + 1] + b2.y)
                                       : 0u;
      put_pair(tile, r, c, v, which != 0 || remote_q, peer);
    }
  }
}

// One cluster (two CTAs) per (batch element b, head h); CTA `rank` projects
// rows [128 rank, 128 rank + 128), warpgroup w the query tile 2 rank + w,
// and writes that tile of `a` (B, N, C) at the head's 64 columns.
template <int C, int NW>
__global__ void __launch_bounds__(kThreads, 1)
heads_fwd(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mwq,
          const __grid_constant__ CUtensorMap mwk, const __grid_constant__ CUtensorMap mwv,
          const __grid_constant__ CUtensorMap ma, const bf16* __restrict__ x,
          const float* __restrict__ ln_s, const float* __restrict__ ln_b,
          const float* __restrict__ bq, const float* __restrict__ bk,
          const float* __restrict__ bv, int N, int H, float eps, float scale_log2) {
  using L = HeadsCfg<false>;
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* Qs = base;
  unsigned char* Ks = base + L::OFF_K;
  unsigned char* Vs = base + L::OFF_V;
  unsigned char* ring = base + L::OFF_RING;
  float* stats = reinterpret_cast<float*>(base + L::OFF_STATS);
  auto* bars = reinterpret_cast<Bars<L::S>*>(base + L::OFF_BARS);
  const uint32_t rank = cluster_rank();
  const int bh = blockIdx.x >> 1, b = bh / H, h = bh % H;
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) init_bars(bars);
  cluster_sync();

  if (wgi == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 288) {   // one warp; lane i starts box i of a stage
      const int lane = threadIdx.x & 31;
      wring::Pipe<L::S> p;
      for (int kt = 0; kt < C / 64; ++kt) {
        wring::acquire(bars->full, bars->empty, p, kStageB, lane);
        unsigned char* st = ring + p.s * kStageB;
        if (lane < 2)
          tma_load_3d(st + lane * kTileB, &mx, &bars->full[p.s], 64 * kt, 64 * (2 * rank + lane), b);
        else if (lane < 5)
          tma_load_2d(st + kSlabB + (lane - 2) * kTileB, lane == 2 ? &mwq : (lane == 3 ? &mwk : &mwv),
                      &bars->full[p.s], h * HD, 64 * kt);
        p.next();
      }
    }
    cluster_sync();
  } else {
    regs_inc<kConsumerRegs>();
    const int w = wgi, wl = threadIdx.x & 127;
    const int warp = wl >> 5, lane = wl & 31, g = lane >> 2, t = lane & 3;
    const int i = 2 * rank + w;                      // the warpgroup's row tile
    const int live_rows = min(64, max(0, N - 64 * i));
    float* mean = stats + 64 * w;
    float* rstd = stats + 128 + 64 * w;
    row_stats<C>(mean, rstd, x + (size_t)b * N * C, 64 * i, N, eps, warp, lane);
    named_barrier(1 + w, 128);

    float acc[96];
    wring::Pipe<L::S> p;
    project_qkv<C>(acc, ring, bars, p, mean, rstd, ln_s, ln_b, w, live_rows, wl, lane);
    unsigned char* Qt = Qs + w * kTileB;
    qkv_to_tiles(acc, Qt, Ks + i * kTileB, Vs + i * kTileB, bq, bk, bv, h, live_rows, false,
                 rank ^ 1, warp, g, t);
    fence_async_all();
    cluster_sync();   // every K and V tile is in both CTAs

    if (live_rows > 0) {
      float o[32], m[2], l[2];
      wg::fwd_tile<NW>(o, m, l, reinterpret_cast<const bf16*>(Qt), reinterpret_cast<const bf16*>(Ks),
                   reinterpret_cast<const bf16*>(Vs), N, scale_log2, t, [] {});
      // the attention output over the Q tile (its products are done)
      wg::acc_to_tile(Qt, o, warp, g, t);
      fence_async_shared();
      named_barrier(1 + w, 128);
      if (wl == 0) {
        tma_store_3d(&ma, Qt, h * HD, 64 * i, b);
        tma_store_commit();
        tma_store_wait_read();
      }
    }
  }
}

// The backward of the same cluster: LN, q/k/v and da = dy Wo[head rows]^T
// recomputed and shared with the peer, each row's log-sum-exp and D, then
// dq of query tile 2 rank + w and dk, dv of key block 2 rank + w.
template <int C, int NW>
__global__ void __launch_bounds__(kThreads, 1)
heads_bwd(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mdy,
          const __grid_constant__ CUtensorMap mwq, const __grid_constant__ CUtensorMap mwk,
          const __grid_constant__ CUtensorMap mwv, const __grid_constant__ CUtensorMap mwo,
          const __grid_constant__ CUtensorMap mdq, const __grid_constant__ CUtensorMap mdk,
          const __grid_constant__ CUtensorMap mdv, const bf16* __restrict__ x,
          const float* __restrict__ ln_s, const float* __restrict__ ln_b,
          const float* __restrict__ bq, const float* __restrict__ bk,
          const float* __restrict__ bv, int N, int H, float eps, float scale, float scale_log2) {
  using L = HeadsCfg<true>;
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* Qs = base;
  unsigned char* Ks = base + L::OFF_K;
  unsigned char* Vs = base + L::OFF_V;
  unsigned char* dAs = base + L::OFF_DA;
  unsigned char* ring = base + L::OFF_RING;
  float* stats = reinterpret_cast<float*>(base + L::OFF_STATS);
  float* lse2 = stats + 256;   // per query row, log2 domain; +inf past N
  float* Dr = stats + 512;
  auto* bars = reinterpret_cast<Bars<L::S>*>(base + L::OFF_BARS);
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;
  const int bh = blockIdx.x >> 1, b = bh / H, h = bh % H;
  const int wgi = threadIdx.x >> 7;
  constexpr int KT = C / 64;

  if (threadIdx.x == 0) init_bars(bars);
  cluster_sync();

  if (wgi == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      wring::Pipe<L::S> p;
      for (int kt = 0; kt < KT; ++kt) {   // x and Wq | Wk | Wv
        wring::acquire(bars->full, bars->empty, p, kStageB, lane);
        unsigned char* st = ring + p.s * kStageB;
        if (lane < 2)
          tma_load_3d(st + lane * kTileB, &mx, &bars->full[p.s], 64 * kt, 64 * (2 * rank + lane), b);
        else if (lane < 5)
          tma_load_2d(st + kSlabB + (lane - 2) * kTileB, lane == 2 ? &mwq : (lane == 3 ? &mwk : &mwv),
                      &bars->full[p.s], h * HD, 64 * kt);
        p.next();
      }
      for (int kt = 0; kt < KT; ++kt) {   // dy and the head's 64 rows of Wo
        wring::acquire(bars->full, bars->empty, p, kSlabB + kTileB, lane);
        unsigned char* st = ring + p.s * kStageB;
        if (lane < 2)
          tma_load_3d(st + lane * kTileB, &mdy, &bars->full[p.s], 64 * kt, 64 * (2 * rank + lane), b);
        else if (lane == 2)
          tma_load_2d(st + kSlabB, &mwo, &bars->full[p.s], 64 * kt, h * HD);
        p.next();
      }
    }
    cluster_sync();
    cluster_sync();
  } else {
    regs_inc<kConsumerRegs>();
    const int w = wgi, wl = threadIdx.x & 127;
    const int warp = wl >> 5, lane = wl & 31, g = lane >> 2, t = lane & 3;
    const int i = 2 * rank + w;
    const int live_rows = min(64, max(0, N - 64 * i));
    float* mean = stats + 64 * w;
    float* rstd = stats + 128 + 64 * w;
    row_stats<C>(mean, rstd, x + (size_t)b * N * C, 64 * i, N, eps, warp, lane);
    named_barrier(1 + w, 128);

    wring::Pipe<L::S> p;
    {
      float acc[96];
      project_qkv<C>(acc, ring, bars, p, mean, rstd, ln_s, ln_b, w, live_rows, wl, lane);
      qkv_to_tiles(acc, Qs + i * kTileB, Ks + i * kTileB, Vs + i * kTileB, bq, bk, bv, h,
                   live_rows, true, peer, warp, g, t);
    }
    {
      // da (this warpgroup's 64 rows) = dy Wo[h*64 .. h*64 + 63, :]^T
      float da[32];
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&bars->full[p.s], p.ph);
        unsigned char* st = ring + p.s * kStageB;
        const uint64_t a = mdesc(st + w * kTileB), bo = mdesc(st + kSlabB);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<64>::template ss<0, 0>(da, madvance(a, 32 * kk), madvance(bo, 32 * kk), kt | kk);
        wring::commit_stage(bars->empty, p, lane);
      }
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          put_pair(dAs + i * kTileB, warp * 16 + g + 8 * hi, 8 * jt + 2 * t,
                   pack_bf16(da[4 * jt + 2 * hi], da[4 * jt + 2 * hi + 1]), true, peer);
      }
    }
    fence_async_all();
    cluster_sync();   // Q, K, V and da whole in both CTAs

    const int NB = (N + 63) / 64;
    const int r0 = 64 * i + warp * 16 + g;   // this thread's rows: r0 and r0 + 8
    if (i < NB) {
      // each row's log-sum-exp (log2 domain) and D = rowsum(da * o), o = P V in f32
      float o[32], m[2], l[2];
      wg::fwd_tile<NW>(o, m, l, reinterpret_cast<const bf16*>(Qs + i * kTileB),
                   reinterpret_cast<const bf16*>(Ks), reinterpret_cast<const bf16*>(Vs), N,
                   scale_log2, t, [] {});
      const unsigned char* dat = dAs + i * kTileB;
      float d[2] = {0.f, 0.f};
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float2 av = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              dat + swz(warp * 16 + g + 8 * hi, 8 * jt + 2 * t)));
          d[hi] += o[4 * jt + 2 * hi] * av.x + o[4 * jt + 2 * hi + 1] * av.y;
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float dd = quad_sum(d[hi]);
        if (t == 0) {
          const int row = r0 + 8 * hi;
          const float ls = row < N ? m[hi] + log2f(l[hi]) : INFINITY;
          const float dv = row < N ? dd : 0.f;
          lse2[row] = ls;
          Dr[row] = dv;
          st_cluster_f32(mapa(saddr(lse2 + row), peer), ls);
          st_cluster_f32(mapa(saddr(Dr + row), peer), dv);
        }
      }
    }
    cluster_sync();   // every row's statistics in both CTAs

    const wg::BwdTiles tiles{reinterpret_cast<const bf16*>(Qs), reinterpret_cast<const bf16*>(Ks),
                             reinterpret_cast<const bf16*>(Vs), reinterpret_cast<const bf16*>(dAs),
                             lse2, Dr};
    const int NL = (N - (NB - 1) * 64 + 15) & ~15;   // the last block's width
    unsigned char* stage = ring + w * kTileB;        // the ring is free: staging tiles
    if (i < NB) {
      // dq of query tile i
      const float l0 = lse2[r0], l1 = lse2[r0 + 8], D0 = Dr[r0], D1 = Dr[r0 + 8];
      float dq[32];
      for (int j = 0; j < NB - 1; ++j)
        wg::dq_block<64>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
      const int j = NB - 1;
      if (NL == 64)
        wg::dq_block<64>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
      else if (NL == 48)
        wg::dq_block<48>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
      else if (NL == 32)
        wg::dq_block<32>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
      else
        wg::dq_block<16>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
      wg::store_block(&mdq, stage, dq, h * HD, 64 * i, b, w, wl);

      // dk, dv of key block i
      const bool valid0 = r0 < N, valid1 = r0 + 8 < N;
      float dk[32], dv[32];
      for (int q = 0; q < NB - 1; ++q)
        wg::dkv_block<64>(dk, dv, tiles, q, i, scale, scale_log2, valid0, valid1, t);
      const int q = NB - 1;
      if (NL == 64)
        wg::dkv_block<64>(dk, dv, tiles, q, i, scale, scale_log2, valid0, valid1, t);
      else if (NL == 48)
        wg::dkv_block<48>(dk, dv, tiles, q, i, scale, scale_log2, valid0, valid1, t);
      else if (NL == 32)
        wg::dkv_block<32>(dk, dv, tiles, q, i, scale, scale_log2, valid0, valid1, t);
      else
        wg::dkv_block<16>(dk, dv, tiles, q, i, scale, scale_log2, valid0, valid1, t);
      wg::store_block(&mdk, stage, dk, h * HD, 64 * i, b, w, wl);
      wg::store_block(&mdv, stage, dv, h * HD, 64 * i, b, w, wl);
      if (wl == 0) tma_store_wait_read();
    }
  }
}

// Shared memory of the row-block kernels.
struct RowsCfg {
  static constexpr int S = 4;
  static constexpr int OFF_STAGE = S * kStageB;            // 6 staging tiles: 128 x 192 bf16
  static constexpr int OFF_STATS = OFF_STAGE + 6 * kTileB;  // mean, rstd (128); row sums [4][128][2]
  static constexpr int OFF_BARS = OFF_STATS + (256 + 4 * 256) * 4;
  static constexpr size_t SMEM = 1024 + OFF_BARS + sizeof(Bars<S>);
  static_assert(SMEM <= kSmemMax, "shared memory of a CTA");
};

// A warpgroup's 64 x 192 result (the f32 value of each element pair from
// `value(e)`, rounded) through its three staging tiles to columns n0.. of
// rows row0.. of the (T, C) tensor behind `map`.
template <typename Value>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, unsigned char* stage,
                                           Value value, int n0, int row0, int w, int wl) {
  const int warp = wl >> 5, g = (wl & 31) >> 2, t = wl & 3;
  unsigned char* st = stage + 3 * w * kTileB;
#pragma unroll
  for (int jt = 0; jt < 24; ++jt) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float2 v = value(4 * jt + 2 * hi);
      *reinterpret_cast<uint32_t*>(st + (jt >> 3) * kTileB +
                                   swz(warp * 16 + g + 8 * hi, 8 * (jt & 7) + 2 * t)) =
          pack_bf16(v.x, v.y);
    }
  }
  fence_async_shared();
  named_barrier(1 + w, 128);
  if (wl == 0) {
    for (int q = 0; q < 3; ++q) tma_store_2d(map, st + q * kTileB, n0 + 64 * q, row0);
    tma_store_commit();
    tma_store_wait_read();
  }
}

// out (T, C) = a (T, C) Wo + bo: a CTA per 128 rows x 192 columns.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
oproj_fwd(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mwo,
          const __grid_constant__ CUtensorMap mout, const float* __restrict__ bo) {
  using L = RowsCfg;
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* ring = base;
  auto* bars = reinterpret_cast<Bars<L::S>*>(base + L::OFF_BARS);
  const int row0 = 128 * (blockIdx.x / (C / 192)), n0 = 192 * (blockIdx.x % (C / 192));
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) init_bars(bars);
  __syncthreads();

  if (wgi == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      wring::Pipe<L::S> p;
      for (int kt = 0; kt < C / 64; ++kt) {
        wring::acquire(bars->full, bars->empty, p, kStageB, lane);
        unsigned char* st = ring + p.s * kStageB;
        if (lane < 2)
          tma_load_2d(st + lane * kTileB, &ma, &bars->full[p.s], 64 * kt, row0 + 64 * lane);
        else if (lane < 5)
          tma_load_2d(st + kSlabB + (lane - 2) * kTileB, &mwo, &bars->full[p.s],
                      n0 + 64 * (lane - 2), 64 * kt);
        p.next();
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int w = wgi, wl = threadIdx.x & 127, lane = wl & 31, t = wl & 3;
    float acc[96];
    wring::Pipe<L::S> p;
    for (int kt = 0; kt < C / 64; ++kt) {
      mbar_wait(&bars->full[p.s], p.ph);
      unsigned char* st = ring + p.s * kStageB;
      const uint64_t a = mdesc(st + w * kTileB), b = mdesc(st + kSlabB, kTileB, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<192>::template ss<0, 1>(acc, madvance(a, 32 * kk), madvance(b, 2048 * kk), kt | kk);
      wring::commit_stage(bars->empty, p, lane);
    }
    store_rows(&mout, base + L::OFF_STAGE, [&](int e) {
      const float2 bias = __ldg(reinterpret_cast<const float2*>(bo + n0 + 8 * (e >> 2) + 2 * t));
      return make_float2(acc[e] + bias.x, acc[e + 1] + bias.y);
    }, n0, row0 + 64 * w, w, wl);
  }
}

// dx (T, C) = the LayerNorm backward of dh = dq Wq^T + dk Wk^T + dv Wv^T: a
// cluster of C / 192 CTAs per 128 rows, CTA `rank` the columns 192 rank..
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
dh_bwd(const __grid_constant__ CUtensorMap mdq, const __grid_constant__ CUtensorMap mdk,
       const __grid_constant__ CUtensorMap mdv, const __grid_constant__ CUtensorMap mwq,
       const __grid_constant__ CUtensorMap mwk, const __grid_constant__ CUtensorMap mwv,
       const __grid_constant__ CUtensorMap mdx, const bf16* __restrict__ x,
       const float* __restrict__ ln_s, int T, float eps) {
  using L = RowsCfg;
  constexpr int CL = C / 192, KT = C / 64;
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* ring = base;
  float* stats = reinterpret_cast<float*>(base + L::OFF_STATS);
  float* sums = stats + 256;   // [rank of the cluster][row of 128][2]
  auto* bars = reinterpret_cast<Bars<L::S>*>(base + L::OFF_BARS);
  const int rank = CL > 1 ? (int)cluster_rank() : 0;
  const int row0 = 128 * (blockIdx.x / CL), n0 = 192 * rank;
  const int wgi = threadIdx.x >> 7;

  if (threadIdx.x == 0) init_bars(bars);
  cluster_sync();

  if (wgi == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x < 288) {
      const int lane = threadIdx.x & 31;
      wring::Pipe<L::S> p;
      for (int src = 0; src < 3; ++src) {
        const CUtensorMap* md = src == 0 ? &mdq : (src == 1 ? &mdk : &mdv);
        const CUtensorMap* mw = src == 0 ? &mwq : (src == 1 ? &mwk : &mwv);
        for (int kt = 0; kt < KT; ++kt) {
          wring::acquire(bars->full, bars->empty, p, kStageB, lane);
          unsigned char* st = ring + p.s * kStageB;
          if (lane < 2)
            tma_load_2d(st + lane * kTileB, md, &bars->full[p.s], 64 * kt, row0 + 64 * lane);
          else if (lane == 2)
            tma_load_2d(st + kSlabB, mw, &bars->full[p.s], 64 * kt, n0);
          p.next();
        }
      }
    }
    cluster_sync();
  } else {
    regs_inc<kConsumerRegs>();
    const int w = wgi, wl = threadIdx.x & 127;
    const int warp = wl >> 5, lane = wl & 31, g = lane >> 2, t = lane & 3;
    float* mean = stats + 64 * w;
    float* rstd = stats + 128 + 64 * w;
    row_stats<C>(mean, rstd, x, row0 + 64 * w, T, eps, warp, lane);

    float acc[96];
    wring::Pipe<L::S> p;
    for (int kt = 0; kt < 3 * KT; ++kt) {
      mbar_wait(&bars->full[p.s], p.ph);
      unsigned char* st = ring + p.s * kStageB;
      const uint64_t a = mdesc(st + w * kTileB), bw = mdesc(st + kSlabB);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<192>::template ss<0, 0>(acc, madvance(a, 32 * kk), madvance(bw, 32 * kk), kt | kk);
      wring::commit_stage(bars->empty, p, lane);
    }
    named_barrier(1 + w, 128);   // the warpgroup's row statistics

    // the LayerNorm backward on the accumulators: dn = dh * scale and the
    // normalised row n; row sums of dn and dn * n over this CTA's columns,
    // then over the cluster in rank order
    const int rl = warp * 16 + g;   // this thread's rows of the warpgroup: rl, rl + 8
    float mu[2], rs[2];
    const bf16* xr[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mu[hi] = mean[rl + 8 * hi];
      rs[hi] = rstd[rl + 8 * hi];
      const int row = row0 + 64 * w + rl + 8 * hi;
      xr[hi] = x + (size_t)(row < T ? row : 0) * C;
    }
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int jt = 0; jt < 24; ++jt) {
      const int col = n0 + 8 * jt + 2 * t;
      const float2 sc = __ldg(reinterpret_cast<const float2*>(ln_s + col));
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr[hi] + col));
        float& d0 = acc[4 * jt + 2 * hi];
        float& d1 = acc[4 * jt + 2 * hi + 1];
        d0 *= sc.x;
        d1 *= sc.y;
        s1[hi] += d0 + d1;
        s2[hi] += d0 * ((xv.x - mu[hi]) * rs[hi]) + d1 * ((xv.y - mu[hi]) * rs[hi]);
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      s1[hi] = quad_sum(s1[hi]);
      s2[hi] = quad_sum(s2[hi]);
      if (t == 0) {
        float* slot = sums + (rank * 128 + 64 * w + rl + 8 * hi) * 2;
        slot[0] = s1[hi];
        slot[1] = s2[hi];
        for (int q = 0; q < CL; ++q) {
          if (q == rank) continue;
          st_cluster_f32(mapa(saddr(slot), q), s1[hi]);
          st_cluster_f32(mapa(saddr(slot + 1), q), s2[hi]);
        }
      }
    }
    cluster_sync();
    float m1[2], m2[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        a += sums[(q * 128 + 64 * w + rl + 8 * hi) * 2];
        c += sums[(q * 128 + 64 * w + rl + 8 * hi) * 2 + 1];
      }
      m1[hi] = a * (1.f / C);
      m2[hi] = c * (1.f / C);
    }
    store_rows(&mdx, base + L::OFF_STAGE, [&](int e) {
      const int hi = (e >> 1) & 1, col = n0 + 8 * (e >> 2) + 2 * t;
      const float2 xv =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr[hi] + col));
      return make_float2(
          rs[hi] * (acc[e] - m1[hi] - (xv.x - mu[hi]) * rs[hi] * m2[hi]),
          rs[hi] * (acc[e + 1] - m1[hi] - (xv.y - mu[hi]) * rs[hi] * m2[hi]));
    }, n0, row0 + 64 * w, w, wl);
  }
}

// --- host ------------------------------------------------------------------------

// A (rows, cols) row-major bf16 matrix in boxes of `box_rows` x 64.
bool matrix_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  return make_map(map, p, 2, dims, strides, (uint32_t)box_rows);
}

// (B, N, C) bf16 in 64-row boxes of one batch element.
bool batch_map(CUtensorMap* map, const void* p, int B, int N, int C) {
  const uint64_t dims[3] = {(uint64_t)C, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)C * 2, (uint64_t)N * C * 2};
  return make_map(map, p, 3, dims, strides, 64);
}

template <typename Kernel, typename... KArgs>
int launch(Kernel kernel, int grid, int cluster, size_t smem, cudaStream_t stream,
           KArgs... args) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  if (fa.numRegs < kEntryRegs) return kRegError;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int C, int NW>
int run_fwd(const Args& p, bf16* a, bf16* out) {
  const int T = p.B * p.N;
  CUtensorMap mx, mwq, mwk, mwv, mwo, ma3, ma2, mout;
  if (!batch_map(&mx, p.x, p.B, p.N, C) || !matrix_map(&mwq, p.wq, C, C, 64) ||
      !matrix_map(&mwk, p.wk, C, C, 64) || !matrix_map(&mwv, p.wv, C, C, 64) ||
      !matrix_map(&mwo, p.wo, C, C, 64) || !batch_map(&ma3, a, p.B, p.N, C) ||
      !matrix_map(&ma2, a, T, C, 64) || !matrix_map(&mout, out, T, C, 64))
    return kMapError;
  int rc = launch(heads_fwd<C, NW>, 2 * p.B * p.H, 2, HeadsCfg<false>::SMEM, p.stream, mx, mwq,
                  mwk, mwv, ma3, p.x, p.ln_s, p.ln_b, p.bq, p.bk, p.bv, p.N, p.H, p.eps,
                  0.125f * wg::kLog2e);
  if (rc != 0) return rc;
  return launch(oproj_fwd<C>, (T + 127) / 128 * (C / 192), 1, RowsCfg::SMEM, p.stream, ma2, mwo,
                mout, p.bo);
}

template <int C, int NW>
int run_bwd(const Args& p, const bf16* dy, bf16* dq, bf16* dk, bf16* dv, bf16* dx) {
  const int T = p.B * p.N;
  CUtensorMap mx, mdy, mwq, mwk, mwv, mwo, mdq3, mdk3, mdv3, mdq2, mdk2, mdv2, mwq1, mwk1, mwv1,
      mdx;
  if (!batch_map(&mx, p.x, p.B, p.N, C) || !batch_map(&mdy, dy, p.B, p.N, C) ||
      !matrix_map(&mwq, p.wq, C, C, 64) || !matrix_map(&mwk, p.wk, C, C, 64) ||
      !matrix_map(&mwv, p.wv, C, C, 64) || !matrix_map(&mwo, p.wo, C, C, 64) ||
      !batch_map(&mdq3, dq, p.B, p.N, C) || !batch_map(&mdk3, dk, p.B, p.N, C) ||
      !batch_map(&mdv3, dv, p.B, p.N, C) || !matrix_map(&mdq2, dq, T, C, 64) ||
      !matrix_map(&mdk2, dk, T, C, 64) || !matrix_map(&mdv2, dv, T, C, 64) ||
      !matrix_map(&mwq1, p.wq, C, C, 192) || !matrix_map(&mwk1, p.wk, C, C, 192) ||
      !matrix_map(&mwv1, p.wv, C, C, 192) || !matrix_map(&mdx, dx, T, C, 64))
    return kMapError;
  int rc = launch(heads_bwd<C, NW>, 2 * p.B * p.H, 2, HeadsCfg<true>::SMEM, p.stream, mx, mdy,
                  mwq, mwk, mwv, mwo, mdq3, mdk3, mdv3, p.x, p.ln_s, p.ln_b, p.bq, p.bk, p.bv, p.N,
                  p.H, p.eps, 0.125f, 0.125f * wg::kLog2e);
  if (rc != 0) return rc;
  return launch(dh_bwd<C>, (T + 127) / 128 * (C / 192), C / 192, RowsCfg::SMEM, p.stream, mdq2,
                mdk2, mdv2, mwq1, mwk1, mwv1, mdx, p.x, p.ln_s, T, p.eps);
}

template <int C>
int fwd(const Args& p, bf16* a, bf16* out) {
  if (p.N <= 64) return run_fwd<C, 64>(p, a, out);
  if (p.N <= 128) return run_fwd<C, 128>(p, a, out);
  if (p.N <= 208) return run_fwd<C, 208>(p, a, out);
  return run_fwd<C, 256>(p, a, out);
}

template <int C>
int bwd(const Args& p, const bf16* dy, bf16* dq, bf16* dk, bf16* dv, bf16* dx) {
  if (p.N <= 64) return run_bwd<C, 64>(p, dy, dq, dk, dv, dx);
  if (p.N <= 128) return run_bwd<C, 128>(p, dy, dq, dk, dv, dx);
  if (p.N <= 208) return run_bwd<C, 208>(p, dy, dq, dk, dv, dx);
  return run_bwd<C, 256>(p, dy, dq, dk, dv, dx);
}

}  // namespace wgb

bool supported(int B, int N, int C, int H) {
  return B >= 1 && N >= 1 && N <= 256 && H >= 1 && C == H * 64;
}

Args make_args(const void* x, const void* ln_s, const void* ln_b, const void* wq, const void* bq,
               const void* wk, const void* bk, const void* wv, const void* bv, const void* wo,
               const void* bo, int B, int N, int H, float eps, void* stream) {
  return Args{static_cast<const bf16*>(x),     static_cast<const bf16*>(wq),
              static_cast<const bf16*>(wk),    static_cast<const bf16*>(wv),
              static_cast<const bf16*>(wo),    static_cast<const float*>(ln_s),
              static_cast<const float*>(ln_b), static_cast<const float*>(bq),
              static_cast<const float*>(bk),   static_cast<const float*>(bv),
              static_cast<const float*>(bo),   B, N, H, eps, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// x (B, N, C) bf16; ln_s, ln_b, bq, bk, bv, bo (C) f32; wq, wk, wv, wo (C, C)
// bf16 -> out (B, N, C) bf16. `a` (B, N, C) bf16 is scratch.
int apvt_attn_block_fwd(const void* x, const void* ln_s, const void* ln_b, const void* wq,
                        const void* bq, const void* wk, const void* bk, const void* wv,
                        const void* bv, const void* wo, const void* bo, void* a, void* out, int B,
                        int N, int C, int H, float eps, void* stream) {
  if (!supported(B, N, C, H)) return -1;
  const Args p = make_args(x, ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, B, N, H, eps, stream);
  bf16* aa = static_cast<bf16*>(a);
  bf16* oo = static_cast<bf16*>(out);
  switch (C) {
    case 192: return wgb::fwd<192>(p, aa, oo);
    case 384: return wgb::fwd<384>(p, aa, oo);
    case 768: return wgb::fwd<768>(p, aa, oo);
    default: return -1;
  }
}

// ... and the cotangent dy (B, N, C) bf16 -> dx (B, N, C) bf16. dq, dk, dv
// (B, N, C) bf16 are scratch.
int apvt_attn_block_bwd(const void* x, const void* ln_s, const void* ln_b, const void* wq,
                        const void* bq, const void* wk, const void* bk, const void* wv,
                        const void* bv, const void* wo, const void* dy, void* dq, void* dk,
                        void* dv, void* dx, int B, int N, int C, int H, float eps, void* stream) {
  if (!supported(B, N, C, H)) return -1;
  const Args p =
      make_args(x, ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, nullptr, B, N, H, eps, stream);
  const bf16* g = static_cast<const bf16*>(dy);
  bf16* q = static_cast<bf16*>(dq);
  bf16* k = static_cast<bf16*>(dk);
  bf16* v = static_cast<bf16*>(dv);
  bf16* o = static_cast<bf16*>(dx);
  switch (C) {
    case 192: return wgb::bwd<192>(p, g, q, k, v, o);
    case 384: return wgb::bwd<384>(p, g, q, k, v, o);
    case 768: return wgb::bwd<768>(p, g, q, k, v, o);
    default: return -1;
  }
}

// The same on the first design's device code, at the ViT-B width only (C = 768, 64 <
// N, as far as its shared memory holds the shape; -1 elsewhere): for timing
// the Hopper kernels against it (chip_smoke.py); no model path calls these.
int apvt_attn_block_fwd_mma_sync(const void* x, const void* ln_s, const void* ln_b,
                                 const void* wq, const void* bq, const void* wk, const void* bk,
                                 const void* wv, const void* bv, const void* wo, const void* bo,
                                 void* a, void* out, int B, int N, int C, int H, float eps,
                                 void* stream) {
  if (!supported(B, N, C, H)) return -1;
  const Args p = make_args(x, ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, B, N, H, eps, stream);
  bf16* aa = static_cast<bf16*>(a);
  bf16* oo = static_cast<bf16*>(out);
  return C == 768 && N > 64 ? mma_sync::run_fwd<768, 256>(p, aa, oo) : -1;
}

int apvt_attn_block_bwd_mma_sync(const void* x, const void* ln_s, const void* ln_b,
                                 const void* wq, const void* bq, const void* wk, const void* bk,
                                 const void* wv, const void* bv, const void* wo, const void* dy,
                                 void* dq, void* dk, void* dv, void* dx, int B, int N, int C,
                                 int H, float eps, void* stream) {
  if (!supported(B, N, C, H)) return -1;
  const Args p =
      make_args(x, ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, nullptr, B, N, H, eps, stream);
  const bf16* g = static_cast<const bf16*>(dy);
  bf16* q = static_cast<bf16*>(dq);
  bf16* k = static_cast<bf16*>(dk);
  bf16* v = static_cast<bf16*>(dv);
  bf16* o = static_cast<bf16*>(dx);
  return C == 768 && N > 64 ? mma_sync::run_bwd<768, 256>(p, g, q, k, v, o) : -1;
}

// Dynamic shared memory of the Hopper kernels in bytes: 0 heads_fwd, 1
// oproj_fwd, 2 heads_bwd, 3 dh_bwd (kernels/attn_block.py:_smem_bytes
// mirrors 0 and 2); -1 for another index.
int apvt_attn_block_smem(int which) {
  switch (which) {
    case 0: return (int)wgb::HeadsCfg<false>::SMEM;
    case 2: return (int)wgb::HeadsCfg<true>::SMEM;
    case 1:
    case 3: return (int)wgb::RowsCfg::SMEM;
    default: return -1;
  }
}

const char* apvt_attn_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
