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
//   dq, dk, dv = the softmax-attention backward of attn_core.cuh (rounded to bf16)
//   dh         = dq Wq^T + dk Wk^T + dv Wv^T (f32)
//   dx         = the f32 LayerNorm backward of dh, rounded once.
// Parameter gradients are not computed here: the wrapper recomputes them in
// plain PyTorch only when a caller asks for them, as the JAX VJP leaves them
// to XLA.
//
// What bounds it on the H100: 8 N C^2 + 4 N^2 C FLOP per batch element
// forward (67 GFLOP at B = 64, N = 197, C = 768) against 2 N C bytes in and
// out plus 8 C^2 bytes of weights: ~1600 FLOP/byte, far above the bf16 ridge
// (~295), so the tensor cores are the limit, if h, q, k, v and P stay on
// chip.
//
// What the design does about it:
// * the TPU program holds one batch element, all four weights and two
//   (H, N, N) f32 score buffers in its fast memory (over 8 MB). A CTA here
//   has 227 KB, so the work of a batch element is cut by head: one CTA per
//   (batch element, head) normalises the N rows in blocks of 32 (f32, a warp
//   per row), forms its head's q, k, v tiles (N x 64 each) from the
//   normalised block and the head's 64 columns of Wq, Wk, Wv, which stream
//   from L2 in slabs of 64 contraction rows through a cp.async double
//   buffer, and keeps the three tiles in shared memory. The attention core
//   then runs on them exactly as in the packed-attention kernel (a warp per
//   16 query rows, the whole score row in registers). h, q, k, v and P never
//   reach device memory. 12 CTAs of a batch element each normalise its rows:
//   the rows come from L2 and the LayerNorm is a small part of the work;
// * the o-projection contracts over all heads, that is over CTAs. The
//   attention output `a` (rounded to bf16 there in any case) goes through a
//   bf16 scratch tensor (B, N, C) to a second kernel, a row-block GEMM with
//   the bias in its epilogue. In the backward the same holds for dh: dq, dk,
//   dv (rounded to bf16 there in any case) go through three scratch tensors
//   to a second kernel that forms dh for 32 rows x C in f32 registers and
//   runs the LayerNorm backward on it in shared memory. One sum, one owner,
//   a fixed order: no atomics, results are bitwise reproducible. The scratch
//   round trip costs 2 x 2 N C bytes per batch element forward and 2 x 6 N C
//   backward (77 and 232 MB at the ViT-B shape, 23 and 69 us at 3.35 TB/s);
// * da needs only the head's 64 rows of Wo (as the [n][k] operand, read
//   without a transposed copy), so each head's CTA forms its own da tile from
//   the dy rows: the cotangent never takes a scratch round trip;
// * every product is mma.sync m16n8k16 (bf16 in, f32 out) with ldmatrix
//   operands; the ragged N (197) is masked in the kernel: rows >= N of the
//   tiles are zero, keys >= N get P = 0, rows >= N are never written.
// The weights are re-read from L2 once per block of 32 rows in both kernels
// (the same limit as ln_mlp.cu); a CTA per head leaves the tensor cores idle
// while a warp does the softmax of its rows.
//
// Takes bf16, head dim 64, C in {192, 384, 768}, N <= 256 as far as the
// tiles fit in shared memory. C interface (loaded with ctypes): each entry
// point returns the CUDA error code of its launches (cudaGetLastError), 0 on
// success, -1 for an unsupported shape.

#include "attn_core.cuh"

namespace {

using namespace apvt;
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

// Wait for slab i (the newest but one when slab i + 1 was just issued).
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

struct Args {
  const bf16 *x, *wq, *wk, *wv, *wo;
  const float *ln_s, *ln_b, *bq, *bk, *bv, *bo;
  int B, N, H;
  float eps;
  cudaStream_t stream;
};

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

bool supported(int B, int N, int C, int H) {
  return B >= 1 && N >= 1 && N <= 256 && H >= 1 && C == H * HD;
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
  const Args p{static_cast<const bf16*>(x),    static_cast<const bf16*>(wq),
               static_cast<const bf16*>(wk),   static_cast<const bf16*>(wv),
               static_cast<const bf16*>(wo),   static_cast<const float*>(ln_s),
               static_cast<const float*>(ln_b), static_cast<const float*>(bq),
               static_cast<const float*>(bk),  static_cast<const float*>(bv),
               static_cast<const float*>(bo),  B, N, H, eps, static_cast<cudaStream_t>(stream)};
  bf16* aa = static_cast<bf16*>(a);
  bf16* oo = static_cast<bf16*>(out);
  const bool small = N <= 64;
  switch (C) {
    case 192: return small ? run_fwd<192, 64>(p, aa, oo) : run_fwd<192, 256>(p, aa, oo);
    case 384: return small ? run_fwd<384, 64>(p, aa, oo) : run_fwd<384, 256>(p, aa, oo);
    case 768: return small ? run_fwd<768, 64>(p, aa, oo) : run_fwd<768, 256>(p, aa, oo);
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
  const Args p{static_cast<const bf16*>(x),    static_cast<const bf16*>(wq),
               static_cast<const bf16*>(wk),   static_cast<const bf16*>(wv),
               static_cast<const bf16*>(wo),   static_cast<const float*>(ln_s),
               static_cast<const float*>(ln_b), static_cast<const float*>(bq),
               static_cast<const float*>(bk),  static_cast<const float*>(bv),
               nullptr,                        B, N, H, eps, static_cast<cudaStream_t>(stream)};
  const bf16* g = static_cast<const bf16*>(dy);
  bf16* q = static_cast<bf16*>(dq);
  bf16* k = static_cast<bf16*>(dk);
  bf16* v = static_cast<bf16*>(dv);
  bf16* o = static_cast<bf16*>(dx);
  const bool small = N <= 64;
  switch (C) {
    case 192: return small ? run_bwd<192, 64>(p, g, q, k, v, o) : run_bwd<192, 256>(p, g, q, k, v, o);
    case 384: return small ? run_bwd<384, 64>(p, g, q, k, v, o) : run_bwd<384, 256>(p, g, q, k, v, o);
    case 768: return small ? run_bwd<768, 64>(p, g, q, k, v, o) : run_bwd<768, 256>(p, g, q, k, v, o);
    default: return -1;
  }
}

const char* apvt_attn_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
