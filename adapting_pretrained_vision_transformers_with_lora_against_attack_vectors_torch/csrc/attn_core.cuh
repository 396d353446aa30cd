// The tensor-core attention core shared by attention_packed.cu (packed and
// head-major multi-head attention) and attn_block.cu (the fused attention
// half-block): for one head whose Q, K, V (and dO) tiles lie in shared
// memory as bf16 with rows padded by 16 bytes, the f32 softmax of the scaled
// scores and the products around it, every product on mma.sync m16n8k16.
// A warp owns 16 query rows (forward, backward phase 1) or 16 key rows
// (backward phase 2); a whole 16 x N score block lives in registers
// (N <= KMAX), so the softmax is the exact two-pass max/sum, not an online
// rescaling. P is rounded to bf16 before P.V and P^T.dO, dS before dS.K and
// dS^T.Q; every sum has one owner and a fixed order (bitwise reproducible).
// Keys >= N get P = 0 and rows >= N are never written; tile rows in
// [N, NP), NP = N rounded up to 16, must hold finite values.

#pragma once

#include "tiles.cuh"

namespace apvt {
namespace tc {

template <int HD>
struct Shape {
  static constexpr int kStride = HD + 8;  // bf16 per shared-memory row
};

// N rows of HD values, row stride `rs` elements in device memory -> NP rows
// of a shared-memory tile, 16 bytes per thread and step, rows >= N zero.
template <int HD>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int N, int NP, int rs) {
  constexpr int S = Shape<HD>::kStride, V = HD / 8;
  for (int idx = threadIdx.x; idx < NP * V; idx += blockDim.x) {
    const int j = idx / V, c = idx % V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < N) val = *reinterpret_cast<const uint4*>(src + (size_t)j * rs + c * 8);
    *reinterpret_cast<uint4*>(dst + j * S + c * 8) = val;
  }
}

// Scores of 16 query rows (A fragments qa) against all keys of Ks, then the
// row softmax in place: s[nt][e] = P[row][key] with row = r0 + g + 8*(e>>1),
// key = 8*nt + 2t + (e&1); keys >= N get P = 0. Returns the row max and sum
// for rows g (m[0], l[0]) and g + 8 (m[1], l[1]).
template <int HD, int KMAX>
__device__ __forceinline__ void softmax_rows(float (&s)[KMAX / 8][4],
                                             const uint32_t (&qa)[HD / 16][4], const bf16* Ks,
                                             int N, int NP, float scale, float (&m)[2],
                                             float (&l)[2]) {
  constexpr int S = Shape<HD>::kStride;
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < KMAX / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int c = 0; c < KMAX / 16; ++c) {
    if (c * 16 < NP) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        uint32_t bb[4];
        ldsm(bb, b_addr<S>(Ks, c * 16, kc * 16, lane));
        mma(s[2 * c], qa[kc], bb[0], bb[1]);
        mma(s[2 * c + 1], qa[kc], bb[2], bb[3]);
      }
    }
  }
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < KMAX / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool valid = nt * 8 + 2 * t + (e & 1) < N;
      s[nt][e] = valid ? s[nt][e] * scale : -INFINITY;
      m[e >> 1] = fmaxf(m[e >> 1], s[nt][e]);
    }
  }
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
#pragma unroll
  for (int nt = 0; nt < KMAX / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = expf(s[nt][e] - m[e >> 1]);
      l[e >> 1] += s[nt][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int nt = 0; nt < KMAX / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] / l[e >> 1];
  }
}

// Store an accumulator block (16 rows at r0 x HD) as bf16 into rows of
// stride `rs` elements, rows >= N skipped.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, int r0, int N, int rs,
                                           const float (&acc)[HD / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < N) {
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * rs + nt * 8 + 2 * t) =
            pack(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// A fragments of the 16 x 16 block of probabilities (or dS) for keys
// 16c..16c+15, from the score accumulators, rounded to bf16.
template <int KMAX>
__device__ __forceinline__ void p_frag(uint32_t (&a)[4], const float (&s)[KMAX / 8][4], int c) {
  a[0] = pack(s[2 * c][0], s[2 * c][1]);
  a[1] = pack(s[2 * c][2], s[2 * c][3]);
  a[2] = pack(s[2 * c + 1][0], s[2 * c + 1][1]);
  a[3] = pack(s[2 * c + 1][2], s[2 * c + 1][3]);
}

// acc = softmax(q K^T * scale) V for the 16 query rows whose A fragments are qa.
template <int HD, int KMAX>
__device__ __forceinline__ void fwd_rows(float (&acc)[HD / 8][4],
                                         const uint32_t (&qa)[HD / 16][4], const bf16* Ks,
                                         const bf16* Vs, int N, int NP, float scale) {
  constexpr int S = Shape<HD>::kStride;
  const int lane = threadIdx.x & 31;
  float s[KMAX / 8][4], m[2], l[2];
  softmax_rows<HD, KMAX>(s, qa, Ks, N, NP, scale, m, l);
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int c = 0; c < KMAX / 16; ++c) {
    if (c * 16 < NP) {
      uint32_t pa[4];
      p_frag<KMAX>(pa, s, c);
#pragma unroll
      for (int dc = 0; dc < HD / 16; ++dc) {
        uint32_t bb[4];
        ldsm_t(bb, a_addr<S>(Vs, c * 16, dc * 16, lane));
        mma(acc[2 * dc], pa, bb[0], bb[1]);
        mma(acc[2 * dc + 1], pa, bb[2], bb[3]);
      }
    }
  }
}

// dP = dO V^T for the 16 rows of `da` and keys 16c..16c+15.
template <int HD>
__device__ __forceinline__ void dp_chunk(float (&dp)[2][4], const uint32_t (&da)[HD / 16][4],
                                         const bf16* Vs, int c) {
  constexpr int S = Shape<HD>::kStride;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 2; ++i) dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    uint32_t bb[4];
    ldsm(bb, b_addr<S>(Vs, c * 16, kc * 16, lane));
    mma(dp[0], da[kc], bb[0], bb[1]);
    mma(dp[1], da[kc], bb[2], bb[3]);
  }
}

// Backward phase 1, for a block of WARPS warps: a warp per 16 query rows ->
// P, D = rowsum(dP*P), dS, dQ (written to `dq`, row stride `rs`); leaves
// (max, sum, D) per row in stat_m / stat_l / stat_D for phase 2.
template <int HD, int KMAX, int WARPS>
__device__ __forceinline__ void bwd_phase1(const bf16* Qs, const bf16* Ks, const bf16* Vs,
                                           const bf16* dOs, float* stat_m, float* stat_l,
                                           float* stat_D, bf16* __restrict__ dq, int rs, int N,
                                           int NP, float scale) {
  constexpr int S = Shape<HD>::kStride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int r0 = warp * 16; r0 < NP; r0 += WARPS * 16) {
    float s[KMAX / 8][4], m[2], l[2];
    {
      uint32_t qa[HD / 16][4];
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) ldsm(qa[kc], a_addr<S>(Qs, r0, kc * 16, lane));
      softmax_rows<HD, KMAX>(s, qa, Ks, N, NP, scale, m, l);
    }
    uint32_t da[HD / 16][4];
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) ldsm(da[kc], a_addr<S>(dOs, r0, kc * 16, lane));
    float D[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < KMAX / 16; ++c) {
      if (c * 16 < NP) {
        float dp[2][4];
        dp_chunk<HD>(dp, da, Vs, c);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) D[e >> 1] += s[2 * c + i][e] * dp[i][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      D[r] += __shfl_xor_sync(0xffffffffu, D[r], 1);
      D[r] += __shfl_xor_sync(0xffffffffu, D[r], 2);
    }
    float acc[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int c = 0; c < KMAX / 16; ++c) {
      if (c * 16 < NP) {
        float dp[2][4];
        dp_chunk<HD>(dp, da, Vs, c);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[i][e] = s[2 * c + i][e] * (dp[i][e] - D[e >> 1]) * scale;
        const uint32_t sa[4] = {pack(dp[0][0], dp[0][1]), pack(dp[0][2], dp[0][3]),
                                pack(dp[1][0], dp[1][1]), pack(dp[1][2], dp[1][3])};
#pragma unroll
        for (int dc = 0; dc < HD / 16; ++dc) {
          uint32_t bb[4];
          ldsm_t(bb, a_addr<S>(Ks, c * 16, dc * 16, lane));
          mma(acc[2 * dc], sa, bb[0], bb[1]);
          mma(acc[2 * dc + 1], sa, bb[2], bb[3]);
        }
      }
    }
    store_rows<HD>(dq, r0, N, rs, acc);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        stat_m[r0 + g + 8 * r] = m[r];
        stat_l[r0 + g + 8 * r] = l[r];
        stat_D[r0 + g + 8 * r] = D[r];
      }
    }
  }
}

// Backward phase 2 (after a block-wide barrier behind phase 1): a warp per
// 16 key rows -> P^T, dS^T from the row statistics; dV = P^T dO and
// dK = dS^T Q accumulate in registers over query chunks.
template <int HD, int WARPS>
__device__ __forceinline__ void bwd_phase2(const bf16* Qs, const bf16* Ks, const bf16* Vs,
                                           const bf16* dOs, const float* stat_m,
                                           const float* stat_l, const float* stat_D,
                                           bf16* __restrict__ dk, bf16* __restrict__ dv, int rs,
                                           int N, int NP, float scale) {
  constexpr int S = Shape<HD>::kStride;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int j0 = warp * 16; j0 < NP; j0 += WARPS * 16) {
    uint32_t ka[HD / 16][4], va[HD / 16][4];
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      ldsm(ka[kc], a_addr<S>(Ks, j0, kc * 16, lane));
      ldsm(va[kc], a_addr<S>(Vs, j0, kc * 16, lane));
    }
    float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      dk_acc[nt][0] = dk_acc[nt][1] = dk_acc[nt][2] = dk_acc[nt][3] = 0.f;
      dv_acc[nt][0] = dv_acc[nt][1] = dv_acc[nt][2] = dv_acc[nt][3] = 0.f;
    }
    for (int c = 0; c < NP / 16; ++c) {
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        st[i][0] = st[i][1] = st[i][2] = st[i][3] = dpt[i][0] = dpt[i][1] = dpt[i][2] =
            dpt[i][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        uint32_t bb[4];
        ldsm(bb, b_addr<S>(Qs, c * 16, kc * 16, lane));
        mma(st[0], ka[kc], bb[0], bb[1]);
        mma(st[1], ka[kc], bb[2], bb[3]);
        ldsm(bb, b_addr<S>(dOs, c * 16, kc * 16, lane));
        mma(dpt[0], va[kc], bb[0], bb[1]);
        mma(dpt[1], va[kc], bb[2], bb[3]);
      }
      // element e of tile i: key j0 + g + 8*(e>>1), query 16c + 8i + 2t + (e&1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = c * 16 + i * 8 + 2 * t + (e & 1);
          const bool valid = qi < N && j0 + g + 8 * (e >> 1) < N;
          const float p = valid ? expf(st[i][e] * scale - stat_m[qi]) / stat_l[qi] : 0.f;
          st[i][e] = p;
          dpt[i][e] = p * (dpt[i][e] - stat_D[qi]) * scale;
        }
      }
      const uint32_t pa[4] = {pack(st[0][0], st[0][1]), pack(st[0][2], st[0][3]),
                              pack(st[1][0], st[1][1]), pack(st[1][2], st[1][3])};
      const uint32_t sa[4] = {pack(dpt[0][0], dpt[0][1]), pack(dpt[0][2], dpt[0][3]),
                              pack(dpt[1][0], dpt[1][1]), pack(dpt[1][2], dpt[1][3])};
#pragma unroll
      for (int dc = 0; dc < HD / 16; ++dc) {
        uint32_t bb[4];
        ldsm_t(bb, a_addr<S>(dOs, c * 16, dc * 16, lane));
        mma(dv_acc[2 * dc], pa, bb[0], bb[1]);
        mma(dv_acc[2 * dc + 1], pa, bb[2], bb[3]);
        ldsm_t(bb, a_addr<S>(Qs, c * 16, dc * 16, lane));
        mma(dk_acc[2 * dc], sa, bb[0], bb[1]);
        mma(dk_acc[2 * dc + 1], sa, bb[2], bb[3]);
      }
    }
    store_rows<HD>(dk, j0, N, rs, dk_acc);
    store_rows<HD>(dv, j0, N, rs, dv_acc);
  }
}

}  // namespace tc
}  // namespace apvt
