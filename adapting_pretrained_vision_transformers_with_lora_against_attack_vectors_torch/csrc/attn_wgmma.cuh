// The Hopper attention core of attention_packed.cu: bf16, head dim 64,
// N <= 256, every product on wgmma.mma_async with its operands brought in by
// TMA behind mbarriers. Its forward (attn_fwd) is the packed kernel's
// forward at N <= 256. Its whole-head backward (attn_bwd) is no longer on any
// model path: attn_stream.cuh (the "wgmma_stream" variant) runs the backward
// at every N with this file's tile format, operand maps and backward device
// functions (dq_block, dkv_block take a ring stage's tiles as they take a
// stack's) on CTA roles of one warpgroup that stream the other side through
// a TMA ring in 64-row blocks; attn_bwd stays for timing against it
// (apvt_attn_wg_bwd). Past N = 256 a head no longer fits here (the 64 x N
// scores of a warpgroup in its accumulators, the backward's 4 N/64 tiles in
// shared memory), so the forward streams there too.
//
// What bounds attention at ViT-B shapes (B=64, N=197, H=12, hd=64) on the
// H100: a head reads 4 (forward) or 7 (backward) tiles of 197 x 64 bf16 and
// does 4 N^2 hd (forward) FLOP: 100 FLOP per byte, under the card's ridge of
// 295, so the bytes bound it (23 us forward, 41 us backward at 3.35 TB/s),
// with the tensor-core time close behind (11 / 27 us at the dense bf16
// peak). The mma.sync core (attn_core.cuh) sat 10-12x over that: a warp owns
// 16 rows, so every 512-byte ldmatrix of K or V feeds two mma.sync (shared
// memory reads cost as much as the products), the softmax idles the tensor
// cores, tiles are staged with synchronous 16-byte loads behind a block-wide
// barrier, and the backward forms 8 products where 5 are needed.
//
// What this design does about it:
// * a warpgroup owns 64 query rows (or, in the backward's second phase, 64
//   key rows) and runs wgmma m64nNk16: K, V, Q and dO are read by the
//   tensor cores from shared memory as they lie, once per 64 rows, not once
//   per 16. K (N, hd) row-major is the K-major B operand of Q K^T; V (and K
//   in dS K, dO in P^T dO, Q in dS^T Q) is the MN-major B operand through
//   the descriptor's transpose bit. No ldmatrix, no transposed copy;
// * tiles arrive by TMA (cp.async.bulk.tensor, 64-row boxes, 128-byte
//   swizzle: hd = 64 in bf16 is exactly one 128-byte row) and complete on
//   mbarriers: Q and K on one, V (and dO) on a second, so Q K^T starts while
//   V is in flight. One tensor map per operand serves the packed (B, N, H*hd)
//   and the head-major (B, H, N, hd) layout: only its sizes and strides
//   differ. TMA fills rows >= N with zeros, and its stores drop them, so the
//   ragged edge needs no branch in the data path;
// * forward: the 64 x NW scores (NW = 64, 128, 208 or 256: 104 registers a
//   thread at N = 197) stay in the accumulators, so the softmax is the exact
//   two-pass max/sum in f32 with exp2 and one reciprocal per row; P goes to
//   P V as the A operand from registers, rounded to bf16. A CTA is one
//   warpgroup and takes two of the head's query tiles; two or three CTAs
//   share an SM, so one's exp2 runs under another's wgmma and loads. The
//   forward also writes the row log-sum-exp (B, H, N) in f32;
// * backward (attn_bwd, for timing only since the streamed roles replaced
//   it; dq_block and dkv_block are what those roles run): with the
//   log-sum-exp and D = rowsum(dO * O) known before the first product (D is
//   formed in the prologue), every (query tile, key block) pair is
//   independent. Phase A, a warpgroup per query tile: S and
//   dP of a 64-key block (the last block only as wide as N needs), P and dS
//   in registers, dQ += dS K with dS as the register A operand. Phase B, a
//   warpgroup per 64-key block: S^T = K Q^T and dP^T = V dO^T, so P^T and
//   dS^T are born in registers as the A operands of dV += P^T dO and
//   dK += dS^T Q. Seven products of N^2 hd (the mma.sync core: 8), no
//   shared-memory round trip of P or dS, no barrier between the phases, and
//   every sum has one owner and a fixed order: no atomics, bitwise
//   reproducible;
// * the 197-row edge: four 64-row tiles, the fourth with 5 valid rows. Its
//   S / dP width is cut to 16 (the N side of a product is free in steps of
//   8), its 64-row M side is not: 256 x 208 where 197 x 197 is needed.
//
// Rounding points as in the plain version: f32 scores and sums, P rounded to
// bf16 before P V and P^T dO, dS = P (dP - D) scale rounded before dS K and
// dS^T Q. The backward takes D from the stored bf16 output, rowsum(dO * O),
// where the plain version sums dP * P in f32: the same number up to O's
// rounding (kernels/attention.py:attention_bwd_from_saved is this
// arithmetic in plain PyTorch).

#pragma once

#include "sm90.cuh"

namespace apvt {
namespace wg {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kTile = 64 * 64;        // elements of one 64-row tile (8 KB)
constexpr int kTileBytes = kTile * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Where head h of batch element b starts and the distance between its rows,
// in elements (for the operands the kernels also read with plain loads).
struct Strides {
  long long batch, head;
  int row;
};

// A 64 x 64 f32 accumulator block as bf16 into a swizzled tile.
__device__ __forceinline__ void acc_to_tile(unsigned char* tile, const float (&acc)[32], int warp,
                                            int g, int t) {
#pragma unroll
  for (int jt = 0; jt < 8; ++jt) {
    const int r = warp * 16 + g, c = 8 * jt + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + swz(r, c)) = pack_bf16(acc[4 * jt], acc[4 * jt + 1]);
    *reinterpret_cast<uint32_t*>(tile + swz(r + 8, c)) =
        pack_bf16(acc[4 * jt + 2], acc[4 * jt + 3]);
  }
}

// --- forward -------------------------------------------------------------------

// One warpgroup, one 64-row query tile Qt against the NW (>= N, a multiple
// of 16) keys of the stacked tiles Ks, Vs: o (the 64 x 64 accumulator) =
// softmax(Qt K^T * scale) V, and each of this thread's two rows' max m
// (log2 domain, scaled) and sum l of exp2. before_pv() runs after the
// softmax and before the P V products (the kernel waits for V there).
template <int NW, typename BeforePV>
__device__ __forceinline__ void fwd_tile(float (&o)[32], float (&m)[2], float (&l)[2],
                                         const bf16* Qt, const bf16* Ks, const bf16* Vs, int N,
                                         float scale_log2, int t, BeforePV before_pv) {
  float s[NW / 2];
  {
    const uint64_t dq = mdesc(Qt), dk = mdesc(Ks);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<NW>::template ss<0, 0>(s, madvance(dq, 32 * kk), madvance(dk, 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
  }

  // exact two-pass softmax of rows g and g + 8 of this warp's 16
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    s[i] = col < N ? s[i] * scale_log2 : -INFINITY;
    if (i & 2)
      m1 = fmaxf(m1, s[i]);
    else
      m0 = fmaxf(m0, s[i]);
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) {
    s[i] = ex2(s[i] - ((i & 2) ? m1 : m0));
    if (i & 2)
      l1 += s[i];
    else
      l0 += s[i];
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  m[0] = m0, m[1] = m1, l[0] = l0, l[1] = l1;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  uint32_t pa[NW / 16][4];
#pragma unroll
  for (int c = 0; c < NW / 16; ++c) {
    pa[c][0] = pack_bf16(s[8 * c] * inv0, s[8 * c + 1] * inv0);
    pa[c][1] = pack_bf16(s[8 * c + 2] * inv1, s[8 * c + 3] * inv1);
    pa[c][2] = pack_bf16(s[8 * c + 4] * inv0, s[8 * c + 5] * inv0);
    pa[c][3] = pack_bf16(s[8 * c + 6] * inv1, s[8 * c + 7] * inv1);
  }

  before_pv();
  const uint64_t dv = mdesc(Vs);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NW / 16; ++c) Wgmma<64>::template rs<1>(o, pa[c], madvance(dv, 2048 * c), c);
  wgmma_commit();
  wgmma_wait<0>();
}

template <int NW>
constexpr size_t fwd_smem() {
  return 1024 + (size_t)(2 + 2 * ((NW + 63) / 64)) * kTileBytes + 64;
}

// One warpgroup; query tiles 2z and 2z + 1 of head (b, h). NW >= N, a
// multiple of 16: the width of the score block.
template <int NW>
__global__ void __launch_bounds__(128)
attn_fwd(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
         const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
         float* __restrict__ lse, int N, int H, int head_major, float scale_log2) {
  constexpr int NB = (NW + 63) / 64;
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = Qs + 2 * kTile;
  bf16* Vs = Ks + NB * kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + NB * kTile);

  const int QT = (N + 63) / 64, ZS = (QT + 1) / 2;
  const int bh = blockIdx.x / ZS, z = blockIdx.x % ZS;
  const int c0 = head_major ? 0 : (bh % H) * 64, c2 = head_major ? bh : bh / H;
  const int t0 = 2 * z, ntile = min(2, QT - t0);

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&bars[2], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bars[0], (1 + NB) * kTileBytes);
    tma_load_3d(Qs, &mq, &bars[0], c0, t0 * 64, c2);
    for (int i = 0; i < NB; ++i) tma_load_3d(Ks + i * kTile, &mk, &bars[0], c0, i * 64, c2);
    mbar_expect_tx(&bars[1], NB * kTileBytes);
    for (int i = 0; i < NB; ++i) tma_load_3d(Vs + i * kTile, &mv, &bars[1], c0, i * 64, c2);
    if (ntile > 1) {
      mbar_expect_tx(&bars[2], kTileBytes);
      tma_load_3d(Qs + kTile, &mq, &bars[2], c0, (t0 + 1) * 64, c2);
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int tt = 0; tt < ntile; ++tt) {
    bf16* Qt = Qs + tt * kTile;
    mbar_wait(&bars[tt == 0 ? 0 : 2], 0);
    float o[32], m[2], l[2];
    fwd_tile<NW>(o, m, l, Qt, Ks, Vs, N, scale_log2, t, [&] {
      if (tt == 0) mbar_wait(&bars[1], 0);
    });
    const int row0 = (t0 + tt) * 64 + warp * 16 + g;
    if (t == 0) {
      if (row0 < N) lse[(size_t)bh * N + row0] = (m[0] + log2f(l[0])) * kLn2;
      if (row0 + 8 < N) lse[(size_t)bh * N + row0 + 8] = (m[1] + log2f(l[1])) * kLn2;
    }

    // the O tile over the Q tile (its products are done), then one TMA store
    acc_to_tile(reinterpret_cast<unsigned char*>(Qt), o, warp, g, t);
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_store_3d(&mo, Qt, c0, (t0 + tt) * 64, c2);
      tma_store_commit();
    }
  }
  if (threadIdx.x == 0) tma_store_wait_read();
}

// --- backward ------------------------------------------------------------------

inline size_t bwd_smem(int N) {
  const int nb = (N + 63) / 64;
  return 1024 + (size_t)(4 * nb + 2) * kTileBytes + 2 * 256 * sizeof(float) + 64;
}

struct BwdTiles {
  const bf16 *Q, *K, *V, *dO;   // NB stacked 64-row tiles each
  const float *lse2, *D;        // per query row: log2-domain log-sum-exp (+inf for rows >= N), D
};

// dQ (the 64 query rows of tiles Qt, dOt) += dS K over the W keys of the
// block Kt, Vt whose first key is key0; acc = 0 starts the sum. The whole-head
// kernels give it tiles of their stacks, the streamed route (attn_stream.cuh)
// a ring stage.
template <int W>
__device__ __forceinline__ void dq_block(float (&dq)[32], const bf16* Qt, const bf16* dOt,
                                         const bf16* Kt, const bf16* Vt, int key0, int acc, int N,
                                         float scale, float scale_log2, float l0, float l1,
                                         float D0, float D1, int t) {
  float sc[W / 2], dp[W / 2];
  {
    const uint64_t a_q = mdesc(Qt), a_do = mdesc(dOt);
    const uint64_t b_k = mdesc(Kt), b_v = mdesc(Vt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<W>::template ss<0, 0>(sc, madvance(a_q, 32 * kk), madvance(b_k, 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<W>::template ss<0, 0>(dp, madvance(a_do, 32 * kk), madvance(b_v, 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();   // S is there; P's exp2 runs under dP's products
  }
#pragma unroll
  for (int e = 0; e < W / 2; ++e) {
    const int col = key0 + 8 * (e >> 2) + 2 * t + (e & 1);
    sc[e] = col < N ? ex2(sc[e] * scale_log2 - ((e & 2) ? l1 : l0)) : 0.f;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < W / 2; ++e) dp[e] = sc[e] * (dp[e] - ((e & 2) ? D1 : D0)) * scale;
  uint32_t a[W / 16][4];
#pragma unroll
  for (int c = 0; c < W / 16; ++c) {
    a[c][0] = pack_bf16(dp[8 * c], dp[8 * c + 1]);
    a[c][1] = pack_bf16(dp[8 * c + 2], dp[8 * c + 3]);
    a[c][2] = pack_bf16(dp[8 * c + 4], dp[8 * c + 5]);
    a[c][3] = pack_bf16(dp[8 * c + 6], dp[8 * c + 7]);
  }
  const uint64_t b_k = mdesc(Kt);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < W / 16; ++c)
    Wgmma<64>::template rs<1>(dq, a[c], madvance(b_k, 2048 * c), acc | c);
  wgmma_commit();
  wgmma_wait<0>();
}

// ... at query tile i and key block j of the stacked tiles s.
template <int W>
__device__ __forceinline__ void dq_block(float (&dq)[32], const BwdTiles& s, int i, int j, int N,
                                         float scale, float scale_log2, float l0, float l1,
                                         float D0, float D1, int t) {
  dq_block<W>(dq, s.Q + i * kTile, s.dO + i * kTile, s.K + j * kTile, s.V + j * kTile, j * 64, j,
              N, scale, scale_log2, l0, l1, D0, D1, t);
}

// dV, dK (the 64 key rows of tiles Kt, Vt) += P^T dO, dS^T Q over the W
// queries of the tiles Qt, dOt, whose log2-domain log-sum-exp and D start at
// lse2 and D; acc = 0 starts the sums.
template <int W>
__device__ __forceinline__ void dkv_block(float (&dk)[32], float (&dv)[32], const bf16* Kt,
                                          const bf16* Vt, const bf16* Qt, const bf16* dOt,
                                          const float* lse2, const float* D, int acc, float scale,
                                          float scale_log2, bool valid0, bool valid1, int t) {
  float st[W / 2], dpt[W / 2];
  {
    const uint64_t a_k = mdesc(Kt), a_v = mdesc(Vt);
    const uint64_t b_q = mdesc(Qt), b_do = mdesc(dOt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<W>::template ss<0, 0>(st, madvance(a_k, 32 * kk), madvance(b_q, 32 * kk), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<W>::template ss<0, 0>(dpt, madvance(a_v, 32 * kk), madvance(b_do, 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<1>();   // S^T is there; P^T's exp2 runs under dP^T's products
  }
#pragma unroll
  for (int jt = 0; jt < W / 8; ++jt) {
    const int col = 8 * jt + 2 * t;   // the query of elements 0 and 2; +1 for 1 and 3
    const float2 lq = *reinterpret_cast<const float2*>(lse2 + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool valid = (e & 2) ? valid1 : valid0;
      st[4 * jt + e] = valid ? ex2(st[4 * jt + e] * scale_log2 - ((e & 1) ? lq.y : lq.x)) : 0.f;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int jt = 0; jt < W / 8; ++jt) {
    const float2 Dq = *reinterpret_cast<const float2*>(D + 8 * jt + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * jt + e] = st[4 * jt + e] * (dpt[4 * jt + e] - ((e & 1) ? Dq.y : Dq.x)) * scale;
  }
  uint32_t pa[W / 16][4], sa[W / 16][4];
#pragma unroll
  for (int c = 0; c < W / 16; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[c][r] = pack_bf16(st[8 * c + 2 * r], st[8 * c + 2 * r + 1]);
      sa[c][r] = pack_bf16(dpt[8 * c + 2 * r], dpt[8 * c + 2 * r + 1]);
    }
  }
  const uint64_t b_do = mdesc(dOt), b_q = mdesc(Qt);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < W / 16; ++c) {
    Wgmma<64>::template rs<1>(dv, pa[c], madvance(b_do, 2048 * c), acc | c);
    Wgmma<64>::template rs<1>(dk, sa[c], madvance(b_q, 2048 * c), acc | c);
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// ... at query tile i and key block j of the stacked tiles s.
template <int W>
__device__ __forceinline__ void dkv_block(float (&dk)[32], float (&dv)[32], const BwdTiles& s,
                                          int i, int j, float scale, float scale_log2,
                                          bool valid0, bool valid1, int t) {
  dkv_block<W>(dk, dv, s.K + j * kTile, s.V + j * kTile, s.Q + i * kTile, s.dO + i * kTile,
               s.lse2 + i * 64, s.D + i * 64, i, scale, scale_log2, valid0, valid1, t);
}

// A warpgroup's 64 x 64 result through its staging tile to rows row0.. of a tensor.
__device__ __forceinline__ void store_block(const CUtensorMap* map, unsigned char* stage,
                                            const float (&acc)[32], int c0, int row0, int c2,
                                            int wgi, int wl) {
  if (wl == 0) tma_store_wait_read();   // the staging tile's previous store has read it
  named_barrier(1 + wgi, 128);
  acc_to_tile(stage, acc, wl >> 5, (wl & 31) >> 2, wl & 3);
  fence_async_shared();
  named_barrier(1 + wgi, 128);
  if (wl == 0) {
    tma_store_3d(map, stage, c0, row0, c2);
    tma_store_commit();
  }
}

// Two warpgroups; one head (b, h) per CTA.
__global__ void __launch_bounds__(256)
attn_bwd(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
         const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
         const __grid_constant__ CUtensorMap mdq, const __grid_constant__ CUtensorMap mdk,
         const __grid_constant__ CUtensorMap mdv, const bf16* __restrict__ dout,
         const bf16* __restrict__ out, const float* __restrict__ lse, Strides st, int N, int H,
         int head_major, float scale, float scale_log2) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  const int NB = (N + 63) / 64;
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = Qs + NB * kTile;
  bf16* Vs = Ks + NB * kTile;
  bf16* dOs = Vs + NB * kTile;
  unsigned char* stage = reinterpret_cast<unsigned char*>(dOs + NB * kTile);
  float* lse2 = reinterpret_cast<float*>(stage + 2 * kTileBytes);
  float* Dr = lse2 + 256;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Dr + 256);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c0 = head_major ? 0 : h * 64, c2 = head_major ? bh : b;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bars[0], 2 * NB * kTileBytes);
    for (int i = 0; i < NB; ++i) {
      tma_load_3d(Qs + i * kTile, &mq, &bars[0], c0, i * 64, c2);
      tma_load_3d(Ks + i * kTile, &mk, &bars[0], c0, i * 64, c2);
    }
    mbar_expect_tx(&bars[1], 2 * NB * kTileBytes);
    for (int i = 0; i < NB; ++i) {
      tma_load_3d(Vs + i * kTile, &mv, &bars[1], c0, i * 64, c2);
      tma_load_3d(dOs + i * kTile, &mdo, &bars[1], c0, i * 64, c2);
    }
  }

  // row statistics while the tiles are in flight: D = rowsum(dO * O) in f32
  // (a lane per 2 channels, then a fixed shuffle tree), the log-sum-exp in
  // the log2 domain; rows >= N get +inf, so that their P is 0
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t hb = (size_t)b * st.batch + (size_t)h * st.head;
    for (int row = warp; row < NB * 64; row += 8) {
      float d = 0.f, l2 = INFINITY;
      if (row < N) {
        const size_t off = hb + (size_t)row * st.row + 2 * lane;
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + off));
        d = x.x * y.x + x.y * y.y;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        l2 = lse[(size_t)bh * N + row] * kLog2e;
      }
      if (lane == 0) {
        Dr[row] = d;
        lse2[row] = l2;
      }
    }
  }
  __syncthreads();
  mbar_wait(&bars[0], 0);
  mbar_wait(&bars[1], 0);

  const BwdTiles tiles{Qs, Ks, Vs, dOs, lse2, Dr};
  const int wgi = threadIdx.x >> 7, wl = threadIdx.x & 127;
  const int warp = wl >> 5, g = (wl & 31) >> 2, t = wl & 3;
  const int NL = (N - (NB - 1) * 64 + 15) & ~15;   // the last block's width: 16, 32, 48 or 64
  unsigned char* my_stage = stage + wgi * kTileBytes;

  // Phase A: dQ of query tile i
  for (int i = wgi; i < NB; i += 2) {
    const int r0 = i * 64 + warp * 16 + g;
    const float l0 = lse2[r0], l1 = lse2[r0 + 8], D0 = Dr[r0], D1 = Dr[r0 + 8];
    float dq[32];
    for (int j = 0; j < NB - 1; ++j)
      dq_block<64>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
    const int j = NB - 1;
    if (NL == 64)
      dq_block<64>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
    else if (NL == 48)
      dq_block<48>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
    else if (NL == 32)
      dq_block<32>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
    else
      dq_block<16>(dq, tiles, i, j, N, scale, scale_log2, l0, l1, D0, D1, t);
    store_block(&mdq, my_stage, dq, c0, i * 64, c2, wgi, wl);
  }

  // Phase B: dK, dV of key block j
  for (int j = wgi; j < NB; j += 2) {
    const int k0 = j * 64 + warp * 16 + g;
    const bool valid0 = k0 < N, valid1 = k0 + 8 < N;
    float dk[32], dv[32];
    for (int i = 0; i < NB - 1; ++i)
      dkv_block<64>(dk, dv, tiles, i, j, scale, scale_log2, valid0, valid1, t);
    const int i = NB - 1;
    if (NL == 64)
      dkv_block<64>(dk, dv, tiles, i, j, scale, scale_log2, valid0, valid1, t);
    else if (NL == 48)
      dkv_block<48>(dk, dv, tiles, i, j, scale, scale_log2, valid0, valid1, t);
    else if (NL == 32)
      dkv_block<32>(dk, dv, tiles, i, j, scale, scale_log2, valid0, valid1, t);
    else
      dkv_block<16>(dk, dv, tiles, i, j, scale, scale_log2, valid0, valid1, t);
    store_block(&mdk, my_stage, dk, c0, j * 64, c2, wgi, wl);
    store_block(&mdv, my_stage, dv, c0, j * 64, c2, wgi, wl);
  }
  if (wl == 0) tma_store_wait_read();
}

// --- host ----------------------------------------------------------------------

constexpr int kMaxN = 256;

// Tensor map of one operand: packed (B, N, H*64) or head-major (B, H, N, 64).
inline bool operand_map(CUtensorMap* map, const void* p, int B, int N, int H, int head_major) {
  const uint64_t C = (uint64_t)H * 64;
  if (head_major) {
    const uint64_t dims[3] = {64, (uint64_t)N, (uint64_t)B * H};
    const uint64_t strides[2] = {128, (uint64_t)N * 128};
    return make_map(map, p, 3, dims, strides, 64);
  }
  const uint64_t dims[3] = {C, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {C * 2, (uint64_t)N * C * 2};
  return make_map(map, p, 3, dims, strides, 64);
}

template <int NW>
int launch_fwd_nw(const CUtensorMap* m, float* lse, int B, int N, int H, int head_major,
                  float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<NW>();
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int zs = ((N + 63) / 64 + 1) / 2;
  attn_fwd<NW><<<B * H * zs, 128, smem, stream>>>(m[0], m[1], m[2], m[3], lse, N, H, head_major,
                                                  scale * kLog2e);
  return (int)cudaGetLastError();
}

// q, k, v -> o and lse (B, H, N) f32; bf16, head dim 64, N <= 256.
inline int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int N, int H, int head_major, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  const void* ptr[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (!operand_map(&m[i], ptr[i], B, N, H, head_major)) return kMapError;
  if (N <= 64) return launch_fwd_nw<64>(m, lse, B, N, H, head_major, scale, stream);
  if (N <= 128) return launch_fwd_nw<128>(m, lse, B, N, H, head_major, scale, stream);
  if (N <= 208) return launch_fwd_nw<208>(m, lse, B, N, H, head_major, scale, stream);
  return launch_fwd_nw<256>(m, lse, B, N, H, head_major, scale, stream);
}

inline int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                      const void* out, const float* lse, void* dq, void* dk, void* dv, int B,
                      int N, int H, int head_major, float scale, cudaStream_t stream) {
  CUtensorMap m[7];
  const void* ptr[7] = {q, k, v, dout, dq, dk, dv};
  for (int i = 0; i < 7; ++i)
    if (!operand_map(&m[i], ptr[i], B, N, H, head_major)) return kMapError;
  const Strides st = head_major ? Strides{(long long)H * N * 64, (long long)N * 64, 64}
                                : Strides{(long long)N * H * 64, 64, H * 64};
  const size_t smem = bwd_smem(N);
  cudaError_t err =
      cudaFuncSetAttribute(attn_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd<<<B * H, 256, smem, stream>>>(m[0], m[1], m[2], m[3], m[4], m[5], m[6],
                                         static_cast<const bf16*>(dout),
                                         static_cast<const bf16*>(out), lse, st, N, H, head_major,
                                         scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace apvt
