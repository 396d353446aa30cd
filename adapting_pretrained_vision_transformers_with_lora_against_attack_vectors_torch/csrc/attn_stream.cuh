// The streamed Hopper route of attention_packed.cu ("wgmma_stream"): bf16,
// head dim 64, the backward at every N and the forward past N = 256, every
// product on wgmma.mma_async, every operand brought in by TMA, shared memory
// the same at every N.
//
// What bounds it on the H100: at ViT-B/16 at 384 px (B=8, N=577, H=12,
// hd=64) a head reads 4 (forward) or 7 (backward) tiles of 577 x 64 bf16
// and needs 4 N^2 hd (forward) or 10 N^2 hd (backward) FLOP: ~290 and ~400
// FLOP per byte, at the card's bf16 ridge of 295. The bound is 0.0085 ms
// forward (bytes) and 0.0207 ms backward (tensor-core operations at 989
// TFLOP/s), so the products have to run on wgmma. The whole-head core of
// attn_wgmma.cuh keeps a 64 x N score row of a warpgroup in its
// accumulators and every tile of a head in shared memory, so its forward
// stops at N = 256. Its whole-head backward also held one CTA an SM at
// ViT-B's N = 197 (150,592 bytes, 8 warps), where the backward's roles
// below fit three (12 warps); they run the backward at every N.
//
// What this design does about it:
// * a CTA owns 64-row tiles of one (batch, head), a warpgroup each: two in
//   the forward (128 query rows; the second idle where the head's last tile
//   pair has one tile), one in the backward. Its own tiles arrive once; the
//   other side streams in 64-row blocks through a ring (4 stages forward, 3
//   backward) behind a full and an empty mbarrier a stage. Thread 0 keeps
//   the ring's loads in flight (it waits for a stage only when every
//   consumer thread has freed its previous block), so no producer warp
//   takes registers from the products. TMA fills rows >= N with zeros
//   (the last block of N = 577 holds 1 valid row), so the ring's transaction
//   counts are the same for every block and the data path has no ragged
//   branch; the last block's products are cut to 16, 32 or 48 columns where
//   N allows, as in the whole-head core;
// * forward, two passes over the keys, three products: pass 1 forms S = Q K^T
//   block by block (m64n64k16, ss) and keeps the running row max and sum of
//   exp2 in f32 (log2 domain); pass 2 forms S again from the same tiles (the
//   same bits), P = exp2(S scale log2e - lse2) is already normalised and is
//   rounded to bf16 in registers, the A operand of O += P V (rs). The third
//   product keeps the Pallas kernel's rounding point: a one-pass online
//   softmax would round P before its normalisation. O goes out by a TMA
//   store over the Q tile, the row log-sum-exp beside it. Two CTAs an SM;
// * backward, one launch of two CTA roles over the same ring: the dK/dV role
//   holds 64 key rows of K and V and streams Q and dO blocks with their
//   lse2 and D slices (a 512-byte bulk copy a block); the dQ role holds 64
//   query rows of Q and dO and streams K and V; three CTAs an SM. Each runs
//   attn_wgmma.cuh's dkv_block / dq_block on the ring stage: S^T and dP^T
//   (or S and dP) on wgmma, P^T and dS^T born in registers as the A
//   operands of dV += P^T dO and dK += dS^T Q (dQ += dS K): seven products,
//   every sum with one owner and a fixed order, no atomics, bitwise
//   reproducible;
// * D = rowsum(dO * O) and lse2 = lse log2e come from one small pre-pass
//   (stream_stats) in the launcher, into a (B, H, ceil(N/64), 2, 64) f32
//   buffer that the wrapper allocates (+inf and 0 past N). Every dK/dV CTA
//   reads every query block's D: recomputing it a block at a time would
//   stream O beside Q and dO (a third tile a stage) and redo the sum in
//   every one of the head's ceil(N/64) dK/dV CTAs; the pre-pass reads dO
//   and O once. D is taken from the stored bf16 O, as the whole-head
//   backward takes it.
// Rounding points as the plain version (kernels/attention.py:
// attention_bwd_from_saved): f32 scores and sums, P rounded to bf16 before
// P V and P^T dO, dS rounded before dS K and dS^T Q.

#pragma once

#include "attn_wgmma.cuh"

namespace apvt {
namespace wgs {

using bf16 = __nv_bfloat16;
using namespace sm90;
using wg::kLn2;
using wg::kLog2e;
using wg::kTile;
using wg::kTileBytes;
using wg::Strides;

constexpr int kBlock = 64;  // rows of a streamed block, and of a warpgroup's own tile
// A forward CTA: two warpgroups (128 query rows) over a 4-stage ring, two CTAs
// an SM (95 registers). A backward CTA: one warpgroup (64 own rows) over a
// 3-stage ring, three CTAs an SM (161 registers): 12 warps an SM where two
// warpgroups a CTA gave 8, 18% faster on an H100 at (8, 577, 12, 64); the
// forward was 2% slower with one warpgroup a CTA (five CTAs an SM).
constexpr int kFwdWarpgroups = 2;
constexpr int kFwdStages = 4;
constexpr int kFwdCtasPerSm = 2;  // the forward's __launch_bounds__ minimum
constexpr int kBwdWarpgroups = 1;
constexpr int kBwdStages = 3;
constexpr int kStatBytes = 2 * kBlock * sizeof(float);  // lse2 and D of one block
constexpr int kNoScratch = -3;  // what launch_bwd returns when it is given no work buffer

// Dynamic shared memory: 1024 bytes of alignment slack; the own tiles (the
// forward's Q of each warpgroup; the backward's K and V, or Q and dO); the
// ring's stages of two tiles (K, V; Q, dO); the dK/dV role's statistics of
// each stage; the barriers (own, full and empty of each stage).
constexpr size_t fwd_smem() {
  return 1024 + (size_t)(kFwdWarpgroups + 2 * kFwdStages) * kTileBytes +
         (1 + 2 * kFwdStages) * 8;
}
constexpr size_t bwd_smem() {
  return 1024 + (size_t)(2 * kBwdWarpgroups + 2 * kBwdStages) * kTileBytes +
         (size_t)kBwdStages * kStatBytes + (1 + 2 * kBwdStages) * 8;
}

// Thread 0's side of a ring of S stages. Loads are numbered in the order the
// consumers take them; load n goes into stage n % S once every consumer
// thread has freed the stage's previous load (n - S). issue(n, stage)
// announces the stage's bytes and starts its copies. Every consumer thread
// arrives on a stage's empty barrier (128 a warpgroup): a lane-0 branch
// beside the live accumulators made ptxas serialise the forward's wgmma
// (warning C7520) and cost 6% of its time.
template <int S>
struct Feed {
  uint64_t *full, *empty;
  int next;
  template <typename Issue>
  __device__ __forceinline__ void upto(int n, int total, Issue issue) {
    for (; next < n && next < total; ++next) {
      const int s = next % S;
      if (next >= S) mbar_wait(&empty[s], ((next / S) - 1) & 1);
      issue(next, s);
    }
  }
};

// A consumer thread takes block `it` of a ring of S stages (waits for its
// stage to fill).
template <int S>
__device__ __forceinline__ int take(uint64_t* full, int it) {
  const int s = it % S;
  mbar_wait(&full[s], (it / S) & 1);
  return s;
}

template <int W>
struct Width {
  static constexpr int value = W;
};

// f(Width<W>{}) with W the width of key (or query) block `it` of NB: 64, or
// for the last block the multiple of 16 its NL columns need.
template <typename F>
__device__ __forceinline__ void by_width(int it, int NB, int NL, F f) {
  if (it < NB - 1 || NL == 64)
    f(Width<64>{});
  else if (NL == 48)
    f(Width<48>{});
  else if (NL == 32)
    f(Width<32>{});
  else
    f(Width<16>{});
}

// --- forward -------------------------------------------------------------------

// Pass 1 on the W keys from key0 of one block: this thread's two rows' running
// max m (log2 domain, scaled; the same on the quad) and partial sum lp of
// exp2(s - m) over its columns. release() runs once the products have read K.
template <int W, typename Release>
__device__ __forceinline__ void stats_block(float (&m)[2], float (&lp)[2], const bf16* Qt,
                                            const bf16* Kt, int key0, int N, float scale_log2,
                                            int t, Release release) {
  float s[W / 2];
  const uint64_t dq = mdesc(Qt), dk = mdesc(Kt);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<W>::template ss<0, 0>(s, madvance(dq, 32 * kk), madvance(dk, 32 * kk), kk);
  wgmma_commit();
  wgmma_wait<0>();
  release();
  float b0 = -INFINITY, b1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const int col = key0 + 8 * (i >> 2) + 2 * t + (i & 1);
    s[i] = col < N ? s[i] * scale_log2 : -INFINITY;
    if (i & 2)
      b1 = fmaxf(b1, s[i]);
    else
      b0 = fmaxf(b0, s[i]);
  }
  b0 = fmaxf(m[0], quad_max(b0));
  b1 = fmaxf(m[1], quad_max(b1));
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    if (i & 2)
      a1 += ex2(s[i] - b1);
    else
      a0 += ex2(s[i] - b0);
  }
  lp[0] = lp[0] * ex2(m[0] - b0) + a0;
  lp[1] = lp[1] * ex2(m[1] - b1) + a1;
  m[0] = b0;
  m[1] = b1;
}

// Pass 2 on the W keys from key0: S again, P = exp2(S scale log2e - lse2)
// rounded to bf16 (0 past N), o += P V (acc = 0 starts the sum).
template <int W, typename Release>
__device__ __forceinline__ void pv_block(float (&o)[32], const bf16* Qt, const bf16* Kt,
                                         const bf16* Vt, int key0, int acc, int N,
                                         float scale_log2, float lse0, float lse1, int t,
                                         Release release) {
  float s[W / 2];
  {
    const uint64_t dq = mdesc(Qt), dk = mdesc(Kt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<W>::template ss<0, 0>(s, madvance(dq, 32 * kk), madvance(dk, 32 * kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
  }
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const int col = key0 + 8 * (i >> 2) + 2 * t + (i & 1);
    s[i] = col < N ? ex2(s[i] * scale_log2 - ((i & 2) ? lse1 : lse0)) : 0.f;
  }
  uint32_t pa[W / 16][4];
#pragma unroll
  for (int c = 0; c < W / 16; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
  const uint64_t dv = mdesc(Vt);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < W / 16; ++c)
    Wgmma<64>::template rs<1>(o, pa[c], madvance(dv, 2048 * c), acc | c);
  wgmma_commit();
  wgmma_wait<0>();
  release();
}

// Query tiles kFwdWarpgroups z, kFwdWarpgroups z + 1, ... of head (b, h), a
// warpgroup each; the ring carries K_0 .. K_{NB-1} (pass 1), then K_j with
// V_j (pass 2).
__global__ void __launch_bounds__(128 * kFwdWarpgroups, kFwdCtasPerSm)
stream_fwd(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
           float* __restrict__ lse, int N, int H, int head_major, float scale_log2) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* ring = Qs + kFwdWarpgroups * kTile;  // stage s: K at ring + 2 s kTile, V after it
  uint64_t* own = reinterpret_cast<uint64_t*>(ring + 2 * kFwdStages * kTile);
  uint64_t* full = own + 1;
  uint64_t* empty = full + kFwdStages;

  const int NB = (N + kBlock - 1) / kBlock, ZS = (NB + kFwdWarpgroups - 1) / kFwdWarpgroups;
  const int bh = blockIdx.x / ZS, z = blockIdx.x % ZS;
  const int c0 = head_major ? 0 : (bh % H) * 64, c2 = head_major ? bh : bh / H;
  const int t0 = kFwdWarpgroups * z, nwg = min(kFwdWarpgroups, NB - t0);
  const int wgi = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * nwg);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wgi >= nwg) return;

  const int total = 2 * NB;
  Feed<kFwdStages> feed{full, empty, 0};
  auto issue = [&](int n, int s) {
    const bool with_v = n >= NB;
    const int j = with_v ? n - NB : n;
    bf16* Ks = ring + 2 * s * kTile;
    mbar_expect_tx(&full[s], (with_v ? 2 : 1) * kTileBytes);
    tma_load_3d(Ks, &mk, &full[s], c0, j * kBlock, c2);
    if (with_v) tma_load_3d(Ks + kTile, &mv, &full[s], c0, j * kBlock, c2);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(own, nwg * kTileBytes);
    for (int w = 0; w < nwg; ++w) tma_load_3d(Qs + w * kTile, &mq, own, c0, (t0 + w) * kBlock, c2);
    feed.upto(kFwdStages, total, issue);
  }

  const int wl = threadIdx.x & 127, warp = wl >> 5, lane = wl & 31, g = lane >> 2, t = lane & 3;
  bf16* Qt = Qs + wgi * kTile;
  const int NL = (N - (NB - 1) * kBlock + 15) & ~15;
  mbar_wait(own, 0);

  float m[2] = {-INFINITY, -INFINITY}, lp[2] = {0.f, 0.f};
  for (int it = 0; it < NB; ++it) {
    if (threadIdx.x == 0) feed.upto(it + kFwdStages, total, issue);
    const int s = take<kFwdStages>(full, it);
    const bf16* Kt = ring + 2 * s * kTile;
    auto release = [&] { mbar_arrive(&empty[s]); };
    by_width(it, NB, NL, [&](auto w) {
      stats_block<decltype(w)::value>(m, lp, Qt, Kt, it * kBlock, N, scale_log2, t, release);
    });
  }
  const float lse0 = m[0] + log2f(quad_sum(lp[0])), lse1 = m[1] + log2f(quad_sum(lp[1]));
  const int row0 = (t0 + wgi) * kBlock + warp * 16 + g;
  if (t == 0) {
    if (row0 < N) lse[(size_t)bh * N + row0] = lse0 * kLn2;
    if (row0 + 8 < N) lse[(size_t)bh * N + row0 + 8] = lse1 * kLn2;
  }

  float o[32];
  for (int it = NB; it < total; ++it) {
    if (threadIdx.x == 0) feed.upto(it + kFwdStages, total, issue);
    const int s = take<kFwdStages>(full, it), j = it - NB;
    const bf16* Kt = ring + 2 * s * kTile;
    auto release = [&] { mbar_arrive(&empty[s]); };
    by_width(j, NB, NL, [&](auto w) {
      pv_block<decltype(w)::value>(o, Qt, Kt, Kt + kTile, j * kBlock, j, N, scale_log2, lse0,
                                   lse1, t, release);
    });
  }

  // O over the warpgroup's Q tile (its products are done), then one TMA store
  named_barrier(1 + wgi, 128);
  wg::acc_to_tile(reinterpret_cast<unsigned char*>(Qt), o, warp, g, t);
  fence_async_shared();
  named_barrier(1 + wgi, 128);
  if (wl == 0) {
    tma_store_3d(&mo, Qt, c0, (t0 + wgi) * kBlock, c2);
    tma_store_commit();
    tma_store_wait_read();
  }
}

// --- backward ------------------------------------------------------------------

// lse2 and D of one 64-row block of one (batch, head) into
// work[((b H + h) NB + i) 128 ...]: lse2 = lse log2e (+inf past N), then
// D = rowsum(dO * O) (0 past N). Eight lanes a row, 16 bytes of dO and of O
// a lane, every load of a thread's four rows issued before its first sum:
// the first design (a warp a row, 4 bytes a lane, each row's loads awaited
// in turn) took 0.023 ms at (64, 197, 12, 64) on an H100, this one 0.015,
// where its 40 MB take 0.012 at 3.35 TB/s. D is summed as the whole-head backward sums it, by a tree over
// the row's 32 channel-pair products (lane l of a warp holding pair l, then
// xor shuffles 16, 8, 4, 2, 1): here a lane holds pairs 4 m .. 4 m + 3 (m
// its lane among the row's eight), so the tree's first three levels are
// shuffles between the row's lanes (xor 4, 2, 1) and its last two are sums
// inside the lane, the same operands in the same order: the same bits.
constexpr int kStatThreads = 128;
constexpr int kStatRows = kStatThreads / 8;  // rows a pass; kBlock / kStatRows passes

__global__ void __launch_bounds__(kStatThreads)
stream_stats(const bf16* __restrict__ dout, const bf16* __restrict__ out,
             const float* __restrict__ lse, float* __restrict__ work, Strides st, int N, int H) {
  constexpr int kPasses = kBlock / kStatRows;
  const int NB = (N + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / NB, i = blockIdx.x % NB, b = bh / H, h = bh % H;
  const int grp = threadIdx.x >> 3, m = threadIdx.x & 7;
  float* w = work + (size_t)blockIdx.x * 2 * kBlock;
  const size_t hb = (size_t)b * st.batch + (size_t)h * st.head;
  uint4 x[kPasses], y[kPasses];
  float l[kPasses];
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const int row = i * kBlock + grp + kStatRows * u;
    x[u] = y[u] = make_uint4(0u, 0u, 0u, 0u);  // rows >= N: D = 0
    l[u] = INFINITY;
    if (row < N) {
      const size_t off = hb + (size_t)row * st.row + 8 * m;
      x[u] = __ldg(reinterpret_cast<const uint4*>(dout + off));
      y[u] = __ldg(reinterpret_cast<const uint4*>(out + off));
      if (m == 0) l[u] = lse[(size_t)bh * N + row];
    }
  }
#pragma unroll
  for (int u = 0; u < kPasses; ++u) {
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x[u]);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y[u]);
    float p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(xp[j]), c = __bfloat1622float2(yp[j]);
      p[j] = a.x * c.x + a.y * c.y;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] += __shfl_xor_sync(0xffffffffu, p[j], o);
    if (m == 0) {
      const int r = grp + kStatRows * u;
      w[r] = l[u] * kLog2e;
      w[kBlock + r] = (p[0] + p[2]) + (p[1] + p[3]);
    }
  }
}

// A head's 2 ZS CTAs (ZS = ceil(NB / kBwdWarpgroups)) are neighbours in the
// grid: the first ZS take the dK/dV role (key tiles kBwdWarpgroups z, ...;
// the ring carries Q_i, dO_i and block i's statistics), the next ZS the dQ
// role (query tiles kBwdWarpgroups z, ...; the ring carries K_j, V_j). So
// both roles of a head run in the same wave and read its tiles while they
// are in L2; with every dK/dV CTA first, a head's tiles came from device
// memory once for each role (the inputs outgrow the 50 MB L2 at ViT-B's
// (64, 197, 12, 64)).
__global__ void __launch_bounds__(128 * kBwdWarpgroups, 1)
stream_bwd(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
           const __grid_constant__ CUtensorMap mdq, const __grid_constant__ CUtensorMap mdk,
           const __grid_constant__ CUtensorMap mdv, const float* __restrict__ work, int N, int H,
           int head_major, float scale, float scale_log2) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  bf16* mine = reinterpret_cast<bf16*>(base);  // K0 K1 V0 V1, or Q0 Q1 dO0 dO1
  bf16* ring = mine + 2 * kBwdWarpgroups * kTile;  // stage s: two tiles at ring + 2 s kTile
  float* stats = reinterpret_cast<float*>(ring + 2 * kBwdStages * kTile);  // stage s: 128 floats
  uint64_t* own = reinterpret_cast<uint64_t*>(stats + kBwdStages * 2 * kBlock);
  uint64_t* full = own + 1;
  uint64_t* empty = full + kBwdStages;

  const int NB = (N + kBlock - 1) / kBlock, ZS = (NB + kBwdWarpgroups - 1) / kBwdWarpgroups;
  const int bh = blockIdx.x / (2 * ZS), r = blockIdx.x % (2 * ZS);
  const bool kv = r < ZS;
  const int z = kv ? r : r - ZS;
  const int c0 = head_major ? 0 : (bh % H) * 64, c2 = head_major ? bh : bh / H;
  const int t0 = kBwdWarpgroups * z, nwg = min(kBwdWarpgroups, NB - t0);
  const int wgi = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * nwg);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wgi >= nwg) return;

  const float* wbh = work + (size_t)bh * NB * 2 * kBlock;
  Feed<kBwdStages> feed{full, empty, 0};
  auto issue = [&](int n, int s) {
    bf16* T = ring + 2 * s * kTile;
    if (kv) {
      mbar_expect_tx(&full[s], 2 * kTileBytes + kStatBytes);
      tma_load_3d(T, &mq, &full[s], c0, n * kBlock, c2);
      tma_load_3d(T + kTile, &mdo, &full[s], c0, n * kBlock, c2);
      bulk_load(stats + s * 2 * kBlock, wbh + n * 2 * kBlock, kStatBytes, &full[s]);
    } else {
      mbar_expect_tx(&full[s], 2 * kTileBytes);
      tma_load_3d(T, &mk, &full[s], c0, n * kBlock, c2);
      tma_load_3d(T + kTile, &mv, &full[s], c0, n * kBlock, c2);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(own, 2 * nwg * kTileBytes);
    for (int w = 0; w < nwg; ++w) {
      const int row = (t0 + w) * kBlock;
      tma_load_3d(mine + w * kTile, kv ? &mk : &mq, own, c0, row, c2);
      tma_load_3d(mine + (kBwdWarpgroups + w) * kTile, kv ? &mv : &mdo, own, c0, row, c2);
    }
    feed.upto(kBwdStages, NB, issue);
  }

  const int wl = threadIdx.x & 127, warp = wl >> 5, lane = wl & 31, g = lane >> 2, t = lane & 3;
  const int NL = (N - (NB - 1) * kBlock + 15) & ~15;   // the last block's width: 16, 32, 48 or 64
  const int tile = t0 + wgi;
  bf16* At = mine + wgi * kTile;                  // K (dK/dV role) or Q (dQ role)
  bf16* Bt = mine + (kBwdWarpgroups + wgi) * kTile;  // V or dO
  float acc0[32], acc1[32];                       // dK, dV; dQ in acc0
  if (kv) {
    const int k0 = tile * kBlock + warp * 16 + g;
    const bool valid0 = k0 < N, valid1 = k0 + 8 < N;
    mbar_wait(own, 0);
    for (int i = 0; i < NB; ++i) {
      if (threadIdx.x == 0) feed.upto(i + kBwdStages, NB, issue);
      const int s = take<kBwdStages>(full, i);
      const bf16* T = ring + 2 * s * kTile;
      const float* sl = stats + s * 2 * kBlock;
      by_width(i, NB, NL, [&](auto w) {
        wg::dkv_block<decltype(w)::value>(acc0, acc1, At, Bt, T, T + kTile, sl, sl + kBlock, i,
                                          scale, scale_log2, valid0, valid1, t);
      });
      mbar_arrive(&empty[s]);
    }
  } else {
    const int r = warp * 16 + g;
    const float* wi = wbh + tile * 2 * kBlock;
    const float l0 = wi[r], l1 = wi[r + 8], D0 = wi[kBlock + r], D1 = wi[kBlock + r + 8];
    mbar_wait(own, 0);
    for (int j = 0; j < NB; ++j) {
      if (threadIdx.x == 0) feed.upto(j + kBwdStages, NB, issue);
      const int s = take<kBwdStages>(full, j);
      const bf16* T = ring + 2 * s * kTile;
      by_width(j, NB, NL, [&](auto w) {
        wg::dq_block<decltype(w)::value>(acc0, At, Bt, T, T + kTile, j * kBlock, j, N, scale,
                                         scale_log2, l0, l1, D0, D1, t);
      });
      mbar_arrive(&empty[s]);
    }
  }

  // the results over the warpgroup's own tiles (their products are done), then TMA stores
  named_barrier(1 + wgi, 128);
  wg::acc_to_tile(reinterpret_cast<unsigned char*>(At), acc0, warp, g, t);
  if (kv) wg::acc_to_tile(reinterpret_cast<unsigned char*>(Bt), acc1, warp, g, t);
  fence_async_shared();
  named_barrier(1 + wgi, 128);
  if (wl == 0) {
    tma_store_3d(kv ? &mdk : &mdq, At, c0, tile * kBlock, c2);
    if (kv) tma_store_3d(&mdv, Bt, c0, tile * kBlock, c2);
    tma_store_commit();
    tma_store_wait_read();
  }
}

// --- host ----------------------------------------------------------------------

inline int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int N, int H, int head_major, float scale, cudaStream_t stream) {
  CUtensorMap m[4];
  const void* ptr[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (!wg::operand_map(&m[i], ptr[i], B, N, H, head_major)) return kMapError;
  const size_t smem = fwd_smem();
  cudaError_t err =
      cudaFuncSetAttribute(stream_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int zs = ((N + kBlock - 1) / kBlock + kFwdWarpgroups - 1) / kFwdWarpgroups;
  stream_fwd<<<B * H * zs, 128 * kFwdWarpgroups, smem, stream>>>(m[0], m[1], m[2], m[3], lse, N,
                                                                   H, head_major, scale * kLog2e);
  return (int)cudaGetLastError();
}

// work: B H ceil(N / 64) 128 f32 of scratch (lse2, then D, of each 64-row block).
inline int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                      const void* out, const float* lse, float* work, void* dq, void* dk,
                      void* dv, int B, int N, int H, int head_major, float scale,
                      cudaStream_t stream) {
  if (work == nullptr) return kNoScratch;
  CUtensorMap m[7];
  const void* ptr[7] = {q, k, v, dout, dq, dk, dv};
  for (int i = 0; i < 7; ++i)
    if (!wg::operand_map(&m[i], ptr[i], B, N, H, head_major)) return kMapError;
  const Strides st = head_major ? Strides{(long long)H * N * 64, (long long)N * 64, 64}
                                : Strides{(long long)N * H * 64, 64, H * 64};
  const int nb = (N + kBlock - 1) / kBlock, zs = (nb + kBwdWarpgroups - 1) / kBwdWarpgroups;
  stream_stats<<<B * H * nb, kStatThreads, 0, stream>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out), lse, work, st, N, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bwd_smem();
  err = cudaFuncSetAttribute(stream_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stream_bwd<<<2 * B * H * zs, 128 * kBwdWarpgroups, smem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], work, N, H, head_major, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace wgs
}  // namespace apvt
