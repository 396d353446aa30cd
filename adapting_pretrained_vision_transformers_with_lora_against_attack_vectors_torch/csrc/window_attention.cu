// Swin window attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/window_attention.py:fused_window_attention
// of the JAX package (_probs, _fwd_kernel, _bwd_kernel with pack=1): per
// (batch element b, window w, head h),
//   s = q k^T * hd^-1/2 + bias[h] + mask[w]      (f32)
//   P = softmax(s)                               (f32, max-subtracted)
//   o = P V                                      (P rounded to the input dtype)
// read straight from the raw qkv projection (B, nW, n, 3C): q, k and v of
// head h are the channel slices [h*hd, C + h*hd, 2C + h*hd], so no split
// copies are made. o is written to (B, nW, n, C) at the head's channels.
// The backward recomputes P and follows _bwd_kernel: dV = P^T dO (P rounded),
// dP = dO V^T, dS = P*(dP - rowsum(dP*P)), ds = dS*scale rounded to the input
// dtype, dQ = ds K, dK = ds^T Q, written as one (B, nW, n, 3C) dqkv. The
// bias gradient is not computed here: the wrapper recomputes it in plain
// PyTorch only when a caller asks for it, as the JAX VJP leaves it to XLA.
//
// What bounds it on the H100: one instance (n = 49, hd = 32) is ~0.3 MFLOP
// against ~12 KB of qkv/o traffic, ~25 FLOP/byte, far under the card's bf16
// ridge (~295): the kernel is bound by bytes (stage 3 of Swin-B moves 51 MB
// forward, 15 us at 3.35 TB/s). Its job, like the Pallas kernel's, is to keep
// scores and probabilities out of device memory and to read the projection
// once, with no head-split copies.
//
// Three device codes, chosen by the launchers below from the dtype and the
// head count alone (kernels/window_attention.py:kernel_variant is the same
// test; nothing else chooses):
//
// * bf16 with an even head count (every Swin-B and Swin-T stage but Swin-T's
//   odd ones), namespace wgw: the Hopper design.
//   - A CTA is one warpgroup and owns a (window, head pair, batch chunk): it
//     walks over the chunk's batch elements, so bias[h], bias[h+1] and
//     mask[w] are read once per CTA (not once per instance, as the first design
//     did: ~19 KB of f32 per instance from L2, twice the instance's
//     own bytes), kept in registers in the accumulators' layout, summed and
//     pre-scaled by log2 e: the softmax is exp2 with one reciprocal per row.
//     The batch is cut into chunks so that ~4 CTAs per SM exist at every
//     stage (Swin-B stage 4 has only 16 pairs).
//   - Two heads of one window side by side are 64 bf16 = one 128-byte row,
//     the tile format of sm90.cuh: a 3-D tensor map over qkv viewed as
//     (B nW, n, 3C) brings q, k, v (and dO, for the backward) of an instance
//     as 64-row boxes, whose rows n..63 TMA fills with zeros; the TMA stores
//     of o and dqkv drop them. The ragged window needs no branch in the data
//     path. The boxes arrive in a ring of two instances behind mbarriers, so
//     the next batch element's loads run under this one's products.
//   - Every product is wgmma on one 64-row tile: S = Q K^T over the head's
//     32 channels (two k16 steps at the head's half of the row), P V with P
//     from registers. P V, dQ = ds K, dV = P^T dO and dK = ds^T Q are m64n64
//     over both heads' channels, of which each head keeps its 32: an n32
//     operand at a 64-byte offset inside a swizzled row is not a layout
//     wgmma takes, and the products are not what bounds the kernel.
//   - The backward keeps P and ds in swizzled shared memory (fenced for the
//     async proxy) for dV = P^T dO and dK = ds^T Q with the transposed-A
//     operand; D = rowsum(dP * P) in f32 in registers. No atomics: one owner
//     per sum, bitwise reproducible.
// * bf16 with an odd head count, namespace tc (the first design): a CTA of 4
//   warps per (b, w, h), every product on mma.sync m16n8k16 with ldmatrix
//   operands, a warp per 16 query rows; the backward keeps P and ds in
//   shared memory for phase 2 (a warp per 16 key rows). Also reachable
//   through the *_mma_sync entry points, which chip_smoke.py times against
//   the Hopper design; no model path calls them.
// * f32, namespace cc: the same two phases on the CUDA cores, a warp per row
//   and a lane per key or channel.
//
// Takes hd = 32 and n <= 64 (window <= 8), any heads and nW, f32 and bf16.
// C interface (loaded with ctypes): each entry point returns the CUDA error
// code of its launch (cudaGetLastError), 0 on success, -1 for an
// unsupported dtype, head dim or window size, -2 if a tensor map could not
// be encoded.

#include <math.h>
#include <stddef.h>

#include "sm90.cuh"

namespace {

constexpr int kHD = 32;    // head dim of every Swin-B / Swin-T stage
constexpr int kMaxN = 64;  // tokens per window
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Hopper variant (bf16, even head count): wgmma + TMA.

namespace wgw {

using namespace apvt;
using namespace apvt::sm90;
using bf16 = __nv_bfloat16;
constexpr int kTileB = 8192;   // 64 rows x 64 bf16, swizzled
constexpr int kStages = 2;     // instances in flight in a CTA's ring
constexpr int kCtasPerSm = 4;  // the batch chunking aims at this many CTAs an SM
constexpr float kLog2e = 1.4426950408889634f;

// A CTA's window, first head and batch elements [b0, b0 + count).
struct Work {
  int w, h0, b0, count;
};

__device__ __forceinline__ Work work_of(int nw, int heads, int B, int chunks) {
  const int pair = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int per = (B + chunks - 1) / chunks;
  Work k;
  k.w = pair / (heads / 2);
  k.h0 = 2 * (pair % (heads / 2));
  k.b0 = chunk * per;
  k.count = max(0, min(per, B - k.b0));
  return k;
}

// (bias[h] + mask[w]) * log2 e at this thread's elements of a 64 x 64
// accumulator: -inf for keys >= n (P = 0), 0 for query rows >= n.
__device__ __forceinline__ void load_bm(float (&bm)[32], const float* __restrict__ bias,
                                        const float* __restrict__ mask, int h, int w, int n,
                                        int warp, int g, int t) {
  const float* bh = bias + (size_t)h * n * n;
  const float* mw = mask + (size_t)w * n * n;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t + (i & 1);
    float v = -INFINITY;
    if (col < n) v = row < n ? (__ldg(bh + row * n + col) + __ldg(mw + row * n + col)) * kLog2e : 0.f;
    bm[i] = v;
  }
}

// Scores (64 x 64 accumulator, unscaled) -> probabilities in place: f32,
// max-subtracted, exp2, one reciprocal per row.
__device__ __forceinline__ void softmax_rows(float (&s)[32], const float (&bm)[32],
                                             float scale_log2) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = s[i] * scale_log2 + bm[i];
    if (i & 2)
      m1 = fmaxf(m1, s[i]);
    else
      m0 = fmaxf(m0, s[i]);
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(s[i] - ((i & 2) ? m1 : m0));
    if (i & 2)
      l1 += s[i];
    else
      l0 += s[i];
  }
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= (i & 2) ? inv1 : inv0;
}

// The m16n8k16 A fragments (keys 16c..16c+15) of a 64 x 64 accumulator, rounded.
__device__ __forceinline__ void a_frags(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[c][r] = pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
  }
}

// Columns [32 hh, 32 hh + 32) of a 64 x 64 accumulator into a swizzled tile, rounded.
__device__ __forceinline__ void head_to_tile(unsigned char* tile, const float (&acc)[32], int hh,
                                             int warp, int g, int t) {
#pragma unroll
  for (int jt = 4 * hh; jt < 4 * hh + 4; ++jt) {
    const int r = warp * 16 + g, c = 8 * jt + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + swz(r, c)) = pack_bf16(acc[4 * jt], acc[4 * jt + 1]);
    *reinterpret_cast<uint32_t*>(tile + swz(r + 8, c)) =
        pack_bf16(acc[4 * jt + 2], acc[4 * jt + 3]);
  }
}

// S (64 x 64, unscaled) of head hh of the pair: its half of the tiles' rows.
__device__ __forceinline__ void scores(float (&s)[32], uint64_t a, uint64_t b, int hh) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    Wgmma<64>::template ss<0, 0>(s, madvance(a, 64 * hh + 32 * kk), madvance(b, 64 * hh + 32 * kk),
                                 kk);
}

constexpr size_t fwd_smem() { return 1024 + (size_t)(3 * kStages + 2) * kTileB + 64; }
constexpr size_t bwd_smem() { return 1024 + (size_t)(4 * kStages + 5) * kTileB + 64; }

__global__ void __launch_bounds__(128)
win_fwd(const __grid_constant__ CUtensorMap mqkv, const __grid_constant__ CUtensorMap mo,
        const float* __restrict__ bias, const float* __restrict__ mask, int n, int nw,
        int heads, int B, int chunks, float scale_log2) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* ring = base;                         // kStages x (q, k, v)
  unsigned char* stage = ring + 3 * kStages * kTileB;  // two o staging tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + 2 * kTileB);
  const Work wk = work_of(nw, heads, B, chunks);
  const int C = heads * 32;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto fetch = [&](int j) {   // thread 0: instance j's q, k, v into its slot
    const int s = j % kStages;
    unsigned char* slot = ring + s * 3 * kTileB;
    const int c2 = (wk.b0 + j) * nw + wk.w;
    mbar_expect_tx(&full[s], 3 * kTileB);
    for (int u = 0; u < 3; ++u) tma_load_3d(slot + u * kTileB, &mqkv, &full[s], u * C + wk.h0 * 32, 0, c2);
  };
  if (tid == 0)
    for (int j = 0; j < min(kStages, wk.count); ++j) fetch(j);

  float bm[2][32];   // under the first loads
  load_bm(bm[0], bias, mask, wk.h0, wk.w, n, warp, g, t);
  load_bm(bm[1], bias, mask, wk.h0 + 1, wk.w, n, warp, g, t);

  for (int j = 0; j < wk.count; ++j) {
    const int s = j % kStages;
    unsigned char* slot = ring + s * 3 * kTileB;
    unsigned char* st = stage + (j & 1) * kTileB;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint64_t dq = mdesc(slot), dk = mdesc(slot + kTileB), dv = mdesc(slot + 2 * kTileB);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sc[32];
      wgmma_fence();
      scores(sc, dq, dk, hh);
      wgmma_commit();
      wgmma_wait<0>();
      softmax_rows(sc, bm[hh], scale_log2);
      uint32_t pa[4][4];
      a_frags(pa, sc);
      float o[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) Wgmma<64>::template rs<1>(o, pa[c], madvance(dv, 2048 * c), c);
      wgmma_commit();
      wgmma_wait<0>();
      head_to_tile(st, o, hh, warp, g, t);
    }
    fence_async_shared();
    if (tid == 0) tma_store_wait_read();   // the other staging tile's store has read it
    __syncthreads();                       // the slot's products and the tile's writes are done
    if (tid == 0) {
      tma_store_3d(&mo, st, wk.h0 * 32, 0, (wk.b0 + j) * nw + wk.w);
      tma_store_commit();
      if (j + kStages < wk.count) fetch(j + kStages);
    }
  }
  if (tid == 0) tma_store_wait_read();
}

__global__ void __launch_bounds__(128)
win_bwd(const __grid_constant__ CUtensorMap mqkv, const __grid_constant__ CUtensorMap mdo,
        const __grid_constant__ CUtensorMap mdqkv, const float* __restrict__ bias,
        const float* __restrict__ mask, int n, int nw, int heads, int B, int chunks, float scale,
        float scale_log2) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = align1024(raw);
  unsigned char* ring = base;                          // kStages x (q, k, v, dO)
  unsigned char* Ps = ring + 4 * kStages * kTileB;     // P, then ds, of one head
  unsigned char* dSs = Ps + kTileB;
  unsigned char* stage = dSs + kTileB;                 // dq, dk, dv staging tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + 3 * kTileB);
  const Work wk = work_of(nw, heads, B, chunks);
  const int C = heads * 32;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int r0 = warp * 16 + g;   // this thread's query rows: r0 and r0 + 8
  const bool live0 = r0 < n, live1 = r0 + 8 < n;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto fetch = [&](int j) {   // thread 0: instance j's q, k, v and dO into its slot
    const int s = j % kStages;
    unsigned char* slot = ring + s * 4 * kTileB;
    const int c2 = (wk.b0 + j) * nw + wk.w;
    mbar_expect_tx(&full[s], 4 * kTileB);
    for (int u = 0; u < 3; ++u) tma_load_3d(slot + u * kTileB, &mqkv, &full[s], u * C + wk.h0 * 32, 0, c2);
    tma_load_3d(slot + 3 * kTileB, &mdo, &full[s], wk.h0 * 32, 0, c2);
  };
  if (tid == 0)
    for (int j = 0; j < min(kStages, wk.count); ++j) fetch(j);

  float bm[2][32];
  load_bm(bm[0], bias, mask, wk.h0, wk.w, n, warp, g, t);
  load_bm(bm[1], bias, mask, wk.h0 + 1, wk.w, n, warp, g, t);

  for (int j = 0; j < wk.count; ++j) {
    const int s = j % kStages;
    unsigned char* slot = ring + s * 4 * kTileB;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (tid == 0) tma_store_wait_read();   // the previous instance's stores have read the staging tiles
    __syncthreads();
    const uint64_t dq = mdesc(slot), dk = mdesc(slot + kTileB), dv = mdesc(slot + 2 * kTileB);
    const uint64_t ddo = mdesc(slot + 3 * kTileB);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // phase 1, a row per query: P, dP, ds; P and ds to shared memory; dQ = ds K
      float sc[32], dp[32];
      wgmma_fence();
      scores(sc, dq, dk, hh);
      wgmma_commit();
      scores(dp, ddo, dv, hh);
      wgmma_commit();
      wgmma_wait<1>();   // S is there; its softmax runs under dP's products
      softmax_rows(sc, bm[hh], scale_log2);
      wgmma_wait<0>();
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2)
          d1 += sc[i] * dp[i];
        else
          d0 += sc[i] * dp[i];
      }
      d0 = quad_sum(d0);
      d1 = quad_sum(d1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool live = (i & 2) ? live1 : live0;
        dp[i] = live ? sc[i] * (dp[i] - ((i & 2) ? d1 : d0)) * scale : 0.f;
        sc[i] = live ? sc[i] : 0.f;
      }
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        const int c = 8 * jt + 2 * t;
        *reinterpret_cast<uint32_t*>(Ps + swz(r0, c)) = pack_bf16(sc[4 * jt], sc[4 * jt + 1]);
        *reinterpret_cast<uint32_t*>(Ps + swz(r0 + 8, c)) =
            pack_bf16(sc[4 * jt + 2], sc[4 * jt + 3]);
        *reinterpret_cast<uint32_t*>(dSs + swz(r0, c)) = pack_bf16(dp[4 * jt], dp[4 * jt + 1]);
        *reinterpret_cast<uint32_t*>(dSs + swz(r0 + 8, c)) =
            pack_bf16(dp[4 * jt + 2], dp[4 * jt + 3]);
      }
      uint32_t sa[4][4];
      a_frags(sa, dp);
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) Wgmma<64>::template rs<1>(acc, sa[c], madvance(dk, 2048 * c), c);
      wgmma_commit();
      wgmma_wait<0>();
      head_to_tile(stage, acc, hh, warp, g, t);
      fence_async_shared();   // P and ds for the async proxy
      __syncthreads();

      // phase 2, a row per key: dV = P^T dO, dK = ds^T Q
      float dvv[32];
      const uint64_t ap = mdesc(Ps), as = mdesc(dSs);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Wgmma<64>::template ss<1, 1>(dvv, madvance(ap, 2048 * kk), madvance(ddo, 2048 * kk), kk);
        Wgmma<64>::template ss<1, 1>(acc, madvance(as, 2048 * kk), madvance(dq, 2048 * kk), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      head_to_tile(stage + kTileB, acc, hh, warp, g, t);
      head_to_tile(stage + 2 * kTileB, dvv, hh, warp, g, t);
      fence_async_shared();
      __syncthreads();   // P and ds are read: the next head may write them
    }
    if (tid == 0) {
      const int c2 = (wk.b0 + j) * nw + wk.w;
      for (int u = 0; u < 3; ++u) tma_store_3d(&mdqkv, stage + u * kTileB, u * C + wk.h0 * 32, 0, c2);
      tma_store_commit();
      if (j + kStages < wk.count) fetch(j + kStages);
    }
  }
  if (tid == 0) tma_store_wait_read();
}

// qkv-like (B nW, n, width) bf16 in 64-row boxes of 64 channels.
inline bool rows_map(CUtensorMap* map, const void* p, int bw, int n, int width) {
  const uint64_t dims[3] = {(uint64_t)width, (uint64_t)n, (uint64_t)bw};
  const uint64_t strides[2] = {(uint64_t)width * 2, (uint64_t)n * width * 2};
  return make_map(map, p, 3, dims, strides, 64);
}

// Batch chunks per (window, head pair): about kCtasPerSm CTAs an SM.
inline int chunks_for(int B, int pairs) {
  static const int sms = [] {
    int d = 0, v = 132;
    cudaGetDevice(&d);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, d);
    return v;
  }();
  const int c = (kCtasPerSm * sms + pairs - 1) / pairs;
  return c < 1 ? 1 : (c > B ? B : c);
}

int launch_fwd(const void* qkv, const float* bias, const float* mask, void* out, int B, int nw,
               int n, int heads, float scale, cudaStream_t stream) {
  const int C = heads * 32;
  CUtensorMap mqkv, mo;
  if (!rows_map(&mqkv, qkv, B * nw, n, 3 * C) || !rows_map(&mo, out, B * nw, n, C))
    return kMapError;
  const int pairs = nw * heads / 2, chunks = chunks_for(B, pairs);
  return launch(win_fwd, pairs * chunks, fwd_smem(), stream, mqkv, mo, bias, mask, n, nw, heads,
                B, chunks, scale * kLog2e);
}

int launch_bwd(const void* qkv, const float* bias, const float* mask, const void* dout,
               void* dqkv, int B, int nw, int n, int heads, float scale, cudaStream_t stream) {
  const int C = heads * 32;
  CUtensorMap mqkv, mdo, mdqkv;
  if (!rows_map(&mqkv, qkv, B * nw, n, 3 * C) || !rows_map(&mdo, dout, B * nw, n, C) ||
      !rows_map(&mdqkv, dqkv, B * nw, n, 3 * C))
    return kMapError;
  const int pairs = nw * heads / 2, chunks = chunks_for(B, pairs);
  return launch(win_bwd, pairs * chunks, bwd_smem(), stream, mqkv, mdo, mdqkv, bias, mask, n, nw,
                heads, B, chunks, scale, scale * kLog2e);
}

}  // namespace wgw

// ---------------------------------------------------------------------------
// Tensor-core variant (bf16).

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int S = kHD + 8;      // bf16 per row of a q/k/v/dO tile: 80 bytes
constexpr int SP = kMaxN + 8;   // bf16 per row of a P/ds tile: 144 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one bf16x2 word, round to nearest even; `lo` at the lower column.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane addresses into a row-major tile of row stride LD. a_addr: the A
// operand (16 x 16 at (r0, c0)); with ldsm_t, the B operand of the n-tiles
// c0 and c0+8 from a [k][n] tile. b_addr: the B operand of the n-tiles n0
// and n0+8 from an [n][k] tile (k-chunk at c0); with ldsm_t, the A operand
// of the transpose of the 16 x 16 block at (n0, c0).
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int n0, int c0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8;
}

// Rows [0, n) of one head's hd channels (row stride ld) -> NP tile rows,
// 16 bytes per thread and step, rows >= n zero.
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int ld, int n, int NP) {
  constexpr int V = kHD / 8;
  for (int idx = threadIdx.x; idx < NP * V; idx += blockDim.x) {
    const int j = idx / V, c = idx % V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < n) val = *reinterpret_cast<const uint4*>(src + (size_t)j * ld + c * 8);
    *reinterpret_cast<uint4*>(dst + j * S + c * 8) = val;
  }
}

// Probabilities of 16 query rows (A fragments qa) against every key of Ks:
// s[nt][e] = P[row][key], row = r0 + g + 8*(e>>1), key = 8*nt + 2t + (e&1).
// Keys >= n get P = 0; rows >= n see no bias or mask (and are never stored).
__device__ __forceinline__ void probs_rows(float (&s)[kMaxN / 8][4],
                                           const uint32_t (&qa)[kHD / 16][4], const bf16* Ks,
                                           const float* __restrict__ bias_h,
                                           const float* __restrict__ mask_w, int r0, int n,
                                           int NP, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxN / 16; ++c) {
    if (c * 16 < NP) {
#pragma unroll
      for (int kc = 0; kc < kHD / 16; ++kc) {
        uint32_t bb[4];
        ldsm(bb, b_addr<S>(Ks, c * 16, kc * 16, lane));
        mma(s[2 * c], qa[kc], bb[0], bb[1]);
        mma(s[2 * c + 1], qa[kc], bb[2], bb[3]);
      }
    }
  }
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), key = nt * 8 + 2 * t + (e & 1);
      float v = -INFINITY;
      if (key < n) {
        v = s[nt][e] * scale;
        if (row < n) {
          v = v + __ldg(bias_h + row * n + key);
          v = v + __ldg(mask_w + row * n + key);
        }
      }
      s[nt][e] = v;
      m[e >> 1] = fmaxf(m[e >> 1], v);
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
  }
#pragma unroll
  for (int nt = 0; nt < kMaxN / 8; ++nt) {
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
  for (int nt = 0; nt < kMaxN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] / l[e >> 1];
  }
}

// Store a 16 x hd accumulator block (rows r0..) as bf16; rows >= n skipped.
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, int ld, int r0, int n,
                                           const float (&acc)[kHD / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < n) {
#pragma unroll
      for (int nt = 0; nt < kHD / 8; ++nt)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * ld + nt * 8 + 2 * t) =
            pack(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// A fragments of the 16 x 16 block of keys 16c..16c+15 from score-layout
// accumulators, rounded to bf16.
__device__ __forceinline__ void frag(uint32_t (&a)[4], const float (&s)[kMaxN / 8][4], int c) {
  a[0] = pack(s[2 * c][0], s[2 * c][1]);
  a[1] = pack(s[2 * c][2], s[2 * c][3]);
  a[2] = pack(s[2 * c + 1][0], s[2 * c + 1][1]);
  a[3] = pack(s[2 * c + 1][2], s[2 * c + 1][3]);
}

__device__ __forceinline__ void zero(float (&acc)[kHD / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < kHD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
win_fwd(const bf16* __restrict__ qkv, const float* __restrict__ bias,
        const float* __restrict__ mask, bf16* __restrict__ out, int n, int nw, int heads,
        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % heads, bw = blockIdx.x / heads, w = bw % nw;
  const int C = heads * kHD, ld = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int NP = (n + 15) & ~15;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * S;
  const bf16* q = qkv + (size_t)bw * n * ld + h * kHD;
  load_tile(Ks, q + C, ld, n, NP);
  load_tile(Vs, q + 2 * C, ld, n, NP);
  __syncthreads();
  const float* bias_h = bias + (size_t)h * n * n;
  const float* mask_w = mask + (size_t)w * n * n;

  for (int r0 = warp * 16; r0 < NP; r0 += kWarps * 16) {
    uint32_t qa[kHD / 16][4];
#pragma unroll
    for (int kc = 0; kc < kHD / 16; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i & 1), col = kc * 16 + 8 * (i >> 1) + 2 * t;
        qa[kc][i] = row < n ? *reinterpret_cast<const uint32_t*>(q + (size_t)row * ld + col) : 0u;
      }
    }
    float s[kMaxN / 8][4];
    probs_rows(s, qa, Ks, bias_h, mask_w, r0, n, NP, scale);
    float acc[kHD / 8][4];
    zero(acc);
#pragma unroll
    for (int c = 0; c < kMaxN / 16; ++c) {
      if (c * 16 < NP) {
        uint32_t pa[4];
        frag(pa, s, c);
#pragma unroll
        for (int dc = 0; dc < kHD / 16; ++dc) {
          uint32_t bb[4];
          ldsm_t(bb, a_addr<S>(Vs, c * 16, dc * 16, lane));
          mma(acc[2 * dc], pa, bb[0], bb[1]);
          mma(acc[2 * dc + 1], pa, bb[2], bb[3]);
        }
      }
    }
    store_rows(out + (size_t)bw * n * C + h * kHD, C, r0, n, acc);
  }
}

__global__ void __launch_bounds__(kThreads)
win_bwd(const bf16* __restrict__ qkv, const float* __restrict__ bias,
        const float* __restrict__ mask, const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
        int n, int nw, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % heads, bw = blockIdx.x / heads, w = bw % nw;
  const int C = heads * kHD, ld = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int NP = (n + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + NP * S;
  bf16* Vs = Ks + NP * S;
  bf16* dOs = Vs + NP * S;
  bf16* Ps = dOs + NP * S;
  bf16* dSs = Ps + NP * SP;
  const bf16* q = qkv + (size_t)bw * n * ld + h * kHD;
  load_tile(Qs, q, ld, n, NP);
  load_tile(Ks, q + C, ld, n, NP);
  load_tile(Vs, q + 2 * C, ld, n, NP);
  load_tile(dOs, dout + (size_t)bw * n * C + h * kHD, C, n, NP);
  __syncthreads();
  const float* bias_h = bias + (size_t)h * n * n;
  const float* mask_w = mask + (size_t)w * n * n;
  bf16* dq = dqkv + (size_t)bw * n * ld + h * kHD;

  // Phase 1: a warp per 16 query rows -> P and ds into shared memory, dQ.
  for (int r0 = warp * 16; r0 < NP; r0 += kWarps * 16) {
    float s[kMaxN / 8][4];
    {
      uint32_t qa[kHD / 16][4];
#pragma unroll
      for (int kc = 0; kc < kHD / 16; ++kc) ldsm(qa[kc], a_addr<S>(Qs, r0, kc * 16, lane));
      probs_rows(s, qa, Ks, bias_h, mask_w, r0, n, NP, scale);
    }
    uint32_t da[kHD / 16][4];
#pragma unroll
    for (int kc = 0; kc < kHD / 16; ++kc) ldsm(da[kc], a_addr<S>(dOs, r0, kc * 16, lane));
    float dp[kMaxN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxN / 16; ++c) {
      if (c * 16 < NP) {
#pragma unroll
        for (int kc = 0; kc < kHD / 16; ++kc) {
          uint32_t bb[4];
          ldsm(bb, b_addr<S>(Vs, c * 16, kc * 16, lane));
          mma(dp[2 * c], da[kc], bb[0], bb[1]);
          mma(dp[2 * c + 1], da[kc], bb[2], bb[3]);
        }
      }
    }
    float D[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) D[e >> 1] += s[nt][e] * dp[nt][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      D[r] += __shfl_xor_sync(0xffffffffu, D[r], 1);
      D[r] += __shfl_xor_sync(0xffffffffu, D[r], 2);
    }
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = r0 + g + 8 * (e >> 1) < n && nt * 8 + 2 * t + (e & 1) < n;
        dp[nt][e] = valid ? s[nt][e] * (dp[nt][e] - D[e >> 1]) * scale : 0.f;
        s[nt][e] = valid ? s[nt][e] : 0.f;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      if (nt * 8 < NP) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (r0 + g + 8 * r) * SP + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(Ps + off) = pack(s[nt][2 * r], s[nt][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dSs + off) = pack(dp[nt][2 * r], dp[nt][2 * r + 1]);
        }
      }
    }
    float acc[kHD / 8][4];
    zero(acc);
#pragma unroll
    for (int c = 0; c < kMaxN / 16; ++c) {
      if (c * 16 < NP) {
        uint32_t sa[4];
        frag(sa, dp, c);
#pragma unroll
        for (int dc = 0; dc < kHD / 16; ++dc) {
          uint32_t bb[4];
          ldsm_t(bb, a_addr<S>(Ks, c * 16, dc * 16, lane));
          mma(acc[2 * dc], sa, bb[0], bb[1]);
          mma(acc[2 * dc + 1], sa, bb[2], bb[3]);
        }
      }
    }
    store_rows(dq, ld, r0, n, acc);
  }
  __syncthreads();

  // Phase 2: a warp per 16 key rows; dV = P^T dO and dK = ds^T Q over query
  // chunks, P^T and ds^T read from shared memory with ldmatrix .trans.
  for (int j0 = warp * 16; j0 < NP; j0 += kWarps * 16) {
    float dk_acc[kHD / 8][4], dv_acc[kHD / 8][4];
    zero(dk_acc);
    zero(dv_acc);
    for (int c = 0; c < NP / 16; ++c) {
      uint32_t pa[4], sa[4];
      ldsm_t(pa, b_addr<SP>(Ps, c * 16, j0, lane));
      ldsm_t(sa, b_addr<SP>(dSs, c * 16, j0, lane));
#pragma unroll
      for (int dc = 0; dc < kHD / 16; ++dc) {
        uint32_t bb[4];
        ldsm_t(bb, a_addr<S>(dOs, c * 16, dc * 16, lane));
        mma(dv_acc[2 * dc], pa, bb[0], bb[1]);
        mma(dv_acc[2 * dc + 1], pa, bb[2], bb[3]);
        ldsm_t(bb, a_addr<S>(Qs, c * 16, dc * 16, lane));
        mma(dk_acc[2 * dc], sa, bb[0], bb[1]);
        mma(dk_acc[2 * dc + 1], sa, bb[2], bb[3]);
      }
    }
    store_rows(dq + C, ld, j0, n, dk_acc);
    store_rows(dq + 2 * C, ld, j0, n, dv_acc);
  }
}

size_t fwd_smem(int n) { return 2 * (size_t)((n + 15) & ~15) * S * sizeof(bf16); }

size_t bwd_smem(int n) {
  const size_t np = (size_t)((n + 15) & ~15);
  return (4 * np * S + 2 * np * SP) * sizeof(bf16);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA-core variant (f32): a warp per row, a lane per key (two per lane) or
// per output channel (hd = 32 = one warp).

namespace cc {

constexpr int S = kHD + 1;     // floats per row of a q/k/v/dO tile
constexpr int SP = kMaxN + 1;  // floats per row of a P/ds tile

__device__ void load_tile(float* dst, const float* __restrict__ src, int ld, int n) {
  for (int idx = threadIdx.x; idx < n * kHD; idx += blockDim.x) {
    const int j = idx / kHD, d = idx % kHD;
    dst[j * S + d] = src[(size_t)j * ld + d];
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < kHD; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// P[i][j] for the keys j = lane and lane + 32 of query row qi (0 past n).
__device__ __forceinline__ void probs_row(float (&p)[2], const float* qi, const float* Ks,
                                          const float* __restrict__ bias_row,
                                          const float* __restrict__ mask_row, int n,
                                          float scale) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = lane + 32 * u;
    float v = -INFINITY;
    if (j < n) {
      v = dot(qi, Ks + j * S) * scale;
      v = v + __ldg(bias_row + j);
      v = v + __ldg(mask_row + j);
    }
    p[u] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  float l = 0.f;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    p[u] = lane + 32 * u < n ? expf(p[u] - m) : 0.f;
    l += p[u];
  }
  l = warp_sum(l);
#pragma unroll
  for (int u = 0; u < 2; ++u) p[u] = p[u] / l;
}

__global__ void __launch_bounds__(kThreads)
win_fwd(const float* __restrict__ qkv, const float* __restrict__ bias,
        const float* __restrict__ mask, float* __restrict__ out, int n, int nw, int heads,
        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % heads, bw = blockIdx.x / heads, w = bw % nw;
  const int C = heads * kHD, ld = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + n * S;
  float* Vs = Ks + n * S;
  float* prow = Vs + n * S + warp * kMaxN;
  const float* q = qkv + (size_t)bw * n * ld + h * kHD;
  load_tile(Qs, q, ld, n);
  load_tile(Ks, q + C, ld, n);
  load_tile(Vs, q + 2 * C, ld, n);
  __syncthreads();
  float* o = out + (size_t)bw * n * C + h * kHD;
  for (int i = warp; i < n; i += kWarps) {
    float p[2];
    probs_row(p, Qs + i * S, Ks, bias + ((size_t)h * n + i) * n, mask + ((size_t)w * n + i) * n,
              n, scale);
    prow[lane] = p[0];
    prow[lane + 32] = p[1];
    __syncwarp();
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(prow[j], Vs[j * S + lane], acc);
    o[(size_t)i * C + lane] = acc;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
win_bwd(const float* __restrict__ qkv, const float* __restrict__ bias,
        const float* __restrict__ mask, const float* __restrict__ dout,
        float* __restrict__ dqkv, int n, int nw, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x % heads, bw = blockIdx.x / heads, w = bw % nw;
  const int C = heads * kHD, ld = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + n * S;
  float* Vs = Ks + n * S;
  float* dOs = Vs + n * S;
  float* Ps = dOs + n * S;
  float* dSs = Ps + n * SP;
  const float* q = qkv + (size_t)bw * n * ld + h * kHD;
  load_tile(Qs, q, ld, n);
  load_tile(Ks, q + C, ld, n);
  load_tile(Vs, q + 2 * C, ld, n);
  load_tile(dOs, dout + (size_t)bw * n * C + h * kHD, C, n);
  __syncthreads();
  float* dq = dqkv + (size_t)bw * n * ld + h * kHD;

  // Phase 1: a warp per query row -> P and ds rows into shared memory, dQ.
  for (int i = warp; i < n; i += kWarps) {
    float p[2], dp[2] = {0.f, 0.f};
    probs_row(p, Qs + i * S, Ks, bias + ((size_t)h * n + i) * n, mask + ((size_t)w * n + i) * n,
              n, scale);
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      if (j < n) dp[u] = dot(dOs + i * S, Vs + j * S);
      part += p[u] * dp[u];
    }
    const float D = warp_sum(part);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      if (j < n) {
        Ps[i * SP + j] = p[u];
        dSs[i * SP + j] = p[u] * (dp[u] - D) * scale;
      }
    }
    __syncwarp();
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(dSs[i * SP + j], Ks[j * S + lane], acc);
    dq[(size_t)i * ld + lane] = acc;
  }
  __syncthreads();

  // Phase 2: a warp per key row -> dV = P^T dO, dK = ds^T Q.
  for (int j = warp; j < n; j += kWarps) {
    float dv = 0.f, dk = 0.f;
    for (int i = 0; i < n; ++i) {
      dv = fmaf(Ps[i * SP + j], dOs[i * S + lane], dv);
      dk = fmaf(dSs[i * SP + j], Qs[i * S + lane], dk);
    }
    dq[(size_t)j * ld + C + lane] = dk;
    dq[(size_t)j * ld + 2 * C + lane] = dv;
  }
}

size_t fwd_smem(int n) { return (3 * (size_t)n * S + kWarps * kMaxN) * sizeof(float); }

size_t bwd_smem(int n) { return (4 * (size_t)n * S + 2 * (size_t)n * SP) * sizeof(float); }

}  // namespace cc

bool supported(int n, int hd, int dtype) {
  return hd == kHD && n >= 1 && n <= kMaxN && (dtype == 0 || dtype == 1);
}

// The Hopper kernels take bf16 with an even head count (two heads = one
// 128-byte row); everything else keeps the first design's kernels.
bool use_wgmma(int heads, int dtype) { return dtype == 1 && heads % 2 == 0; }

int fwd(const void* qkv, const void* bias, const void* mask, void* out, int B, int nw, int n,
        int heads, int hd, int dtype, float scale, void* stream, bool hopper) {
  if (!supported(n, hd, dtype) || heads < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = B * nw * heads;
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch(cc::win_fwd, grid, cc::fwd_smem(n), s, static_cast<const float*>(qkv), b, m,
                  static_cast<float*>(out), n, nw, heads, scale);
  if (hopper && use_wgmma(heads, dtype))
    return wgw::launch_fwd(qkv, b, m, out, B, nw, n, heads, scale, s);
  return launch(tc::win_fwd, grid, tc::fwd_smem(n), s, static_cast<const tc::bf16*>(qkv), b, m,
                static_cast<tc::bf16*>(out), n, nw, heads, scale);
}

int bwd(const void* qkv, const void* bias, const void* mask, const void* dout, void* dqkv, int B,
        int nw, int n, int heads, int hd, int dtype, float scale, void* stream, bool hopper) {
  if (!supported(n, hd, dtype) || heads < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = B * nw * heads;
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch(cc::win_bwd, grid, cc::bwd_smem(n), s, static_cast<const float*>(qkv), b, m,
                  static_cast<const float*>(dout), static_cast<float*>(dqkv), n, nw, heads,
                  scale);
  if (hopper && use_wgmma(heads, dtype))
    return wgw::launch_bwd(qkv, b, m, dout, dqkv, B, nw, n, heads, scale, s);
  return launch(tc::win_bwd, grid, tc::bwd_smem(n), s, static_cast<const tc::bf16*>(qkv), b, m,
                static_cast<const tc::bf16*>(dout), static_cast<tc::bf16*>(dqkv), n, nw,
                heads, scale);
}

}  // namespace

extern "C" {

// qkv (B, nW, n, 3C), bias (heads, n, n) f32, mask (nW, n, n) f32 ->
// out (B, nW, n, C). dtype: 0 = float32, 1 = bfloat16.
int apvt_win_attn_fwd(const void* qkv, const void* bias, const void* mask, void* out, int B,
                      int nw, int n, int heads, int hd, int dtype, float scale, void* stream) {
  return fwd(qkv, bias, mask, out, B, nw, n, heads, hd, dtype, scale, stream, true);
}

// ... and the cotangent dout (B, nW, n, C) -> dqkv (B, nW, n, 3C).
int apvt_win_attn_bwd(const void* qkv, const void* bias, const void* mask, const void* dout,
                      void* dqkv, int B, int nw, int n, int heads, int hd, int dtype,
                      float scale, void* stream) {
  return bwd(qkv, bias, mask, dout, dqkv, B, nw, n, heads, hd, dtype, scale, stream, true);
}

// The same with the first design's device code at every bf16 shape: for timing the
// Hopper kernels against it (chip_smoke.py); no model path calls these.
int apvt_win_attn_fwd_mma_sync(const void* qkv, const void* bias, const void* mask, void* out,
                               int B, int nw, int n, int heads, int hd, int dtype, float scale,
                               void* stream) {
  return fwd(qkv, bias, mask, out, B, nw, n, heads, hd, dtype, scale, stream, false);
}

int apvt_win_attn_bwd_mma_sync(const void* qkv, const void* bias, const void* mask,
                               const void* dout, void* dqkv, int B, int nw, int n, int heads,
                               int hd, int dtype, float scale, void* stream) {
  return bwd(qkv, bias, mask, dout, dqkv, B, nw, n, heads, hd, dtype, scale, stream, false);
}

// Dynamic shared memory of the Hopper kernels in bytes: 0 win_fwd, 1 win_bwd
// (the same at every shape); -1 for another index.
int apvt_win_attn_smem(int which) {
  return which == 0 ? (int)wgw::fwd_smem() : which == 1 ? (int)wgw::bwd_smem() : -1;
}

const char* apvt_win_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
