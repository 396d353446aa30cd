// Fused MLP over token rows, with and without the LayerNorm folded in,
// forward and input gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels kernels/mlp.py:fused_ln_mlp (_ln_fwd_kernel,
// _ln_bwd_kernel) and kernels/mlp.py:fused_mlp (_fwd_kernel, _bwd_kernel) of
// the JAX package. One device code serves both: the template flag LN folds
// the LayerNorm in; without it h = x and dx = dhid, every other step and
// rounding point is the same. Over token rows x (T, D) in bf16,
//   h   = LN(x) * scale + bias            (f32, two-pass mean/var; the normalised value,
//                                          its product with scale and the sum each
//                                          rounded as the plain version rounds them,
//                                          tiles.cuh:ln_affine; rounded to bf16)
//   pre = h W1 + b1                       (f32 accumulation, bias added in f32)
//   a   = gelu(pre)                       (exact, erff, f32; rounded to bf16)
//   y   = a W2 + b2                       (f32 accumulation, bias in f32; rounded to bf16)
// with W1 (D, M) and W2 (M, D) row-major in bf16, M a multiple of 128. The
// hidden activation (T, M) never reaches device memory. The backward kernel
// computes dx only: it recomputes h and pre, then
//   dh   = dy W2^T                        (f32 accumulation)
//   dpre = dh * gelu'(pre)                (f32; rounded to bf16)
//   dhid = dpre W1^T                      (f32 accumulation)
//   dx   = rstd * (dn - mean(dn) - n * mean(dn * n)),  dn = dhid * scale, n = (x - mean) * rstd
// rounded once. Parameter gradients are not computed here: the wrapper
// recomputes them in plain PyTorch only when a caller asks for them, as the
// JAX VJP leaves them to XLA.
//
// What bounds it on the H100: 4 T D M FLOP forward and 6 T D M backward
// against 4-6 T D bytes of activations plus the weights, 500-4000 FLOP per
// byte: far above the bf16 ridge (295), so the tensor cores are the limit
// (0.12 ms forward, 0.18 ms backward at the ViT-B shape at the dense bf16
// peak) if the hidden activation stays on chip and the weights, which no SM
// can hold (up to 16.8 MB against 227 KB), are streamed from L2 rarely
// enough: 64 token rows per pass over the weights is 1.9 GB of L2 reads per
// forward launch at the ViT-B shape, 16 rows (the mma.sync version,
// ln_mlp_mma.cuh) 7.4 GB, which ran at the L2's rate, not the tensor cores'.
//
// What the design does about it (namespace wgk below):
// * 64 token rows per pass at every width. The 64 x D f32 output does not
//   fit one SM's registers at D >= 768, so from D = 512 on a thread block
//   cluster of two CTAs splits D (at 512 it halves the accumulators and
//   doubles the CTAs, 392 for 132 SMs at the ConvNeXt-B stage-3 shape; it
//   measured 6-10% faster than one CTA): each CTA owns D/2 output columns
//   and half of every hidden chunk's columns, reads only its share of W1
//   and W2, and writes its bf16 hidden slices into both CTAs' shared memory
//   (st.shared::cluster through mapa), signalling an mbarrier in each. Below
//   512 a CTA is its own cluster;
// * a CTA is two consumer warpgroups and a producer warpgroup (one warp of
//   it starts the loads, a lane per box; setmaxnreg gives its registers to
//   the consumers). The consumers
//   split the CTA's output columns and the chunk's hidden columns in
//   halves; all products are wgmma.mma_async with both operands in shared
//   memory. Row-major W1 (D, M) and W2 (M, D) are the MN-major B operand in
//   the forward and the K-major one in the backward's two transposed
//   products (dh = dy W2^T, dhid = dpre W1^T): no transposed copy of a
//   weight exists;
// * weights (and, in the backward, the 64 x 64 slabs of dy) arrive by TMA in
//   128-byte-swizzled boxes through a ring of four 16 KB stages with a full
//   and an empty mbarrier each: a consumer waits for the stage it needs and
//   for nothing else; there is no block-wide barrier in the main loop. The
//   64 x D rows of x arrive by TMA too and stay resident; with the
//   LayerNorm the consumers normalise them in place, a warp per row;
// * bias + GELU (gelu' in the backward) of one warpgroup run under the
//   other's wgmma, and under the other CTAs of the SM where two fit;
// * the LayerNorm backward runs on the accumulators in registers: row sums
//   per warpgroup, exchanged through both CTAs' shared memory in a fixed
//   order (no atomics: dx is bitwise reproducible), mean and rstd kept from
//   the prologue. Results leave through swizzled staging tiles and TMA
//   stores, which drop the rows past T.
//
// What still holds it at about a third of the tensor peak (NVIDIA H100 80GB
// HBM3, 700 W; tools/ln_mlp_diagnose.py and PERF.md): two limits of about
// equal size. 64 rows per pass is 1.9 GB (forward) and 3.6 GB (backward) of
// L2 reads per launch at the ViT-B shape, 5 to 6 TB/s at the measured times,
// the L2's rate: without the products the forward still takes 87% of its
// time. And without the weight loads it takes 82%: a stage is one to four
// wgmma, and each stage pays its barrier round trip and the wait for its
// products. Neither GELU (6%) nor the meeting point per chunk (3%) matters.
// Tried and measured no faster: eight ring stages; a wgmma group kept in
// flight across stages, or two stages per wait (a barrier wait between
// products makes ptxas serialise them, and fewer free stages starve the
// loads); a cheaper erf; sharing the weight boxes of two row blocks by TMA
// multicast (half the L2 reads, but the two CTAs' rings are then coupled
// through remote barriers: 1.35 times slower). What would help is 128 rows
// per pass, which needs the resident rows streamed instead.
//
// Shapes: bf16, D in {128, 256, 384, 512, 768, 1024}, any T. The wgmma
// kernels take M a multiple of 128 (D <= 384) or of 256 (D >= 512: a chunk is
// 128 hidden columns per CTA of the cluster). Two cases keep the mma.sync
// kernels of ln_mlp_mma.cuh, by tests of the shape in the launchers below
// (kernels/mlp.py:kernel_variant is the same test; no flag chooses): D >= 512
// with M = 128 mod 256, which the cluster's chunk does not divide; and the
// LayerNorm-fused forward at D = 128, where the wgmma kernel measured 3%
// slower (a CTA's fixed costs weigh most at the narrowest width).
//
// C interface (loaded with ctypes): each entry point returns the CUDA error
// code of its launch (cudaGetLastError), 0 on success, -1 for an unsupported
// shape, -2 if a tensor map could not be encoded.

#include "ln_mlp_mma.cuh"
#include "sm90.cuh"
#include "wg_ring.cuh"

namespace {

using namespace apvt;

namespace wgk {

using namespace apvt::sm90;

constexpr int kThreads = 384;        // two consumer warpgroups and the producer's
constexpr int kStage = 16384;        // bytes of a ring stage
constexpr int kTileB = 8192;         // bytes of a 64 x 64 bf16 tile
constexpr int kStages = 4;           // of the ring; eight where they fit measured no faster
constexpr int kSmemMax = 232448;     // what a CTA may ask for

template <int D>
struct Cfg {
  static_assert(D % 128 == 0 && D <= 1024, "D must be a multiple of 128, at most 1024");
  static constexpr int CL = D >= 512 ? 2 : 1;      // CTAs of a cluster: D is split over them
  static constexpr int HC = 128 * CL;              // hidden columns of a chunk, cluster-wide
  static constexpr int NC = D / CL;                // output columns of a CTA
  static constexpr int NW = NC / 2;                // ... of a warpgroup
  static constexpr int KT = D / 64;                // 64-wide k tiles of the resident rows
  static constexpr int HT = HC / 64;               // tiles of a hidden buffer
  static constexpr int HB = D >= 1024 ? 1 : 2;     // hidden buffers
  // rows of W2 per stage in the forward's second product (a stage holds KS2 x NC)
  static constexpr int KS2 = NC >= 384 ? 16 : (NC >= 256 ? 32 : 64);
  // the backward's third product takes W1 in blocks of NS of the warpgroup's rows
  static constexpr int NS = NW % 128 == 0 ? 128 : 64;
  static constexpr int NSB = NW / NS;
  // registers a thread after setmaxnreg (consumers, producer); what the two
  // consumer warpgroups take and the producer keeps must fit what the CTA has
  // at entry, or setmaxnreg.inc waits forever: 384 x 168 = 2 x 128 x 232 +
  // 128 x 40. The forward at D = 128 leaves room for two CTAs on an SM (80 at
  // entry, by __launch_bounds__): 384 x 80 >= 2 x 128 x 104 + 128 x 24
  static constexpr int FWD_BLOCKS = D == 128 ? 2 : 1;
  static constexpr int FWD_REGS = D == 128 ? 104 : 232;
  static constexpr int FWD_PRODUCER_REGS = D == 128 ? 24 : 40;
  static_assert(2 * FWD_REGS + FWD_PRODUCER_REGS <= 3 * (FWD_BLOCKS == 2 ? 80 : 168),
                "setmaxnreg would wait forever");
  static constexpr int XN = KT * kTileB;
  static constexpr int HID = HT * kTileB;
  static constexpr int STATS = (128 + 2 * CL * 128) * 4;   // mean, rstd, row sums per warpgroup
  static constexpr int OFF_HID = XN;
  static constexpr int OFF_RING = OFF_HID + HB * HID;
  static constexpr int OFF_STATS = OFF_RING + kStages * kStage;
  static constexpr int OFF_BARS = OFF_STATS + STATS;
  static constexpr size_t SMEM = OFF_BARS + 192;
  static_assert(SMEM <= kSmemMax, "shared memory of a CTA");
};

struct Bars {
  uint64_t full[kStages], empty[kStages], hfull[2], hfree, xbar;
};

using Pipe = wring::Pipe<kStages>;

__device__ __forceinline__ float gelu(float pre) {
  return 0.5f * pre * (1.f + erff(pre * 0.7071067811865476f));
}

// d/dx [x Phi(x)] = Phi(x) + x phi(x)
__device__ __forceinline__ float gelu_grad(float pre) {
  const float phi = expf(-0.5f * pre * pre) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erff(pre * 0.7071067811865476f));
  return cdf + pre * phi;
}

// One product step, both operands in shared memory: d (64 x N) (+)= A B.
template <int N, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  Wgmma<N>::template ss<0, TB>(d, a, b, acc);
}

// One box of a weight into a ring stage.
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int bytes) {
  tma_load_2d(dst, map, bar, c0, c1);
}

// The ring of wg_ring.cuh over this kernel's barriers: acquire returns the stage.
__device__ __forceinline__ unsigned char* acquire(Bars* b, unsigned char* ring, const Pipe& p,
                                                  int bytes, int lane) {
  wring::acquire(b->full, b->empty, p, bytes, lane);
  return ring + p.s * kStage;
}
__device__ __forceinline__ void release(Bars* b, Pipe& p, int lane) {
  wring::release(b->empty, p, lane);
}
__device__ __forceinline__ void commit_stage(Bars* b, Pipe& p, int lane) {
  wring::commit_stage(b->empty, p, lane);
}

// The 64 rows of x that TMA has put into the swizzled tiles Xn, normalised in
// place in f32 (two-pass mean/var), times scale plus bias, rounded to bf16
// (rows >= T: zeros); mean and rstd of each row into `stats`. 8 warps; a row
// is spread over G = min(32, D / 8) lanes, 16 bytes a lane and step, so at
// D = 128 a warp works on two rows at once.
template <int D>
__device__ void ln_rows_swz(unsigned char* Xn, const float* __restrict__ ln_s,
                            const float* __restrict__ ln_b, int row0, int T, float eps,
                            float* stats, int warp, int lane) {
  constexpr int V = D / 8, G = V < 32 ? V : 32, PER = (V + G - 1) / G, RPW = 32 / G;
  const int sub = lane / G, gl = lane % G;
  float sc[PER][8], bi[PER][8];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int vec = gl + G * p < V ? gl + G * p : 0;   // D = 384: the last step is half empty
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(ln_s + vec * 8));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(ln_s + vec * 8 + 4));
    const float4 t0 = __ldg(reinterpret_cast<const float4*>(ln_b + vec * 8));
    const float4 t1 = __ldg(reinterpret_cast<const float4*>(ln_b + vec * 8 + 4));
    sc[p][0] = s0.x, sc[p][1] = s0.y, sc[p][2] = s0.z, sc[p][3] = s0.w;
    sc[p][4] = s1.x, sc[p][5] = s1.y, sc[p][6] = s1.z, sc[p][7] = s1.w;
    bi[p][0] = t0.x, bi[p][1] = t0.y, bi[p][2] = t0.z, bi[p][3] = t0.w;
    bi[p][4] = t1.x, bi[p][5] = t1.y, bi[p][6] = t1.z, bi[p][7] = t1.w;
  }
  auto group_sum = [](float v) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  for (int r = warp * RPW + sub; r < 64; r += 8 * RPW) {
    float v[PER][8];
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int vec = gl + G * p;   // columns 8 vec .. 8 vec + 7: tile vec / 8, chunk vec % 8
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (vec < V)
        raw = *reinterpret_cast<const uint4*>(Xn + (vec >> 3) * kTileB + r * 128 +
                                              (((vec & 7) ^ (r & 7)) << 4));
      unpack8(v[p], raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[p][e];
    }
    const float mean = group_sum(sum) * (1.f / D);
    float sq = 0.f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      if (gl + G * p < V) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[p][e] -= mean;
          sq += v[p][e] * v[p][e];
        }
      }
    }
    const float rstd = rsqrtf(group_sum(sq) * (1.f / D) + eps);
    if (gl == 0) {
      stats[r] = mean;
      stats[64 + r] = rstd;
    }
    const bool live = row0 + r < T;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int vec = gl + G * p;
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (live) {
        o.x = pack(ln_affine(v[p][0], rstd, sc[p][0], bi[p][0]),
                   ln_affine(v[p][1], rstd, sc[p][1], bi[p][1]));
        o.y = pack(ln_affine(v[p][2], rstd, sc[p][2], bi[p][2]),
                   ln_affine(v[p][3], rstd, sc[p][3], bi[p][3]));
        o.z = pack(ln_affine(v[p][4], rstd, sc[p][4], bi[p][4]),
                   ln_affine(v[p][5], rstd, sc[p][5], bi[p][5]));
        o.w = pack(ln_affine(v[p][6], rstd, sc[p][6], bi[p][6]),
                   ln_affine(v[p][7], rstd, sc[p][7], bi[p][7]));
      }
      if (vec < V)
        *reinterpret_cast<uint4*>(Xn + (vec >> 3) * kTileB + r * 128 +
                                  (((vec & 7) ^ (r & 7)) << 4)) = o;
    }
  }
}

// The kernels' LayerNorm prologue alone, for a diagnosis: rows of x (T, D)
// put into the swizzled tiles as TMA puts them, normalised by ln_rows_swz,
// then h (T, D) bf16 and the rows' mean and rstd (stats: 2 x T f32) written
// out. The mma.sync forward (D = 128) normalises with tiles.cuh's ln_rows,
// the same expressions in the same order.
template <int D>
__global__ void __launch_bounds__(256)
ln_rows_probe(const bf16* __restrict__ x, const float* __restrict__ ln_s,
              const float* __restrict__ ln_b, bf16* __restrict__ h, float* __restrict__ stats,
              int T, float eps) {
  extern __shared__ __align__(1024) unsigned char raw[];
  constexpr int V = D / 8;
  const int row0 = blockIdx.x * 64;
  float* st = reinterpret_cast<float*>(raw + (D / 64) * kTileB);
  auto slot = [&](int r, int vec) {   // 8 columns of row r, where TMA puts them
    return reinterpret_cast<uint4*>(raw + (vec >> 3) * kTileB + r * 128 +
                                    (((vec & 7) ^ (r & 7)) << 4));
  };
  for (int i = threadIdx.x; i < 64 * V; i += 256) {
    const int r = i / V, vec = i % V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * D) + vec);
    *slot(r, vec) = v;
  }
  __syncthreads();
  ln_rows_swz<D>(raw, ln_s, ln_b, row0, T, eps, st, threadIdx.x >> 5, threadIdx.x & 31);
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * V; i += 256) {
    const int r = i / V, vec = i % V;
    if (row0 + r < T) reinterpret_cast<uint4*>(h + (size_t)(row0 + r) * D)[vec] = *slot(r, vec);
  }
  if (threadIdx.x < 64 && row0 + threadIdx.x < T) {
    stats[row0 + threadIdx.x] = st[threadIdx.x];
    stats[T + row0 + threadIdx.x] = st[64 + threadIdx.x];
  }
}

template <int D>
int launch_ln_probe(const void* x, const void* ln_s, const void* ln_b, void* h, void* stats,
                    int T, float eps, cudaStream_t stream) {
  const int smem = (D / 64) * kTileB + 512;
  cudaError_t err = cudaFuncSetAttribute(ln_rows_probe<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ln_rows_probe<D><<<(T + 63) / 64, 256, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(h), static_cast<float*>(stats), T, eps);
  return (int)cudaGetLastError();
}

// The resident rows: awaited from TMA, then normalised by the consumers.
template <int D, bool LN>
__device__ __forceinline__ void resident_rows(unsigned char* Xn, Bars* bars, float* stats,
                                              const float* ln_s, const float* ln_b, int row0,
                                              int T, float eps) {
  mbar_wait(&bars->xbar, 0);
  if (LN) {
    ln_rows_swz<D>(Xn, ln_s, ln_b, row0, T, eps, stats, threadIdx.x >> 5, threadIdx.x & 31);
    fence_async_shared();
    named_barrier(3, 256);
  }
}

// pre (this warpgroup's 64 hidden columns of chunk c) = Xn W1[:, columns]:
// KT stages of 64 rows of W1 x the CTA's 128 columns.
template <int D>
__device__ __forceinline__ void product_pre(float (&pre)[32], const unsigned char* Xn,
                                            unsigned char* ring, Bars* bars, Pipe& p, int w,
                                            int lane) {
  using C = Cfg<D>;
  for (int kt = 0; kt < C::KT; ++kt) {
    mbar_wait(&bars->full[p.s], p.ph);
    const uint64_t a = mdesc(Xn + kt * kTileB), b = mdesc(ring + p.s * kStage + w * kTileB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<64, 1>(pre, madvance(a, 32 * kk), madvance(b, 2048 * kk), kt | kk);
    commit_stage(bars, p, lane);
  }
}

// This warpgroup's 64 x 64 slice of the hidden chunk into tile `ti` of the
// hidden buffer of every CTA of the cluster: value(e, bias) is element e of
// the accumulator layout in f32, `bias` the entry of b1 for its column;
// rounded in pairs. Then the warp's arrival on each CTA's barrier and the
// wait for the whole chunk.
template <int D, typename Value>
__device__ __forceinline__ void share_hidden(Value value, const float* __restrict__ b1c,
                                             unsigned char* hid, int ti, Bars* bars, int buf,
                                             int use, int crank, int warp, int g, int t,
                                             int lane) {
  using C = Cfg<D>;
  unsigned char* tile = hid + ti * kTileB;
#pragma unroll
  for (int jt = 0; jt < 8; ++jt) {
    const float2 bias = __ldg(reinterpret_cast<const float2*>(b1c + ti * 64 + 8 * jt + 2 * t));
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const uint32_t v = pack(value(4 * jt + 2 * hi, bias.x), value(4 * jt + 2 * hi + 1, bias.y));
      const int off = swz(warp * 16 + g + 8 * hi, 8 * jt + 2 * t);
      *reinterpret_cast<uint32_t*>(tile + off) = v;
      if (C::CL == 2) st_cluster_u32(mapa(saddr(tile + off), crank ^ 1), v);
    }
  }
  fence_async_all();
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < C::CL; ++q)
      mbar_arrive_cluster(&bars->hfull[buf], (crank & ~(C::CL - 1)) + q);
  }
  mbar_wait_cluster(&bars->hfull[buf], use & 1);
}

// Staging tiles (over the resident rows, which no product reads any more)
// and TMA stores of this warpgroup's NW output columns.
template <int D>
__device__ __forceinline__ void store_out(const CUtensorMap* map, unsigned char* Xn, int w,
                                          int rank, int row0, int wl) {
  using C = Cfg<D>;
  fence_async_shared();
  named_barrier(1 + w, 128);
  if (wl == 0) {
    for (int i = 0; i < C::NW / 64; ++i)
      tma_store_2d(map, Xn + (w * (C::NW / 64) + i) * kTileB,
                   rank * C::NC + w * C::NW + 64 * i, row0);
    tma_store_commit();
    tma_store_wait_read();
  }
}

template <int D, bool LN>
__global__ void __launch_bounds__(kThreads, Cfg<D>::FWD_BLOCKS)
wg_mlp_fwd(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw1,
           const __grid_constant__ CUtensorMap mw2, const __grid_constant__ CUtensorMap mout,
           const float* __restrict__ ln_s, const float* __restrict__ ln_b,
           const float* __restrict__ b1, const float* __restrict__ b2, int T, int M, float eps) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char raw[];
  if (saddr(raw) & 1023) __trap();
  unsigned char* Xn = raw;
  unsigned char* Hid = raw + C::OFF_HID;
  unsigned char* ring = raw + C::OFF_RING;
  float* stats = reinterpret_cast<float*>(raw + C::OFF_STATS);
  Bars* bars = reinterpret_cast<Bars*>(raw + C::OFF_BARS);
  const int crank = (int)cluster_rank(), rank = crank;   // which of the CL column shares
  const int row0 = (blockIdx.x / C::CL) * 64;
  const int chunks = M / C::HC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars->full[s], 1);
      mbar_init(&bars->empty[s], 8);
    }
    mbar_init(&bars->hfull[0], 8 * C::CL);
    mbar_init(&bars->hfull[1], 8 * C::CL);
    mbar_init(&bars->hfree, 8 * C::CL);
    mbar_init(&bars->xbar, 1);
    mbar_fence_init();
  }
  cluster_sync();

  const int wgi = threadIdx.x >> 7;
  if (wgi == 2) {
    regs_dec<C::FWD_PRODUCER_REGS>();
    if (threadIdx.x < 288) {   // one warp; lane i loads box i of a stage
      const int lane = threadIdx.x & 31;
      if (lane == 0) mbar_expect_tx(&bars->xbar, C::XN);
      __syncwarp();
      if (lane < C::KT) tma_load_2d(Xn + lane * kTileB, &mx, &bars->xbar, 64 * lane, row0);
      Pipe p;
      for (int c = 0; c < chunks; ++c) {
        for (int kt = 0; kt < C::KT; ++kt) {
          unsigned char* st = acquire(bars, ring, p, 2 * kTileB, lane);
          if (lane < 2)
            load_box(st + lane * kTileB, &mw1, &bars->full[p.s],
                     c * C::HC + rank * 128 + lane * 64, 64 * kt, kTileB);
          p.next();
        }
        for (int j = 0; j < C::HC / C::KS2; ++j) {
          unsigned char* st = acquire(bars, ring, p, C::NC * C::KS2 * 2, lane);
          if (lane < C::NC / 64)
            load_box(st + lane * C::KS2 * 128, &mw2, &bars->full[p.s], rank * C::NC + 64 * lane,
                     c * C::HC + j * C::KS2, C::KS2 * 128);
          p.next();
        }
      }
    }
    cluster_sync();
  } else {
    regs_inc<C::FWD_REGS>();
    const int w = wgi, wl = threadIdx.x & 127;
    const int warp = wl >> 5, lane = wl & 31, g = lane >> 2, t = lane & 3;
    resident_rows<D, LN>(Xn, bars, stats, ln_s, ln_b, row0, T, eps);

    float y[C::NW / 2];
    Pipe p;
    for (int c = 0; c < chunks; ++c) {
      float pre[32];
      product_pre<D>(pre, Xn, ring, bars, p, w, lane);

      // bias + GELU in f32, the hidden slice to every CTA of the cluster as bf16
      const int buf = C::HB == 2 ? (c & 1) : 0, ti = rank * 2 + w;
      if (C::HB == 1 && c > 0) mbar_wait_cluster(&bars->hfree, (c - 1) & 1);
      unsigned char* hid = Hid + buf * C::HID;
      share_hidden<D>([&](int e, float bias) { return gelu(pre[e] + bias); }, b1 + c * C::HC, hid,
                      ti, bars, buf, c / C::HB, crank, warp, g, t, lane);

      // y += hidden W2[chunk rows, this warpgroup's columns]
          for (int j = 0; j < C::HC / C::KS2; ++j) {
        mbar_wait(&bars->full[p.s], p.ph);
        const uint64_t b = mdesc(ring + p.s * kStage + w * (C::NW / 64) * C::KS2 * 128,
                                 C::KS2 * 128, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::KS2 / 16; ++kk) {
          const int k = j * C::KS2 + 16 * kk;
          const uint64_t a = madvance(mdesc(hid + (k / 64) * kTileB), (k % 64) * 2);
          mma_ss<C::NW, 1>(y, a, madvance(b, 2048 * kk), c | j | kk);
        }
        commit_stage(bars, p, lane);
      }
      if (C::HB == 1 && lane == 0) {
#pragma unroll
        for (int q = 0; q < C::CL; ++q)
          mbar_arrive_cluster(&bars->hfree, (crank & ~(C::CL - 1)) + q);
      }
    }

    // y + b2, rounded once
    unsigned char* st = Xn + w * (C::NW / 64) * kTileB;
#pragma unroll
    for (int jt = 0; jt < C::NW / 8; ++jt) {
      const int cl = 8 * jt + 2 * t;
      const float2 bias =
          __ldg(reinterpret_cast<const float2*>(b2 + rank * C::NC + w * C::NW + cl));
      unsigned char* tile = st + (cl / 64) * kTileB;
      *reinterpret_cast<uint32_t*>(tile + swz(warp * 16 + g, cl % 64)) =
          pack(y[4 * jt] + bias.x, y[4 * jt + 1] + bias.y);
      *reinterpret_cast<uint32_t*>(tile + swz(warp * 16 + g + 8, cl % 64)) =
          pack(y[4 * jt + 2] + bias.x, y[4 * jt + 3] + bias.y);
    }
    store_out<D>(&mout, Xn, w, rank, row0, wl);
    cluster_sync();
  }
}

template <int D, bool LN>
__global__ void __launch_bounds__(kThreads, 1)
wg_mlp_bwd(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mdy,
           const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
           const __grid_constant__ CUtensorMap mw1t, const __grid_constant__ CUtensorMap mdx,
           const bf16* __restrict__ x, const float* __restrict__ ln_s,
           const float* __restrict__ ln_b, const float* __restrict__ b1, int T, int M,
           float eps) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) unsigned char raw[];
  if (saddr(raw) & 1023) __trap();
  unsigned char* Xn = raw;
  unsigned char* Hid = raw + C::OFF_HID;   // the dpre chunk
  unsigned char* ring = raw + C::OFF_RING;
  float* stats = reinterpret_cast<float*>(raw + C::OFF_STATS);
  Bars* bars = reinterpret_cast<Bars*>(raw + C::OFF_BARS);
  const int crank = (int)cluster_rank(), rank = crank;   // which of the CL column shares
  const int row0 = (blockIdx.x / C::CL) * 64;
  const int chunks = M / C::HC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars->full[s], 1);
      mbar_init(&bars->empty[s], 8);
    }
    mbar_init(&bars->hfull[0], 8 * C::CL);
    mbar_init(&bars->hfull[1], 8 * C::CL);
    mbar_init(&bars->hfree, 8 * C::CL);
    mbar_init(&bars->xbar, 1);
    mbar_fence_init();
  }
  cluster_sync();

  // Stages of a chunk, in this order for the producer and both consumers:
  // KT of W1 (64 rows of D x the CTA's 128 hidden columns) for pre; per k
  // tile of D and warpgroup, a 64 x 64 slab of dy beside the warpgroup's 64
  // rows of W2 x 64 columns, for dh; per block of NS of a warpgroup's output
  // columns, hidden tile and warpgroup, NS rows of W1 x 64 hidden columns,
  // for dhid. A warpgroup passes over the stages of the other.
  const int wgi = threadIdx.x >> 7;
  if (wgi == 2) {
    regs_dec<40>();
    if (threadIdx.x < 288) {   // one warp; lane i loads box i of a stage
      const int lane = threadIdx.x & 31;
      if (lane == 0) mbar_expect_tx(&bars->xbar, C::XN);
      __syncwarp();
      if (lane < C::KT) tma_load_2d(Xn + lane * kTileB, &mx, &bars->xbar, 64 * lane, row0);
      Pipe p;
      for (int c = 0; c < chunks; ++c) {
        const int m0 = c * C::HC + rank * 128;   // the CTA's hidden columns of this chunk
        for (int kt = 0; kt < C::KT; ++kt) {
          unsigned char* st = acquire(bars, ring, p, 2 * kTileB, lane);
          if (lane < 2)
            load_box(st + lane * kTileB, &mw1, &bars->full[p.s], m0 + lane * 64, 64 * kt,
                     kTileB);
          p.next();
        }
        for (int kt = 0; kt < C::KT; ++kt) {
          for (int w = 0; w < 2; ++w) {
            unsigned char* st = acquire(bars, ring, p, 2 * kTileB, lane);
            if (lane == 0) tma_load_2d(st, &mdy, &bars->full[p.s], 64 * kt, row0);
            if (lane == 1)
              load_box(st + kTileB, &mw2, &bars->full[p.s], 64 * kt, m0 + w * 64, kTileB);
            p.next();
          }
        }
        for (int sb = 0; sb < C::NSB; ++sb) {
          for (int ht = 0; ht < C::HT; ++ht) {
            for (int w = 0; w < 2; ++w) {
              unsigned char* st = acquire(bars, ring, p, C::NS * 128, lane);
              if (lane == 0)
                load_box(st, &mw1t, &bars->full[p.s], c * C::HC + ht * 64,
                         rank * C::NC + w * C::NW + sb * C::NS, C::NS * 128);
              p.next();
            }
          }
        }
      }
    }
    if (LN) cluster_sync();
    cluster_sync();
  } else {
    regs_inc<232>();
    const int w = wgi, wl = threadIdx.x & 127;
    const int warp = wl >> 5, lane = wl & 31, g = lane >> 2, t = lane & 3;
    resident_rows<D, LN>(Xn, bars, stats, ln_s, ln_b, row0, T, eps);

    float acc[C::NSB][C::NS / 2];
    Pipe p;
    for (int c = 0; c < chunks; ++c) {
      float pre[32], dh[32];
      product_pre<D>(pre, Xn, ring, bars, p, w, lane);

      // dh (this warpgroup's 64 hidden columns) = dy W2[columns, :]^T
          for (int kt = 0; kt < C::KT; ++kt) {
#pragma unroll
        for (int wq = 0; wq < 2; ++wq) {
          mbar_wait(&bars->full[p.s], p.ph);
          if (wq == w) {
            const uint64_t a = mdesc(ring + p.s * kStage), b = mdesc(ring + p.s * kStage + kTileB);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              mma_ss<64, 0>(dh, madvance(a, 32 * kk), madvance(b, 32 * kk), kt | kk);
            commit_stage(bars, p, lane);
          } else {
            release(bars, p, lane);
          }
        }
      }

      // dpre = dh * gelu'(pre + b1), rounded, to every CTA of the cluster
      const int buf = C::HB == 2 ? (c & 1) : 0, ti = rank * 2 + w;
      if (C::HB == 1 && c > 0) mbar_wait_cluster(&bars->hfree, (c - 1) & 1);
      unsigned char* hid = Hid + buf * C::HID;
      share_hidden<D>([&](int e, float bias) { return dh[e] * gelu_grad(pre[e] + bias); },
                      b1 + c * C::HC, hid, ti, bars, buf, c / C::HB, crank, warp, g, t, lane);

      // dhid (this warpgroup's columns, in blocks of NS) += dpre W1[columns, chunk]^T
#pragma unroll
      for (int sb = 0; sb < C::NSB; ++sb) {
        for (int ht = 0; ht < C::HT; ++ht) {
#pragma unroll
          for (int wq = 0; wq < 2; ++wq) {
            mbar_wait(&bars->full[p.s], p.ph);
            if (wq == w) {
              const uint64_t a = mdesc(hid + ht * kTileB), b = mdesc(ring + p.s * kStage);
              wgmma_fence();
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                mma_ss<C::NS, 0>(acc[sb], madvance(a, 32 * kk), madvance(b, 32 * kk),
                                 c | ht | kk);
              commit_stage(bars, p, lane);
            } else {
              release(bars, p, lane);
            }
          }
        }
      }
      if (C::HB == 1 && lane == 0) {
#pragma unroll
        for (int q = 0; q < C::CL; ++q)
          mbar_arrive_cluster(&bars->hfree, (crank & ~(C::CL - 1)) + q);
      }
    }

    const int r0 = warp * 16 + g;              // this thread's rows: r0 and r0 + 8
    const int col0 = rank * C::NC + w * C::NW;   // this warpgroup's first output column
    if (LN) {
      // the LayerNorm backward on the accumulators: row sums of dn and dn * n
      // over this warpgroup's columns, then over the warpgroups of the cluster
      // in a fixed order
      float mean[2], rstd[2];
      const bf16* xr[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        mean[hi] = stats[r0 + 8 * hi];
        rstd[hi] = stats[64 + r0 + 8 * hi];
        xr[hi] = x + (size_t)(row0 + r0 + 8 * hi < T ? row0 + r0 + 8 * hi : 0) * D;
      }
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
      for (int sb = 0; sb < C::NSB; ++sb) {
#pragma unroll
        for (int jt = 0; jt < C::NS / 8; ++jt) {
          const int col = col0 + sb * C::NS + 8 * jt + 2 * t;
          const float2 sc = __ldg(reinterpret_cast<const float2*>(ln_s + col));
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xr[hi] + col));
            const float d0 = acc[sb][4 * jt + 2 * hi] * sc.x;
            const float d1 = acc[sb][4 * jt + 2 * hi + 1] * sc.y;
            s1[hi] += d0 + d1;
            s2[hi] += d0 * ((xv.x - mean[hi]) * rstd[hi]) + d1 * ((xv.y - mean[hi]) * rstd[hi]);
          }
        }
      }
      float* sums = stats + 128;   // [warpgroup of the cluster][row][2]
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        s1[hi] += __shfl_xor_sync(0xffffffffu, s1[hi], 1);
        s1[hi] += __shfl_xor_sync(0xffffffffu, s1[hi], 2);
        s2[hi] += __shfl_xor_sync(0xffffffffu, s2[hi], 1);
        s2[hi] += __shfl_xor_sync(0xffffffffu, s2[hi], 2);
        if (t == 0) {
          float* slot = sums + ((rank * 2 + w) * 64 + r0 + 8 * hi) * 2;
          slot[0] = s1[hi];
          slot[1] = s2[hi];
          if (C::CL == 2) {
            st_cluster_f32(mapa(saddr(slot), crank ^ 1), s1[hi]);
            st_cluster_f32(mapa(saddr(slot + 1), crank ^ 1), s2[hi]);
          }
        }
      }
      cluster_sync();
      float m1[2], m2[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int q = 0; q < 2 * C::CL; ++q) {
          a += sums[(q * 64 + r0 + 8 * hi) * 2];
          b += sums[(q * 64 + r0 + 8 * hi) * 2 + 1];
        }
        m1[hi] = a * (1.f / D);
        m2[hi] = b * (1.f / D);
      }
#pragma unroll
      for (int sb = 0; sb < C::NSB; ++sb) {
#pragma unroll
        for (int jt = 0; jt < C::NS / 8; ++jt) {
          const int col = col0 + sb * C::NS + 8 * jt + 2 * t;
          const float2 sc = __ldg(reinterpret_cast<const float2*>(ln_s + col));
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xr[hi] + col));
            float& d0 = acc[sb][4 * jt + 2 * hi];
            float& d1 = acc[sb][4 * jt + 2 * hi + 1];
            d0 = rstd[hi] * (d0 * sc.x - m1[hi] - (xv.x - mean[hi]) * rstd[hi] * m2[hi]);
            d1 = rstd[hi] * (d1 * sc.y - m1[hi] - (xv.y - mean[hi]) * rstd[hi] * m2[hi]);
          }
        }
      }
    }

    // dx (= dhid without the LayerNorm), rounded once
    unsigned char* st = Xn + w * (C::NW / 64) * kTileB;
#pragma unroll
    for (int sb = 0; sb < C::NSB; ++sb) {
#pragma unroll
      for (int jt = 0; jt < C::NS / 8; ++jt) {
        const int cl = sb * C::NS + 8 * jt + 2 * t;
        unsigned char* tile = st + (cl / 64) * kTileB;
        *reinterpret_cast<uint32_t*>(tile + swz(r0, cl % 64)) =
            pack(acc[sb][4 * jt], acc[sb][4 * jt + 1]);
        *reinterpret_cast<uint32_t*>(tile + swz(r0 + 8, cl % 64)) =
            pack(acc[sb][4 * jt + 2], acc[sb][4 * jt + 3]);
      }
    }
    store_out<D>(&mdx, Xn, w, rank, row0, wl);
    cluster_sync();
  }
}

// A (rows, cols) row-major bf16 matrix in boxes of `box_rows` x 64.
bool matrix_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  return make_map(map, p, 2, dims, strides, (uint32_t)box_rows);
}

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int grid, int cluster, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

template <int D, bool LN>
int launch_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int T, int M, float eps,
               cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mx, mw1, mw2, mout;
  if (!matrix_map(&mx, x, T, D, 64) || !matrix_map(&mw1, w1, D, M, 64) ||
      !matrix_map(&mw2, w2, M, D, C::KS2) || !matrix_map(&mout, out, T, D, 64))
    return kMapError;
  return launch_cluster(wg_mlp_fwd<D, LN>, (T + 63) / 64 * C::CL, C::CL, C::SMEM, stream, mx, mw1,
                        mw2, mout, static_cast<const float*>(ln_s),
                        static_cast<const float*>(ln_b), static_cast<const float*>(b1),
                        static_cast<const float*>(b2), T, M, eps);
}

template <int D, bool LN>
int launch_bwd(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* dy, void* dx, int T, int M, float eps,
               cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mx, mdy, mw1, mw2, mw1t, mdx;
  if (!matrix_map(&mx, x, T, D, 64) || !matrix_map(&mdy, dy, T, D, 64) ||
      !matrix_map(&mw1, w1, D, M, 64) || !matrix_map(&mw2, w2, M, D, 64) ||
      !matrix_map(&mw1t, w1, D, M, C::NS) || !matrix_map(&mdx, dx, T, D, 64))
    return kMapError;
  return launch_cluster(wg_mlp_bwd<D, LN>, (T + 63) / 64 * C::CL, C::CL, C::SMEM, stream, mx, mdy,
                        mw1, mw2, mw1t, mdx, static_cast<const bf16*>(x),
                        static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
                        static_cast<const float*>(b1), T, M, eps);
}

}  // namespace wgk

bool supported(int T, int M) { return T >= 1 && M >= 128 && M % 128 == 0; }

// The wgmma kernels take every supported shape but D >= 512 with a hidden
// width that is not a multiple of the cluster's 256-column chunk.
bool use_wgmma(int D, int M) { return D < 512 || M % 256 == 0; }

template <bool LN>
int dispatch_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                 const void* b1, const void* w2, const void* b2, void* out, int T, int D, int M,
                 float eps, void* stream) {
  if (!supported(T, M)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the LayerNorm-fused forward at D = 128 measured 3% slower on wgmma (0.437
  // ms against 0.424 at T = 200704, M = 512): it keeps the mma.sync kernel
  if (LN && D == 128)
    return mma_mlp::launch_fwd<128, true>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
  if (!use_wgmma(D, M)) {
    if (D == 512)
      return mma_mlp::launch_fwd<512, LN>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    if (D == 768)
      return mma_mlp::launch_fwd<768, LN>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    if (D == 1024)
      return mma_mlp::launch_fwd<1024, LN>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    return -1;
  }
  switch (D) {
    case 128: return wgk::launch_fwd<128, LN>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 256: return wgk::launch_fwd<256, LN>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 384: return wgk::launch_fwd<384, LN>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 512: return wgk::launch_fwd<512, LN>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 768: return wgk::launch_fwd<768, LN>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 1024: return wgk::launch_fwd<1024, LN>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    default: return -1;
  }
}

template <bool LN>
int dispatch_bwd(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                 const void* b1, const void* w2, const void* dy, void* dx, int T, int D, int M,
                 float eps, void* stream) {
  if (!supported(T, M)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!use_wgmma(D, M)) {
    if (D == 512)
      return mma_mlp::launch_bwd<512, LN>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    if (D == 768)
      return mma_mlp::launch_bwd<768, LN>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    if (D == 1024)
      return mma_mlp::launch_bwd<1024, LN>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    return -1;
  }
  switch (D) {
    case 128: return wgk::launch_bwd<128, LN>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 256: return wgk::launch_bwd<256, LN>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 384: return wgk::launch_bwd<384, LN>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 512: return wgk::launch_bwd<512, LN>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 768: return wgk::launch_bwd<768, LN>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 1024: return wgk::launch_bwd<1024, LN>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// x (T, D) bf16, ln_s / ln_b (D) f32, w1 (D, M) bf16, b1 (M) f32, w2 (M, D)
// bf16, b2 (D) f32 -> out (T, D) bf16.
int apvt_ln_mlp_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* out, int T, int D,
                    int M, float eps, void* stream) {
  return dispatch_fwd<true>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, D, M, eps, stream);
}

// ... and the cotangent dy (T, D) bf16 -> dx (T, D) bf16.
int apvt_ln_mlp_bwd(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* dy, void* dx, int T, int D,
                    int M, float eps, void* stream) {
  return dispatch_bwd<true>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, D, M, eps, stream);
}

// The same without the LayerNorm: out = gelu(x w1 + b1) w2 + b2, and its dx.
int apvt_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 void* out, int T, int D, int M, void* stream) {
  return dispatch_fwd<false>(x, nullptr, nullptr, w1, b1, w2, b2, out, T, D, M, 0.f, stream);
}

int apvt_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2, const void* dy,
                 void* dx, int T, int D, int M, void* stream) {
  return dispatch_bwd<false>(x, nullptr, nullptr, w1, b1, w2, dy, dx, T, D, M, 0.f, stream);
}

// The LayerNorm prologue of the kernels alone (x (T, D) bf16 -> h (T, D)
// bf16, stats (2, T) f32: mean, rstd), for a diagnosis; no model path calls it.
int apvt_ln_mlp_ln_rows(const void* x, const void* ln_s, const void* ln_b, void* h, void* stats,
                        int T, int D, float eps, void* stream) {
  if (T < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return wgk::launch_ln_probe<128>(x, ln_s, ln_b, h, stats, T, eps, s);
    case 256: return wgk::launch_ln_probe<256>(x, ln_s, ln_b, h, stats, T, eps, s);
    case 384: return wgk::launch_ln_probe<384>(x, ln_s, ln_b, h, stats, T, eps, s);
    case 512: return wgk::launch_ln_probe<512>(x, ln_s, ln_b, h, stats, T, eps, s);
    case 768: return wgk::launch_ln_probe<768>(x, ln_s, ln_b, h, stats, T, eps, s);
    case 1024: return wgk::launch_ln_probe<1024>(x, ln_s, ln_b, h, stats, T, eps, s);
    default: return -1;
  }
}

const char* apvt_ln_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
