// LayerNorm-fused MLP, forward and input gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels kernels/mlp.py:fused_ln_mlp of the JAX package
// (_ln_fwd_kernel, _ln_bwd_kernel): over token rows x (T, D) in bf16,
//   h   = LN(x) * scale + bias            (f32, two-pass mean/var; rounded to bf16)
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
// What bounds it on the H100: 4 T D M FLOP forward (52.6 GFLOP at every
// ConvNeXt-B stage with B = 64) against 4 T D bytes of activations plus the
// weights, 500-4000 FLOP/byte: far above the bf16 ridge (~295), so the
// tensor cores are the limit (53 us forward, 80 us backward at the dense
// bf16 peak), if the hidden activation stays on chip. This first version
// stays far under it (0.4-0.8 ms forward): with 16-64 token rows per CTA the
// weights are re-read from L2 once per CTA (1.6-3.3 GB per launch at D = 512
// and 1024); taking every mma.sync or ldmatrix out changes no time, taking
// the weight loads out up to 46%, the block-wide barriers up to 30%
// (tools/ln_mlp_diagnose.py).
//
// What the design does about it:
// * the TPU kernel keeps both weight matrices resident in its fast memory
//   and streams blocks of 64 token rows past them, padded to a multiple of
//   64. Here nothing can stay resident (227 KB per SM against up to 16.8 MB
//   of weights): a CTA of 8 warps owns RB token rows (64 for D <= 128, 32 up
//   to 512, 16 above, so that the RB x D f32 output fits its registers),
//   normalises them once into shared memory as bf16, and walks over the
//   hidden dimension in chunks of 128 columns. Per chunk it forms pre
//   (RB x 128, a 16-column slice per warp), applies bias and GELU in
//   registers, puts the bf16 hidden chunk in shared memory, and adds its
//   product with the chunk's rows of W2 to the output accumulators (a D/8
//   column slice per warp). The ragged last block is masked in the kernel;
// * the weights stream from L2 (every CTA reads the same slabs) through a
//   double buffer of shared-memory slabs filled with cp.async 16 bytes per
//   thread, the next slab in flight while the tensor cores work on this one;
//   inside a slab the ldmatrix fragments of the next k-step (or column pair)
//   are loaded while the mma.sync products of this one run;
// * every product is mma.sync m16n8k16 (bf16 in, f32 out) with ldmatrix
//   operands: a row-major (K, N) slab is the B operand through
//   ldmatrix.trans; for the backward's two transposed products the row-major
//   weight is already the (N, K) form and is read without .trans, so no
//   transposed copy of a weight exists;
// * the backward keeps the normalised rows and the dy rows in shared memory,
//   forms pre and dh of a chunk side by side (the same accumulator layout, so
//   dpre is a product in registers), and at the end lays the f32 dhid tile
//   over the two row buffers for the LayerNorm backward: a warp per row,
//   mean and rstd recomputed from x, 16-byte stores.
//
// Takes bf16, D in {128, 256, 384, 512, 768, 1024}, M a multiple of 128, any
// T. The body without ln_rows and ln_bwd_rows is the plain fused MLP. C
// interface (loaded with ctypes): each entry point returns the CUDA error
// code of its launch (cudaGetLastError), 0 on success, -1 for an unsupported
// shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHC = 128;   // hidden columns per chunk: 16 per warp
constexpr int kKS = 64;    // rows of D per slab in the products with N = kHC
constexpr int kLDH = kHC + 8;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int D>
struct Cfg {
  static_assert(D % 128 == 0 && D <= 1024, "D must be a multiple of 128, at most 1024");
  static constexpr int RB = D <= 128 ? 64 : (D <= 512 ? 32 : 16);   // token rows per CTA
  static constexpr int MT = RB / 16;
  // hidden rows per slab in the products with N = D (a slab is 16-48 KB)
  static constexpr int KS2 = D <= 128 ? 128 : (D <= 256 ? 64 : (D <= 512 ? 32 : 16));
  static constexpr int WN = D / kWarps;   // output columns per warp
  static constexpr int NT = WN / 8;
  static constexpr int LDX = D + 8;
  static constexpr int N1 = D / kKS;      // slabs per chunk, products with N = kHC
  static constexpr int N2 = kHC / KS2;    // slabs per chunk, products with N = D
  static constexpr int ROWS = RB * LDX;   // elements of a row buffer
  static constexpr int HID = RB * kLDH;   // elements of the hidden chunk
  static constexpr int SLAB_FWD = cmax(kKS * kLDH, KS2 * LDX);
  static constexpr int SLAB_BWD = cmax(cmax(kKS * kLDH, kHC * (kKS + 8)), D * (KS2 + 8));
  static constexpr size_t SMEM_FWD = (size_t)(ROWS + HID + 2 * SLAB_FWD) * sizeof(bf16);
  static constexpr size_t SMEM_BWD = (size_t)(2 * ROWS + HID + 2 * SLAB_BWD) * sizeof(bf16);
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

// d += a (16x16, row) * b (16x8, col). Not volatile: a pure function of its
// registers, which the compiler may schedule among the fragment loads.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two f32 -> one bf16x2 word, round to nearest even; `lo` at the lower column.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void unpack8(float (&f)[8], const uint4& v) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Lane addresses into a row-major tile of row stride LD. a_addr: the A
// operand (16 x 16 at (r0, c0)); with ldsm_t, the B operand of the n-tiles
// c0 and c0+8 from a [k][n] tile (k-chunk at r0). b_addr: the B operand of
// the n-tiles n0 and n0+8 from an [n][k] tile (k-chunk at c0).
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int n0, int c0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8;
}

// ROWS x COLS block of a row-major matrix (leading dimension ld) -> a tile of
// row stride COLS + 8, 16 bytes per thread and copy, asynchronously.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_slab(bf16* dst, const bf16* __restrict__ src, int ld) {
  constexpr int V = COLS / 8;
  for (int idx = threadIdx.x; idx < ROWS * V; idx += kThreads) {
    const int r = idx / V, c = idx % V;
    cp_async16(dst + r * (COLS + 8) + c * 8, src + (size_t)r * ld + c * 8);
  }
}

__device__ __forceinline__ float gelu(float pre) {
  return 0.5f * pre * (1.f + erff(pre * 0.7071067811865476f));
}

// d/dx [x Phi(x)] = Phi(x) + x phi(x)
__device__ __forceinline__ float gelu_grad(float pre) {
  const float phi = expf(-0.5f * pre * pre) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.f + erff(pre * 0.7071067811865476f));
  return cdf + pre * phi;
}

// One row's 16-byte vectors are spread over the lanes: vector lane + 32 p.
template <int D>
struct RowVecs {
  static constexpr int V = D / 8;
  static constexpr int PER = (V + 31) / 32;
};

// Rows [row0, row0 + RB) of x, normalised in f32, times scale plus bias,
// rounded to bf16 into Xn (rows >= T: zeros). A warp per row.
template <int D>
__device__ void ln_rows(bf16* Xn, const bf16* __restrict__ x, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, int row0, int T, float eps) {
  using C = Cfg<D>;
  using R = RowVecs<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < C::RB; r += kWarps) {
    const int row = row0 + r;
    float v[R::PER][8];
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < R::PER; ++p) {
      const int vec = lane + 32 * p;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (vec < R::V && row < T)
        raw = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * D + vec * 8));
      unpack8(v[p], raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[p][e];
    }
    const float mean = warp_sum(sum) * (1.f / D);
    float sq = 0.f;
#pragma unroll
    for (int p = 0; p < R::PER; ++p) {
      if (lane + 32 * p < R::V) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[p][e] -= mean;
          sq += v[p][e] * v[p][e];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * (1.f / D) + eps);
#pragma unroll
    for (int p = 0; p < R::PER; ++p) {
      const int vec = lane + 32 * p;
      if (vec < R::V) {
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (row < T) {
          const float4 s0 = __ldg(reinterpret_cast<const float4*>(ln_s + vec * 8));
          const float4 s1 = __ldg(reinterpret_cast<const float4*>(ln_s + vec * 8 + 4));
          const float4 t0 = __ldg(reinterpret_cast<const float4*>(ln_b + vec * 8));
          const float4 t1 = __ldg(reinterpret_cast<const float4*>(ln_b + vec * 8 + 4));
          o.x = pack(v[p][0] * rstd * s0.x + t0.x, v[p][1] * rstd * s0.y + t0.y);
          o.y = pack(v[p][2] * rstd * s0.z + t0.z, v[p][3] * rstd * s0.w + t0.w);
          o.z = pack(v[p][4] * rstd * s1.x + t1.x, v[p][5] * rstd * s1.y + t1.y);
          o.w = pack(v[p][6] * rstd * s1.z + t1.z, v[p][7] * rstd * s1.w + t1.w);
        }
        *reinterpret_cast<uint4*>(Xn + r * C::LDX + vec * 8) = o;
      }
    }
  }
}

// Rows [row0, row0 + RB) of a (T, D) bf16 matrix into a row buffer (rows >= T: zeros).
template <int D>
__device__ void load_rows(bf16* dst, const bf16* __restrict__ src, int row0, int T) {
  using C = Cfg<D>;
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < C::RB * V; idx += kThreads) {
    const int r = idx / V, c = idx % V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8));
    *reinterpret_cast<uint4*>(dst + r * C::LDX + c * 8) = val;
  }
}

// acc (RB x 16 columns of this warp) += A[:, k0 .. k0 + kKS) * slab, the slab
// a [k][n] tile (kKS x kHC, row stride kLDH).
template <int D>
__device__ __forceinline__ void mma_chunk_kn(float (&acc)[Cfg<D>::MT][2][4], const bf16* A,
                                             int k0, const bf16* slab, int warp, int lane) {
  using C = Cfg<D>;
  constexpr int KK = kKS / 16;
  uint32_t bb[2][4], a[2][C::MT][4];   // this k-step's fragments and the next one's
  auto load = [&](int kk, int buf) {
    ldsm_t(bb[buf], a_addr<kLDH>(slab, kk * 16, warp * 16, lane));
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
      ldsm(a[buf][mt], a_addr<C::LDX>(A, mt * 16, k0 + kk * 16, lane));
  };
  load(0, 0);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    if (kk + 1 < KK) load(kk + 1, (kk + 1) & 1);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      mma(acc[mt][0], a[kk & 1][mt], bb[kk & 1][0], bb[kk & 1][1]);
      mma(acc[mt][1], a[kk & 1][mt], bb[kk & 1][2], bb[kk & 1][3]);
    }
  }
}

// The same with the slab an [n][k] tile (kHC x kKS, row stride kKS + 8).
template <int D>
__device__ __forceinline__ void mma_chunk_nk(float (&acc)[Cfg<D>::MT][2][4], const bf16* A,
                                             int k0, const bf16* slab, int warp, int lane) {
  using C = Cfg<D>;
  constexpr int KK = kKS / 16;
  uint32_t bb[2][4], a[2][C::MT][4];
  auto load = [&](int kk, int buf) {
    ldsm(bb[buf], b_addr<kKS + 8>(slab, warp * 16, kk * 16, lane));
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
      ldsm(a[buf][mt], a_addr<C::LDX>(A, mt * 16, k0 + kk * 16, lane));
  };
  load(0, 0);
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    if (kk + 1 < KK) load(kk + 1, (kk + 1) & 1);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      mma(acc[mt][0], a[kk & 1][mt], bb[kk & 1][0], bb[kk & 1][1]);
      mma(acc[mt][1], a[kk & 1][mt], bb[kk & 1][2], bb[kk & 1][3]);
    }
  }
}

// acc (RB x WN columns of this warp) += Hs[:, k0 .. k0 + KS2) * slab; the slab
// is a [k][n] tile (KS2 x D, row stride LDX) or an [n][k] tile (D x KS2, row
// stride KS2 + 8).
template <int D, bool NK>
__device__ __forceinline__ void mma_out(float (&acc)[Cfg<D>::MT][Cfg<D>::NT][4], const bf16* Hs,
                                        int k0, const bf16* slab, int warp, int lane) {
  using C = Cfg<D>;
  constexpr int NP = C::NT / 2;
  auto load_b = [&](uint32_t (&bb)[4], int kk, int np) {
    if (NK)
      ldsm(bb, b_addr<C::KS2 + 8>(slab, warp * C::WN + np * 16, kk * 16, lane));
    else
      ldsm_t(bb, a_addr<C::LDX>(slab, kk * 16, warp * C::WN + np * 16, lane));
  };
#pragma unroll
  for (int kk = 0; kk < C::KS2 / 16; ++kk) {
    uint32_t a[C::MT][4], bb[2][4];   // the B fragments of this column pair and the next
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) ldsm(a[mt], a_addr<kLDH>(Hs, mt * 16, k0 + kk * 16, lane));
    load_b(bb[0], kk, 0);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      if (np + 1 < NP) load_b(bb[(np + 1) & 1], kk, np + 1);
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        mma(acc[mt][2 * np], a[mt], bb[np & 1][0], bb[np & 1][1]);
        mma(acc[mt][2 * np + 1], a[mt], bb[np & 1][2], bb[np & 1][3]);
      }
    }
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

template <int D>
__global__ void __launch_bounds__(kThreads)
ln_mlp_fwd(const bf16* __restrict__ x, const float* __restrict__ ln_s,
           const float* __restrict__ ln_b, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, bf16* __restrict__ out, int T, int M, float eps) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);
  bf16* Hs = Xn + C::ROWS;
  bf16* slabs = Hs + C::HID;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * C::RB;
  constexpr int PER = C::N1 + C::N2;
  const int chunks = M / kHC, total = chunks * PER;

  // slab i of the sequence: per chunk, N1 slabs of W1 (kKS rows of D x the
  // chunk's columns), then N2 slabs of W2 (KS2 of the chunk's rows x D)
  auto issue = [&](int i) {
    bf16* dst = slabs + (i & 1) * C::SLAB_FWD;
    const int c = i / PER, j = i % PER;
    if (j < C::N1)
      load_slab<kKS, kHC>(dst, w1 + (size_t)(j * kKS) * M + c * kHC, M);
    else
      load_slab<C::KS2, D>(dst, w2 + (size_t)(c * kHC + (j - C::N1) * C::KS2) * D, D);
    cp_commit();
  };

  issue(0);
  ln_rows<D>(Xn, x, ln_s, ln_b, row0, T, eps);

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  int i = 0;
  for (int c = 0; c < chunks; ++c) {
    float pre[C::MT][2][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) pre[mt][nt][0] = pre[mt][nt][1] = pre[mt][nt][2] = pre[mt][nt][3] = 0.f;
    for (int j = 0; j < C::N1; ++j, ++i) {
      if (i + 1 < total) issue(i + 1);
      wait_slab(i + 1 < total);
      mma_chunk_kn<D>(pre, Xn, j * kKS, slabs + (i & 1) * C::SLAB_FWD, warp, lane);
      __syncthreads();
    }
    // bias and GELU in f32, the hidden chunk to shared memory as bf16
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = warp * 16 + nt * 8 + 2 * t;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b1 + c * kHC + col));
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(Hs + (mt * 16 + g + 8 * r) * kLDH + col) =
              pack(gelu(pre[mt][nt][2 * r] + bias.x), gelu(pre[mt][nt][2 * r + 1] + bias.y));
      }
    }
    for (int j = 0; j < C::N2; ++j, ++i) {
      if (i + 1 < total) issue(i + 1);
      wait_slab(i + 1 < total);   // also orders the hidden chunk's stores before its loads
      mma_out<D, false>(acc, Hs, j * C::KS2, slabs + (i & 1) * C::SLAB_FWD, warp, lane);
      __syncthreads();
    }
  }

#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) {
    const int col = warp * C::WN + nt * 8 + 2 * t;
    const float2 bias = __ldg(reinterpret_cast<const float2*>(b2 + col));
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + mt * 16 + g + 8 * r;
        if (row < T)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * D + col) =
              pack(acc[mt][nt][2 * r] + bias.x, acc[mt][nt][2 * r + 1] + bias.y);
      }
    }
  }
}

// The LayerNorm backward over the f32 tile dh (RB rows, row stride LDX
// floats): a warp per row, mean and rstd recomputed from x.
template <int D>
__device__ void ln_bwd_rows(const float* dh, const bf16* __restrict__ x,
                            const float* __restrict__ ln_s, bf16* __restrict__ dx, int row0,
                            int T, float eps) {
  using C = Cfg<D>;
  using R = RowVecs<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < C::RB; r += kWarps) {
    const int row = row0 + r;
    if (row >= T) continue;   // the whole warp takes the same branch
    float v[R::PER][8], dn[R::PER][8];
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < R::PER; ++p) {
      const int vec = lane + 32 * p;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (vec < R::V) raw = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * D + vec * 8));
      unpack8(v[p], raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[p][e];
    }
    const float mean = warp_sum(sum) * (1.f / D);
    float sq = 0.f;
#pragma unroll
    for (int p = 0; p < R::PER; ++p) {
      if (lane + 32 * p < R::V) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[p][e] -= mean;
          sq += v[p][e] * v[p][e];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * (1.f / D) + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int p = 0; p < R::PER; ++p) {
      const int vec = lane + 32 * p;
#pragma unroll
      for (int e = 0; e < 8; ++e) dn[p][e] = 0.f;
      if (vec < R::V) {
        const float4 d0 = *reinterpret_cast<const float4*>(dh + r * C::LDX + vec * 8);
        const float4 d1 = *reinterpret_cast<const float4*>(dh + r * C::LDX + vec * 8 + 4);
        const float4 c0 = __ldg(reinterpret_cast<const float4*>(ln_s + vec * 8));
        const float4 c1 = __ldg(reinterpret_cast<const float4*>(ln_s + vec * 8 + 4));
        const float d[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
        const float sc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[p][e] *= rstd;   // the normalised row
          dn[p][e] = d[e] * sc[e];
          s1 += dn[p][e];
          s2 += dn[p][e] * v[p][e];
        }
      }
    }
    const float m1 = warp_sum(s1) * (1.f / D), m2 = warp_sum(s2) * (1.f / D);
#pragma unroll
    for (int p = 0; p < R::PER; ++p) {
      const int vec = lane + 32 * p;
      if (vec < R::V) {
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = rstd * (dn[p][e] - m1 - v[p][e] * m2);
        uint4 w;
        w.x = pack(o[0], o[1]);
        w.y = pack(o[2], o[3]);
        w.z = pack(o[4], o[5]);
        w.w = pack(o[6], o[7]);
        *reinterpret_cast<uint4*>(dx + (size_t)row * D + vec * 8) = w;
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
ln_mlp_bwd(const bf16* __restrict__ x, const float* __restrict__ ln_s,
           const float* __restrict__ ln_b, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const bf16* __restrict__ dy, bf16* __restrict__ dx, int T, int M, float eps) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);
  bf16* dYs = Xn + C::ROWS;
  bf16* Hs = dYs + C::ROWS;   // the dpre chunk
  bf16* slabs = Hs + C::HID;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * C::RB;
  constexpr int PER = 2 * C::N1 + C::N2;
  const int chunks = M / kHC, total = chunks * PER;

  // slab i of the sequence: per chunk, N1 slabs of W1 ([k][n]: kKS rows of D
  // x the chunk's columns) for pre, N1 slabs of W2 ([n][k]: the chunk's rows
  // x kKS columns of D) for dh, then N2 slabs of W1 ([n][k]: all D rows x
  // KS2 of the chunk's columns) for dhid
  auto issue = [&](int i) {
    bf16* dst = slabs + (i & 1) * C::SLAB_BWD;
    const int c = i / PER, j = i % PER;
    if (j < C::N1)
      load_slab<kKS, kHC>(dst, w1 + (size_t)(j * kKS) * M + c * kHC, M);
    else if (j < 2 * C::N1)
      load_slab<kHC, kKS>(dst, w2 + (size_t)(c * kHC) * D + (j - C::N1) * kKS, D);
    else
      load_slab<D, C::KS2>(dst, w1 + c * kHC + (j - 2 * C::N1) * C::KS2, M);
    cp_commit();
  };

  issue(0);
  ln_rows<D>(Xn, x, ln_s, ln_b, row0, T, eps);
  load_rows<D>(dYs, dy, row0, T);

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  int i = 0;
  for (int c = 0; c < chunks; ++c) {
    float pre[C::MT][2][4], dh[C::MT][2][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pre[mt][nt][e] = dh[mt][nt][e] = 0.f;
    for (int j = 0; j < C::N1; ++j, ++i) {
      if (i + 1 < total) issue(i + 1);
      wait_slab(i + 1 < total);
      mma_chunk_kn<D>(pre, Xn, j * kKS, slabs + (i & 1) * C::SLAB_BWD, warp, lane);
      __syncthreads();
    }
    for (int j = 0; j < C::N1; ++j, ++i) {
      if (i + 1 < total) issue(i + 1);
      wait_slab(i + 1 < total);
      mma_chunk_nk<D>(dh, dYs, j * kKS, slabs + (i & 1) * C::SLAB_BWD, warp, lane);
      __syncthreads();
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = warp * 16 + nt * 8 + 2 * t;
      const float2 bias = __ldg(reinterpret_cast<const float2*>(b1 + c * kHC + col));
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(Hs + (mt * 16 + g + 8 * r) * kLDH + col) =
              pack(dh[mt][nt][2 * r] * gelu_grad(pre[mt][nt][2 * r] + bias.x),
                   dh[mt][nt][2 * r + 1] * gelu_grad(pre[mt][nt][2 * r + 1] + bias.y));
      }
    }
    for (int j = 0; j < C::N2; ++j, ++i) {
      if (i + 1 < total) issue(i + 1);
      wait_slab(i + 1 < total);   // also orders the dpre chunk's stores before its loads
      mma_out<D, true>(acc, Hs, j * C::KS2, slabs + (i & 1) * C::SLAB_BWD, warp, lane);
      __syncthreads();
    }
  }

  // dhid as an f32 tile over the two row buffers (the last __syncthreads of
  // the loop ended their use), then the LayerNorm backward
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < C::NT; ++nt) {
    const int col = warp * C::WN + nt * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(tile + (mt * 16 + g + 8 * r) * C::LDX + col) =
            make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
    }
  }
  __syncthreads();
  ln_bwd_rows<D>(tile, x, ln_s, dx, row0, T, eps);
}

template <int D>
int launch_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int T, int M, float eps,
               cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM_FWD);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_fwd<D><<<(T + C::RB - 1) / C::RB, kThreads, C::SMEM_FWD, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<bf16*>(out), T, M, eps);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* dy, void* dx, int T, int M, float eps,
               cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_bwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM_BWD);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_bwd<D><<<(T + C::RB - 1) / C::RB, kThreads, C::SMEM_BWD, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), T, M, eps);
  return (int)cudaGetLastError();
}

bool supported(int T, int M) { return T >= 1 && M >= kHC && M % kHC == 0; }

}  // namespace

extern "C" {

// x (T, D) bf16, ln_s / ln_b (D) f32, w1 (D, M) bf16, b1 (M) f32, w2 (M, D)
// bf16, b2 (D) f32 -> out (T, D) bf16.
int apvt_ln_mlp_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* b2, void* out, int T, int D,
                    int M, float eps, void* stream) {
  if (!supported(T, M)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch_fwd<128>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 256: return launch_fwd<256>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 384: return launch_fwd<384>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 512: return launch_fwd<512>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 768: return launch_fwd<768>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    case 1024: return launch_fwd<1024>(x, ln_s, ln_b, w1, b1, w2, b2, out, T, M, eps, s);
    default: return -1;
  }
}

// ... and the cotangent dy (T, D) bf16 -> dx (T, D) bf16.
int apvt_ln_mlp_bwd(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                    const void* b1, const void* w2, const void* dy, void* dx, int T, int D,
                    int M, float eps, void* stream) {
  if (!supported(T, M)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch_bwd<128>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 256: return launch_bwd<256>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 384: return launch_bwd<384>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 512: return launch_bwd<512>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 768: return launch_bwd<768>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    case 1024: return launch_bwd<1024>(x, ln_s, ln_b, w1, b1, w2, dy, dx, T, M, eps, s);
    default: return -1;
  }
}

const char* apvt_ln_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
