// The mma.sync version of the fused MLP kernels of ln_mlp.cu (forward and
// input gradient, with and without the LayerNorm): the first design of the
// port, kept for the shapes the wgmma kernels do not take (D >= 512 with a
// hidden width that is not a multiple of 256; ln_mlp.cu's launcher tests the
// shape). Same arithmetic and rounding points as ln_mlp.cu's header lists.
//
// A CTA of 8 warps owns RB token rows (64 for D <= 128, 32 up to 512, 16
// above, so that the RB x D f32 output fits its registers), normalises them
// once into shared memory as bf16, and walks over the hidden dimension in
// chunks of 128 columns: pre (RB x 128, a 16-column slice per warp), bias and
// GELU in registers, the bf16 hidden chunk to shared memory, its product
// with the chunk's rows of W2 into the output accumulators (a D/8 column
// slice per warp). The weights stream from L2 through a cp.async double
// buffer of slabs; every product is mma.sync m16n8k16 with ldmatrix
// operands (a row-major (K, N) slab through ldmatrix.trans; the backward's
// transposed products read the row-major weight as the (N, K) form). What
// held it back (tools/ln_mlp_diagnose.py at its time): with 16-64 rows per
// CTA the weights are re-read from L2 once per CTA (7.4 GB per forward
// launch at the ViT-B shape), two block-wide barriers per slab, GELU between
// the products, and one ldmatrix per two mma.sync.

#pragma once

#include "tiles.cuh"

namespace apvt {
namespace mma_mlp {

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

// Wait for slab i (the newest but one when slab i + 1 was just started).
__device__ __forceinline__ void wait_slab(bool newer_in_flight) {
  if (newer_in_flight)
    cp_wait<1>();
  else
    cp_wait<0>();
  __syncthreads();
}

template <int D, bool LN>
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
  auto fetch = [&](int i) {
    bf16* dst = slabs + (i & 1) * C::SLAB_FWD;
    const int c = i / PER, j = i % PER;
    if (j < C::N1)
      load_slab<kKS, kHC>(dst, w1 + (size_t)(j * kKS) * M + c * kHC, M);
    else
      load_slab<C::KS2, D>(dst, w2 + (size_t)(c * kHC + (j - C::N1) * C::KS2) * D, D);
    cp_commit();
  };

  fetch(0);
  if (LN)
    ln_rows<D, C::RB, C::LDX, kWarps>(Xn, x, ln_s, ln_b, row0, T, eps);
  else
    load_rows<D>(Xn, x, row0, T);

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
      if (i + 1 < total) fetch(i + 1);
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
      if (i + 1 < total) fetch(i + 1);
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

template <int D, bool LN>
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
  auto fetch = [&](int i) {
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

  fetch(0);
  if (LN)
    ln_rows<D, C::RB, C::LDX, kWarps>(Xn, x, ln_s, ln_b, row0, T, eps);
  else
    load_rows<D>(Xn, x, row0, T);
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
      if (i + 1 < total) fetch(i + 1);
      wait_slab(i + 1 < total);
      mma_chunk_kn<D>(pre, Xn, j * kKS, slabs + (i & 1) * C::SLAB_BWD, warp, lane);
      __syncthreads();
    }
    for (int j = 0; j < C::N1; ++j, ++i) {
      if (i + 1 < total) fetch(i + 1);
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
      if (i + 1 < total) fetch(i + 1);
      wait_slab(i + 1 < total);   // also orders the dpre chunk's stores before its loads
      mma_out<D, true>(acc, Hs, j * C::KS2, slabs + (i & 1) * C::SLAB_BWD, warp, lane);
      __syncthreads();
    }
  }

  if (!LN) {   // dx = dhid, rounded once
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int col = warp * C::WN + nt * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + mt * 16 + g + 8 * r;
          if (row < T)
            *reinterpret_cast<uint32_t*>(dx + (size_t)row * D + col) =
                pack(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
        }
      }
    }
    return;
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
  ln_bwd_rows<D, C::RB, C::LDX, kWarps>(tile, x, ln_s, dx, row0, T, eps);
}

template <int D, bool LN>
int launch_fwd(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int T, int M, float eps,
               cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_fwd<D, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_FWD);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_fwd<D, LN><<<(T + C::RB - 1) / C::RB, kThreads, C::SMEM_FWD, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<bf16*>(out), T, M, eps);
  return (int)cudaGetLastError();
}

template <int D, bool LN>
int launch_bwd(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* dy, void* dx, int T, int M, float eps,
               cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_bwd<D, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM_BWD);
  if (err != cudaSuccess) return (int)err;
  ln_mlp_bwd<D, LN><<<(T + C::RB - 1) / C::RB, kThreads, C::SMEM_BWD, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), T, M, eps);
  return (int)cudaGetLastError();
}

}  // namespace mma_mlp
}  // namespace apvt
