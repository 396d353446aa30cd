// Multi-head attention, forward and backward, for Hopper (sm_90a), in two
// operand layouts.
//
// Replaces the TPU kernels kernels/attention.py:fused_attention_packed
// (_packed_fwd_kernel, _packed_bwd_kernel) and kernels/attention.py:
// fused_attention (_fwd_kernel, _bwd_kernel) of the JAX package, which share
// _attn_bwd_core: the softmax(Q K^T * hd^-1/2) V of one ViT layer over q/k/v
// in the packed (B, N, H*hd) layout the dense projections produce, heads as
// contiguous hd-wide channel slices, or in the head-major (B, H, N, hd)
// layout. One device code serves both layouts: a kernel gets the operands'
// strides (or tensor maps built from them) and reads them in place (no
// transposed or padded copy exists; the TPU whole-head kernel pads N to 128
// with an additive key mask, here the ragged tail is masked as below).
// Scores, softmax and every accumulation are f32; P is rounded to the input
// dtype before P.V (forward) and P^T.dO (backward), dS to the input dtype
// before dS.K and dS^T.Q, as the Pallas kernel does. P is never written to
// device memory in either pass.
//
// What bounds it on the H100: at ViT-B shapes (B=64, N=197, H=12, hd=64) a
// head does ~100 FLOP per byte it reads, under the card's bf16 ridge of 295:
// the bytes bound it (23 us forward, 41 us backward), with the tensor-core
// time at the dense peak close behind, so the products have to run on the
// tensor cores at a rate only wgmma reaches, and the loads have to overlap
// them.
//
// Three variants, chosen by an explicit test of (dtype, N, hd) in fwd_any /
// bwd_any below (kernels/attention.py:kernel_variant is the same test; no
// flag chooses):
// * "wgmma": bf16, hd = 64, N <= 256, the ViT-B path. The Hopper core of
//   attn_wgmma.cuh: wgmma.mma_async from TMA-loaded, 128-byte-swizzled tiles
//   behind mbarriers, the 64 x N scores of a warpgroup in its accumulators,
//   a seven-product backward from the forward's log-sum-exp. Its header
//   says what it does about the bound;
// * "mma_sync": bf16, hd = 32, N <= 256 (no model of the package has this
//   shape; a 64-byte row would need the 64-byte swizzle and its own tile
//   format). namespace tc below: the core of attn_core.cuh, which
//   attn_block.cu also uses: a warp owns 16 rows with their whole score row
//   in registers, mma.sync m16n8k16 with ldmatrix operands;
// * "cuda_core": f32, and bf16 with N > 256: a warp per row, a lane per key.
// All three: one CTA (or a few) per (batch, head); the backward in two
// phases, query-row owners for dQ, key-row owners for dK and dV, every sum
// with one owner and a fixed order: no atomics, bitwise reproducible; keys
// >= N get P = 0, rows >= N are never written. The forward writes the row
// log-sum-exp (B, H, N) f32 and the backward reads it and the forward's
// output only in the wgmma variant; the other two ignore those pointers.
//
// C interface (loaded with ctypes): each entry point returns the CUDA error
// code of its launch (cudaGetLastError), 0 on success, -1 for an
// unsupported dtype or head dim, -2 if a tensor map could not be encoded.

#include "attn_core.cuh"
#include "attn_wgmma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // round to nearest even, as XLA's f32 -> bf16 convert
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Cvt<T>::to_f(Cvt<T>::from_f(x));
}

// Row stride (in elements) of a head tile in shared memory: hd elements plus
// one 32-bit word, so consecutive rows start in consecutive banks.
template <typename T, int HD>
struct Tile {
  static constexpr int kStride = HD + 4 / static_cast<int>(sizeof(T));
};

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

// f32 dot product of two hd-long rows in a fixed order (both passes use it,
// so the backward's recomputed scores equal the forward's bit for bit).
template <typename T, int HD>
__device__ __forceinline__ float dot_row(const T* a, const T* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < HD; ++d) acc = fmaf(Cvt<T>::to_f(a[d]), Cvt<T>::to_f(b[d]), acc);
  return acc;
}

// Where head h of batch element b starts, and the distance between its rows,
// in elements: packed (B, N, H*hd) is {N*H*hd, hd, H*hd}, head-major
// (B, H, N, hd) is {H*N*hd, N*hd, hd}.
struct Layout {
  long long batch, head;
  int row;
};

// Copy one head (N rows of HD values, row stride rs) into a shared-memory tile.
template <typename T, int HD>
__device__ void load_tile(T* dst, const T* __restrict__ src, int N, int rs) {
  constexpr int S = Tile<T, HD>::kStride;
  for (int idx = threadIdx.x; idx < N * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD;
    dst[j * S + d] = src[(size_t)j * rs + d];
  }
}

// Softmax of one score row, computed by one warp: prow[j] = P[j] in f32 for
// j < N. Returns the row max and the sum of exponentials.
template <typename T, int HD>
__device__ __forceinline__ void softmax_row(const T* qrow, const T* Ks, int N, float scale,
                                            float* prow, float& m_out, float& l_out) {
  constexpr int S = Tile<T, HD>::kStride;
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int j = lane; j < N; j += 32) {
    const float s = dot_row<T, HD>(qrow, Ks + j * S) * scale;
    prow[j] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < N; j += 32) {
    const float e = expf(prow[j] - m);
    prow[j] = e;
    l += e;
  }
  l = warp_sum(l);
  for (int j = lane; j < N; j += 32) prow[j] = prow[j] / l;
  __syncwarp();
  m_out = m;
  l_out = l;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, int N, int H, Layout lay, float scale) {
  constexpr int S = Tile<T, HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)(blockIdx.x / H) * lay.batch + (size_t)(blockIdx.x % H) * lay.head;
  const int rs = lay.row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + N * S;
  float* prow = reinterpret_cast<float*>(Vs + N * S) + warp * N;
  T* qbuf = reinterpret_cast<T*>(reinterpret_cast<float*>(Vs + N * S) + kWarps * N) + warp * HD;

  load_tile<T, HD>(Ks, k + base, N, rs);
  load_tile<T, HD>(Vs, v + base, N, rs);
  __syncthreads();

  for (int i = warp; i < N; i += kWarps) {
    for (int d = lane; d < HD; d += 32) qbuf[d] = q[base + (size_t)i * rs + d];
    __syncwarp();
    float m, l;
    softmax_row<T, HD>(qbuf, Ks, N, scale, prow, m, l);
    for (int j = lane; j < N; j += 32) prow[j] = round_to<T>(prow[j]);
    __syncwarp();
    for (int d = lane; d < HD; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(prow[j], Cvt<T>::to_f(Vs[j * S + d]), acc);
      o[base + (size_t)i * rs + d] = Cvt<T>::from_f(acc);
    }
    __syncwarp();
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                T* __restrict__ dv, int N, int H, Layout lay, float scale) {
  constexpr int S = Tile<T, HD>::kStride;
  constexpr int R = HD / 32;  // output channels per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)(blockIdx.x / H) * lay.batch + (size_t)(blockIdx.x % H) * lay.head;
  const int rs = lay.row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wbuf = max(2 * N, 64);

  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + N * S;
  T* Qs = Vs + N * S;
  T* dOs = Qs + N * S;
  float* stat_m = reinterpret_cast<float*>(dOs + N * S);
  float* stat_l = stat_m + N;
  float* stat_D = stat_l + N;
  float* prow = stat_D + N + warp * wbuf;
  float* dsrow = prow + N;

  load_tile<T, HD>(Ks, k + base, N, rs);
  load_tile<T, HD>(Vs, v + base, N, rs);
  load_tile<T, HD>(Qs, q + base, N, rs);
  load_tile<T, HD>(dOs, dout + base, N, rs);
  __syncthreads();


  // Phase 1: one warp per query row -> dQ and the row statistics.
  for (int i = warp; i < N; i += kWarps) {
    const T* qi = Qs + i * S;
    const T* doi = dOs + i * S;
    float m, l;
    softmax_row<T, HD>(qi, Ks, N, scale, prow, m, l);
    float part = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float dp = dot_row<T, HD>(doi, Vs + j * S);
      dsrow[j] = dp;
      part += prow[j] * dp;
    }
    const float D = warp_sum(part);
    for (int j = lane; j < N; j += 32)
      dsrow[j] = round_to<T>(prow[j] * (dsrow[j] - D) * scale);
    if (lane == 0) {
      stat_m[i] = m;
      stat_l[i] = l;
      stat_D[i] = D;
    }
    __syncwarp();
    for (int d = lane; d < HD; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(dsrow[j], Cvt<T>::to_f(Ks[j * S + d]), acc);
      dq[base + (size_t)i * rs + d] = Cvt<T>::from_f(acc);
    }
    __syncwarp();
  }
  __syncthreads();

  // Phase 2: one warp per key row -> dK, dV. Lanes recompute P and dS for 32
  // query rows at a time, then switch to one output channel per lane.
  float* pbuf = prow;
  float* dsbuf = prow + 32;
  for (int j = warp; j < N; j += kWarps) {
    const T* kj = Ks + j * S;
    const T* vj = Vs + j * S;
    float dk_acc[R], dv_acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dk_acc[r] = dv_acc[r] = 0.f;
    for (int i0 = 0; i0 < N; i0 += 32) {
      const int i = i0 + lane;
      float p = 0.f, ds = 0.f;
      if (i < N) {
        const float s = dot_row<T, HD>(Qs + i * S, kj) * scale;
        p = expf(s - stat_m[i]) / stat_l[i];
        const float dp = dot_row<T, HD>(dOs + i * S, vj);
        ds = p * (dp - stat_D[i]) * scale;
      }
      pbuf[lane] = round_to<T>(p);
      dsbuf[lane] = round_to<T>(ds);
      __syncwarp();
      const int cnt = min(32, N - i0);
      for (int t = 0; t < cnt; ++t) {
        const float pt = pbuf[t], dst = dsbuf[t];
        const T* dorow = dOs + (i0 + t) * S;
        const T* qrow = Qs + (i0 + t) * S;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int d = lane + 32 * r;
          dv_acc[r] = fmaf(pt, Cvt<T>::to_f(dorow[d]), dv_acc[r]);
          dk_acc[r] = fmaf(dst, Cvt<T>::to_f(qrow[d]), dk_acc[r]);
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int d = lane + 32 * r;
      dk[base + (size_t)j * rs + d] = Cvt<T>::from_f(dk_acc[r]);
      dv[base + (size_t)j * rs + d] = Cvt<T>::from_f(dv_acc[r]);
    }
  }
}

template <typename T, int HD>
size_t fwd_smem(int N) {
  return 2 * (size_t)N * Tile<T, HD>::kStride * sizeof(T) + (size_t)kWarps * N * sizeof(float) +
         (size_t)kWarps * HD * sizeof(T);
}

template <typename T, int HD>
size_t bwd_smem(int N) {
  const size_t wbuf = (size_t)(2 * N > 64 ? 2 * N : 64);
  return 4 * (size_t)N * Tile<T, HD>::kStride * sizeof(T) + 3 * (size_t)N * sizeof(float) +
         (size_t)kWarps * wbuf * sizeof(float);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
               Layout lay, float scale, cudaStream_t stream) {
  return launch(attn_fwd_kernel<T, HD>, B * H, kThreads, fwd_smem<T, HD>(N), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), N, H, lay, scale);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
               void* dk, void* dv, int B, int N, int H, Layout lay, float scale, cudaStream_t stream) {
  return launch(attn_bwd_kernel<T, HD>, B * H, kThreads, bwd_smem<T, HD>(N), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
                static_cast<T*>(dv), N, H, lay, scale);
}

// ---------------------------------------------------------------------------
// mma.sync variant for bf16 operands with hd = 32 and N <= 256: the same math
// with every product on mma.sync m16n8k16 (bf16 in, f32 accumulate), from the
// shared attention core (attn_core.cuh). Tiles are staged in shared memory
// with rows padded by 16 bytes (ldmatrix reads 8 rows of 16 bytes without
// bank conflicts); ldmatrix .trans gives the operand fragments that need a
// transposed tile.

namespace tc {

namespace core = apvt::tc;
using apvt::bf16;
constexpr int kFwdWarps = 4;
constexpr int kBwdWarps = 8;

template <int HD, int KMAX>
__global__ void __launch_bounds__(kFwdWarps * 32)
attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         bf16* __restrict__ o, int N, int H, Layout lay, float scale) {
  constexpr int S = core::Shape<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)(blockIdx.x / H) * lay.batch + (size_t)(blockIdx.x % H) * lay.head;
  const int rs = lay.row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int NP = (N + 15) & ~15;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * S;
  core::load_tile<HD>(Ks, k + base, N, NP, rs);
  core::load_tile<HD>(Vs, v + base, N, NP, rs);
  __syncthreads();

  for (int r0 = warp * 16; r0 < NP; r0 += kFwdWarps * 16) {
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i & 1), col = kc * 16 + 8 * (i >> 1) + 2 * t;
        qa[kc][i] = row < N ? *reinterpret_cast<const uint32_t*>(q + base + (size_t)row * rs + col)
                            : 0u;
      }
    }
    float acc[HD / 8][4];
    core::fwd_rows<HD, KMAX>(acc, qa, Ks, Vs, N, NP, scale);
    core::store_rows<HD>(o + base, r0, N, rs, acc);
  }
}

template <int HD, int KMAX>
__global__ void __launch_bounds__(kBwdWarps * 32)
attn_bwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const bf16* __restrict__ dout, bf16* __restrict__ dq, bf16* __restrict__ dk,
         bf16* __restrict__ dv, int N, int H, Layout lay, float scale) {
  constexpr int S = core::Shape<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)(blockIdx.x / H) * lay.batch + (size_t)(blockIdx.x % H) * lay.head;
  const int rs = lay.row;
  const int NP = (N + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + NP * S;
  bf16* Vs = Ks + NP * S;
  bf16* dOs = Vs + NP * S;
  float* stat_m = reinterpret_cast<float*>(dOs + NP * S);
  float* stat_l = stat_m + NP;
  float* stat_D = stat_l + NP;
  core::load_tile<HD>(Qs, q + base, N, NP, rs);
  core::load_tile<HD>(Ks, k + base, N, NP, rs);
  core::load_tile<HD>(Vs, v + base, N, NP, rs);
  core::load_tile<HD>(dOs, dout + base, N, NP, rs);
  __syncthreads();
  core::bwd_phase1<HD, KMAX, kBwdWarps>(Qs, Ks, Vs, dOs, stat_m, stat_l, stat_D, dq + base, rs,
                                        N, NP, scale);
  __syncthreads();
  core::bwd_phase2<HD, kBwdWarps>(Qs, Ks, Vs, dOs, stat_m, stat_l, stat_D, dk + base, dv + base,
                                  rs, N, NP, scale);
}

template <int HD>
size_t fwd_smem(int N) {
  return 2 * (size_t)((N + 15) & ~15) * core::Shape<HD>::kStride * sizeof(bf16);
}

template <int HD>
size_t bwd_smem(int N) {
  const size_t np = (size_t)((N + 15) & ~15);
  return 4 * np * core::Shape<HD>::kStride * sizeof(bf16) + 3 * np * sizeof(float);
}

}  // namespace tc

constexpr int kTcMaxN = 256;  // the tensor-core kernels hold 16 x 256 scores per warp

template <int HD>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                  Layout lay, float scale, cudaStream_t s) {
  using tc::bf16;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  const size_t smem = tc::fwd_smem<HD>(N);
  if (N <= 64)
    return launch(tc::attn_fwd<HD, 64>, B * H, tc::kFwdWarps * 32, smem, s, qq, kk, vv, oo, N, H,
                  lay, scale);
  return launch(tc::attn_fwd<HD, 256>, B * H, tc::kFwdWarps * 32, smem, s, qq, kk, vv, oo, N, H,
                lay, scale);
}

template <int HD>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* dout, void* dq,
                  void* dk, void* dv, int B, int N, int H, Layout lay, float scale,
                  cudaStream_t s) {
  using tc::bf16;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  const auto* dd = static_cast<const bf16*>(dout);
  auto* dqq = static_cast<bf16*>(dq);
  auto* dkk = static_cast<bf16*>(dk);
  auto* dvv = static_cast<bf16*>(dv);
  const size_t smem = tc::bwd_smem<HD>(N);
  if (N <= 64)
    return launch(tc::attn_bwd<HD, 64>, B * H, tc::kBwdWarps * 32, smem, s, qq, kk, vv, dd, dqq,
                  dkk, dvv, N, H, lay, scale);
  return launch(tc::attn_bwd<HD, 256>, B * H, tc::kBwdWarps * 32, smem, s, qq, kk, vv, dd, dqq,
                dkk, dvv, N, H, lay, scale);
}

// layout: 0 = packed (B, N, H*hd), 1 = head-major (B, H, N, hd).
Layout layout_of(int layout, int N, int H, int hd) {
  if (layout == 1) return Layout{(long long)H * N * hd, (long long)N * hd, hd};
  return Layout{(long long)N * H * hd, (long long)hd, H * hd};
}

int fwd_any(const void* q, const void* k, const void* v, void* o, void* lse, int B, int N, int H,
            int hd, int dtype, int layout, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = layout_of(layout, N, H, hd);
  if (dtype == 1 && hd == 64 && N <= apvt::wg::kMaxN)
    return apvt::wg::launch_fwd(q, k, v, o, static_cast<float*>(lse), B, N, H, layout, scale, s);
  if (dtype == 0 && hd == 32) return launch_fwd<float, 32>(q, k, v, o, B, N, H, lay, scale, s);
  if (dtype == 0 && hd == 64) return launch_fwd<float, 64>(q, k, v, o, B, N, H, lay, scale, s);
  if (dtype == 1 && N <= kTcMaxN && hd == 32)
    return launch_fwd_tc<32>(q, k, v, o, B, N, H, lay, scale, s);
  if (dtype == 1 && hd == 32)
    return launch_fwd<__nv_bfloat16, 32>(q, k, v, o, B, N, H, lay, scale, s);
  if (dtype == 1 && hd == 64)
    return launch_fwd<__nv_bfloat16, 64>(q, k, v, o, B, N, H, lay, scale, s);
  return -1;
}

int bwd_any(const void* q, const void* k, const void* v, const void* dout, const void* o,
            const void* lse, void* dq, void* dk, void* dv, int B, int N, int H, int hd, int dtype,
            int layout, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = layout_of(layout, N, H, hd);
  if (dtype == 1 && hd == 64 && N <= apvt::wg::kMaxN)
    return apvt::wg::launch_bwd(q, k, v, dout, o, static_cast<const float*>(lse), dq, dk, dv, B, N,
                                H, layout, scale, s);
  if (dtype == 0 && hd == 32)
    return launch_bwd<float, 32>(q, k, v, dout, dq, dk, dv, B, N, H, lay, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_bwd<float, 64>(q, k, v, dout, dq, dk, dv, B, N, H, lay, scale, s);
  if (dtype == 1 && N <= kTcMaxN && hd == 32)
    return launch_bwd_tc<32>(q, k, v, dout, dq, dk, dv, B, N, H, lay, scale, s);
  if (dtype == 1 && hd == 32)
    return launch_bwd<__nv_bfloat16, 32>(q, k, v, dout, dq, dk, dv, B, N, H, lay, scale, s);
  if (dtype == 1 && hd == 64)
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, dout, dq, dk, dv, B, N, H, lay, scale, s);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. hd: 32 or 64. Operands (B, N, H*hd); lse
// (B, H, N) f32, written by the forward and read (with o) by the backward in
// the wgmma variant only.
int apvt_attn_packed_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int N, int H, int hd, int dtype, float scale, void* stream) {
  return fwd_any(q, k, v, o, lse, B, N, H, hd, dtype, 0, scale, stream);
}

int apvt_attn_packed_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* o, const void* lse, void* dq, void* dk, void* dv, int B,
                         int N, int H, int hd, int dtype, float scale, void* stream) {
  return bwd_any(q, k, v, dout, o, lse, dq, dk, dv, B, N, H, hd, dtype, 0, scale, stream);
}

// The same over head-major operands (B, H, N, hd).
int apvt_attn_bhnd_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int N, int H, int hd, int dtype, float scale, void* stream) {
  return fwd_any(q, k, v, o, lse, B, N, H, hd, dtype, 1, scale, stream);
}

int apvt_attn_bhnd_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* o, const void* lse, void* dq, void* dk, void* dv, int B, int N,
                       int H, int hd, int dtype, float scale, void* stream) {
  return bwd_any(q, k, v, dout, o, lse, dq, dk, dv, B, N, H, hd, dtype, 1, scale, stream);
}

const char* apvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
