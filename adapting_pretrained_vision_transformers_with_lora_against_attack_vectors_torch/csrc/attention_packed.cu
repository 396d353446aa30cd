// Packed multi-head attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/attention.py:fused_attention_packed of the
// JAX package (_packed_fwd_kernel, _packed_bwd_kernel, _attn_bwd_core): the
// softmax(Q K^T * hd^-1/2) V of one ViT layer over q/k/v in the packed
// (B, N, H*hd) layout the dense projections produce, heads as contiguous
// hd-wide channel slices. Scores, softmax and every accumulation are f32; P
// is rounded to the input dtype before P.V (forward) and P^T.dO (backward),
// dS to the input dtype before dS.K and dS^T.Q, as the Pallas kernel does.
// P is never written to device memory in either pass.
//
// What bounds it on the H100: at ViT-B shapes (B=64, N=197, H=12, hd=64) one
// (batch, head) pair reads 3-4 tiles of 197x64 and does ~2*N^2*hd (forward)
// and 5-8*N^2*hd (backward, with recompute) multiply-adds: ~100 FMA per byte
// read, so the work is compute, not bytes, and it has to run on the tensor
// cores to get near the card's bf16 rate.
//
// What the design does about it. Two variants share the grid and the
// two-phase structure:
// * one CTA per (batch, head): 768 CTAs at ViT-B, enough to fill 132 SMs
//   (the Pallas grid of one program per batch element would give 64);
// * the head's K and V (and, in the backward, Q and dO) are staged once in
//   shared memory with padded rows, so lanes walking different rows hit
//   different banks; a shape that needs more than 48 KB is opted in with
//   cudaFuncSetAttribute, one that does not fit is refused with the CUDA
//   error code;
// * the backward runs two phases inside the CTA. Phase 1 (query-row owners)
//   recomputes P, forms dP, the row statistic D = rowsum(dP*P) and dS, and
//   writes dQ; it leaves (max, sum, D) per row in shared memory. Phase 2
//   (key-row owners) recomputes P and dS from those statistics and
//   accumulates dK and dV in registers. Every sum has one owner and a fixed
//   order: no atomics, results are bitwise reproducible from run to run;
// * the ragged N (197) is masked explicitly: keys >= N get P = 0, rows >= N
//   are never written.
// The tensor-core variant (namespace tc: bf16, N <= 256, the ViT path) runs
// every product on mma.sync m16n8k16 with ldmatrix operands, a warp owning
// 16 rows with their whole score row in registers (exact two-pass softmax).
// The CUDA-core variant (f32, and bf16 with N > 256) gives a warp one row
// and a lane one key at a time.
//
// C interface (loaded with ctypes): each entry point returns the CUDA error
// code of its launch (cudaGetLastError), 0 on success, -1 for an
// unsupported dtype or head dim.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

// Copy head h of batch element b of a packed (B, N, C) tensor into a
// shared-memory tile of N rows.
template <typename T, int HD>
__device__ void load_tile(T* dst, const T* __restrict__ src, int b, int h, int N, int C) {
  constexpr int S = Tile<T, HD>::kStride;
  const T* base = src + (size_t)b * N * C + (size_t)h * HD;
  for (int idx = threadIdx.x; idx < N * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD;
    dst[j * S + d] = base[(size_t)j * C + d];
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
                T* __restrict__ o, int N, int H, float scale) {
  constexpr int S = Tile<T, HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H, C = H * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + N * S;
  float* prow = reinterpret_cast<float*>(Vs + N * S) + warp * N;
  T* qbuf = reinterpret_cast<T*>(reinterpret_cast<float*>(Vs + N * S) + kWarps * N) + warp * HD;

  load_tile<T, HD>(Ks, k, b, h, N, C);
  load_tile<T, HD>(Vs, v, b, h, N, C);
  __syncthreads();

  const size_t base = (size_t)b * N * C + (size_t)h * HD;
  for (int i = warp; i < N; i += kWarps) {
    for (int d = lane; d < HD; d += 32) qbuf[d] = q[base + (size_t)i * C + d];
    __syncwarp();
    float m, l;
    softmax_row<T, HD>(qbuf, Ks, N, scale, prow, m, l);
    for (int j = lane; j < N; j += 32) prow[j] = round_to<T>(prow[j]);
    __syncwarp();
    for (int d = lane; d < HD; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(prow[j], Cvt<T>::to_f(Vs[j * S + d]), acc);
      o[base + (size_t)i * C + d] = Cvt<T>::from_f(acc);
    }
    __syncwarp();
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                T* __restrict__ dv, int N, int H, float scale) {
  constexpr int S = Tile<T, HD>::kStride;
  constexpr int R = HD / 32;  // output channels per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H, C = H * HD;
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

  load_tile<T, HD>(Ks, k, b, h, N, C);
  load_tile<T, HD>(Vs, v, b, h, N, C);
  load_tile<T, HD>(Qs, q, b, h, N, C);
  load_tile<T, HD>(dOs, dout, b, h, N, C);
  __syncthreads();

  const size_t base = (size_t)b * N * C + (size_t)h * HD;

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
      dq[base + (size_t)i * C + d] = Cvt<T>::from_f(acc);
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
      dk[base + (size_t)j * C + d] = Cvt<T>::from_f(dk_acc[r]);
      dv[base + (size_t)j * C + d] = Cvt<T>::from_f(dv_acc[r]);
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
               float scale, cudaStream_t stream) {
  return launch(attn_fwd_kernel<T, HD>, B * H, kThreads, fwd_smem<T, HD>(N), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), N, H, scale);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
               void* dk, void* dv, int B, int N, int H, float scale, cudaStream_t stream) {
  return launch(attn_bwd_kernel<T, HD>, B * H, kThreads, bwd_smem<T, HD>(N), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
                static_cast<T*>(dv), N, H, scale);
}

// ---------------------------------------------------------------------------
// Tensor-core variant for bf16 operands with N <= 256: the same math with
// every product on mma.sync m16n8k16 (bf16 in, f32 accumulate). A warp owns
// 16 query rows (forward, backward phase 1) or 16 key rows (backward phase
// 2); a whole 16 x N score block lives in registers, so the softmax is the
// exact two-pass max/sum of the Pallas kernel, not an online rescaling.
// Tiles are staged in shared memory with rows padded by 16 bytes (ldmatrix
// reads 8 rows of 16 bytes without bank conflicts); ldmatrix .trans gives
// the operand fragments that need a transposed tile.

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kFwdWarps = 4;
constexpr int kBwdWarps = 8;

template <int HD>
struct Shape {
  static constexpr int kStride = HD + 8;  // bf16 per shared-memory row
};

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

// Fragment addresses (lane-dependent) into a row-major tile with stride S.
// A operand (16 rows x 16 cols at (r0, c0)); the same address with ldsm_t
// gives the B operand of two n-tiles (c0, c0+8) from a [k][n] tile.
template <int S>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + c0 + (lane >> 4) * 8;
}
// B operand of two n-tiles (rows n0, n0+8) from an [n][k] tile, k-chunk at c0.
template <int S>
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int n0, int c0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * S + c0 + ((lane >> 3) & 1) * 8;
}

// Head h of batch element b of a packed (B, N, C) tensor -> NP rows of a
// shared-memory tile, 16 bytes per thread and step, rows >= N zero.
template <int HD>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, int b, int h, int N, int NP,
                          int C) {
  constexpr int S = Shape<HD>::kStride, V = HD / 8;
  const bf16* base = src + (size_t)b * N * C + (size_t)h * HD;
  for (int idx = threadIdx.x; idx < NP * V; idx += blockDim.x) {
    const int j = idx / V, c = idx % V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (j < N) val = *reinterpret_cast<const uint4*>(base + (size_t)j * C + c * 8);
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

// Store an accumulator block (16 rows at r0 x HD) as bf16, rows >= N skipped.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, size_t base, int r0, int N,
                                           int C, const float (&acc)[HD / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < N) {
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        *reinterpret_cast<uint32_t*>(out + base + (size_t)row * C + nt * 8 + 2 * t) =
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

template <int HD, int KMAX>
__global__ void __launch_bounds__(kFwdWarps * 32)
attn_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         bf16* __restrict__ o, int N, int H, float scale) {
  constexpr int S = Shape<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H, C = H * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int NP = (N + 15) & ~15;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + NP * S;
  load_tile<HD>(Ks, k, b, h, N, NP, C);
  load_tile<HD>(Vs, v, b, h, N, NP, C);
  __syncthreads();

  const size_t base = (size_t)b * N * C + (size_t)h * HD;
  for (int r0 = warp * 16; r0 < NP; r0 += kFwdWarps * 16) {
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + g + 8 * (i & 1), col = kc * 16 + 8 * (i >> 1) + 2 * t;
        qa[kc][i] = row < N ? *reinterpret_cast<const uint32_t*>(q + base + (size_t)row * C + col)
                            : 0u;
      }
    }
    float s[KMAX / 8][4], m[2], l[2];
    softmax_rows<HD, KMAX>(s, qa, Ks, N, NP, scale, m, l);
    float acc[HD / 8][4];
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
    store_rows<HD>(o, base, r0, N, C, acc);
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

template <int HD, int KMAX>
__global__ void __launch_bounds__(kBwdWarps * 32)
attn_bwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
         const bf16* __restrict__ dout, bf16* __restrict__ dq, bf16* __restrict__ dk,
         bf16* __restrict__ dv, int N, int H, float scale) {
  constexpr int S = Shape<HD>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H, C = H * HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int NP = (N + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + NP * S;
  bf16* Vs = Ks + NP * S;
  bf16* dOs = Vs + NP * S;
  float* stat_m = reinterpret_cast<float*>(dOs + NP * S);
  float* stat_l = stat_m + NP;
  float* stat_D = stat_l + NP;
  load_tile<HD>(Qs, q, b, h, N, NP, C);
  load_tile<HD>(Ks, k, b, h, N, NP, C);
  load_tile<HD>(Vs, v, b, h, N, NP, C);
  load_tile<HD>(dOs, dout, b, h, N, NP, C);
  __syncthreads();
  const size_t base = (size_t)b * N * C + (size_t)h * HD;

  // Phase 1: a warp per 16 query rows -> P, D = rowsum(dP*P), dS, dQ.
  for (int r0 = warp * 16; r0 < NP; r0 += kBwdWarps * 16) {
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
    store_rows<HD>(dq, base, r0, N, C, acc);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        stat_m[r0 + g + 8 * r] = m[r];
        stat_l[r0 + g + 8 * r] = l[r];
        stat_D[r0 + g + 8 * r] = D[r];
      }
    }
  }
  __syncthreads();

  // Phase 2: a warp per 16 key rows -> P^T, dS^T from the row statistics;
  // dV = P^T dO and dK = dS^T Q accumulate in registers over query chunks.
  for (int j0 = warp * 16; j0 < NP; j0 += kBwdWarps * 16) {
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
    store_rows<HD>(dk, base, j0, N, C, dk_acc);
    store_rows<HD>(dv, base, j0, N, C, dv_acc);
  }
}

template <int HD>
size_t fwd_smem(int N) {
  return 2 * (size_t)((N + 15) & ~15) * Shape<HD>::kStride * sizeof(bf16);
}

template <int HD>
size_t bwd_smem(int N) {
  const size_t np = (size_t)((N + 15) & ~15);
  return 4 * np * Shape<HD>::kStride * sizeof(bf16) + 3 * np * sizeof(float);
}

}  // namespace tc

constexpr int kTcMaxN = 256;  // the tensor-core kernels hold 16 x 256 scores per warp

template <int HD>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                  float scale, cudaStream_t s) {
  using tc::bf16;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  auto* oo = static_cast<bf16*>(o);
  const size_t smem = tc::fwd_smem<HD>(N);
  if (N <= 64)
    return launch(tc::attn_fwd<HD, 64>, B * H, tc::kFwdWarps * 32, smem, s, qq, kk, vv, oo, N, H,
                  scale);
  return launch(tc::attn_fwd<HD, 256>, B * H, tc::kFwdWarps * 32, smem, s, qq, kk, vv, oo, N, H,
                scale);
}

template <int HD>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* dout, void* dq,
                  void* dk, void* dv, int B, int N, int H, float scale, cudaStream_t s) {
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
                  dkk, dvv, N, H, scale);
  return launch(tc::attn_bwd<HD, 256>, B * H, tc::kBwdWarps * 32, smem, s, qq, kk, vv, dd, dqq,
                dkk, dvv, N, H, scale);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. hd: 32 or 64.
int apvt_attn_packed_fwd(const void* q, const void* k, const void* v, void* o, int B, int N,
                         int H, int hd, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 32) return launch_fwd<float, 32>(q, k, v, o, B, N, H, scale, s);
  if (dtype == 0 && hd == 64) return launch_fwd<float, 64>(q, k, v, o, B, N, H, scale, s);
  if (dtype == 1 && N <= kTcMaxN && hd == 32) return launch_fwd_tc<32>(q, k, v, o, B, N, H, scale, s);
  if (dtype == 1 && N <= kTcMaxN && hd == 64) return launch_fwd_tc<64>(q, k, v, o, B, N, H, scale, s);
  if (dtype == 1 && hd == 32) return launch_fwd<__nv_bfloat16, 32>(q, k, v, o, B, N, H, scale, s);
  if (dtype == 1 && hd == 64) return launch_fwd<__nv_bfloat16, 64>(q, k, v, o, B, N, H, scale, s);
  return -1;
}

int apvt_attn_packed_bwd(const void* q, const void* k, const void* v, const void* dout,
                         void* dq, void* dk, void* dv, int B, int N, int H, int hd, int dtype,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 32)
    return launch_bwd<float, 32>(q, k, v, dout, dq, dk, dv, B, N, H, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_bwd<float, 64>(q, k, v, dout, dq, dk, dv, B, N, H, scale, s);
  if (dtype == 1 && N <= kTcMaxN && hd == 32)
    return launch_bwd_tc<32>(q, k, v, dout, dq, dk, dv, B, N, H, scale, s);
  if (dtype == 1 && N <= kTcMaxN && hd == 64)
    return launch_bwd_tc<64>(q, k, v, dout, dq, dk, dv, B, N, H, scale, s);
  if (dtype == 1 && hd == 32)
    return launch_bwd<__nv_bfloat16, 32>(q, k, v, dout, dq, dk, dv, B, N, H, scale, s);
  if (dtype == 1 && hd == 64)
    return launch_bwd<__nv_bfloat16, 64>(q, k, v, dout, dq, dk, dv, B, N, H, scale, s);
  return -1;
}

const char* apvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
