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
// ridge (~295): the kernel is bound by bytes and latency. Its job, like the
// Pallas kernel's, is to keep scores and probabilities out of device memory
// and to read the projection once, with no head-split copies.
//
// What the design does about it:
// * one CTA of 4 warps per (b, w, h): 16384 CTAs at Swin-B stage 1, 2048 at
//   stage 4. Consecutive CTAs are the heads of one window, so the qkv rows
//   they share meet in L2;
// * rows and keys are padded to a multiple of 16 (at most 64) inside shared
//   memory only: nothing past n is read or written, keys >= n get P = 0;
// * bias[h] and mask[w] are read from device memory, where they stay in L2:
//   every batch element shares them;
// * bf16 (namespace tc): every product on mma.sync m16n8k16 with ldmatrix
//   operands; a warp owns 16 query rows with their whole score row in
//   registers (the exact two-pass softmax of the Pallas kernel). The
//   backward keeps P and ds (<= 64 x 64 bf16) in shared memory, so phase 2
//   (a warp per 16 key rows) forms dV = P^T dO and dK = ds^T Q from them
//   with ldmatrix .trans: no recompute, no atomics, bitwise reproducible;
// * f32 (namespace cc): the same two phases on the CUDA cores, a warp per
//   row and a lane per key or channel.
//
// Takes hd = 32 and n <= 64 (window <= 8), any heads and nW, f32 and bf16.
// C interface (loaded with ctypes): each entry point returns the CUDA error
// code of its launch (cudaGetLastError), 0 on success, -1 for an
// unsupported dtype, head dim or window size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// qkv (B, nW, n, 3C), bias (heads, n, n) f32, mask (nW, n, n) f32 ->
// out (B, nW, n, C). dtype: 0 = float32, 1 = bfloat16.
int apvt_win_attn_fwd(const void* qkv, const void* bias, const void* mask, void* out, int B,
                      int nw, int n, int heads, int hd, int dtype, float scale, void* stream) {
  if (!supported(n, hd, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = B * nw * heads;
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch(cc::win_fwd, grid, cc::fwd_smem(n), s, static_cast<const float*>(qkv), b, m,
                  static_cast<float*>(out), n, nw, heads, scale);
  return launch(tc::win_fwd, grid, tc::fwd_smem(n), s, static_cast<const tc::bf16*>(qkv), b, m,
                static_cast<tc::bf16*>(out), n, nw, heads, scale);
}

// ... and the cotangent dout (B, nW, n, C) -> dqkv (B, nW, n, 3C).
int apvt_win_attn_bwd(const void* qkv, const void* bias, const void* mask, const void* dout,
                      void* dqkv, int B, int nw, int n, int heads, int hd, int dtype,
                      float scale, void* stream) {
  if (!supported(n, hd, dtype)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = B * nw * heads;
  const auto* b = static_cast<const float*>(bias);
  const auto* m = static_cast<const float*>(mask);
  if (dtype == 0)
    return launch(cc::win_bwd, grid, cc::bwd_smem(n), s, static_cast<const float*>(qkv), b, m,
                  static_cast<const float*>(dout), static_cast<float*>(dqkv), n, nw, heads,
                  scale);
  return launch(tc::win_bwd, grid, tc::bwd_smem(n), s, static_cast<const tc::bf16*>(qkv), b, m,
                static_cast<const tc::bf16*>(dout), static_cast<tc::bf16*>(dqkv), n, nw,
                heads, scale);
}

const char* apvt_win_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
