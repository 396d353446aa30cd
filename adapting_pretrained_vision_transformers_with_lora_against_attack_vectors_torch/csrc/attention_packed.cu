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
// Four variants, chosen by an explicit test of (dtype, N, hd) in fwd_any /
// bwd_any below, the direction deciding for bf16 with hd = 64
// (kernels/attention.py:kernel_variant is the same test; no flag chooses):
// * "wgmma": the forward of bf16, hd = 64, N <= 256, the ViT-B path. The
//   Hopper core of attn_wgmma.cuh: wgmma.mma_async from TMA-loaded,
//   128-byte-swizzled tiles behind mbarriers, the 64 x N scores of a
//   warpgroup in its accumulators; it also writes the row log-sum-exp that
//   the backward reads. Its whole-head backward (one CTA of two warpgroups a
//   head, every tile of the head in shared memory: one CTA an SM at N = 197)
//   stays for timing only, behind apvt_attn_wg_bwd;
// * "wgmma_stream": the backward of bf16, hd = 64 at every N, and the
//   forward past N = 256 (ViT-B/16 at 384 px: N = 577). attn_stream.cuh:
//   the same tile format, products and backward device functions, with a
//   CTA's own rows held and the other side streamed in 64-row blocks through
//   a TMA ring, so that shared memory does not depend on N; a forward of two
//   passes over the keys (statistics, then P normalised and rounded before
//   P V: three products), a backward of dK/dV and dQ CTA roles of one
//   warpgroup (three CTAs an SM) in one launch after a pre-pass that writes
//   lse2 and D. At (64, 197, 12, 64) the backward's bound is 0.0405 ms
//   (bytes), at (8, 577, 12, 64) 0.0085 ms forward (bytes) and 0.0207 ms
//   backward (tensor-core operations); PERF.md section 6 has where it stands;
// * "mma_sync": bf16, hd = 32, N <= 256 (no model of the package has this
//   shape; a 64-byte row would need the 64-byte swizzle and its own tile
//   format). namespace tc below: the core of attn_core.cuh, which
//   attn_block.cu also uses: a warp owns 16 rows with their whole score row
//   in registers, mma.sync m16n8k16 with ldmatrix operands;
// * "cuda_core": f32 at every N, and bf16 with hd = 32 past N = 256 (no model
//   has that shape either; namespace cc below; apvt_attn_cc_bf16_fwd / _bwd
//   still launch its bf16 hd-64 code, for timing the route "wgmma_stream"
//   replaced). Exact f32 arithmetic on the CUDA cores, as the f32 reference
//   computes.
//   What bounds it: the f32 FMA rate. At the parity shape (B=24, N=197,
//   H=12, hd=64, f32) the forward's two products need 0.0427 ms at 67
//   TFLOP/s and the backward's five 0.1068 ms, against 0.0062 / 0.0109 ms
//   of bytes. So the design keeps the FMA pipes fed and holds no part of a
//   head's length on chip:
//   - a CTA owns a block of rows of one (batch, head) (64 query rows in the
//     forward, 8 warps, two CTAs an SM; in the backward 128 key rows for dK
//     and dV or 128 query rows for dQ, 8 warps) and streams the other side
//     in 64-row blocks through a two-stage cp.async ring, so shared memory
//     does not depend on N (any N >= 1);
//   - every product is register-tiled as an SGEMM: a thread owns TR rows
//     (g, g + 2, ...; TR = 4 in the forward, 8 in the backward, a warp 2 TR)
//     by 4 score columns (c, c + 16, c + 32, c + 48) or by hd / 16 adjacent
//     output columns, and reads float4 rows of both operands from padded f32
//     tiles: TR + 4 shared loads for 16 TR FMAs, no bank conflict beyond the
//     minimum wavefronts;
//   - the forward keeps a running (max, sum) a row (online softmax) in f32;
//     in bf16 it takes two passes over the keys (statistics, then P), so
//     that P is rounded to bf16 after its normalisation, as the Pallas
//     kernel rounds it. It writes O and the row log-sum-exp;
//   - the backward runs from the saved log-sum-exp and D = rowsum(dO * O)
//     in one launch of two CTA roles with one owner a sum: dK, dV (a CTA
//     walks the query blocks in order) and dQ (a CTA walks the key blocks
//     in order); each role recomputes S and dP and computes D, seven
//     products against the bound's five, and the roles share the last wave;
//   - the softmax and the P / dS arithmetic are straight-line code over a
//     thread's 8 rows, so that their shuffles and exponentials overlap;
//   - the last block's keys past N are masked (P = 0) and skipped in 16-key
//     steps; a warp whose rows all lie past N does no products.
// All four: the backward in two phases or two CTA roles, query-row owners
// for dQ, key-row owners for dK and dV, every sum with one owner and a fixed
// order: no atomics, bitwise reproducible; keys >= N get P = 0, rows >= N
// are never written. The forward writes the row log-sum-exp (B, H, N) f32;
// the backward reads it and the forward's output in the "wgmma_stream" and
// "cuda_core" variants, the "mma_sync" variant ignores those pointers.
//
// C interface (loaded with ctypes): each entry point returns the CUDA error
// code of its launch (cudaGetLastError), 0 on success, -1 for an
// unsupported dtype or head dim, -2 if a tensor map could not be encoded, -3
// if the "wgmma_stream" backward was given no scratch (work null).

#include "attn_core.cuh"
#include "attn_stream.cuh"

namespace {

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

// Where head h of batch element b starts, and the distance between its rows,
// in elements: packed (B, N, H*hd) is {N*H*hd, hd, H*hd}, head-major
// (B, H, N, hd) is {H*N*hd, N*hd, hd}.
struct Layout {
  long long batch, head;
  int row;
};

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// "cuda_core" variant: f32, and bf16 hd 32 with N > 256 (the note at the top
// says what bounds it). Thread (warp w, lane 16 g + c) owns rows 2 TR w + g + 2 m
// (m < TR) of its CTA's block, score columns c + 16 j (j < 4) of a streamed
// block and output columns E c + e (e < E = hd / 16). Shared tiles hold f32
// (bf16 operands are widened as they land).

namespace cc {

constexpr int kBlock = 64;                 // rows of a streamed block
// Rows a thread owns (a warp owns twice as many): the forward's 4 keep it under
// 128 registers, so that two CTAs of 8 warps fit an SM; the backward's two
// score tiles and two accumulators need 8 (254 registers, 8 warps an SM).
constexpr int kFwdTR = 4, kBwdTR = 8;
constexpr int kFwdRows = 64;               // forward CTA: 64 query rows, two CTAs an SM
constexpr int kBwdRows = 128;              // backward CTAs: 128 own rows
constexpr int kFwdWarps = kFwdRows / (2 * kFwdTR), kBwdWarps = kBwdRows / (2 * kBwdTR);
constexpr int kXStride = kBlock + 16;      // a P / dS row: rows g = 0, 1 sit 16 banks apart

// f32 tile row: hd values and 4 of padding, so that rows r and r + 1 start 4
// banks apart and every row stays 16-byte aligned.
template <int HD>
__host__ __device__ constexpr int stride() {
  return HD + 4;
}

template <int HD>
constexpr size_t fwd_smem() {  // Q; two stages of K, V; P
  return sizeof(float) * ((size_t)(kFwdRows + 4 * kBlock) * stride<HD>() +
                          (size_t)kFwdRows * kXStride);
}

// The backward: the larger of its two roles' (dQ: Q, dO; two stages of K, V;
// dS; lse and D of the rows. dK, dV: K, V; two stages of Q, dO, O; P then dS;
// two stages of lse; D)
template <int HD>
constexpr size_t bwd_smem() {
  const size_t dq = (size_t)(2 * kBwdRows + 4 * kBlock) * stride<HD>() +
                    (size_t)kBwdRows * kXStride + 2 * kBwdRows;
  const size_t dkdv = (size_t)(2 * kBwdRows + 6 * kBlock) * stride<HD>() +
                      (size_t)kBwdRows * kXStride + 3 * kBlock;
  return sizeof(float) * (dq > dkdv ? dq : dkdv);
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(apvt::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// Rows [r0, r0 + ROWS) of a head (row stride rs elements) into an f32 tile;
// rows >= N become zeros. f32 by cp.async (the caller commits the group),
// bf16 through registers.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int r0, int N,
                                          int rs) {
  constexpr int S = stride<HD>(), Q = HD / 4;
  for (int idx = threadIdx.x; idx < ROWS * Q; idx += blockDim.x) {
    const int r = idx / Q, d = (idx % Q) * 4, row = r0 + r;
    const bool valid = row < N;
    float* to = dst + r * S + d;
    if constexpr (sizeof(T) == 4) {
      const float* from = reinterpret_cast<const float*>(src);
      cp16(to, valid ? from + (size_t)row * rs + d : from, valid);
    } else {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) {
        const uint2 raw = *reinterpret_cast<const uint2*>(src + (size_t)row * rs + d);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        f = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      *reinterpret_cast<float4*>(to) = f;
    }
  }
}

// s[m][j] = sum over d (ascending) of A[2 m][d] * B[16 j][d] for j < JN, 0 for
// the other column groups. A points at the thread's first own row, B at its
// first column's row of the streamed block. Both passes of every kernel use
// it, so a recomputed score equals the forward's bit for bit (fmaf is
// symmetric in its factors).
template <int HD, int JN, int TR>
__device__ __forceinline__ void dot_nt(float (&s)[TR][4], const float* A, const float* B) {
  constexpr int S = stride<HD>();
#pragma unroll
  for (int m = 0; m < TR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[m][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[TR], b[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j) b[j] = *reinterpret_cast<const float4*>(B + 16 * j * S + d);
#pragma unroll
    for (int m = 0; m < TR; ++m) a[m] = *reinterpret_cast<const float4*>(A + 2 * m * S + d);
#pragma unroll
    for (int m = 0; m < TR; ++m)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        s[m][j] = fmaf(a[m].x, b[j].x, s[m][j]);
        s[m][j] = fmaf(a[m].y, b[j].y, s[m][j]);
        s[m][j] = fmaf(a[m].z, b[j].z, s[m][j]);
        s[m][j] = fmaf(a[m].w, b[j].w, s[m][j]);
      }
  }
}

// ... over the jn (block-uniform) column groups that hold a key below N.
template <int HD, int TR>
__device__ __forceinline__ void dot_nt(float (&s)[TR][4], const float* A, const float* B, int jn) {
  switch (jn) {
    case 1: dot_nt<HD, 1>(s, A, B); break;
    case 2: dot_nt<HD, 2>(s, A, B); break;
    case 3: dot_nt<HD, 3>(s, A, B); break;
    default: dot_nt<HD, 4>(s, A, B);
  }
}

// o[m][e] += sum over k < kn (ascending) of X[2 m][k] * C[k][e]. X points at
// the thread's first row of its warp's P / dS tile, C at its first output
// column of the streamed block; kn is a multiple of 4 (X and C are zero past
// the block's last valid row, so the sum is that of the valid rows).
template <int HD, int TR>
__device__ __forceinline__ void acc_nn(float (&o)[TR][HD / 16], const float* X, const float* C,
                                       int kn) {
  constexpr int S = stride<HD>(), E = HD / 16;
#pragma unroll 2
  for (int k = 0; k < kn; k += 4) {
    float4 x[TR];
#pragma unroll
    for (int m = 0; m < TR; ++m) x[m] = *reinterpret_cast<const float4*>(X + 2 * m * kXStride + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float cv[E];
      if constexpr (E == 4) {
        const float4 t = *reinterpret_cast<const float4*>(C + (k + kk) * S);
        cv[0] = t.x, cv[1] = t.y, cv[2] = t.z, cv[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(C + (k + kk) * S);
        cv[0] = t.x, cv[1] = t.y;
      }
#pragma unroll
      for (int m = 0; m < TR; ++m) {
        const float xv = kk == 0 ? x[m].x : kk == 1 ? x[m].y : kk == 2 ? x[m].z : x[m].w;
#pragma unroll
        for (int e = 0; e < E; ++e) o[m][e] = fmaf(xv, cv[e], o[m][e]);
      }
    }
  }
}

// max and sum over the 16 lanes (c) that share a row, in a fixed tree, for a
// thread's 8 rows at once (the rows' shuffles overlap)
template <int TR>
__device__ __forceinline__ void row_max(float (&x)[TR]) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int m = 0; m < TR; ++m) x[m] = fmaxf(x[m], __shfl_xor_sync(0xffffffffu, x[m], o));
}

template <int TR>
__device__ __forceinline__ void row_sum(float (&x)[TR]) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
#pragma unroll
    for (int m = 0; m < TR; ++m) x[m] = __fadd_rn(x[m], __shfl_xor_sync(0xffffffffu, x[m], o));
}

// The backward's P from the row's log-sum-exp, and dS = P (dP - D) scale, in
// the plain version's order (no contraction into FMAs): the dQ and the dK/dV
// kernels get the same bits for one (row, key).
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(s, scale), lse));
}

__device__ __forceinline__ float dscore(float p, float dp, float d, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, d)), scale);
}

// D = rowsum(dO * O) of ROWS rows (tiles of stride hd + 4) into Ds, for both
// kernels of the backward: four lanes a row, each over a quarter of hd in
// ascending order, the quarters summed in a fixed tree. 4 ROWS is a multiple
// of the CTA's threads, so that every lane takes part in each shuffle.
template <int HD, int ROWS>
__device__ __forceinline__ void block_delta(float* Ds, const float* dOs, const float* Os) {
  constexpr int S = stride<HD>(), P = HD / 4;
  for (int idx = threadIdx.x; idx < 4 * ROWS; idx += blockDim.x) {
    const int r = idx >> 2, d0 = (idx & 3) * P;
    float acc = 0.f;
#pragma unroll
    for (int d = d0; d < d0 + P; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(dOs + r * S + d);
      const float4 b = *reinterpret_cast<const float4*>(Os + r * S + d);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
    if ((idx & 3) == 0) Ds[r] = acc;
  }
}

template <typename T, int HD, int TR>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, const float (&acc)[TR][HD / 16],
                                           int r0, int N, int rs, int c) {
#pragma unroll
  for (int m = 0; m < TR; ++m) {
    const int row = r0 + 2 * m;
    if (row < N) {
#pragma unroll
      for (int e = 0; e < HD / 16; ++e)
        dst[(size_t)row * rs + HD / 16 * c + e] = Cvt<T>::from_f(acc[m][e]);
    }
  }
}

// The forward on one key block of nk valid keys (Ks: K, then V): the scores
// scaled, keys past nk at -inf; with kStats the running max and sum updated
// (and, one pass, the running output rescaled) and P~ = exp(s - max); without
// it (bf16's second pass) P = exp(s - max) / sum rounded to bf16; with kPV,
// acc += P V. Straight-line code over every column group: the rows' shuffles
// and exponentials overlap.
template <typename T, int HD, bool kStats, bool kPV, int TR>
__device__ __forceinline__ void fwd_block(float (&acc)[TR][HD / 16], float (&mrow)[TR],
                                          float (&lrow)[TR], const float* A, const float* Ks,
                                          float* X, int nk, int c, float scale) {
  constexpr int S = stride<HD>(), E = HD / 16;
  float s[TR][4];
  dot_nt<HD>(s, A, Ks + c * S, (nk + 15) >> 4);
#pragma unroll
  for (int m = 0; m < TR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[m][j] = c + 16 * j < nk ? __fmul_rn(s[m][j], scale) : -INFINITY;
  if constexpr (kStats) {
    float mx[TR], sum[TR];
#pragma unroll
    for (int m = 0; m < TR; ++m) mx[m] = fmaxf(fmaxf(s[m][0], s[m][1]), fmaxf(s[m][2], s[m][3]));
    row_max(mx);
#pragma unroll
    for (int m = 0; m < TR; ++m) {
      mx[m] = fmaxf(mrow[m], mx[m]);
      sum[m] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[m][j] = expf(__fsub_rn(s[m][j], mx[m]));
        sum[m] = __fadd_rn(sum[m], s[m][j]);
      }
    }
    row_sum(sum);
#pragma unroll
    for (int m = 0; m < TR; ++m) {
      const float alpha = expf(__fsub_rn(mrow[m], mx[m]));
      lrow[m] = __fadd_rn(__fmul_rn(lrow[m], alpha), sum[m]);
      mrow[m] = mx[m];
      if constexpr (kPV) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[m][e] = __fmul_rn(acc[m][e], alpha);
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < TR; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[m][j] = round_to<T>(__fdiv_rn(expf(__fsub_rn(s[m][j], mrow[m])), lrow[m]));
  }
  if constexpr (kPV) {
#pragma unroll
    for (int m = 0; m < TR; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) X[2 * m * kXStride + c + 16 * j] = s[m][j];
    __syncwarp();
    acc_nn<HD>(acc, X, Ks + kBlock * S + E * c, (nk + 3) & ~3);
    __syncwarp();
  }
}

// Forward: grid (ceil(N / 64), H, B), kFwdWarps warps.
template <typename T, int HD>
__global__ void __launch_bounds__(kFwdWarps * 32, 2)
fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, int N, int H, Layout lay, float scale) {
  constexpr int S = stride<HD>(), E = HD / 16;
  constexpr bool kTwoPass = sizeof(T) == 2;  // P rounds to bf16 after its normalisation
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* KV = Qs + kFwdRows * S;  // stage t: K at KV + 2 t * 64 S, V after it
  float* Xs = KV + 4 * kBlock * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 15;
  const int wr = warp * 2 * kFwdTR + (lane >> 4);  // the thread's first row in the block
  const size_t base = (size_t)blockIdx.z * lay.batch + (size_t)blockIdx.y * lay.head;
  const int rs = lay.row, i0 = blockIdx.x * kFwdRows;
  const bool active = i0 + warp * 2 * kFwdTR < N;
  const int nblk = (N + kBlock - 1) / kBlock, total = (kTwoPass ? 2 : 1) * nblk;

  load_rows<T, HD, kFwdRows>(Qs, q + base, i0, N, rs);
  load_rows<T, HD, kBlock>(KV, k + base, 0, N, rs);
  load_rows<T, HD, kBlock>(KV + kBlock * S, v + base, 0, N, rs);
  apvt::cp_commit();

  float mrow[kFwdTR], lrow[kFwdTR], acc[kFwdTR][E];
#pragma unroll
  for (int m = 0; m < kFwdTR; ++m) {
    mrow[m] = -INFINITY, lrow[m] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[m][e] = 0.f;
  }
  const float* A = Qs + wr * S;
  float* X = Xs + wr * kXStride;
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      const int next = (it + 1) % nblk;
      float* to = KV + ((it + 1) & 1) * 2 * kBlock * S;
      load_rows<T, HD, kBlock>(to, k + base, next * kBlock, N, rs);
      load_rows<T, HD, kBlock>(to + kBlock * S, v + base, next * kBlock, N, rs);
    }
    apvt::cp_commit();
    apvt::cp_wait<1>();
    __syncthreads();
    if (active) {
      const float* Ks = KV + (it & 1) * 2 * kBlock * S;
      const int nk = min(kBlock, N - (it % nblk) * kBlock);
      if constexpr (!kTwoPass)
        fwd_block<T, HD, true, true>(acc, mrow, lrow, A, Ks, X, nk, c, scale);
      else if (it < nblk)  // the first pass: statistics only
        fwd_block<T, HD, true, false>(acc, mrow, lrow, A, Ks, X, nk, c, scale);
      else
        fwd_block<T, HD, false, true>(acc, mrow, lrow, A, Ks, X, nk, c, scale);
    }
    __syncthreads();  // the stage is refilled next
  }
  if (active) {
    float* lrow_out = lse + ((size_t)blockIdx.z * H + blockIdx.y) * N;
#pragma unroll
    for (int m = 0; m < kFwdTR; ++m) {
      const int row = i0 + wr + 2 * m;
      if (!kTwoPass) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[m][e] = __fdiv_rn(acc[m][e], lrow[m]);
      }
      if (row < N && c == 0) lrow_out[row] = __fadd_rn(mrow[m], logf(lrow[m]));
    }
    store_rows<T, HD>(o + base, acc, i0 + wr, N, rs, c);
  }
}

// The backward's dQ role: a CTA owns query rows [128 blk, 128 blk + 128) and
// walks the key blocks in order; D of its rows from its dO rows and the
// forward's output.
template <typename T, int HD>
__device__ __forceinline__ void bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, const T* __restrict__ dout,
                                       const T* __restrict__ out, const float* __restrict__ lse,
                                       T* __restrict__ dq, int N, int H, Layout lay, float scale,
                                       int blk) {
  constexpr int S = stride<HD>(), E = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kBwdRows * S;
  float* KV = dOs + kBwdRows * S;  // stage t: K at KV + 2 t * 64 S, V after it
  float* Xs = KV + 4 * kBlock * S;
  float* Ls = Xs + kBwdRows * kXStride;
  float* Ds = Ls + kBwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 15;
  const int wr = warp * 2 * kBwdTR + (lane >> 4);
  const size_t base = (size_t)blockIdx.z * lay.batch + (size_t)blockIdx.y * lay.head;
  const float* lse_bh = lse + ((size_t)blockIdx.z * H + blockIdx.y) * N;
  const int rs = lay.row, i0 = blk * kBwdRows;
  const bool active = i0 + warp * 2 * kBwdTR < N;
  const int nblk = (N + kBlock - 1) / kBlock;

  load_rows<T, HD, kBwdRows>(Qs, q + base, i0, N, rs);
  load_rows<T, HD, kBwdRows>(dOs, dout + base, i0, N, rs);
  apvt::cp_commit();
  load_rows<T, HD, kBlock>(KV, k + base, 0, N, rs);
  load_rows<T, HD, kBlock>(KV + kBlock * S, v + base, 0, N, rs);
  apvt::cp_commit();
  // the forward's output lands where dS goes, for D; rows past N get an
  // infinite log-sum-exp (P = 0)
  load_rows<T, HD, kBwdRows>(Xs, out + base, i0, N, rs);
  apvt::cp_commit();
  for (int r = threadIdx.x; r < kBwdRows; r += blockDim.x)
    Ls[r] = i0 + r < N ? lse_bh[i0 + r] : INFINITY;
  apvt::cp_wait<0>();
  __syncthreads();
  block_delta<HD, kBwdRows>(Ds, dOs, Xs);
  __syncthreads();

  float L[kBwdTR], D[kBwdTR], acc[kBwdTR][E];
#pragma unroll
  for (int m = 0; m < kBwdTR; ++m) {
    L[m] = Ls[wr + 2 * m], D[m] = Ds[wr + 2 * m];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[m][e] = 0.f;
  }
  float* X = Xs + wr * kXStride;
  for (int it = 0; it < nblk; ++it) {
    if (it + 1 < nblk) {
      float* to = KV + ((it + 1) & 1) * 2 * kBlock * S;
      load_rows<T, HD, kBlock>(to, k + base, (it + 1) * kBlock, N, rs);
      load_rows<T, HD, kBlock>(to + kBlock * S, v + base, (it + 1) * kBlock, N, rs);
    }
    apvt::cp_commit();
    apvt::cp_wait<1>();
    __syncthreads();
    if (active) {
      const float* Ks = KV + (it & 1) * 2 * kBlock * S;
      const int nk = min(kBlock, N - it * kBlock), jn = (nk + 15) >> 4;
      float s[kBwdTR][4], dp[kBwdTR][4];
      dot_nt<HD>(s, Qs + wr * S, Ks + c * S, jn);
      dot_nt<HD>(dp, dOs + wr * S, Ks + kBlock * S + c * S, jn);
#pragma unroll
      for (int m = 0; m < kBwdTR; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = c + 16 * j < nk ? prob(s[m][j], scale, L[m]) : 0.f;
          X[2 * m * kXStride + c + 16 * j] = round_to<T>(dscore(p, dp[m][j], D[m], scale));
        }
      __syncwarp();
      acc_nn<HD>(acc, X, Ks + E * c, (nk + 3) & ~3);
      __syncwarp();
    }
    __syncthreads();
  }
  if (active) store_rows<T, HD>(dq + base, acc, i0 + wr, N, rs, c);
}

// The backward's dK, dV role: a CTA owns key rows [128 blk, 128 blk + 128)
// and walks the query blocks in order; D of each query block from its dO and
// O rows, as the dQ role computes it (the same bits).
template <typename T, int HD>
__device__ __forceinline__ void bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         const T* __restrict__ out,
                                         const float* __restrict__ lse, T* __restrict__ dk,
                                         T* __restrict__ dv, int N, int H, Layout lay,
                                         float scale, int blk) {
  constexpr int S = stride<HD>(), E = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kBwdRows * S;
  float* QD = Vs + kBwdRows * S;  // stage t: Q at QD + 3 t * 64 S, then dO, then O
  float* Xs = QD + 6 * kBlock * S;
  float* Ls = Xs + kBwdRows * kXStride;  // stage t: lse at Ls + 64 t
  float* Dq = Ls + 2 * kBlock;           // D of the block in use
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 15;
  const int wr = warp * 2 * kBwdTR + (lane >> 4);
  const size_t base = (size_t)blockIdx.z * lay.batch + (size_t)blockIdx.y * lay.head;
  const float* lse_bh = lse + ((size_t)blockIdx.z * H + blockIdx.y) * N;
  const int rs = lay.row, j0 = blk * kBwdRows;
  const bool active = j0 + warp * 2 * kBwdTR < N;
  const int nblk = (N + kBlock - 1) / kBlock;

  load_rows<T, HD, kBwdRows>(Ks, k + base, j0, N, rs);
  load_rows<T, HD, kBwdRows>(Vs, v + base, j0, N, rs);
  apvt::cp_commit();
  load_rows<T, HD, kBlock>(QD, q + base, 0, N, rs);
  load_rows<T, HD, kBlock>(QD + kBlock * S, dout + base, 0, N, rs);
  load_rows<T, HD, kBlock>(QD + 2 * kBlock * S, out + base, 0, N, rs);
  for (int r = threadIdx.x; r < kBlock; r += blockDim.x) Ls[r] = r < N ? lse_bh[r] : INFINITY;
  apvt::cp_commit();

  float dk_acc[kBwdTR][E], dv_acc[kBwdTR][E];
#pragma unroll
  for (int m = 0; m < kBwdTR; ++m)
#pragma unroll
    for (int e = 0; e < E; ++e) dk_acc[m][e] = dv_acc[m][e] = 0.f;
  float* X = Xs + wr * kXStride;
  for (int it = 0; it < nblk; ++it) {
    if (it + 1 < nblk) {
      const int i1 = (it + 1) * kBlock;
      float* to = QD + ((it + 1) & 1) * 3 * kBlock * S;
      load_rows<T, HD, kBlock>(to, q + base, i1, N, rs);
      load_rows<T, HD, kBlock>(to + kBlock * S, dout + base, i1, N, rs);
      load_rows<T, HD, kBlock>(to + 2 * kBlock * S, out + base, i1, N, rs);
      float* lt = Ls + ((it + 1) & 1) * kBlock;
      for (int r = threadIdx.x; r < kBlock; r += blockDim.x)
        lt[r] = i1 + r < N ? lse_bh[i1 + r] : INFINITY;
    }
    apvt::cp_commit();
    apvt::cp_wait<1>();
    __syncthreads();
    const float* Qb = QD + (it & 1) * 3 * kBlock * S;
    const float* dOb = Qb + kBlock * S;
    block_delta<HD, kBlock>(Dq, dOb, dOb + kBlock * S);
    __syncthreads();
    if (active) {
      const float* Lb = Ls + (it & 1) * kBlock;
      const int nq = min(kBlock, N - it * kBlock), jn = (nq + 15) >> 4;
      float lq[4], dq_row[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) lq[j] = Lb[c + 16 * j], dq_row[j] = Dq[c + 16 * j];
      float st[kBwdTR][4], dpt[kBwdTR][4];
      dot_nt<HD>(st, Ks + wr * S, Qb + c * S, jn);
      dot_nt<HD>(dpt, Vs + wr * S, dOb + c * S, jn);
#pragma unroll
      for (int m = 0; m < kBwdTR; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = c + 16 * j < nq ? prob(st[m][j], scale, lq[j]) : 0.f;
          dpt[m][j] = round_to<T>(dscore(p, dpt[m][j], dq_row[j], scale));
          X[2 * m * kXStride + c + 16 * j] = round_to<T>(p);
        }
      __syncwarp();
      acc_nn<HD>(dv_acc, X, dOb + E * c, (nq + 3) & ~3);
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kBwdTR; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) X[2 * m * kXStride + c + 16 * j] = dpt[m][j];
      __syncwarp();
      acc_nn<HD>(dk_acc, X, Qb + E * c, (nq + 3) & ~3);
      __syncwarp();
    }
    __syncthreads();
  }
  if (active) {
    store_rows<T, HD>(dk + base, dk_acc, j0 + wr, N, rs, c);
    store_rows<T, HD>(dv + base, dv_acc, j0 + wr, N, rs, c);
  }
}

// Backward: grid (2 ceil(N / 128), H, B), kBwdWarps warps. The first
// ceil(N / 128) CTAs of a (batch, head) take the dK, dV role (four products,
// the longer), the others the dQ role. The roles share no sum (each computes
// D), so one launch runs them side by side and they share the card's last
// wave.
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
bwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const T* __restrict__ out, const float* __restrict__ lse,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int N, int H, Layout lay,
    float scale) {
  const int nrb = (N + kBwdRows - 1) / kBwdRows;
  if ((int)blockIdx.x < nrb)
    bwd_dkdv<T, HD>(q, k, v, dout, out, lse, dk, dv, N, H, lay, scale, blockIdx.x);
  else
    bwd_dq<T, HD>(q, k, v, dout, out, lse, dq, N, H, lay, scale, blockIdx.x - nrb);
}

}  // namespace cc

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int N,
               int H, Layout lay, float scale, cudaStream_t stream) {
  const dim3 grid((N + cc::kFwdRows - 1) / cc::kFwdRows, H, B);
  return launch(cc::fwd<T, HD>, grid, cc::kFwdWarps * 32, cc::fwd_smem<HD>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), N, H, lay, scale);
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* o,
               const void* lse, void* dq, void* dk, void* dv, int B, int N, int H, Layout lay,
               float scale, cudaStream_t stream) {
  const dim3 grid(2 * ((N + cc::kBwdRows - 1) / cc::kBwdRows), H, B);
  return launch(cc::bwd<T, HD>, grid, cc::kBwdWarps * 32, cc::bwd_smem<HD>(), stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const T*>(o),
                static_cast<const float*>(lse), static_cast<T*>(dq), static_cast<T*>(dk),
                static_cast<T*>(dv), N, H, lay, scale);
}

}  // namespace

extern "C" {

// The "cuda_core" launchers' plan at head dim hd (32 or 64): out[0..5] = rows
// a CTA owns, threads a CTA, dynamic shared memory in bytes, for the forward
// and the backward kernel (the same at every N and dtype). Returns -1 for
// another head dim.
int apvt_attn_cc_plan(int hd, int* out) {
  if (hd != 32 && hd != 64) return -1;
  const size_t smem[2] = {hd == 32 ? cc::fwd_smem<32>() : cc::fwd_smem<64>(),
                          hd == 32 ? cc::bwd_smem<32>() : cc::bwd_smem<64>()};
  const int rows[2] = {cc::kFwdRows, cc::kBwdRows};
  const int warps[2] = {cc::kFwdWarps, cc::kBwdWarps};
  for (int i = 0; i < 2; ++i) {
    out[3 * i] = rows[i];
    out[3 * i + 1] = warps[i] * 32;
    out[3 * i + 2] = (int)smem[i];
  }
  return 0;
}

}  // extern "C"

namespace {

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
  if (dtype == 1 && hd == 64)
    return apvt::wgs::launch_fwd(q, k, v, o, static_cast<float*>(lse), B, N, H, layout, scale, s);
  if (dtype == 0 && hd == 32)
    return launch_fwd<float, 32>(q, k, v, o, lse, B, N, H, lay, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_fwd<float, 64>(q, k, v, o, lse, B, N, H, lay, scale, s);
  if (dtype == 1 && N <= kTcMaxN && hd == 32)
    return launch_fwd_tc<32>(q, k, v, o, B, N, H, lay, scale, s);
  if (dtype == 1 && hd == 32)
    return launch_fwd<__nv_bfloat16, 32>(q, k, v, o, lse, B, N, H, lay, scale, s);
  return -1;
}

int bwd_any(const void* q, const void* k, const void* v, const void* dout, const void* o,
            const void* lse, void* work, void* dq, void* dk, void* dv, int B, int N, int H,
            int hd, int dtype, int layout, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lay = layout_of(layout, N, H, hd);
  if (dtype == 1 && hd == 64)
    return apvt::wgs::launch_bwd(q, k, v, dout, o, static_cast<const float*>(lse),
                                 static_cast<float*>(work), dq, dk, dv, B, N, H, layout, scale, s);
  if (dtype == 0 && hd == 32)
    return launch_bwd<float, 32>(q, k, v, dout, o, lse, dq, dk, dv, B, N, H, lay, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_bwd<float, 64>(q, k, v, dout, o, lse, dq, dk, dv, B, N, H, lay, scale, s);
  if (dtype == 1 && N <= kTcMaxN && hd == 32)
    return launch_bwd_tc<32>(q, k, v, dout, dq, dk, dv, B, N, H, lay, scale, s);
  if (dtype == 1 && hd == 32)
    return launch_bwd<__nv_bfloat16, 32>(q, k, v, dout, o, lse, dq, dk, dv, B, N, H, lay,
                                         scale, s);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. hd: 32 or 64. Operands (B, N, H*hd); lse
// (B, H, N) f32, written by the forward and read (with o) by the backward in
// every variant but "mma_sync". work: the "wgmma_stream" backward's scratch
// (bf16 with hd 64 at every N), B H ceil(N / 64) 128 f32 (unread by the
// other variants; may be null for them).
int apvt_attn_packed_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int N, int H, int hd, int dtype, float scale, void* stream) {
  return fwd_any(q, k, v, o, lse, B, N, H, hd, dtype, 0, scale, stream);
}

int apvt_attn_packed_bwd(const void* q, const void* k, const void* v, const void* dout,
                         const void* o, const void* lse, void* work, void* dq, void* dk, void* dv,
                         int B, int N, int H, int hd, int dtype, float scale, void* stream) {
  return bwd_any(q, k, v, dout, o, lse, work, dq, dk, dv, B, N, H, hd, dtype, 0, scale, stream);
}

// The same over head-major operands (B, H, N, hd).
int apvt_attn_bhnd_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int N, int H, int hd, int dtype, float scale, void* stream) {
  return fwd_any(q, k, v, o, lse, B, N, H, hd, dtype, 1, scale, stream);
}

int apvt_attn_bhnd_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* o, const void* lse, void* work, void* dq, void* dk, void* dv,
                       int B, int N, int H, int hd, int dtype, float scale, void* stream) {
  return bwd_any(q, k, v, dout, o, lse, work, dq, dk, dv, B, N, H, hd, dtype, 1, scale, stream);
}

// The "wgmma_stream" launchers' plan: out[0..4] = rows a CTA owns, warpgroups
// a CTA, threads a CTA, ring stages and dynamic shared memory in bytes of the
// forward kernel (N > 256), out[5..9] the same of the backward kernel (every
// N); the same at every N.
int apvt_attn_stream_plan(int* out) {
  using namespace apvt::wgs;
  const int groups[2] = {kFwdWarpgroups, kBwdWarpgroups}, stages[2] = {kFwdStages, kBwdStages};
  const size_t smem[2] = {fwd_smem(), bwd_smem()};
  for (int i = 0; i < 2; ++i) {
    out[5 * i] = kBlock * groups[i];
    out[5 * i + 1] = groups[i];
    out[5 * i + 2] = 128 * groups[i];
    out[5 * i + 3] = stages[i];
    out[5 * i + 4] = (int)smem[i];
  }
  return 0;
}

// For timing only, reachable from no model path: the "cuda_core" device code
// on packed bf16 operands with hd = 64 at any N (the code the "wgmma_stream"
// variant replaced past N = 256). No counter moves.
int apvt_attn_cc_bf16_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                          int N, int H, float scale, void* stream) {
  return launch_fwd<__nv_bfloat16, 64>(q, k, v, o, lse, B, N, H, layout_of(0, N, H, 64), scale,
                                       static_cast<cudaStream_t>(stream));
}

int apvt_attn_cc_bf16_bwd(const void* q, const void* k, const void* v, const void* dout,
                          const void* o, const void* lse, void* dq, void* dk, void* dv, int B,
                          int N, int H, float scale, void* stream) {
  return launch_bwd<__nv_bfloat16, 64>(q, k, v, dout, o, lse, dq, dk, dv, B, N, H,
                                       layout_of(0, N, H, 64), scale,
                                       static_cast<cudaStream_t>(stream));
}

// For timing only, reachable from no model path: the whole-head backward of
// attn_wgmma.cuh (bf16, hd = 64, N <= 256; layout 0 packed, 1 head-major), the
// code the "wgmma_stream" backward replaced there. No counter moves.
int apvt_attn_wg_bwd(const void* q, const void* k, const void* v, const void* dout,
                     const void* o, const void* lse, void* dq, void* dk, void* dv, int B, int N,
                     int H, int layout, float scale, void* stream) {
  if (N < 1 || N > apvt::wg::kMaxN) return -1;
  return apvt::wg::launch_bwd(q, k, v, dout, o, static_cast<const float*>(lse), dq, dk, dv, B, N,
                              H, layout, scale, static_cast<cudaStream_t>(stream));
}

const char* apvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
