// Warp-level building blocks shared by the kernels of this directory that
// run their products on mma.sync m16n8k16 (bf16 in, f32 out) with ldmatrix
// operands: fragment addressing into padded shared-memory tiles, cp.async
// copies, bf16 packing, and the f32 LayerNorm over token rows (forward and
// input gradient), a warp per row. Header only; every function is a template
// or forced inline, and each .cu file is its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace apvt {

using bf16 = __nv_bfloat16;

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

// One LayerNorm output in f32, rounded where the plain version rounds it:
// (x - mean) * rstd, times the scale, plus the bias, each step on its own.
// Contracted into one FMA, the last two steps put about three times as many
// values on the other side of a bf16 rounding boundary from the plain
// version's, and one such value moves every output of its row.
__device__ __forceinline__ float ln_affine(float xc, float rstd, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(xc, rstd), scale), bias);
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

// One row's 16-byte vectors are spread over the lanes: vector lane + 32 p.
template <int D>
struct RowVecs {
  static constexpr int V = D / 8;
  static constexpr int PER = (V + 31) / 32;
};

// Rows [row0, row0 + RB) of x (T, D), normalised in f32 (two-pass mean/var),
// times scale plus bias, rounded to bf16 into Xn (row stride LDX; rows >= T:
// zeros). A warp per row, WARPS warps in the block.
template <int D, int RB, int LDX, int WARPS>
__device__ void ln_rows(bf16* Xn, const bf16* __restrict__ x, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, int row0, int T, float eps) {
  using R = RowVecs<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < RB; r += WARPS) {
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
          o.x = pack(ln_affine(v[p][0], rstd, s0.x, t0.x),
                     ln_affine(v[p][1], rstd, s0.y, t0.y));
          o.y = pack(ln_affine(v[p][2], rstd, s0.z, t0.z),
                     ln_affine(v[p][3], rstd, s0.w, t0.w));
          o.z = pack(ln_affine(v[p][4], rstd, s1.x, t1.x),
                     ln_affine(v[p][5], rstd, s1.y, t1.y));
          o.w = pack(ln_affine(v[p][6], rstd, s1.z, t1.z),
                     ln_affine(v[p][7], rstd, s1.w, t1.w));
        }
        *reinterpret_cast<uint4*>(Xn + r * LDX + vec * 8) = o;
      }
    }
  }
}

// The LayerNorm backward over the f32 tile dh (RB rows, row stride LDX
// floats): a warp per row, mean and rstd recomputed from x; dx rounded once.
template <int D, int RB, int LDX, int WARPS>
__device__ void ln_bwd_rows(const float* dh, const bf16* __restrict__ x,
                            const float* __restrict__ ln_s, bf16* __restrict__ dx, int row0,
                            int T, float eps) {
  using R = RowVecs<D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < RB; r += WARPS) {
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
        const float4 d0 = *reinterpret_cast<const float4*>(dh + r * LDX + vec * 8);
        const float4 d1 = *reinterpret_cast<const float4*>(dh + r * LDX + vec * 8 + 4);
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

}  // namespace apvt
