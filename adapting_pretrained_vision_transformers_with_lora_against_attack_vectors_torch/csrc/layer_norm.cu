// LayerNorm over the last dimension of a row-major bf16 tensor, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package the LayerNorm (ops/nn.py:
// layer_norm) is an XLA composition, which XLA fuses into one pass each way.
// The port's composition of the same function in PyTorch (widen x to f32,
// F.layer_norm in f32, round the result) runs three kernels each way: a
// widening copy, the f32 LayerNorm and a rounding copy, 44 bytes of device
// traffic per element for a forward and its backward where the mathematics
// needs 10.
//
// Numerics. Forward: the row's mean, then the mean of its squared deviations
// from that mean, in f32 over the row held in registers; rstd = rsqrtf(var +
// eps); y = fmaf(gamma, rstd * (x - mean), beta) in f32 (the expression of
// F.layer_norm's CUDA kernel), rounded to bf16 once. gamma and beta are read
// in their stored dtype (bf16 or f32) and widened in registers. The row's
// mean and rstd are written, f32, for the backward. Backward, with the saved
// mean and rstd: x_hat = (x - mean) * rstd, g = dy * gamma, dx = rstd * (g -
// mean(g) - x_hat * mean(g * x_hat)) in f32, rounded once. With `partials`,
// each CTA also sums dy * x_hat and dy over its rows into one f32 partial row
// (dgamma's C values, then dbeta's), its row groups combined in a fixed order;
// layer_norm_param_grads sums the partial rows in a fixed order and writes
// dgamma and dbeta in the parameters' dtype. No atomics: a run repeats bit
// for bit, replayed in a CUDA graph too.
//
// What bounds it on the H100: bytes. A few operations per element against 4
// bytes forward (bf16 x read, y written) and 6 backward (x and dy read, dx
// written), plus 8 bytes a row of statistics, so the 3.35 TB/s of device
// memory set the time. The design moves each byte once:
// * a row lives in registers, read by 16-byte loads, neighbouring lanes on
//   neighbouring addresses (lane l of a row's LANES lanes holds the 8-value
//   vectors l, l + LANES, ...), and leaves by 16-byte stores;
// * LANES lanes a row: 16 where C <= 128 (two rows to a warp, so that no lane
//   idles at Swin-B's C = 128), 32 above (VEC = C / 256 vectors a lane, 3 at
//   ViT-B's 768, 8 at 2048); the reductions are shuffles among those lanes;
// * CTAs of 4 warps walk rows with a grid stride over a grid of one wave (the
//   kernel's occupancy times the SMs, asked once a kernel, width and device by
//   the caller through apvt_layer_norm_wave: a finer grid than 8-warp CTAs give, which
//   evens out the few passes of a 12,544-row tensor), the next row's loads
//   issued before this row's reductions (kPrefetch, where the registers allow),
//   so that each warp keeps two rows of loads in flight;
// * the backward keeps x_hat and dy * gamma of its first pass in registers for
//   the second (kKeep, up to 4 vectors a lane) instead of unpacking x, dy and
//   gamma again: the same bits, 1.5-6.5% faster at the cells' shapes. Measured
//   no faster (PERF.md): 8- or 2-warp CTAs, no prefetch, the forward's row
//   kept unpacked, bf16 gamma and beta held in registers across rows, a grid
//   of two waves or of every row pass.
// Widths: a multiple of 8 up to 256 on one vector a lane, (LANES, VEC) = (16,
// 1) up to 128 and (32, 1) above, the vectors past C masked (the test
// configurations, 128, ViT-Ti's 192, 256); and the whole rows C = 256 * VEC,
// VEC in {2, 3, 4, 8} (512, 768, 1024, 2048), with no mask.
// kernels/layer_norm.py:kernel_variant is the same rule.
//
// C interface (loaded with ctypes): the launchers return the CUDA error code
// of the launch (cudaGetLastError), 0 on success, -1 for an unsupported width,
// parameter dtype or grid.

#include "tiles.cuh"

namespace apvt {
namespace lnk {

constexpr int kThreads = 128;
constexpr int kMaxC = 2048;

template <int L, int V>
struct Cfg {
  static constexpr int kLanes = L;
  static constexpr int kVec = V;
};

// the row's sum over its LANES lanes (a power of two dividing 32)
template <int LANES>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load8(float (&f)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load8(float (&f)[8], const bf16* p) {
  unpack8(f, __ldg(reinterpret_cast<const uint4*>(p)));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Whether the lane's vector at `col` lies inside the row: always at the
// whole-row widths (VEC > 1), tested at the ragged ones (VEC = 1).
template <int VEC>
__device__ __forceinline__ bool inside(int col, int C) { return VEC > 1 || col < C; }

// The lane's vectors of row `row` (zeros past C or past the last row).
template <int LANES, int VEC>
__device__ __forceinline__ void load_row(uint4 (&v)[VEC], const bf16* __restrict__ t, int row,
                                         int rows, int C, int lane) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int col = (i * LANES + lane) * 8;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && inside<VEC>(col, C))
      v[i] = __ldg(reinterpret_cast<const uint4*>(t + (size_t)row * C + col));
  }
}

template <int LANES, int VEC, typename P>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd(const bf16* __restrict__ x, const P* __restrict__ gamma,
                   const P* __restrict__ beta, bf16* __restrict__ y,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows, int C,
                   float eps) {
  constexpr int kRowsPerPass = kThreads / LANES;
  constexpr bool kPrefetch = VEC <= 4;
  const int lane = threadIdx.x % LANES, group = threadIdx.x / LANES;
  const int stride = gridDim.x * kRowsPerPass;
  uint4 cur[VEC], nxt[VEC];
  // the loop's bounds are the CTA's, so every lane of a warp takes each
  // shuffle; a row past the end computes on zeros and stores nothing
  int base = blockIdx.x * kRowsPerPass;
  load_row<LANES, VEC>(cur, x, base + group, rows, C, lane);
  for (; base < rows; base += stride) {
    const int row = base + group;
    if (kPrefetch) load_row<LANES, VEC>(nxt, x, row + stride, rows, C, lane);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float f[8];
      unpack8(f, cur[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[e];
    }
    const float mean = row_sum<LANES>(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (inside<VEC>((i * LANES + lane) * 8, C)) {
        float f[8];
        unpack8(f, cur[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = f[e] - mean;
          q += d * d;
        }
      }
    }
    const float rstd = rsqrtf(row_sum<LANES>(q) / C + eps);
    if (row < rows) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int col = (i * LANES + lane) * 8;
        if (inside<VEC>(col, C)) {
          float f[8], g[8], b[8], o[8];
          unpack8(f, cur[i]);
          load8(g, gamma + col);
          load8(b, beta + col);
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = fmaf(g[e], rstd * (f[e] - mean), b[e]);
          uint4 w;
          w.x = pack(o[0], o[1]);
          w.y = pack(o[2], o[3]);
          w.z = pack(o[4], o[5]);
          w.w = pack(o[6], o[7]);
          *reinterpret_cast<uint4*>(y + (size_t)row * C + col) = w;
        }
      }
      if (lane == 0) {
        mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
    if (kPrefetch) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) cur[i] = nxt[i];
    } else {
      load_row<LANES, VEC>(cur, x, row + stride, rows, C, lane);
    }
  }
}

template <int LANES, int VEC, typename P, bool PARAMS>
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                   const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                   const P* __restrict__ gamma, bf16* __restrict__ dx,
                   float* __restrict__ partials, int rows, int C) {
  constexpr int kRowsPerPass = kThreads / LANES;
  // the parameter sums hold 16 VEC floats a lane: no room for a second row
  constexpr bool kPrefetch = !PARAMS && VEC <= 4;
  // x_hat and dy * gamma kept between the two passes (no second unpack and
  // gamma load) where the registers allow
  constexpr bool kKeep = VEC <= 4;
  constexpr int kAcc = PARAMS ? VEC : 1;
  const int lane = threadIdx.x % LANES, group = threadIdx.x / LANES;
  const int stride = gridDim.x * kRowsPerPass;
  uint4 xc[VEC], dc[VEC], xn[VEC], dn[VEC];
  float acc_g[kAcc][8], acc_b[kAcc][8];
  if (PARAMS) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc_g[i][e] = acc_b[i][e] = 0.f;
  }
  int base = blockIdx.x * kRowsPerPass;
  load_row<LANES, VEC>(xc, x, base + group, rows, C, lane);
  load_row<LANES, VEC>(dc, dy, base + group, rows, C, lane);
  for (; base < rows; base += stride) {
    const int row = base + group;
    const bool ok = row < rows;
    const float mean = ok ? __ldg(mean_in + row) : 0.f;
    const float rstd = ok ? __ldg(rstd_in + row) : 0.f;
    if (kPrefetch) {
      load_row<LANES, VEC>(xn, x, row + stride, rows, C, lane);
      load_row<LANES, VEC>(dn, dy, row + stride, rows, C, lane);
    }
    float xk[kKeep ? VEC : 1][8], gk[kKeep ? VEC : 1][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int col = (i * LANES + lane) * 8;
      if (inside<VEC>(col, C)) {
        float f[8], d[8], g[8];
        unpack8(f, xc[i]);
        unpack8(d, dc[i]);
        load8(g, gamma + col);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = (f[e] - mean) * rstd;
          const float gg = d[e] * g[e];
          s1 += gg;
          s2 += gg * xh;
          if (kKeep) {
            xk[kKeep ? i : 0][e] = xh;
            gk[kKeep ? i : 0][e] = gg;
          }
          if (PARAMS) {
            acc_g[PARAMS ? i : 0][e] += d[e] * xh;
            acc_b[PARAMS ? i : 0][e] += d[e];
          }
        }
      }
    }
    const float m1 = row_sum<LANES>(s1) / C, m2 = row_sum<LANES>(s2) / C;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int col = (i * LANES + lane) * 8;
      if (ok && inside<VEC>(col, C)) {
        float o[8];
        if (kKeep) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            o[e] = rstd * (gk[kKeep ? i : 0][e] - m1 - xk[kKeep ? i : 0][e] * m2);
        } else {
          float f[8], d[8], g[8];
          unpack8(f, xc[i]);
          unpack8(d, dc[i]);
          load8(g, gamma + col);
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = rstd * (d[e] * g[e] - m1 - (f[e] - mean) * rstd * m2);
        }
        uint4 w;
        w.x = pack(o[0], o[1]);
        w.y = pack(o[2], o[3]);
        w.z = pack(o[4], o[5]);
        w.w = pack(o[6], o[7]);
        *reinterpret_cast<uint4*>(dx + (size_t)row * C + col) = w;
      }
    }
    if (kPrefetch) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) xc[i] = xn[i], dc[i] = dn[i];
    } else {
      load_row<LANES, VEC>(xc, x, row + stride, rows, C, lane);
      load_row<LANES, VEC>(dc, dy, row + stride, rows, C, lane);
    }
  }
  if (PARAMS) {
    // the CTA's row groups summed in group order, then its partial row out
    __shared__ float red[2 * kMaxC];
    for (int k = threadIdx.x; k < 2 * C; k += kThreads) red[k] = 0.f;
    for (int turn = 0; turn < kRowsPerPass; ++turn) {
      __syncthreads();
      if (group == turn) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int col = (i * LANES + lane) * 8;
          if (inside<VEC>(col, C)) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              red[col + e] += acc_g[i][e];
              red[C + col + e] += acc_b[i][e];
            }
          }
        }
      }
    }
    __syncthreads();
    float* out = partials + (size_t)blockIdx.x * 2 * C;
    for (int k = threadIdx.x; k < 2 * C; k += kThreads) out[k] = red[k];
  }
}

// dgamma (columns 0..C-1 of the partial rows) and dbeta (C..2C-1): a CTA of
// 32 columns x 8 slices of the partial rows, the slices summed in order
template <typename P>
__global__ void __launch_bounds__(256)
    layer_norm_param_grads(const float* __restrict__ partials, int parts, int C,
                           P* __restrict__ dgamma, P* __restrict__ dbeta) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (j < 2 * C)
    for (int p = ty; p < parts; p += 8) s += partials[(size_t)p * 2 * C + j];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < 2 * C) {
    float t = red[0][tx];
#pragma unroll
    for (int k = 1; k < 8; ++k) t += red[k][tx];
    if (j < C)
      store(dgamma + j, t);
    else
      store(dbeta + j - C, t);
  }
}

// --- host side ------------------------------------------------------------

inline bool supported(int rows, int C) { return rows > 0 && C >= 8 && C % 8 == 0; }

// fn(Cfg<LANES, VEC>{}) for the instantiation that takes width C; -1 if none
template <typename Fn>
int with_cfg(int C, Fn&& fn) {
  if (C <= 128) return fn(Cfg<16, 1>{});
  if (C <= 256) return fn(Cfg<32, 1>{});
  if (C == 512) return fn(Cfg<32, 2>{});
  if (C == 768) return fn(Cfg<32, 3>{});
  if (C == 1024) return fn(Cfg<32, 4>{});
  if (C == 2048) return fn(Cfg<32, 8>{});
  return -1;
}

// The kernel's resident CTAs an SM times the SMs of the current device.
inline int wave(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
}

template <int LANES>
inline bool grid_ok(int grid, int rows) {
  return grid >= 1 && grid <= (rows + kThreads / LANES - 1) / (kThreads / LANES);
}

template <typename P>
int wave_of(int C, int kernel) {
  return with_cfg(C, [&](auto cfg) {
    using K = decltype(cfg);
    if (kernel == 0)
      return wave(reinterpret_cast<const void*>(&layer_norm_fwd<K::kLanes, K::kVec, P>));
    if (kernel == 1)
      return wave(reinterpret_cast<const void*>(&layer_norm_bwd<K::kLanes, K::kVec, P, false>));
    return wave(reinterpret_cast<const void*>(&layer_norm_bwd<K::kLanes, K::kVec, P, true>));
  });
}

template <typename P>
int fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean, void* rstd,
        int rows, int C, float eps, int grid, cudaStream_t s) {
  return with_cfg(C, [&](auto cfg) {
    using K = decltype(cfg);
    if (!grid_ok<K::kLanes>(grid, rows)) return -1;
    layer_norm_fwd<K::kLanes, K::kVec, P><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const P*>(gamma), static_cast<const P*>(beta),
        static_cast<bf16*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), rows, C,
        eps);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename P, bool PARAMS>
int bwd(const void* x, const void* dy, const void* mean, const void* rstd, const void* gamma,
        void* dx, void* partials, int rows, int C, int grid, cudaStream_t s) {
  return with_cfg(C, [&](auto cfg) {
    using K = decltype(cfg);
    if (!grid_ok<K::kLanes>(grid, rows)) return -1;
    layer_norm_bwd<K::kLanes, K::kVec, P, PARAMS><<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const P*>(gamma), static_cast<bf16*>(dx), static_cast<float*>(partials),
        rows, C);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename P>
int param_grads(const void* partials, int parts, int C, void* dgamma, void* dbeta,
                cudaStream_t s) {
  layer_norm_param_grads<P><<<(2 * C + 31) / 32, 256, 0, s>>>(
      static_cast<const float*>(partials), parts, C, static_cast<P*>(dgamma),
      static_cast<P*>(dbeta));
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int bwd_all(const void* x, const void* dy, const void* mean, const void* rstd, const void* gamma,
            void* dx, void* partials, void* dgamma, void* dbeta, int rows, int C, int grid,
            cudaStream_t s) {
  if (partials == nullptr)
    return bwd<P, false>(x, dy, mean, rstd, gamma, dx, nullptr, rows, C, grid, s);
  const int rc = bwd<P, true>(x, dy, mean, rstd, gamma, dx, partials, rows, C, grid, s);
  return rc != 0 ? rc : param_grads<P>(partials, grid, C, dgamma, dbeta, s);
}

}  // namespace lnk
}  // namespace apvt

using namespace apvt;

extern "C" {

// The resident CTAs of one wave on the current device for the kernel that
// takes width C: kernel 0 the forward, 1 the backward, 2 the backward with
// parameter gradients. The caller asks once and launches min(wave, row
// passes) CTAs. -1 if unsupported.
int apvt_layer_norm_wave(int C, int pdtype, int kernel) {
  if (!lnk::supported(1, C) || kernel < 0 || kernel > 2) return -1;
  if (pdtype == 0) return lnk::wave_of<float>(C, kernel);
  if (pdtype == 1) return lnk::wave_of<bf16>(C, kernel);
  return -1;
}

// x (rows, C) bf16, gamma and beta (C) in pdtype (0 = float32, 1 = bfloat16)
// -> y (rows, C) bf16, mean and rstd (rows) f32, over `grid` CTAs.
int apvt_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y, void* mean,
                        void* rstd, int rows, int C, int pdtype, float eps, int grid,
                        void* stream) {
  if (!lnk::supported(rows, C)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pdtype == 0) return lnk::fwd<float>(x, gamma, beta, y, mean, rstd, rows, C, eps, grid, s);
  if (pdtype == 1) return lnk::fwd<bf16>(x, gamma, beta, y, mean, rstd, rows, C, eps, grid, s);
  return -1;
}

// x, dy (rows, C) bf16, the forward's mean and rstd (rows) f32, gamma (C) in
// pdtype -> dx (rows, C) bf16 over `grid` CTAs. With `partials` (grid, 2, C)
// f32 not null, each CTA's sums of dy * x_hat and dy as well, and then, by a
// second kernel on the same stream, dgamma and dbeta (C) in pdtype, the
// partial rows summed in a fixed order.
int apvt_layer_norm_bwd(const void* x, const void* dy, const void* mean, const void* rstd,
                        const void* gamma, void* dx, void* partials, void* dgamma, void* dbeta,
                        int rows, int C, int pdtype, int grid, void* stream) {
  if (!lnk::supported(rows, C)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pdtype == 0)
    return lnk::bwd_all<float>(x, dy, mean, rstd, gamma, dx, partials, dgamma, dbeta, rows, C,
                               grid, s);
  if (pdtype == 1)
    return lnk::bwd_all<bf16>(x, dy, mean, rstd, gamma, dx, partials, dgamma, dbeta, rows, C,
                              grid, s);
  return -1;
}

const char* apvt_layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
