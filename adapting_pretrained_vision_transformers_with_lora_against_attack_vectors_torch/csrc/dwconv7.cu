// Depthwise 7x7 convolution (NHWC, stride 1, SAME, bias-free) for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/dwconv.py:dwconv7 of the JAX package
// (_make_dw_kernel): out[b, h, w, c] = sum over the 49 taps (di, dj) of
//   x[b, h + di - 3, w + dj - 3, c] * taps[di, dj, c]
// with zeros outside the image, the taps given in x's dtype (the wrapper
// rounds the filter to it first, as the Pallas wrapper does) and widened to
// f32 here, f32 accumulation in row-major tap order, one rounding to x's
// dtype. The same kernel computes the input gradient: the wrapper calls it on
// the cotangent with flip = 1, which reads the filter spatially flipped. The
// filter gradient is not computed here (the wrapper leaves it to the plain
// version's autograd, as the JAX VJP leaves it to XLA).
//
// What bounds it on the H100: 98 FLOP per output element against 4 bytes of
// bf16 traffic (one read, one write), ~25 FLOP/byte, and no contraction for
// the tensor cores: at the ConvNeXt-B stage-1 shape (64, 56, 56, 128) the
// 2.5 GFLOP at the 67 TFLOP/s f32 rate (37 us) and the 103 MB at 3.35 TB/s
// (31 us) are about even. The kernel's job is to read each input once from
// device memory and to keep the 49-fold reuse in shared memory and registers.
//
// What the design does about it:
// * the TPU kernel's blocking (one padded image per program, row chunks, seven
//   pre-shifted column copies, a zero-padded copy made outside) is not
//   carried over. A CTA owns a spatial tile (at most 14 x 14 outputs) of 64
//   channels of one image and stages it with its 3-pixel halo in shared
//   memory, 16 bytes per thread and load, zero-filled outside the image: no
//   padded copy exists anywhere;
// * channels are contiguous, so a lane owns a channel pair (one 32-bit word of
//   bf16) and a warp 64 channels: every shared-memory access of a warp is one
//   contiguous row, free of bank conflicts, and every store is 128 bytes;
// * a warp computes strips of 7 consecutive outputs of one row: per tap row it
//   loads 13 inputs and 7 taps for 98 multiply-adds per lane (a 4.9-fold
//   reuse from registers); the taps sit in shared memory as f32. The tap-row
//   loop is kept rolled: unrolled, the compiler hoists every load and takes
//   244 registers a thread (one CTA per SM) for no gain in time;
// * maps smaller than the tile (14 x 14 and 7 x 7, ConvNeXt stages 3 and 4)
//   shrink the tile to the map, so no thread works on padding; stage 4 still
//   launches B * C / 64 = 1024 CTAs.
//
// Takes f32 and bf16, any H and W, C a multiple of 8. C interface (loaded
// with ctypes): the entry point returns the CUDA error code of its launch
// (cudaGetLastError), 0 on success, -1 for an unsupported dtype or shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kK = 7;           // taps per side
constexpr int kPad = kK / 2;
constexpr int kCC = 64;         // channels per CTA: a channel pair per lane
constexpr int kStrip = 7;       // consecutive outputs of a row per warp and step
constexpr int kMaxTile = 14;    // output rows (and columns) per CTA, at most
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// x (B, H, W, C), taps (7, 7, C) -> out (B, H, W, C). Grid: (spatial tiles,
// channel chunks of 64, B); the tile is th rows by tws strips of 7. With
// flip, tap (di, dj) is read from (6 - di, 6 - dj).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dwconv7_kernel(const T* __restrict__ x, const T* __restrict__ taps, T* __restrict__ out, int H,
               int W, int C, int th, int tws, int tiles_w, int flip) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);             // [49][kCC]
  T* xs = reinterpret_cast<T*>(ws + kK * kK * kCC);       // [th + 6][tw + 6][kCC]
  const int tw = tws * kStrip;
  const int ph = th + 2 * kPad, pw = tw + 2 * kPad;
  const int h0 = (blockIdx.x / tiles_w) * th, w0 = (blockIdx.x % tiles_w) * tw;
  const int c0 = blockIdx.y * kCC, b = blockIdx.z;

  for (int i = threadIdx.x; i < kK * kK * kCC; i += kThreads) {
    const int c = c0 + i % kCC, tap = flip ? kK * kK - 1 - i / kCC : i / kCC;
    ws[i] = c < C ? widen(taps[(size_t)tap * C + c]) : 0.f;
  }
  constexpr int kVec = 16 / sizeof(T);   // channels per 16-byte load
  constexpr int kVP = kCC / kVec;        // loads per pixel
  for (int i = threadIdx.x; i < ph * pw * kVP; i += kThreads) {
    const int v = i % kVP, p = i / kVP;
    const int hh = h0 + p / pw - kPad, ww = w0 + p % pw - kPad, c = c0 + v * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (hh >= 0 && hh < H && ww >= 0 && ww < W && c < C)
      val = __ldg(reinterpret_cast<const uint4*>(x + (((size_t)b * H + hh) * W + ww) * C + c));
    *reinterpret_cast<uint4*>(xs + (size_t)p * kCC + v * kVec) = val;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, cl = 2 * (threadIdx.x & 31);
  if (c0 + cl >= C) return;
  for (int u = warp; u < th * tws; u += kWarps) {
    const int r = u / tws, s = u % tws;
    float2 acc[kStrip];
#pragma unroll
    for (int o = 0; o < kStrip; ++o) acc[o] = make_float2(0.f, 0.f);
#pragma unroll 1
    for (int di = 0; di < kK; ++di) {
      const T* row = xs + ((size_t)(r + di) * pw + s * kStrip) * kCC + cl;
      float2 in[kStrip + kK - 1];
#pragma unroll
      for (int j = 0; j < kStrip + kK - 1; ++j) in[j] = load2(row + j * kCC);
#pragma unroll
      for (int dj = 0; dj < kK; ++dj) {
        const float2 tp = load2(ws + (di * kK + dj) * kCC + cl);
#pragma unroll
        for (int o = 0; o < kStrip; ++o) {
          acc[o].x = fmaf(in[o + dj].x, tp.x, acc[o].x);
          acc[o].y = fmaf(in[o + dj].y, tp.y, acc[o].y);
        }
      }
    }
    const int hh = h0 + r;
    if (hh < H) {
#pragma unroll
      for (int o = 0; o < kStrip; ++o) {
        const int ww = w0 + s * kStrip + o;
        if (ww < W) store2(out + (((size_t)b * H + hh) * W + ww) * C + c0 + cl, acc[o]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* taps, void* out, int B, int H, int W, int C, int flip,
           cudaStream_t stream) {
  const int th = H < kMaxTile ? H : kMaxTile;
  const int tws = W > kStrip ? kMaxTile / kStrip : 1;
  const int tw = tws * kStrip;
  const int tiles_h = (H + th - 1) / th, tiles_w = (W + tw - 1) / tw;
  const size_t smem = (size_t)kK * kK * kCC * sizeof(float) +
                      (size_t)(th + 2 * kPad) * (tw + 2 * kPad) * kCC * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(dwconv7_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_h * tiles_w, (C + kCC - 1) / kCC, B);
  dwconv7_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(taps), static_cast<T*>(out), H, W, C, th,
      tws, tiles_w, flip);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, H, W, C), taps (7, 7, C) in x's dtype -> out (B, H, W, C). dtype: 0 =
// float32, 1 = bfloat16. flip: 0 = the convolution, 1 = its input gradient
// (the same convolution with the spatially flipped filter).
int apvt_dwconv7(const void* x, const void* taps, void* out, int B, int H, int W, int C,
                 int dtype, int flip, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 8 || C % 8 || B > 65535 || (C + kCC - 1) / kCC > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, taps, out, B, H, W, C, flip, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, taps, out, B, H, W, C, flip, s);
  return -1;
}

const char* apvt_dwconv7_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
