// Depthwise 7x7 convolution (NHWC, stride 1, SAME, bias-free) for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/dwconv.py:dwconv7 of the JAX package
// (_make_dw_kernel): out[b, h, w, c] = sum over the 49 taps (di, dj) of
//   x[b, h + di - 3, w + dj - 3, c] * taps[di, dj, c]
// with zeros outside the image, the taps given in x's dtype (the wrapper
// rounds the filter to it first, as the Pallas wrapper does) and widened to
// f32 here, f32 accumulation in row-major tap order (one fmaf chain from 0),
// one rounding to x's dtype. The same kernel computes the input gradient: the
// wrapper calls it on the cotangent with flip = 1, which reads the filter
// spatially flipped. The filter gradient is not computed here (the wrapper
// leaves it to the plain version's autograd, as the JAX VJP leaves it to XLA).
//
// What bounds it on the H100: 98 FLOP per output element against 4 bytes of
// bf16 traffic (one read, one write), ~25 FLOP/byte, and no contraction for
// the tensor cores: at the ConvNeXt-B stage-1 shape (64, 56, 56, 128) the
// 2.5 GFLOP at the 67 TFLOP/s f32 rate (37 us) and the 103 MB at 3.35 TB/s
// (31 us) are about even. The kernel's job is to keep the FMA pipe busy: to
// spend as few issue slots as it can on anything but FFMA, and to read each
// input from device memory about once.
//
// The bf16 kernel (namespace tr, "tma_ring"):
// * a persistent CTA per SM walks a contiguous range of work items, channel
//   chunk major: an item is a tile of at most 14 x 28 outputs (a whole map
//   at ConvNeXt-B stages 3 and 4) of 64 channels of one image. The tile with
//   its 3-pixel halo arrives by one 4-D TMA box over (C, W, H, B) from the
//   signed start (c0, w0 - 3, h0 - 3, b): the hardware fills what lies
//   outside the image (and the channels past C) with zeros, so SAME padding
//   costs no bytes and no bounds checks;
// * the next tiles are in flight in a ring of 2-8 slots while the 8 warps
//   compute on the tiles that have arrived. A slot has a full mbarrier and a
//   release count; the warp that releases it last starts its next load
//   (a ninth, producer warp would put three warps on one scheduler and cap a
//   thread at 168 registers). No block-wide barrier past the prologue;
// * a lane owns a channel pair (one 32-bit word of bf16; a warp reads one
//   128-byte pixel row per load, free of bank conflicts) and holds its 49
//   tap pairs in registers as f32, loaded once per channel chunk (flipped
//   at load time for the input-gradient role, so both roles run one loop);
// * 2-D register blocking: a warp computes a block of 2 rows x 7 columns
//   (1 x 7 in a tile of odd height, a whole 7 x 7 map). Each of its 8 input
//   rows is read once (13 pixel pairs, converted once) and feeds every
//   (output row, tap row) pair it reaches: 104 loads for 686 FMA pairs (the
//   staged kernel's strips: 91 loads and 49 tap loads of 2 wavefronts).
//   Input rows go in ascending order, so each output still sums its taps
//   row by row, column by column: the result is bit-identical to the staged
//   kernel's;
// * a block leaves through a staging buffer in shared memory and one TMA
//   store of 2 x 7 pixels x 64 channels, which drops what lies outside the
//   tensor; the warp goes on computing while the store drains;
// * the warps take the blocks of the items round robin across items, so a
//   tile whose blocks do not divide by 8 leaves no warp idle.
// plan() below picks the tile, the block rows and the ring;
// kernels/dwconv.py:kernel_plan is the same arithmetic in Python.
//
// What limits it (NVIDIA H100 80GB HBM3, 700 W; tools/dwconv_diagnose.py,
// PERF.md): 38-48% of the f32 FMA peak at stages 1-3. With parts taken out
// at stage 1 the products alone take 86% of the time (the TMA loads are
// hidden; storing from registers instead of by TMA was 1.19x slower), at
// about 70% of the issue rate their instructions need (81% FFMA: each bf16
// pair costs a load and two conversions). Measured no faster: 12 warps
// instead of 8 (so latency is not the limit); blocks of 3 and 4 rows
// (better reuse on paper, 1.2-1.35x slower: 222-234 registers and up to
// twice the code). What is left is the tensor cores (PERF.md).
//
// The first design (namespace st, "staged") stays for f32 (no model path
// sends f32: the JAX gate takes 2-byte dtypes only) and behind
// apvt_dwconv7_staged, which only chip_smoke.py and tools/dwconv_diagnose.py
// call, to time the two in turns and compare their bits. A CTA of it stages
// its 49 taps and its haloed tile (at most 14 x 14 outputs) in shared
// memory, waits at a block barrier, then computes strips of 7 outputs a warp.
//
// Takes f32 and bf16, any H and W, C a multiple of 8. C interface (loaded
// with ctypes): the entry points return the CUDA error code of the launch
// (cudaGetLastError), 0 on success, -1 for an unsupported dtype or shape,
// -2 if the tensor map could not be encoded.

#include "sm90.cuh"

namespace {

using namespace apvt::sm90;

constexpr int kK = 7;           // taps per side
constexpr int kPad = kK / 2;
constexpr int kCC = 64;         // channels per CTA and item: a channel pair per lane

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

bool supported(int B, int H, int W, int C) {
  return B >= 1 && H >= 1 && W >= 1 && C >= 8 && C % 8 == 0;
}

// --- the first design: stage, barrier, compute ---------------------------------

namespace st {

constexpr int kStrip = 7;       // consecutive outputs of a row per warp and step
constexpr int kMaxTile = 14;    // output rows (and columns) per CTA, at most
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

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
  if (B > 65535 || (C + kCC - 1) / kCC > 65535) return -1;
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

}  // namespace st

// --- the Hopper kernel: TMA ring, taps in registers, 2-D register blocking, TMA stores ---

namespace tr {

using bf16 = __nv_bfloat16;

constexpr int kMaxRows = 2;       // output rows of a warp's block: 2, or 1 in a tile of odd height
constexpr int kCols = 7;          // output columns of a warp's block (a strip)
constexpr int kIn = kCols + kK - 1;   // input columns a block row reads
constexpr int kMaxTileH = 14;     // output rows of a tile, at most
constexpr int kMaxTileW = 28;     // output columns of a tile, at most (a multiple of kCols)
constexpr int kWarps = 8;         // two a scheduler: a ninth would cap a thread at 168 registers
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSlots = 8;
constexpr int kSmemMax = 232448;  // what a CTA may ask for
constexpr int kBarBytes = 2 * kMaxSlots * 8;   // a full barrier and a release count per slot
// a warp's block of outputs in bf16, staged for its TMA store; two a warp
constexpr int kStageBytes = kMaxRows * kCols * kCC * 2;
constexpr int kStagingBytes = 2 * kWarps * kStageBytes;
constexpr int kSlotBudget = kSmemMax - 1024 - kStagingBytes - kBarBytes;   // 1024: alignment
// a block's TMA store writes all its rows: a tile's rows must come in whole
// blocks unless the tile ends the image (where the store drops what lies
// past it). A tile of odd height is a whole map (th = H): blocks of one row
// there, of two elsewhere
static_assert(kMaxTileH % kMaxRows == 0, "tile rows in whole blocks");

// The tile, the schedule and the ring of a launch; kernels/dwconv.py:kernel_plan
// computes the same.
struct Plan {
  int th, tw;               // outputs of a tile
  int rows;                 // output rows of a warp's block
  int tiles_h, tiles_w, chunks;
  long long items;          // chunks x B x tiles_h x tiles_w, channel chunk major
  int grid;                 // persistent CTAs: one per SM, at most one per item
  int slots, slot_bytes;    // the ring; slot_bytes: a box, rounded up to 1024
  int smem;
};

Plan plan(int B, int H, int W, int C, int sms) {
  Plan p;
  p.th = H < kMaxTileH ? H : kMaxTileH;
  p.rows = p.th % 2 ? 1 : kMaxRows;
  const int w7 = (W + kCols - 1) / kCols * kCols;
  p.tw = w7 < kMaxTileW ? w7 : kMaxTileW;
  p.tiles_h = (H + p.th - 1) / p.th;
  p.tiles_w = (W + p.tw - 1) / p.tw;
  p.chunks = (C + kCC - 1) / kCC;
  p.items = (long long)p.chunks * B * p.tiles_h * p.tiles_w;
  p.grid = p.items < sms ? (int)p.items : sms;
  const int box = (p.th + 2 * kPad) * (p.tw + 2 * kPad) * kCC * 2;
  p.slot_bytes = (box + 1023) / 1024 * 1024;
  p.slots = kSlotBudget / p.slot_bytes;
  if (p.slots > kMaxSlots) p.slots = kMaxSlots;
  p.smem = p.slots * p.slot_bytes + kStagingBytes + 1024 + kBarBytes;
  return p;
}

struct Item {
  int c0, b, h0, w0;
};

__device__ __forceinline__ Item decode(long long i, int B, int tiles_h, int tiles_w, int th,
                                       int tw) {
  const int tiles = tiles_h * tiles_w;
  const long long per_chunk = (long long)B * tiles;
  const int chunk = (int)(i / per_chunk);
  const int r = (int)(i % per_chunk);
  const int t = r % tiles;
  return {chunk * kCC, r / tiles, (t / tiles_w) * th, (t % tiles_w) * tw};
}

// The 49 tap pairs of channels (c, c + 1) as f32, flipped for the input
// gradient; zeros past C.
__device__ __forceinline__ void load_taps(float2 (&tk)[kK * kK], const bf16* __restrict__ taps,
                                          int c, int C, int flip) {
#pragma unroll
  for (int t = 0; t < kK * kK; ++t) {
    const int src = flip ? kK * kK - 1 - t : t;
    tk[t] = c < C ? load2(taps + (size_t)src * C + c) : make_float2(0.f, 0.f);
  }
}

// A block of R output rows x 7 columns of one lane's channel pair. `in0`:
// the lane's word of the block's first input pixel (row r0, column s0 of
// the tile with its halo); `row_words`: 32-bit words per tile row.
template <int R, int ROWS>
__device__ __forceinline__ void conv_block(float2 (&acc)[ROWS][kCols], const uint32_t* in0,
                                           int row_words, const float2 (&tk)[kK * kK]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int o = 0; o < kCols; ++o) acc[r][o] = make_float2(0.f, 0.f);
#pragma unroll
  for (int ir = 0; ir < R + kK - 1; ++ir) {
    const uint32_t* row = in0 + ir * row_words;
    float2 in[kIn];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      const uint32_t v = row[j * 32];
      in[j] = make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
    }
    // output row r takes this input row as its tap row ir - r, in ascending order
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int di = ir - r;
      if (di < 0 || di >= kK) continue;
#pragma unroll
      for (int dj = 0; dj < kK; ++dj) {
        // one channel's 7 products, then the other's: a tap in 7 FFMA in a row
        const float2 t = tk[di * kK + dj];
#pragma unroll
        for (int o = 0; o < kCols; ++o) acc[r][o].x = fmaf(in[o + dj].x, t.x, acc[r][o].x);
#pragma unroll
        for (int o = 0; o < kCols; ++o) acc[r][o].y = fmaf(in[o + dj].y, t.y, acc[r][o].y);
      }
    }
  }
}

// conv_block for the R = min(rows, ROWS) rows that are left: one
// instantiation per count.
template <int R, int ROWS>
__device__ __forceinline__ void conv_rows(int rows, float2 (&acc)[ROWS][kCols],
                                          const uint32_t* in0, int row_words,
                                          const float2 (&tk)[kK * kK]) {
  if constexpr (R == 1) {
    conv_block<1>(acc, in0, row_words, tk);
  } else {
    if (rows >= R) conv_block<R>(acc, in0, row_words, tk);
    else conv_rows<R - 1>(rows, acc, in0, row_words, tk);
  }
}

struct Shape {
  int B, H, W, C, th, tw, tiles_h, tiles_w;
  long long items;
  int slots, slot_bytes, flip;
};

// The TMA load of item i into `slot`, announced on its full barrier.
__device__ __forceinline__ void load_item(unsigned char* ring, uint64_t* full,
                                          const CUtensorMap* map, const Shape& s, long long i,
                                          int slot) {
  const Item it = decode(i, s.B, s.tiles_h, s.tiles_w, s.th, s.tw);
  mbar_expect_tx(&full[slot], (s.th + 2 * kPad) * (s.tw + 2 * kPad) * kCC * 2);
  tma_load_4d(ring + slot * s.slot_bytes, map, &full[slot], it.c0, it.w0 - kPad, it.h0 - kPad,
              it.b);
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
dwconv7_tma(const __grid_constant__ CUtensorMap map, const __grid_constant__ CUtensorMap omap,
            const bf16* __restrict__ taps, const Shape s) {
  extern __shared__ __align__(16) unsigned char raw[];
  unsigned char* ring = align1024(raw);
  unsigned char* staging = ring + s.slots * s.slot_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kStagingBytes);
  unsigned int* released = reinterpret_cast<unsigned int*>(full + kMaxSlots);
  const long long first = (long long)blockIdx.x * s.items / gridDim.x;
  const long long last = (long long)(blockIdx.x + 1) * s.items / gridDim.x;
  const int n = (int)(last - first);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < s.slots; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    mbar_fence_init();
    for (int j = 0; j < n && j < s.slots; ++j) load_item(ring, full, &map, s, first + j, j);
  }
  __syncthreads();

  const int row_words = (s.tw + 2 * kPad) * (kCC / 2);
  float2 tk[kK * kK];
  int chunk_c0 = -1;
  int slot = 0, base = 0;   // base: blocks of the CTA's earlier items, modulo kWarps
  uint32_t ph = 0;
  int sbuf = 0;   // which of the warp's two staging buffers the next block fills
  for (int j = 0; j < n; ++j) {
    const Item it = decode(first + j, s.B, s.tiles_h, s.tiles_w, s.th, s.tw);
    const int rows = min(s.th, s.H - it.h0), cols = min(s.tw, s.W - it.w0);
    const int strips = (cols + kCols - 1) / kCols;
    const int blocks = (rows + ROWS - 1) / ROWS * strips;
    const int c = it.c0 + 2 * lane;
    int k = (warp - base) % kWarps;
    if (k < 0) k += kWarps;
    base = (base + blocks) % kWarps;
    if (k < blocks && it.c0 != chunk_c0) {
      load_taps(tk, taps, c, s.C, s.flip);
      chunk_c0 = it.c0;
    }
    // every warp waits, also one without a block here: its release below
    // must not count towards the slot's previous item
    mbar_wait(&full[slot], ph);
    const uint32_t* tile = reinterpret_cast<const uint32_t*>(ring + slot * s.slot_bytes) + lane;
    for (; k < blocks; k += kWarps) {
      const int r0 = (k / strips) * ROWS, s0 = (k % strips) * kCols;
      const uint32_t* in0 = tile + r0 * row_words + s0 * (kCC / 2);
      float2 acc[ROWS][kCols];
      conv_rows<ROWS>(rows - r0, acc, in0, row_words, tk);
      // out through a staging buffer and one TMA store: the hardware drops
      // the rows, columns and channels that lie outside the tensor
      unsigned char* stage = staging + (2 * warp + sbuf) * kStageBytes;
      if (lane == 0) tma_store_wait_read<1>();   // this buffer's store two blocks ago
      __syncwarp();
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          reinterpret_cast<uint32_t*>(stage)[(r * kCols + q) * 32 + lane] =
              pack_bf16(acc[r][q].x, acc[r][q].y);
      fence_async_shared();
      __syncwarp();
      if (lane == 0) {
        tma_store_4d(&omap, stage, it.c0, it.w0 + s0, it.h0 + r0, it.b);
        tma_store_commit();
      }
      sbuf ^= 1;
    }
    // the last warp to be done with the slot refills it with the item s.slots on
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&released[slot], 1u) % kWarps == kWarps - 1 && j + s.slots < n) {
        fence_async_shared();
        load_item(ring, full, &map, s, first + j + s.slots, slot);
      }
    }
    if (++slot == s.slots) slot = 0, ph ^= 1;
  }
  if (lane == 0) tma_store_wait_read<0>();   // the staging buffers outlive their stores
}

int sm_count() {
  static int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return v;
  }();
  return n;
}

int launch(const void* x, const void* taps, void* out, int B, int H, int W, int C, int flip,
           cudaStream_t stream) {
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorNoDevice;
  const Plan p = plan(B, H, W, C, sms);
  // x read in haloed tiles, out written in blocks: the same (C, W, H, B) view
  CUtensorMap map, omap;
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)C * 2, (uint64_t)W * C * 2, (uint64_t)H * W * C * 2};
  const uint32_t box[4] = {(uint32_t)kCC, (uint32_t)(p.tw + 2 * kPad),
                           (uint32_t)(p.th + 2 * kPad), 1u};
  const uint32_t obox[4] = {(uint32_t)kCC, (uint32_t)kCols, (uint32_t)p.rows, 1u};
  if (!make_map_4d(&map, x, dims, strides, box) || !make_map_4d(&omap, out, dims, strides, obox))
    return kMapError;
  auto kernel = p.rows == kMaxRows ? dwconv7_tma<kMaxRows> : dwconv7_tma<1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const Shape s = {B, H, W, C, p.th, p.tw, p.tiles_h, p.tiles_w, p.items, p.slots,
                   p.slot_bytes, flip};
  kernel<<<p.grid, kThreads, p.smem, stream>>>(map, omap, static_cast<const bf16*>(taps), s);
  return (int)cudaGetLastError();
}

}  // namespace tr

}  // namespace

extern "C" {

// x (B, H, W, C), taps (7, 7, C) in x's dtype -> out (B, H, W, C). dtype: 0 =
// float32 (the staged kernel), 1 = bfloat16 (the TMA-ring kernel). flip: 0 = the
// convolution, 1 = its input gradient (the same convolution with the
// spatially flipped filter).
int apvt_dwconv7(const void* x, const void* taps, void* out, int B, int H, int W, int C,
                 int dtype, int flip, void* stream) {
  if (!supported(B, H, W, C)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return st::launch<float>(x, taps, out, B, H, W, C, flip, s);
  if (dtype == 1) return tr::launch(x, taps, out, B, H, W, C, flip, s);
  return -1;
}

// The same with the staged device code at every dtype: for timing the two in
// turns; no model path calls it.
int apvt_dwconv7_staged(const void* x, const void* taps, void* out, int B, int H, int W, int C,
                        int dtype, int flip, void* stream) {
  if (!supported(B, H, W, C)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return st::launch<float>(x, taps, out, B, H, W, C, flip, s);
  if (dtype == 1) return st::launch<__nv_bfloat16>(x, taps, out, B, H, W, C, flip, s);
  return -1;
}

// The bf16 launcher's plan for a shape on `sms` SMs (the card's count where
// sms <= 0), into plan[9]: tile rows, tile columns, block rows, tiles along
// H and W, items, CTAs, ring slots, dynamic shared memory. -1 for an
// unsupported shape.
int apvt_dwconv7_plan(int B, int H, int W, int C, int sms, long long* out) {
  if (!supported(B, H, W, C)) return -1;
  const tr::Plan p = tr::plan(B, H, W, C, sms > 0 ? sms : tr::sm_count());
  const long long v[9] = {p.th,    p.tw,   p.rows,  p.tiles_h, p.tiles_w,
                          p.items, p.grid, p.slots, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

const char* apvt_dwconv7_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
