// The ring of TMA-filled shared-memory stages that the warp-specialised
// wgmma kernels of this directory stream their weights (and activation
// slabs) through: a full and an empty mbarrier per stage, one producer warp
// that waits for a free stage, announces its bytes and starts its boxes,
// and consumer warps that wait for the stage they need and free it when its
// products are done. No block-wide barrier in a main loop.
// Header only; each .cu file is its own library.

#pragma once

#include "sm90.cuh"

namespace apvt {
namespace wring {

using namespace sm90;

// Where a thread is in a ring of S stages: the stage and its phase parity.
template <int S>
struct Pipe {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next() {
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The producer warp's wait for a free stage, and the announcement of `bytes`
// to come on its full barrier. The lanes then start the stage's boxes side
// by side, one each.
template <int S>
__device__ __forceinline__ void acquire(uint64_t* full, uint64_t* empty, const Pipe<S>& p,
                                        uint32_t bytes, int lane) {
  mbar_wait(&empty[p.s], p.ph ^ 1);
  if (lane == 0) mbar_expect_tx(&full[p.s], bytes);
  __syncwarp();
}

// A consumer warp is done with a stage (or passes over one it does not read).
template <int S>
__device__ __forceinline__ void release(uint64_t* empty, Pipe<S>& p, int lane) {
  if (lane == 0) mbar_arrive(&empty[p.s]);
  p.next();
}

// The stage's products are under way: wait for them and free the stage.
template <int S>
__device__ __forceinline__ void commit_stage(uint64_t* empty, Pipe<S>& p, int lane) {
  wgmma_commit();
  wgmma_wait<0>();
  release(empty, p, lane);
}

}  // namespace wring
}  // namespace apvt
