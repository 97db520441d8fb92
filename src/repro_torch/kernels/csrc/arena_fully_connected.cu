// arena_fully_connected: y = x . W on the arena (flat or row-blocked), over
// the whole card. int8: x and W (symmetric, zero point 0) in an int32 dot
// of (x - x_zp) * w, then the shared requantisation; f32: an f32 dot.
//
// Replaces the TPU kernel
// src/repro/kernels/arena_ops.py::_fully_connected_kernel (apply_op ->
// _plain_kernel over _FlatMem, and over _BlockMem in the row-blocked
// program).
//
// Bound on this card: bytes, W's (resnet_50_v2's 2048 x 1000 f32 is 8.2 MB,
// 2.45 us at 3.35 TB/s; the flagship's 256 x 1000 int8 0.26 MB). The body
// is fc_tiles.cuh's grid: W's column blocks x K slices, one a CTA, the
// slices' partials summed in a fixed order (f32 results depend on (m,
// idim, odim) only). The output may overlap the input (on the flagship the
// 1000-byte output at byte 0 covers the input's first byte, 999): the
// descriptor's order word then makes every CTA read x and compute its
// partials before one grid-wide barrier, and only then store (paper
// §III.F), on a cooperative grid the entry point refuses, never shrinks,
// on a card that cannot hold it.
#include "fc_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

// two CTAs an SM (at most 64 registers a thread)
__global__ void __launch_bounds__(NT, 2)
arena_fc_kernel(uint8_t* arena_buf, const int* d, const uint8_t* w,
                uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  fc_grid(d, arena_buf, w, gws, smem);
}

// (arena, descriptor, W, workspace (the counters, then the partials),
// dynamic shared bytes, CTAs to launch at most, CTAs that must run at once
// (order 2: all of them; else 0), counter bytes, stream):
// arena_common.cuh's launch_grid.
extern "C" int arena_fully_connected(void* arena_buf, const void* desc,
                                     const void* w, void* gws, int smem,
                                     int grid, int group, int counter_bytes,
                                     void* stream) {
  return launch_grid<NT>(arena_fc_kernel, launch_state, arena_buf, desc, w,
                         gws, smem, grid, group, counter_bytes, stream);
}
