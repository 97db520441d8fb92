// arena_pool: max or average pooling in place on the arena (flat or
// row-blocked), int8 or f32, over the whole card. Average is over the valid
// taps of each window; int8 max requantises acc - x_zp, int8 avg acc /
// max(cnt, 1) - x_zp (in f32), both with the shared requantisation.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_pool_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: bytes, at a few MB per op (resnet_50_v2's 3x3/2 max
// pool reads 3.2 MB of f32 and writes 0.8 MB, 1.2 us at 3.35 TB/s). The
// design is arena_conv's (conv_tiles.cuh, the pool bodies B_MAX / B_AVG
// that arena_stream_roll also runs): row tiles of output columns and a
// channel block over every SM, taking tickets in row-major order, each
// tile's input footprint staged in shared memory, each output in
// pool_point's order (bit-equal to the one-CTA row walk the fused chains
// keep). The planner may overlap the pool's output with its input
// diagonally (paper §III.F), so the descriptor's order word
// (arena_ops.conv_order) makes a tile store only once every tile of its
// row and the rows before has staged its footprint; footprint rows are
// read where the operand's addressing puts them (ArenaRows).
#include "conv_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

__global__ void __launch_bounds__(CT)
arena_pool_kernel(uint8_t* arena_buf, const int* d, const uint8_t* w,
                  uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  run_tiles<true>(arena_buf, d, w, gws, smem, ArenaRows{});
}

// (arena, descriptor, null, workspace (counters first), dynamic shared
// bytes, CTAs to launch at most, tiles that must run at once (one output
// row's), counter bytes, stream): arena_common.cuh's launch_grid.
extern "C" int arena_pool(void* arena_buf, const void* desc, const void* w,
                          void* gws, int smem, int grid, int tpr,
                          int counter_bytes, void* stream) {
  return launch_grid<CT>(arena_pool_kernel, launch_state, arena_buf, desc, w,
                         gws, smem, grid, tpr, counter_bytes, stream);
}
