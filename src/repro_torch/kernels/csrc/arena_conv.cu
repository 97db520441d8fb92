// arena_conv: conv2d and depthwise conv2d (channel multiplier) in place on
// the arena (flat or row-blocked: plain, packed or spanning image rows),
// int8 (int32 accumulation + f32 requantisation) or f32, over the whole
// card.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_conv_kernel,
// reached through apply_op -> _plain_kernel over _FlatMem (the flat byte
// program of the Pallas backend) or _BlockMem (the row-blocked program);
// and, on one row-blocked spec, the standalone in-place depthwise conv
// src/repro/kernels/dmo_arena_dwconv.py::dmo_dwconv2d_arena.
//
// Bound on this card: operations for the wide convs (resnet_50_v2's 3.86
// GMAC at 67 TFLOP/s f32), bytes for the flagship's small int8 ones. The
// design spreads an op over every SM in row tiles whose stores wait for
// the reads they could clobber (§III.F), each output in conv_point's
// order (f32 bit-equal to the fused chain's row walk); conv_tiles.cuh
// holds it, shared with arena_stream_roll. Here a footprint row is read
// where the operand's addressing puts it, and rows wait one at a time
// (groups of one row) where a later row reads an earlier row's store.
#include "conv_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

__global__ void __launch_bounds__(CT)
arena_conv_kernel(uint8_t* arena_buf, const int* d, const uint8_t* w,
                  uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  run_tiles<false>(arena_buf, d, w, gws, smem, ArenaRows{});
}

// (arena, descriptor, filter, workspace (counters first), dynamic shared
// bytes, CTAs to launch at most, tiles of one output row, counter bytes,
// stream): arena_common.cuh's launch_grid.
extern "C" int arena_conv(void* arena_buf, const void* desc, const void* w,
                          void* gws, int smem, int grid, int tpr,
                          int counter_bytes, void* stream) {
  return launch_grid<CT>(arena_conv_kernel, launch_state, arena_buf, desc, w,
                         gws, smem, grid, tpr, counter_bytes, stream);
}
