// arena_mean: mean over a set of axes (global average pool of the head), in
// place on the arena (flat or row-blocked), over the whole card. int8:
// int32 sum, (f32 sum / count) - x_zp, then the shared requantisation;
// f32: sum / count.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_mean_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: bytes, a few KB to a few hundred KB in
// (resnet_50_v2's 7x7x2048 f32 head, 401 KB, 0.12 us at 3.35 TB/s) and a
// few KB out; what it takes is the launch and one output's chain of loads.
// The body is ew_tiles.cuh's grid: one thread an output, MEAN_BATCH of
// its loads in flight, chunks of 128 outputs over the SMs (16 on
// resnet_50_v2), each output summed in one fixed order (r ascending, the
// reduced axes last axis fastest, as the one-CTA kernel it replaces
// summed), so f32 results are unchanged and equal across the programs. The output may overlap the input (on the flat
// heads both start at the same byte): the descriptor's order word
// (arena_ops.mean_order) is 1 when every output element's bytes hold only
// inputs of its own reduction, which its thread reads before it stores
// (the flat heads), 0 when they are disjoint (the blocked and streaming
// heads), else 2: every chunk stages its outputs before one grid-wide
// barrier on a cooperative grid the entry point refuses, never shrinks,
// on a card that cannot hold it (paper §III.F).
#include "ew_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

__global__ void __launch_bounds__(NT)
arena_mean_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                  uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  mean_grid(d, arena_buf, gws, smem);
}

// (arena, descriptor, null, workspace (order 2: the barrier counter, then
// any global staging), dynamic shared bytes, CTAs to launch at most, CTAs
// that must run at once (order 2: all of them; else 0), counter bytes,
// stream): arena_common.cuh's launch_grid.
extern "C" int arena_mean(void* arena_buf, const void* desc, const void* w,
                          void* gws, int smem, int grid, int group,
                          int counter_bytes, void* stream) {
  return launch_grid<NT>(arena_mean_kernel, launch_state, arena_buf, desc,
                         w, gws, smem, grid, group, counter_bytes, stream);
}
