// arena_softmax: softmax over the last axis on the arena (flat or
// row-blocked), over the whole card. int8: dequantise, subtract the row
// max, expf, divide by the row sum, quantise (IEEE division by the output
// scale); f32: the same without the casts.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_softmax_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: bytes (a 1,000-class row: 1 to 4 KB in and out, far
// below a microsecond; 1,024 such rows f32: 8.2 MB, 2.4 us at 3.35 TB/s).
// The body is softmax_tiles.cuh's grid: one warp a row (a CTA a row past
// 1,024 values), its values in registers from the max to the store, each
// exp once, warp-shuffle reductions, 16-byte loads and stores where the
// addressing allows; rows go to CTAs first, so a few rows take a few SMs.
// The output may overlap the input (the flagship runs it in place): the
// descriptor's order word (arena_ops.softmax_order) lets a row that only
// overwrites its own input store as it finishes, and makes any other
// overlap stage every result before one grid-wide barrier on a
// cooperative grid the entry point refuses, never shrinks, on a card that
// cannot hold it (paper §III.F).
#include "softmax_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

__global__ void __launch_bounds__(NT)
arena_softmax_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                     uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  softmax_grid(d, arena_buf, gws, smem);
}

// (arena, descriptor, null, workspace (order 2: the barrier counter, then
// the results; a staged row's global slices), dynamic shared bytes, CTAs to
// launch at most, CTAs that must run at once (order 2: all of them; else
// 0), counter bytes, stream): arena_common.cuh's launch_grid.
extern "C" int arena_softmax(void* arena_buf, const void* desc,
                             const void* w, void* gws, int smem, int grid,
                             int group, int counter_bytes, void* stream) {
  return launch_grid<NT>(arena_softmax_kernel, launch_state, arena_buf, desc,
                         w, gws, smem, grid, group, counter_bytes, stream);
}

// launch_floor, a second entry point of this library (build.entry): an
// empty kernel of NT threads through the same launch_grid, the floor a
// launch of one arena op cannot go under (the occupancy query, the memset
// of any counters, the launch and, with `group` > 0, a cooperative launch
// of resident CTAs). It ports no TPU kernel: chip_smoke.py times it beside
// the kernels that run on one CTA or a few.
namespace {
GridLaunch floor_state;
}  // namespace

__global__ void __launch_bounds__(NT)
launch_floor_kernel(uint8_t*, const int*, const uint8_t*, uint8_t*) {}

extern "C" int launch_floor(void* arena_buf, const void* desc, const void* w,
                            void* gws, int smem, int grid, int group,
                            int counter_bytes, void* stream) {
  return launch_grid<NT>(launch_floor_kernel, floor_state, arena_buf, desc,
                         w, gws, smem, grid, group, counter_bytes, stream);
}
