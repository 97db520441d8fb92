// arena_concat: a standalone concat on the arena (flat or row-blocked),
// over the whole card, each int8 input rescaled to the output's params
// (ops.rescale_q: the shared requantisation of x - zp by the f32 ratio of
// the scales).
//
// Replaces the TPU kernels src/repro/kernels/arena_ops.py::_concat_kernel
// with ::_rescale (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program); the fused chains run the same
// chunk body on their concat stages (chain_tiles.cuh).
//
// Bound on this card: bytes (densenet_121's widest concat writes 3.2 MB of
// f32, about 2 us read and written at 3.35 TB/s). The body is
// ew_tiles.cuh's grid: the output's block in 16-byte units (where every
// input's columns and every operand's rows and base allow) in chunks over
// every SM, each output element read from the input whose column range
// holds it. The planner may place the output over an input: the
// descriptor's order word (arena_ops.concat_order) is 0 when no input
// meets the output (every concat of the Table III zoo), and chunks store
// as they go; otherwise 2, every chunk stages its results before one
// grid-wide barrier (a cooperative launch of resident CTAs, refused,
// never shrunk, on a card that cannot hold them).
#include "ew_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

__global__ void __launch_bounds__(NT)
arena_concat_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                    uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  cat_grid(d, arena_buf, gws, smem);
}

// (arena, descriptor, null, workspace (order 2: the barrier counter, then
// any global staging), dynamic shared bytes, CTAs to launch at most, CTAs
// that must run at once (order 2: all of them; else 0), counter bytes,
// stream): arena_common.cuh's launch_grid.
extern "C" int arena_concat(void* arena_buf, const void* desc,
                            const void* w, void* gws, int smem, int grid,
                            int group, int counter_bytes, void* stream) {
  return launch_grid<NT>(arena_concat_kernel, launch_state, arena_buf, desc,
                         w, gws, smem, grid, group, counter_bytes, stream);
}
