// arena_pad: a constant pad on the arena (flat or row-blocked), over the
// whole card. f32 pads with 0; int8 pads with the input's zero point and
// then rescales the whole padded tensor to the output's params
// (ops.rescale_q), as the reference does.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_pad_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over _BlockMem in the
// row-blocked program); arena_stream_stage runs the same body on a staged
// pad of the streaming program, in place on the arena.
//
// Bound on this card: bytes (the input read once, the padded output
// written once: a few KB on the graphs that lower one, 3.3 MB on a
// ResNet50 stem's (112, 112, 64) f32 pad, about 2 us at 3.35 TB/s). The
// body is ew_tiles.cuh's grid: the output's block in 16-byte units (where
// the innermost axis keeps a unit wholly inside or wholly outside the
// input's box and both operands' rows and bases allow) in chunks over
// every SM, each output element read from the input element at its
// coordinate less the leading pads, or the pad value. The planner may
// place the output over its input: the descriptor's order word
// (arena_ops.pad_order) is 0 when the two do not meet (every pad the
// port's programs lower), and chunks store as they go; otherwise 2, every
// chunk stages its results before one grid-wide barrier (a cooperative
// launch of resident CTAs, refused, never shrunk, on a card that cannot
// hold them).
#include "ew_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

__global__ void __launch_bounds__(NT)
arena_pad_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                 uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  pad_grid(d, arena_buf, gws, smem);
}

// (arena, descriptor, null, workspace (order 2: the barrier counter, then
// any global staging), dynamic shared bytes, CTAs to launch at most, CTAs
// that must run at once (order 2: all of them; else 0), counter bytes,
// stream): arena_common.cuh's launch_grid.
extern "C" int arena_pad(void* arena_buf, const void* desc, const void* w,
                         void* gws, int smem, int grid, int group,
                         int counter_bytes, void* stream) {
  return launch_grid<NT>(arena_pad_kernel, launch_state, arena_buf, desc, w,
                         gws, smem, grid, group, counter_bytes, stream);
}
