// arena_stream_stage: a whole-block op (elementwise, concat, pad, matmul,
// mean, fully connected, softmax) in the streaming program.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_stream_stage_kernel
// with ::_StreamStageMem (apply_op -> _apply_stream, the staged branch).
//
// - An elementwise, concat or mean body runs in place on the arena over the
//   whole card (ew_tiles.cuh's grid bodies, those of arena_elementwise,
//   arena_concat and arena_mean; its descriptor carries arena offsets and
//   no window). The reference's window slot was written whole, padding
//   zeroed, and copied back row for row; the in-place bodies write the
//   same padded block. Their order words, from the operands' arena byte
//   ranges, keep read-all-before-write-all: an output placed over an input
//   behaves as in the row-blocked program. A mean sums in the blocked
//   kernel's order, so the streaming arena stays bit-equal to the blocked
//   one. Bound: bytes.
// - A softmax body also runs in place on the arena over the whole card
//   (softmax_tiles.cuh, arena_softmax's grid body): a warp a row (a CTA a
//   row past 1,024 values), its order word from the arena byte ranges of
//   the input and the output. Its sums follow the blocked kernel's fixed
//   order, so the streaming arena stays bit-equal to the blocked one.
//   Bound: bytes.
// - A fully connected or matmul body also runs in place on the arena over
//   the whole card (fc_tiles.cuh, arena_fully_connected's and
//   arena_matmul's grid body): b's column blocks x K slices (x row blocks
//   of a matmul's many rows), its order word from the arena byte ranges of
//   the operands and the output. Its f32 sums follow the same fixed order
//   as the blocked kernel's, so the streaming arena stays bit-equal to the
//   blocked one. Bound: bytes (W's) for an FC.
// - A pad keeps the one-CTA staged walk: every operand block is copied
//   from the arena into its packed slot of a window buffer
//   (planner.staged_slots: inputs back to back, the output last; the
//   reference's VMEM scratch, here in shared memory when it fits beside
//   the op's own staging buffer and otherwise in the global workspace),
//   the blocked kernel's routine (pad_op) runs on the window with the
//   descriptor's offsets rebased to it, and the output block is copied
//   back in one copy. Every block is read before anything is written. The
//   wrapper launches one CTA for it; it is bound by one SM's load and
//   store rate.
#include "ew_tiles.cuh"
#include "fc_tiles.cuh"
#include "softmax_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;

// The softmax body out of line: a warp row's 32 values a lane exceed this
// kernel's 64 registers, and its spills stay in this function's frame
// rather than in the other bodies' allocation.
__device__ __noinline__ void softmax_body(const int* d, uint8_t* arena,
                                          uint8_t* gws, uint8_t* smem) {
  softmax_grid(d, arena, gws, smem);
}
}  // namespace

// two CTAs an SM (at most 64 registers a thread)
__global__ void __launch_bounds__(NT, 2)
arena_stream_stage_kernel(uint8_t* arena_buf, const int* sd,
                          const uint8_t* w, uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int* d = sd + sd[S_BODY];
  switch (d[D_KIND]) {
    case K_ELEMENTWISE: ew_grid(d, arena_buf, gws, smem); return;
    case K_CONCAT: cat_grid(d, arena_buf, gws, smem); return;
    case K_MEAN: mean_grid(d, arena_buf, gws, smem); return;
    case K_FC: fc_grid(d, arena_buf, w, gws, smem); return;
    case K_MATMUL: matmul_grid(d, arena_buf, gws, smem); return;
    case K_SOFTMAX: softmax_body(d, arena_buf, gws, smem); return;
  }
  uint8_t* win = buffer(sd, S_WIN_G, smem, gws);
  stage_blocks_in(sd, arena_buf, win);
  pad_op(d, win, buffer(d, D_STAGE_G, smem, gws));
  __syncthreads();
  stage_block_out(sd, arena_buf, win);
}

// (arena, streaming descriptor, filter or null, workspace, dynamic shared
// bytes, CTAs to launch at most (1 for a staged walk), CTAs that must run
// at once (an order-2 grid body: all of them; else 0), counter bytes,
// stream): arena_common.cuh's launch_grid.
extern "C" int arena_stream_stage(void* arena_buf, const void* desc,
                                  const void* w, void* gws, int smem,
                                  int grid, int group, int counter_bytes,
                                  void* stream) {
  return launch_grid<NT>(arena_stream_stage_kernel, launch_state, arena_buf,
                         desc, w, gws, smem, grid, group, counter_bytes,
                         stream);
}
