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
// - A fully connected body also runs in place on the arena over the whole
//   card (fc_tiles.cuh, arena_fully_connected's grid body): W's column
//   blocks x K slices, its order word from the arena byte ranges of x and
//   the output. Its f32 sums follow the same fixed order as the blocked
//   kernel's, so the streaming arena stays bit-equal to the blocked one.
//   Bound: bytes (W's).
// - Any other body (softmax, pad, matmul) keeps the one-CTA staged walk:
//   every operand block is copied from the arena into its packed slot of a
//   window buffer (planner.staged_slots: inputs back to back, the output
//   last; the reference's VMEM scratch, here in shared memory when it fits
//   beside the op's own staging buffer and otherwise in the global
//   workspace), the blocked kernel's routine (block_op) runs on the window
//   with the descriptor's offsets rebased to it, and the output block is
//   copied back in one copy. Every block is read before anything is
//   written. The wrapper launches one CTA for it; it is bound by one SM's
//   load and store rate.
#include "ew_tiles.cuh"
#include "fc_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
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
  }
  uint8_t* win = buffer(sd, S_WIN_G, smem, gws);
  stage_blocks_in(sd, arena_buf, win);
  block_op(d, win, buffer(d, D_STAGE_G, smem, gws));
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
