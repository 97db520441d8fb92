// arena_stream_stage: a whole-block op (elementwise, concat, pad, matmul,
// mean, fully connected, softmax) in the streaming program. Every operand
// block is copied from the arena into its packed slot of a window buffer
// (planner.staged_slots: inputs back to back, the output last), the op runs
// on the window with its output in the output slot, and the output block
// is copied back to the arena in one copy.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_stream_stage_kernel
// with ::_StreamStageMem (apply_op -> _apply_stream, the staged branch):
// its VMEM scratch is the window buffer here, in shared memory when it
// fits beside the op's own staging buffer and otherwise in the global
// workspace.
//
// Order: every block is read before anything is written, then the whole
// output block is written, the blocked kernels' read-all-before-write-all,
// so an output placed over an input behaves as in the row-blocked program.
// The op's body is the blocked kernel's routine (block_op) with the
// descriptor's offsets rebased to the window.
//
// Bound on this card: the op's own bytes are those of the blocked kernel;
// the staging copies its operand blocks in and its output block out
// (padding rows included). One CTA, bound by one SM's load and store rate.
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_stream_stage_kernel(uint8_t* arena_buf, const int* sd,
                          const uint8_t* w, uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int* d = sd + sd[S_BODY];
  uint8_t* win = buffer(sd, S_WIN_G, smem, gws);
  stage_blocks_in(sd, arena_buf, win);
  block_op(d, win, w, buffer(d, D_STAGE_G, smem, gws));
  stage_block_out(sd, arena_buf, win);
}

ARENA_ENTRY(arena_stream_stage, arena_stream_stage_kernel)
