// arena_stream_fused: a fused band chain in the streaming program. The
// chain's external input blocks are copied from the arena into their slots
// of the chain's scratch (planner.fused_slots with include_io: inputs,
// chain-internal tensors and the terminal output all packed there), every
// stage runs inside the scratch, and the terminal output block is copied
// back to the arena once.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_stream_fused_kernel
// (apply_op -> _apply_stream, the fused branch). The stages are
// arena_fused_chain's routine (chain_run) with every operand's scratch
// flag set. The scratch of max(scratch_rows, win_rows) rows sits in shared
// memory when it fits with the stage and row buffers (the flagship int8's
// 49,152 B) and otherwise in the global workspace (the flagship f32's
// 229,376 B takes shared memory and sends the stage and row buffers to
// the workspace; mobilenet_v2_1.0_224's 5.4 MB goes to the workspace).
//
// Bound on this card: the chain's own bytes and operations are those of
// the blocked chain; the staging copies its input blocks in and its output
// block out. One CTA, for the order of paper §III.F: stages in graph
// order, each stage's rows ascending.
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_stream_fused_kernel(uint8_t* arena_buf, const int* sd,
                          const uint8_t* wblob, uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int* h = sd + sd[S_BODY];
  uint8_t* scratch = buffer(sd, S_WIN_G, smem, gws);
  stage_blocks_in(sd, arena_buf, scratch);
  chain_run(h, arena_buf, scratch, wblob, buffer(h, D_STAGE_G, smem, gws),
            buffer(h, D_ROW_G, smem, gws));
  stage_block_out(sd, arena_buf, scratch);
}

ARENA_ENTRY(arena_stream_fused, arena_stream_fused_kernel)
