// arena_fused_chain: one launch runs a fused band chain's stages in graph
// order (op-major when batched): band convs, depthwise convs, pools and
// elementwise ops whose chain-internal tensors live in a scratch buffer,
// then the terminal stage (the reassembling concat, each int8 input
// rescaled to the output's params) that alone writes the arena.
//
// Replaces the TPU kernels src/repro/kernels/arena_ops.py::_fused_kernel
// with _RoutedFlatMem or, in the row-blocked program, _RoutedBlockMem (the
// stages) and ::_concat_kernel with ::_rescale (the terminal concat),
// reached through apply_op. In the row-blocked program the scratch is a
// typed (scratch_rows, L) block addressed like the arena.
//
// Three buffers, each in dynamic shared memory when it fits beside the ones
// before it (at most 232,448 bytes in all) and otherwise in the global
// workspace the wrapper allocates once per spec; the header says where:
// the scratch (the flagship's 25,600 B int8 and 102,400 B f32 chains fit;
// mobilenet_v1_1.0_224_8bit's 308,224 B and mobilenet_v2_1.0_224's
// 1,849,344 B do not), the staging buffer of the whole-block stages
// (concat, elementwise), and the row buffer of the row stages (conv,
// depthwise, pool).
//
// Bound on this card: the chain moves a few tens of KB to a few MB and does
// a few MMACs to a few hundred, microseconds by either bound; the kernel is
// bound by running its stages row after row in one CTA. One CTA is the
// paper's §III.F choice: stages must run in order, and each stage's rows in
// ascending order, for the planner's overlaps (chain input and output share
// arena bytes) to hold.
#include "arena_common.cuh"

using namespace arena;

// desc: a header of DESC_WORDS words (word 0 = stage count, the buffer
// placement words), then one DESC_WORDS descriptor per stage.
__global__ void __launch_bounds__(NT)
arena_fused_chain_kernel(uint8_t* arena_buf, const int* desc,
                         const uint8_t* wblob, uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  chain_run(desc, arena_buf, buffer(desc, D_SCR_G, smem, gws), wblob,
            buffer(desc, D_STAGE_G, smem, gws),
            buffer(desc, D_ROW_G, smem, gws));
}

ARENA_ENTRY(arena_fused_chain, arena_fused_chain_kernel)
