// arena_fused_chain: one launch runs a fused band chain (op-major when
// batched: band convs, depthwise convs, pools and elementwise ops whose
// chain-internal tensors never touch the arena, then the terminal stage,
// the reassembling concat with each int8 input rescaled to the output's
// params, that alone writes the arena) over the whole card.
//
// Replaces the TPU kernels src/repro/kernels/arena_ops.py::_fused_kernel
// with _RoutedFlatMem or, in the row-blocked program, _RoutedBlockMem (the
// stages) and ::_concat_kernel with ::_rescale (the terminal concat),
// reached through apply_op.
//
// Bound on this card: the chain moves a few tens of KB to a few MB and
// does a few MMACs to a few hundred (bytes on the flagship's int8 chain,
// 15 ns; operations on mobilenet_v1_1.0_224's and mobilenet_v2_1.0_224's).
// The one-CTA row walk this replaced took 0.18 ms on the flagship, every
// output row behind two barriers on one SM. The design (chain_tiles.cuh):
// every chain-internal tensor in a workspace region of its own, so the
// stages that do not depend on each other run at once as one level of row
// tiles and chunks over every SM, a grid barrier between levels, and the
// terminal stage, which may overwrite the chain input in the arena
// (§III.F), after the last barrier.
#include "chain_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

// desc: a header of DESC_WORDS words (arena_ops.chain_schedule's levels,
// the buffer placement words), then one DESC_WORDS descriptor per stage in
// level order.
__global__ void __launch_bounds__(CT, 2)
arena_fused_chain_kernel(uint8_t* arena_buf, const int* desc,
                         const uint8_t* wblob, uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  chain_grid(desc, arena_buf, wblob, gws, smem);
}

// (arena, descriptor, filter blob, workspace (counters, regions, global
// slices), dynamic shared bytes, CTAs, CTAs that must run at once (all of
// them), counter bytes, stream): arena_common.cuh's launch_grid.
extern "C" int arena_fused_chain(void* arena_buf, const void* desc,
                                 const void* w, void* gws, int smem,
                                 int grid, int group, int counter_bytes,
                                 void* stream) {
  return launch_grid<CT>(arena_fused_chain_kernel, launch_state, arena_buf,
                         desc, w, gws, smem, grid, group, counter_bytes,
                         stream);
}
