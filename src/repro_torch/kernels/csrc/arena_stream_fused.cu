// arena_stream_fused: a fused band chain in the streaming program, on
// arena_fused_chain's grid (chain_tiles.cuh). The reference copies the
// chain's external input blocks into its scratch slots (planner.fused_slots
// with include_io), runs every stage there and copies the terminal output
// block back; here the stages read the external inputs in place at their
// arena rows and the terminal stage writes the output block straight to
// the arena, as the row-blocked chain does, so there is no window and the
// final arena stays bit-equal to the row-blocked program's. The chain's
// internal tensors each take a region of the workspace.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_stream_fused_kernel
// (apply_op -> _apply_stream, the fused branch).
//
// Bound on this card: the chain's own bytes and operations, those of the
// row-blocked chain. The design is arena_fused_chain's: levels of row
// tiles and chunks over every SM with a grid barrier between levels.
#include "chain_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

__global__ void __launch_bounds__(CT, 2)
arena_stream_fused_kernel(uint8_t* arena_buf, const int* sd,
                          const uint8_t* wblob, uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  chain_grid(sd + sd[S_BODY], arena_buf, wblob, gws, smem);
}

// (arena, streaming descriptor, filter blob, workspace, dynamic shared
// bytes, CTAs, CTAs that must run at once, counter bytes, stream):
// arena_common.cuh's launch_grid.
extern "C" int arena_stream_fused(void* arena_buf, const void* desc,
                                  const void* w, void* gws, int smem,
                                  int grid, int group, int counter_bytes,
                                  void* stream) {
  return launch_grid<CT>(arena_stream_fused_kernel, launch_state, arena_buf,
                         desc, w, gws, smem, grid, group, counter_bytes,
                         stream);
}
