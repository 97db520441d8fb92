// arena_matmul: y = a . b with both operands in the arena (flat or
// row-blocked; (M, K) x (K, N)), over the whole card. int8: an int32 dot
// of (a - a_zp) * (b - b_zp), then the shared requantisation; f32: an f32
// dot on the FMA units (no TF32).
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_matmul_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: at the zoo's shape ((16, 8) x (8, 2), the reference's
// test graph) a few hundred bytes and operations, far below a microsecond;
// at (1024, 1024, 1024) f32 operations, 32 us at 67 TFLOP/s. The body is
// fc_tiles.cuh's grid, arena_fully_connected's, with b read from the arena
// at its addressing: column blocks x K slices, and row blocks where M is
// large (each warp four rows of a over the whole slice in registers), the
// slices' partials summed in a fixed order (f32 results depend on (M, K,
// N) only). The output may overlap an operand: the descriptor's order word
// (arena_ops.matmul_order) then makes every CTA read both and compute its
// partials before one grid-wide barrier, and only then store (paper
// §III.F), on a cooperative grid the entry point refuses, never shrinks,
// on a card that cannot hold it.
#include "fc_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

// two CTAs an SM (at most 64 registers a thread)
__global__ void __launch_bounds__(NT, 2)
arena_matmul_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                    uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  matmul_grid(d, arena_buf, gws, smem);
}

// (arena, descriptor, null, workspace (the counters, then the partials),
// dynamic shared bytes, CTAs to launch at most, CTAs that must run at once
// (order 2: all of them; else 0), counter bytes, stream):
// arena_common.cuh's launch_grid.
extern "C" int arena_matmul(void* arena_buf, const void* desc,
                            const void* w, void* gws, int smem, int grid,
                            int group, int counter_bytes, void* stream) {
  return launch_grid<NT>(arena_matmul_kernel, launch_state, arena_buf, desc,
                         w, gws, smem, grid, group, counter_bytes, stream);
}
