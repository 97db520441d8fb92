// arena_elementwise: relu, relu6, sigmoid, identity, add, mul and sub on the
// arena (flat or row-blocked), the second operand broadcast when its element
// count differs, over the whole card. int8: dequantise each operand, compute
// in f32, quantise at the output's params (IEEE division, rintf); sigmoid
// uses expf and an IEEE divide (no fast math).
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_elementwise_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: bytes (resnet_50_v2's largest add reads two and
// writes one 3.2 MB f32 tensor, about 3 us at 3.35 TB/s). The body is
// ew_tiles.cuh's grid: 16-byte units in chunks over every SM, each element
// dequantised, computed and quantised on its own. The reference writes its
// whole output only after reading all of its operands (an add written over its
// own input, or diagonally below or above it); the descriptor's order word
// keeps that: disjoint operands and an output that is its input element for
// element store as they go, any other overlap stages every chunk's results
// before one grid-wide barrier (a cooperative launch of resident CTAs,
// refused, never shrunk, on a card that cannot hold them).
#include "ew_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;
}  // namespace

__global__ void __launch_bounds__(NT)
arena_elementwise_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                         uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  ew_grid(d, arena_buf, gws, smem);
}

// (arena, descriptor, null, workspace (order 2: the barrier counter, then
// any global staging), dynamic shared bytes, CTAs to launch at most, CTAs
// that must run at once (order 2: all of them; else 0), counter bytes,
// stream): arena_common.cuh's launch_grid.
extern "C" int arena_elementwise(void* arena_buf, const void* desc,
                                 const void* w, void* gws, int smem,
                                 int grid, int group, int counter_bytes,
                                 void* stream) {
  return launch_grid<NT>(arena_elementwise_kernel, launch_state, arena_buf,
                         desc, w, gws, smem, grid, group, counter_bytes,
                         stream);
}
