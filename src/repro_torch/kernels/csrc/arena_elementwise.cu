// arena_elementwise: relu, relu6, sigmoid, identity, add, mul and sub on the
// arena (flat or row-blocked), the second operand broadcast when its element
// count differs. int8: dequantise each operand, compute in f32, quantise at
// the output's params (IEEE division, rintf); sigmoid uses expf and an IEEE
// divide (no fast math).
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_elementwise_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: bytes (resnet_50_v2's largest add reads two and
// writes one 3.2 MB f32 tensor, about 3 us at 3.35 TB/s); the kernel is
// bound by one SM's load and store rate. One CTA because the output may
// overlap an operand diagonally (a residual add written over its own
// input): the whole result is computed into a staging buffer (shared
// memory, or the global workspace past 227 KB), then a barrier, then it is
// copied out, the reference's read-all-before-write-all order.
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_elementwise_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                         uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  elementwise_op(d, arena_buf, nullptr, buffer(d, D_STAGE_G, smem, gws));
}

ARENA_ENTRY(arena_elementwise, arena_elementwise_kernel)
