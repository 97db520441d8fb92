// arena_matmul: y = a . b with both operands in the arena (flat or
// row-blocked; (M, K) x (K, N)). int8: an int32 dot of (a - a_zp) * (b -
// b_zp), then the shared requantisation; f32: an f32 dot.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_matmul_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: at the shapes the zoo's graphs give it ((16, 8) x
// (8, 2)) a few hundred bytes and operations, far below a microsecond by
// either bound; the kernel is bound by its launch. One CTA because the
// output may overlap an operand: every output element is computed into a
// staging buffer (shared memory, or the global workspace past 227 KB), then
// a barrier, then the result is copied out (read-all-before-write-all).
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_matmul_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                    uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  matmul_op(d, arena_buf, buffer(d, D_STAGE_G, smem, gws));
}

ARENA_ENTRY(arena_matmul, arena_matmul_kernel)
