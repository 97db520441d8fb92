// arena_pool: max or average pooling in place on the arena (flat or
// row-blocked), int8 or f32. Average is over the valid taps of each window;
// int8 max requantises acc - x_zp, int8 avg acc / max(cnt, 1) - x_zp (in f32),
// both with the shared requantisation.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_pool_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: bytes, at a few MB per op (resnet_50_v2's 3x3/2 max
// pool reads 3.2 MB of f32), a microsecond by the byte bound; the kernel is
// bound by its one CTA walking output rows with two barriers per row. One
// CTA because the planner may overlap the pool's output with its input
// diagonally (paper §III.F): rows go in ascending order, each staged in a
// row buffer (shared memory, or the global workspace) until every read of
// that row is done.
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_pool_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                  uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  row_op(d, arena_buf, nullptr, nullptr, buffer(d, D_ROW_G, smem, gws));
}

ARENA_ENTRY(arena_pool, arena_pool_kernel)
