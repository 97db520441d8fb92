// arena_fully_connected: y = x . W on the arena (flat or row-blocked). int8: x
// and W (symmetric, zero point 0) in an int32 dot of (x - x_zp) * w, then the
// shared requantisation; f32: an f32 dot.
//
// Replaces the TPU kernel
// src/repro/kernels/arena_ops.py::_fully_connected_kernel (apply_op ->
// _plain_kernel over _FlatMem, and over _BlockMem in the row-blocked
// program).
//
// Bound on this card: the weights dominate the bytes (256 x 1000 int8 on
// the flagship, 0.26 MB: about 0.08 us at 3.35 TB/s), so by bytes it is
// memory-bound; in practice one CTA reading W at a single SM's rate bounds
// it. One CTA because the output may overlap the input (on the flagship the
// 1000-byte output at byte 0 covers the input's first byte, 999): x is
// staged whole before any output is written (paper §III.F).
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_fc_kernel(uint8_t* arena_buf, const int* d, const uint8_t* w,
                uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  fc_op(d, arena_buf, w, buffer(d, D_STAGE_G, smem, gws));
}

ARENA_ENTRY(arena_fully_connected, arena_fc_kernel)
