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
  uint8_t* stage = buffer(d, D_STAGE_G, smem, gws);
  const bool q = d[D_QUANT] != 0;
  const int m = d[D_M], idim = d[D_IDIM], odim = d[D_ODIM];
  stage_in(stage, arena_buf + d[D_IN_OFF], load_addr(d, 1), m * idim, q);
  __syncthreads();  // x is read whole before any output is written
  const int x_zp = d[D_X_ZP];
  write_block(arena_buf + d[D_OUT_OFF], load_addr(d, 0), m * odim, q,
              [&](int e) -> uint32_t {
    const int r = e / odim, o = e - r * odim;
    if (q) {
      const int8_t* x = (const int8_t*)stage + r * idim;
      int acc = 0;
      for (int i = 0; i < idim; ++i)
        acc += ((int)x[i] - x_zp) * (int)((const int8_t*)w)[i * odim + o];
      return (uint8_t)requant_i(acc, fword(d, D_AMULT), d[D_Y_ZP]);
    }
    const float* x = (const float*)stage + r * idim;
    float acc = 0.0f;
    for (int i = 0; i < idim; ++i)
      acc += x[i] * ((const float*)w)[i * odim + o];
    return __float_as_uint(acc);
  });
}

ARENA_ENTRY(arena_fully_connected, arena_fc_kernel)
