// arena_fully_connected: y = x . W on the flat byte arena. int8: x and W
// (symmetric, zero point 0) in an int32 dot of (x - x_zp) * w, then the
// shared requantisation; f32: an f32 dot.
//
// Replaces the TPU kernel
// src/repro/kernels/arena_ops.py::_fully_connected_kernel (apply_op ->
// _plain_kernel over _FlatMem).
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
                uint8_t* gstage) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stage = gstage ? gstage : smem;
  const bool q = d[D_QUANT] != 0;
  const int m = d[D_M], idim = d[D_IDIM], odim = d[D_ODIM];
  stage_in(stage, arena_buf + d[D_IN_OFF], m * idim * (q ? 1 : 4));
  __syncthreads();  // x is read whole before any output is written
  uint8_t* out = arena_buf + d[D_OUT_OFF];
  const int x_zp = d[D_X_ZP];
  for (int e = threadIdx.x; e < m * odim; e += NT) {
    const int r = e / odim, o = e - r * odim;
    if (q) {
      const int8_t* x = (const int8_t*)stage + r * idim;
      int acc = 0;
      for (int i = 0; i < idim; ++i)
        acc += ((int)x[i] - x_zp) * (int)((const int8_t*)w)[i * odim + o];
      ((int8_t*)out)[e] = requant_i(acc, fword(d, D_AMULT), d[D_Y_ZP]);
    } else {
      const float* x = (const float*)stage + r * idim;
      float acc = 0.0f;
      for (int i = 0; i < idim; ++i)
        acc += x[i] * ((const float*)w)[i * odim + o];
      ((float*)out)[e] = acc;
    }
  }
}

extern "C" int arena_fully_connected(void* arena_buf, const void* desc,
                                     const void* w, void* gstage, int smem,
                                     void* stream) {
  static int configured = 0;
  cudaError_t e = set_smem(arena_fc_kernel, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  arena_fc_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      (uint8_t*)arena_buf, (const int*)desc, (const uint8_t*)w,
      (uint8_t*)gstage);
  return (int)cudaGetLastError();
}
