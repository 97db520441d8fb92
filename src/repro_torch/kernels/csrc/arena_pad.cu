// arena_pad: constant padding on the arena (flat or row-blocked). f32 pads
// with 0; int8 pads with the input's zero point and then rescales the whole
// padded tensor to the output's params (ops.rescale_q), as the reference does.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_pad_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: bytes (the input read once, the padded output written
// once: a few KB on the graphs that use it), far below a microsecond; the
// kernel is bound by its launch. One CTA because the padded output may
// overlap its input: the whole output is computed into a staging buffer
// (shared memory, or the global workspace past 227 KB), then a barrier,
// then it is copied out (read-all-before-write-all).
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_pad_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                 uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stage = buffer(d, D_STAGE_G, smem, gws);
  const bool q = d[D_QUANT] != 0;
  const int n = d[D_PN];
  const uint8_t* in = arena_buf + d[D_IN_OFF];
  const int x_zp = d[D_X_ZP], y_zp = d[D_Y_ZP];
  const float mult = fword(d, D_AMULT);
  const Addr ia = load_addr(d, 1);
  for (int e = threadIdx.x; e < n; e += NT) {
    int rem = e, idx = 0, stride = 1;
    bool inside = true;
    for (int i = 3; i >= 0; --i) {
      const int od = d[D_POUT0 + i], id = d[D_PIN0 + i];
      const int c = rem % od - d[D_PLO0 + i];
      rem /= od;
      inside = inside && c >= 0 && c < id;
      idx += c * stride;
      stride *= id;
    }
    if (inside) idx = elem_at(ia, idx);
    if (q) {
      const int x = inside ? (int)((const int8_t*)in)[idx] : x_zp;
      ((int8_t*)stage)[e] = requant_i(x - x_zp, mult, y_zp);
    } else {
      ((float*)stage)[e] = inside ? ((const float*)in)[idx] : 0.0f;
    }
  }
  __syncthreads();  // the input is read before any output byte is written
  store_block(arena_buf + d[D_OUT_OFF], load_addr(d, 0), stage, n, q);
}

ARENA_ENTRY(arena_pad, arena_pad_kernel)
