// arena_mean: mean over a set of axes (global average pool of the head), in
// place on the arena (flat or row-blocked). int8: int32 sum, (f32 sum /
// count) - x_zp, then the shared requantisation; f32: sum / count.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_mean_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: a few KB to a few hundred KB in (resnet_50_v2's
// 7x7x2048 f32 head, 401 KB) and a few KB out, so both bounds are at most
// a fraction of a microsecond; the kernel is bound by its one CTA and
// launch. One CTA because the output may overlap the input (on the
// flagship both start at byte 999): the whole input is staged (shared
// memory, or the global workspace when it does not fit) before any output
// byte is written (paper §III.F).
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_mean_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                  uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stage = buffer(d, D_STAGE_G, smem, gws);
  const bool q = d[D_QUANT] != 0;
  int dims[4], stride[4], total = 1;
  for (int i = 3; i >= 0; --i) {
    dims[i] = d[D_DIM0 + i];
    stride[i] = total;
    total *= dims[i];
  }
  stage_in(stage, arena_buf + d[D_IN_OFF], load_addr(d, 1), total, q);
  __syncthreads();  // the whole input is read before any output is written
  const int rmask = d[D_RMASK], cnt = d[D_CNT], outn = d[D_OUTN];
  write_block(arena_buf + d[D_OUT_OFF], load_addr(d, 0), outn, q,
              [&](int o) -> uint32_t {
    int base = 0, rem = o;
    for (int i = 3; i >= 0; --i) {  // coordinates of the kept axes
      if (rmask & (1 << i)) continue;
      base += (rem % dims[i]) * stride[i];
      rem /= dims[i];
    }
    int iacc = 0;
    float facc = 0.0f;
    for (int r = 0; r < cnt; ++r) {  // walk the reduced axes
      int idx = base, rr = r;
      for (int i = 3; i >= 0; --i) {
        if (!(rmask & (1 << i))) continue;
        idx += (rr % dims[i]) * stride[i];
        rr /= dims[i];
      }
      if (q) iacc += ((const int8_t*)stage)[idx];
      else facc += ((const float*)stage)[idx];
    }
    if (q) {
      const float v = __fsub_rn(__fdiv_rn(__int2float_rn(iacc), (float)cnt),
                                (float)d[D_X_ZP]);
      return (uint8_t)requant_f(v, fword(d, D_AMULT), d[D_Y_ZP]);
    }
    return __float_as_uint(__fdiv_rn(facc, (float)cnt));
  });
}

ARENA_ENTRY(arena_mean, arena_mean_kernel)
