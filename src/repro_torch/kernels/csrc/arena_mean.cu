// arena_mean: mean over a set of axes (global average pool of the head), in
// place on the flat byte arena. int8: int32 sum, (f32 sum / count) - x_zp,
// then the shared requantisation; f32: sum / count.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_mean_kernel
// (apply_op -> _plain_kernel over _FlatMem).
//
// Bound on this card: a few KB in and a few hundred bytes out, so both
// bounds are far below a microsecond; the kernel is bound by its one CTA
// and launch. One CTA because the output may overlap the input (on the
// flagship both start at byte 999): the whole input is staged (shared
// memory, or a global staging buffer the wrapper allocates when it does not
// fit) before any output byte is written (paper §III.F).
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_mean_kernel(uint8_t* arena_buf, const int* d, uint8_t* gstage) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stage = gstage ? gstage : smem;
  const bool q = d[D_QUANT] != 0;
  int dims[4], stride[4], total = 1;
  for (int i = 3; i >= 0; --i) {
    dims[i] = d[D_DIM0 + i];
    stride[i] = total;
    total *= dims[i];
  }
  stage_in(stage, arena_buf + d[D_IN_OFF], total * (q ? 1 : 4));
  __syncthreads();  // the whole input is read before any output is written
  const int rmask = d[D_RMASK], cnt = d[D_CNT], outn = d[D_OUTN];
  uint8_t* out = arena_buf + d[D_OUT_OFF];
  for (int o = threadIdx.x; o < outn; o += NT) {
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
      ((int8_t*)out)[o] = requant_f(v, fword(d, D_AMULT), d[D_Y_ZP]);
    } else {
      ((float*)out)[o] = __fdiv_rn(facc, (float)cnt);
    }
  }
}

extern "C" int arena_mean(void* arena_buf, const void* desc, void* gstage,
                          int smem, void* stream) {
  static int configured = 0;
  cudaError_t e = set_smem(arena_mean_kernel, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  arena_mean_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      (uint8_t*)arena_buf, (const int*)desc, (uint8_t*)gstage);
  return (int)cudaGetLastError();
}
