// arena_conv: conv2d and depthwise conv2d (channel multiplier) in place on
// the flat byte arena, int8 (int32 accumulation + f32 requantisation) or f32.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_conv_kernel,
// reached through apply_op -> _plain_kernel over _FlatMem (the flat byte
// program of the Pallas backend).
//
// Bound on this card: neither bytes nor operations. One op moves a few KB
// to a few hundred KB and does at most a few tens of MMACs, so the byte and
// operation bounds are microseconds or less; the kernel is bound by running
// on one SM, row after row, with two barriers per output row. That one CTA
// per op is the paper's §III.F choice: the planner overlaps this op's input
// and output diagonally (the flagship's conv1 writes 133 bytes below its
// input; producer bands carry a negative leading row pad), so rows handed to
// independent CTAs would overwrite input rows still to be read.
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_conv_kernel(uint8_t* arena_buf, const int* desc, const uint8_t* w) {
  conv_dispatch(desc, arena_buf, nullptr, w + desc[D_WOFF]);
}

extern "C" int arena_conv(void* arena_buf, const void* desc, const void* w,
                          void* stream) {
  arena_conv_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      (uint8_t*)arena_buf, (const int*)desc, (const uint8_t*)w);
  return (int)cudaGetLastError();
}
