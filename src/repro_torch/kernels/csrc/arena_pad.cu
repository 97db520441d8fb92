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
  pad_op(d, arena_buf, buffer(d, D_STAGE_G, smem, gws));
}

ARENA_ENTRY(arena_pad, arena_pad_kernel)
