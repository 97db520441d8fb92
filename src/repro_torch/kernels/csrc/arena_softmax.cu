// arena_softmax: softmax over the last axis on the arena (flat or
// row-blocked). int8: dequantise, subtract the row max, expf, divide by the
// row sum, quantise (IEEE division by the output scale); f32: the same without
// the casts.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_softmax_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: 1000 bytes in and out and 1000 exponentials, far
// below a microsecond by either bound; the kernel is bound by its one CTA,
// its block reductions and launch. The flagship runs it in place, so the
// input is staged (as f32) before anything is written (paper §III.F); the
// result overwrites the staged input, then the block is written out.
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_softmax_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                     uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  softmax_op(d, arena_buf, buffer(d, D_STAGE_G, smem, gws));
}

ARENA_ENTRY(arena_softmax, arena_softmax_kernel)
