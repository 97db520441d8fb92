// arena_concat: a standalone concat on the arena (flat or row-blocked), each
// int8 input rescaled to the output's params (ops.rescale_q: the shared
// requantisation of x - zp by the f32 ratio of the scales).
//
// Replaces the TPU kernels src/repro/kernels/arena_ops.py::_concat_kernel
// with ::_rescale (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program); the same routine runs as the
// terminal stage of arena_fused_chain.
//
// Bound on this card: bytes (densenet_121's widest concat writes 3.2 MB of
// f32); the kernel is bound by one SM's load and store rate. One CTA
// because the planner may place the output over an input: every input is
// read into a staging buffer in output order (shared memory, or the global
// workspace past 227 KB), then a barrier, then the whole output is
// written.
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_concat_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                    uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  concat_op(d, arena_buf, nullptr, buffer(d, D_STAGE_G, smem, gws));
}

ARENA_ENTRY(arena_concat, arena_concat_kernel)
