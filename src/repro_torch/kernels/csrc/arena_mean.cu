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
  mean_op(d, arena_buf, buffer(d, D_STAGE_G, smem, gws));
}

ARENA_ENTRY(arena_mean, arena_mean_kernel)
