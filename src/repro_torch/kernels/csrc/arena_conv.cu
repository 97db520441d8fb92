// arena_conv: conv2d and depthwise conv2d (channel multiplier) in place on
// the arena (flat or row-blocked: plain, packed or spanning image rows),
// int8 (int32 accumulation + f32 requantisation) or f32.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_conv_kernel,
// reached through apply_op -> _plain_kernel over _FlatMem (the flat byte
// program of the Pallas backend) or _BlockMem (the row-blocked program);
// and, on one row-blocked spec, the standalone in-place depthwise conv
// src/repro/kernels/dmo_arena_dwconv.py::dmo_dwconv2d_arena.
//
// Bound on this card: neither bytes nor operations. One op moves a few KB
// to a few MB and does at most a few hundred MMACs, so the byte and
// operation bounds are microseconds; the kernel is bound by running on one
// SM, row after row, with two barriers per output row. That one CTA per op
// is the paper's §III.F choice: the planner overlaps this op's input and
// output diagonally (the flagship's conv1 writes 133 bytes below its input;
// producer bands carry a negative leading row pad), so rows handed to
// independent CTAs would overwrite input rows still to be read. Each output
// row is staged in a row buffer (shared memory, or the global workspace for
// a row wider than a CTA's shared memory), so any row width runs.
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_conv_kernel(uint8_t* arena_buf, const int* d, const uint8_t* w,
                  uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  row_op(d, arena_buf, nullptr, w, buffer(d, D_ROW_G, smem, gws));
}

ARENA_ENTRY(arena_conv, arena_conv_kernel)
