// arena_stream_stage: a whole-block op (elementwise, concat, pad, matmul,
// mean, fully connected, softmax) in the streaming program, in place on
// the arena over the whole card: its descriptor carries arena offsets and
// no window. The reference's window slot was written whole, padding
// zeroed, and copied back row for row; the in-place bodies write the same
// padded block, and their order words, from the operands' arena byte
// ranges, keep read-all-before-write-all: an output placed over an input
// behaves as in the row-blocked program.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_stream_stage_kernel
// with ::_StreamStageMem (apply_op -> _apply_stream, the staged branch).
//
// - An elementwise, concat, mean or pad body runs ew_tiles.cuh's chunk
//   walk (those of arena_elementwise, arena_concat, arena_mean and
//   arena_pad). A mean sums in the blocked kernel's order, so the
//   streaming arena stays bit-equal to the blocked one. Bound: bytes.
// - A softmax body runs softmax_tiles.cuh (arena_softmax's grid body):
//   past arena_ops.SM_FEW_ROWS (264) rows of at most 1,024 values a warp
//   a row, else a CTA a row (arena_ops.softmax_tiling). Its sums follow
//   the blocked kernel's fixed order, so the streaming arena stays
//   bit-equal to the blocked one. Bound: bytes.
// - A fully connected or matmul body runs fc_tiles.cuh
//   (arena_fully_connected's and arena_matmul's grid body): b's column
//   blocks x K slices (x row blocks of a matmul's many rows). Its f32 sums
//   follow the same fixed order as the blocked kernel's, so the streaming
//   arena stays bit-equal to the blocked one. Bound: bytes (W's) for an
//   FC.
#include "ew_tiles.cuh"
#include "fc_tiles.cuh"
#include "softmax_tiles.cuh"

using namespace arena;

namespace {
GridLaunch launch_state;

// The softmax body out of line: a warp row's 32 values a lane exceed this
// kernel's 64 registers, and its spills stay in this function's frame
// rather than in the other bodies' allocation.
__device__ __noinline__ void softmax_body(const int* d, uint8_t* arena,
                                          uint8_t* gws, uint8_t* smem) {
  softmax_grid(d, arena, gws, smem);
}
}  // namespace

// two CTAs an SM (at most 64 registers a thread)
__global__ void __launch_bounds__(NT, 2)
arena_stream_stage_kernel(uint8_t* arena_buf, const int* sd,
                          const uint8_t* w, uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int* d = sd + sd[S_BODY];
  switch (d[D_KIND]) {
    case K_ELEMENTWISE: ew_grid(d, arena_buf, gws, smem); return;
    case K_CONCAT: cat_grid(d, arena_buf, gws, smem); return;
    case K_MEAN: mean_grid(d, arena_buf, gws, smem); return;
    case K_FC: fc_grid(d, arena_buf, w, gws, smem); return;
    case K_MATMUL: matmul_grid(d, arena_buf, gws, smem); return;
    case K_SOFTMAX: softmax_body(d, arena_buf, gws, smem); return;
    case K_PAD: pad_grid(d, arena_buf, gws, smem); return;
  }
}

// (arena, streaming descriptor, filter or null, workspace, dynamic shared
// bytes, CTAs to launch at most, CTAs that must run
// at once (an order-2 grid body: all of them; else 0), counter bytes,
// stream): arena_common.cuh's launch_grid.
extern "C" int arena_stream_stage(void* arena_buf, const void* desc,
                                  const void* w, void* gws, int smem,
                                  int grid, int group, int counter_bytes,
                                  void* stream) {
  return launch_grid<NT>(arena_stream_stage_kernel, launch_state, arena_buf,
                         desc, w, gws, smem, grid, group, counter_bytes,
                         stream);
}
