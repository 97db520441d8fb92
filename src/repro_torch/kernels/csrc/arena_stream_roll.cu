// arena_stream_roll: a conv2d, depthwise conv2d or pool with one input in
// the streaming program. The arena stays in device memory and the op reads
// only its live window: output-row tile t (image rows [t*tr, min((t+1)*tr,
// oh))) copies win_in arena rows from the planner's fetch start
// win_starts[t] into a window buffer, computes its rows into a one-tile
// output slot, and copies the slot's rows back to the arena.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_stream_roll_kernel
// with ::_StreamRollMem (apply_op -> _apply_stream, the rolling branch):
// its VMEM input window and output slot are the window buffer and slot
// here, in shared memory when they fit beside the row buffer and otherwise
// in the global workspace (resnet_50_v2's windows do not fit).
//
// Order. One CTA walks the tiles in ascending order (paper §III.F: a grid
// of CTAs over tiles would read rows an earlier tile overwrites), and tile
// t+1 is fetched only after tile t's rows are back in the arena, which is
// the row-blocked program's order; the reference prefetches tile t+1 before
// tile t's write-back and argues the race benign, an overlap left to a
// later change. The output slot starts as a copy of the tile's arena rows,
// so a packed output (several image rows per arena row) read-modify-writes
// its lane phase and leaves the other lanes as the blocked program does; a
// plain or spanning row store covers its whole arena rows. Every valid tap
// row lies inside the window (the planner's schedule); the row address is
// clamped into it all the same (in_row), and masked taps form no address.
//
// Bound on this card: the op's own bytes and operations are those of the
// blocked kernel (arena_conv / arena_pool); the staging adds T * win_in
// rows in and two copies of the output rows. Like them it is bound by one
// CTA walking rows with two barriers per output row.
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_stream_roll_kernel(uint8_t* arena_buf, const int* sd,
                         const uint8_t* w, uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int* d = sd + sd[S_BODY];
  uint8_t* win = buffer(sd, S_WIN_G, smem, gws);
  uint8_t* slot = buffer(sd, S_SLOT_G, smem, gws);
  uint8_t* rowbuf = buffer(d, D_ROW_G, smem, gws);
  const long rb = sd[S_ROWB];
  const int win_in = sd[S_WIN_IN], tr = sd[S_TR], oh = sd[S_OH];
  const int in_row0 = sd[S_IN_ROW], out_row0 = sd[S_OUT_ROW];
  const int* starts = sd + S_COPY0 + 3 * sd[S_NCOPY];
  ConvP p = load_conv(d);
  p.rlo = 0;
  p.rhi = win_in;
  for (int t = 0; t < sd[S_T]; ++t) {
    const int start = starts[t];
    p.y0 = t * tr;
    p.y1 = min(p.y0 + tr, oh);
    p.rbase = in_row0 - start;
    p.obase = out_row_lo(p.oa, p.y0);
    const long nout = (out_row_hi(p.oa, p.y1) - p.obase) * rb;
    uint8_t* dst = arena_buf + (out_row0 + p.obase) * rb;
    copy_bytes(win, arena_buf + start * rb, win_in * rb);
    copy_bytes(slot, dst, nout);
    __syncthreads();  // the window and the slot are in
    row_run<true>(d, p, win, slot, w, rowbuf);  // ends with a barrier
    copy_bytes(dst, slot, nout);
    __syncthreads();  // the tile is back before the next fetch
  }
}

ARENA_ENTRY(arena_stream_roll, arena_stream_roll_kernel)
