// arena_stream_roll: a conv2d, depthwise conv2d or pool with one input in
// the streaming program, over the whole card. The arena stays in device
// memory and the op reads only its live window: output row r belongs to
// streaming tile t = r / tr (image rows [t*tr, min((t+1)*tr, oh))), whose
// window is win_in arena rows from the planner's fetch start
// win_starts[t]; every input row it reads is rebased on that start and
// clamped into the window, as the reference's dynamic slice clamps it.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_stream_roll_kernel
// with ::_StreamRollMem (apply_op -> _apply_stream, the rolling branch):
// its VMEM input window is here each row tile's footprint (the tile's part
// of the window, in shared memory, or a per-CTA global slice past 192 KB),
// and its output slot is gone: tiles store straight into the arena.
//
// Bound on this card: the op's own bytes and operations, those of the
// blocked op (operations for resnet_50_v2's convs, bytes for its pool and
// the flagship's int8). The design is arena_conv's (conv_tiles.cuh): row
// tiles over every SM taking tickets in row-major order, footprints staged
// in shared memory, filters in cp.async chunks, each output in
// conv_point's or pool_point's order (f32 bit-equal to the row-blocked
// program). What the window adds:
//
// - Footprint rows go through the window (WinRows below), so on any start
//   table the kernel reads what stream_roll_plain reads, stray valid taps
//   outside the window included.
// - Order is the streaming tiles': rows of tile t see the arena as it
//   stands after every row of tiles < t has stored and before any row of
//   tile t has. The lowering's order word (arena_ops.conv_order, from the
//   window-clamped rows the tiles really read) gives it: 0 no read meets a
//   store; 1 no row reads a store of an earlier row, so stores wait for
//   every tile of rows <= r to stage (the planner's specs); 2 (hand-built
//   specs only) groups of tr rows run one after another: a tile reads once
//   every row < t*tr is stored, and stores once every tile of rows <
//   (t+1)*tr has staged.
// - A tile covers whole output arena rows and stores as the blocked op
//   does (a packed row its lane phase, a plain or spanning row its k * L
//   elements), which is what the reference's slot wrote back: the lanes a
//   slot carried back unchanged are ones no store of this op touches.
#include "conv_tiles.cuh"

using namespace arena;

namespace {

// The row policy of a rolling op: input image row iy as output row r reads
// it, from the input pointer, through r's streaming tile's window
// (_StreamRollMem's rebased, clamped dynamic slice); a group (order word
// 2) is one streaming tile.
struct WinRows {
  const int* starts;  // the planner's fetch start of each streaming tile
  int in_row0, win_in, tr;
  __device__ __forceinline__ int operator()(const Addr& a, int r, int iy)
      const {
    const bool packed = a.c > 1;
    const int n = packed ? 1 : a.k;  // arena rows of one image row
    const int base = starts[r / tr] - in_row0;
    int w = (packed ? iy / a.c : iy * a.k) - base;  // the window's row
    w = min(max(w, 0), win_in - n);
    return (base + w) * a.L + (packed ? (iy % a.c) * a.rl : 0);
  }
  __device__ __forceinline__ int first(int r) const { return r / tr * tr; }
  __device__ __forceinline__ int end(int r, int oh) const {
    return min((r / tr + 1) * tr, oh);
  }
};

GridLaunch launch_state;

}  // namespace

__global__ void __launch_bounds__(CT)
arena_stream_roll_kernel(uint8_t* arena_buf, const int* sd,
                         const uint8_t* w, uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  const WinRows rows{sd + S_COPY0, sd[S_IN_ROW], sd[S_WIN_IN], sd[S_TR]};
  run_tiles<true>(arena_buf, sd + sd[S_BODY], w, gws, smem, rows);
}

// (arena, streaming descriptor, filter or null, workspace (counters
// first), dynamic shared bytes, CTAs to launch at most, tiles that must
// run at once (one row's; one streaming tile's under order word 2),
// counter bytes, stream): arena_common.cuh's launch_grid.
extern "C" int arena_stream_roll(void* arena_buf, const void* desc,
                                 const void* w, void* gws, int smem,
                                 int grid, int group, int counter_bytes,
                                 void* stream) {
  return launch_grid<CT>(arena_stream_roll_kernel, launch_state, arena_buf,
                         desc, w, gws, smem, grid, group, counter_bytes,
                         stream);
}
