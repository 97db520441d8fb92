// A fused band chain over the whole card: the one device routine of
// arena_fused_chain (the flat and row-blocked programs) and
// arena_stream_fused (the streaming program).
//
// - The host schedule (arena_ops.chain_schedule) gives every non-terminal
//   stage's output a region of its own in the global workspace and points
//   each stage input at the region of the stage that wrote it, or at the
//   arena (the chain's inputs; in the streaming program at their arena
//   rows, no window). With one region per output, a stage depends only on
//   the stages whose outputs it reads, so the stages run in levels: a level
//   holds stages that do not depend on each other.
// - A level is one ticket range over the tiles and chunks of its stages
//   (each stage's first ticket and tickets in words D_T0, D_NT): CTAs take
//   tickets by an atomicAdd on the level's counter, a conv2d, depthwise or
//   pool stage runs one row tile a ticket (conv_tiles.cuh's tile bodies,
//   order word 0: its input and output never meet, so it neither
//   publishes nor waits), an elementwise or concat stage one chunk of
//   units a ticket (ew_tiles.cuh's chunk bodies). One grid_barrier (its
//   own counter word) ends each level.
// - The terminal stages, the only ones that write the arena, form the last
//   level, after the last barrier: every read of the chain input precedes
//   every store of its output (paper §III.F: the planner overlaps them).
//   Where an arena input of that level meets an arena output of it (order
//   word 2 on its stages, hand-built chains only), every CTA computes its
//   one chunk into its slice of the workspace, one more barrier, then
//   stores it, as ew_tiles.cuh's order word 2 does.
// - Every output is computed as the standalone kernels compute it
//   (conv_point's and pool_point's accumulation order, the elementwise and
//   concat maps), so f32 results are bit-equal to the one-CTA row walks
//   this replaced, and stores follow the reference's: a packed row writes
//   its own lane phase, plain and spanning rows and whole blocks zero
//   their padding.
// - The launch is cooperative: every CTA resident, refused (never shrunk)
//   by launch_grid on a card that cannot hold the grid. The counters (one
//   ticket word a level, one word a barrier) sit at the workspace's start
//   and the entry point zeroes them before the launch.
#pragma once

#include "conv_tiles.cuh"
#include "ew_tiles.cuh"

namespace arena {

// a chain's header words (arena_ops.H_*): stage and level counts, the
// bytes of one CTA's footprint slice and of its staged terminal chunk
// slice, then per level its first stage and its tickets; the buffer words
// (D_STAGE_G: footprint, D_ROW_G: filter chunks, and the workspace offset
// of the staged chunks' slices, always global)
enum { H_NS = 0, H_NL = 1, H_FP = 2, H_TERM = 3, H_LEVEL0 = 8 };
enum { D_TERM_OFF = 125 };
// a stage's first ticket in its level and its tickets
enum { D_T0 = 116, D_NT = 117 };

__device__ __forceinline__ EwTiling load_chunks(const int* d) {
  const int* tw = d + D_TILING;
  return EwTiling{tw[0], tw[1], tw[2], tw[3]};
}

// Tile t of a conv2d, depthwise or pool stage (order word 0).
template <bool Q>
__device__ void chain_tile(const int* d, const uint8_t* in, uint8_t* out,
                           const uint8_t* w, uint8_t* tile, uint8_t* wsm,
                           int t) {
  const ConvP p = load_conv(d);
  const Tiling tl = load_tiling(d);
  const ArenaRows rows;
  int staged_rows = 0;
#define CHAIN_TILE(B, VP, VO)                                                \
  conv_tile<Q, B, VP, VO>(p, tl, 0, in, out, w, tile, wsm, nullptr, rows, t, \
                          staged_rows)
#define CHAIN_VP(B, VO)             \
  do {                              \
    if (tl.vp == 4)                 \
      CHAIN_TILE(B, 4, VO);         \
    else if (tl.vp == 2)            \
      CHAIN_TILE(B, 2, VO);         \
    else                            \
      CHAIN_TILE(B, 1, VO);         \
  } while (0)
  const int kind = d[D_KIND];
  if (kind == K_POOL) {
    if (p.m) CHAIN_VP(B_MAX, 1);
    else CHAIN_VP(B_AVG, 1);
  } else if (kind == K_DEPTHWISE) {
    CHAIN_VP(B_DW, 1);
  } else if (tl.vo == 4) {
    CHAIN_VP(B_CONV, 4);
  } else {
    CHAIN_VP(B_CONV, 1);
  }
#undef CHAIN_VP
#undef CHAIN_TILE
}

// Chunk c of an elementwise or concat stage over operands p, stored as it
// goes (STAGE 0), computed into `buf` (STAGE 1) or stored from it
// (STAGE 2).
template <int STAGE, bool Q, bool VEC, typename P>
__device__ __forceinline__ void chain_units(const P& p, const EwTiling& t,
                                            int c, uint8_t* buf) {
  if constexpr (STAGE == 0) {
    chunk_store<Q, VEC, CT>(p, t, c);
  } else {
    typedef typename std::conditional<
        VEC, uint4,
        typename std::conditional<Q, uint8_t, uint32_t>::type>::type S;
    const int u0 = c * t.per, end = min(u0 + t.per, t.units);
    S* s = (S*)buf;
    for (int u = u0 + threadIdx.x; u < end; u += CT) {
      if constexpr (STAGE == 1) s[u - u0] = (S)unit_of<Q, VEC>(p, u);
      else ew_store<Q, VEC>(p.out, u, s[u - u0]);
    }
  }
}

template <int STAGE, typename P>
__device__ __forceinline__ void chain_chunk_of(const int* d, const P& p,
                                               int c, uint8_t* buf) {
  const EwTiling t = load_chunks(d);
  if (d[D_QUANT]) {
    if (t.vec > 1) chain_units<STAGE, true, true>(p, t, c, buf);
    else chain_units<STAGE, true, false>(p, t, c, buf);
  } else {
    if (t.vec > 1) chain_units<STAGE, false, true>(p, t, c, buf);
    else chain_units<STAGE, false, false>(p, t, c, buf);
  }
}

template <int STAGE>
__device__ void chain_chunk(const int* d, uint8_t* arena, uint8_t* gws,
                            int c, uint8_t* buf) {
  if (d[D_KIND] == K_CONCAT)
    chain_chunk_of<STAGE>(d, load_cat(d, arena, gws), c, buf);
  else
    chain_chunk_of<STAGE>(d, load_ew(d, arena, gws), c, buf);
}

// The stage of level stages [first, end) (descriptors from d0) that holds
// ticket t; its local ticket in `local`.
__device__ __forceinline__ const int* stage_of(const int* d0, int first,
                                               int end, int t, int& local) {
  int s = first;
  while (s + 1 < end && t >= d0[(s + 1) * DESC_WORDS + D_T0]) ++s;
  const int* d = d0 + s * DESC_WORDS;
  local = t - d[D_T0];
  return d;
}

// The chain of header h (its stage descriptors after it) on the arena,
// the filter blob and the workspace gws (counters, regions, any global
// slices); every CTA runs it.
__device__ void chain_grid(const int* h, uint8_t* arena,
                           const uint8_t* wblob, uint8_t* gws,
                           uint8_t* smem) {
  __shared__ int s_ticket;
  const int ns = h[H_NS], nl = h[H_NL];
  const int* d0 = h + DESC_WORDS;
  int* ctr = (int*)gws;  // nl ticket words, then the barriers'
  uint8_t* tile = buffer(h, D_STAGE_G, smem, gws);
  if (h[D_STAGE_G]) tile += (size_t)blockIdx.x * h[H_FP];
  uint8_t* wsm = smem + h[D_ROW_OFF];  // the filter chunks (shared)
  for (int l = 0; l < nl; ++l) {
    const int first = h[H_LEVEL0 + 2 * l], tickets = h[H_LEVEL0 + 2 * l + 1];
    const int end = l + 1 < nl ? h[H_LEVEL0 + 2 * l + 2] : ns;
    if (l == nl - 1 && d0[first * DESC_WORDS + D_ORDER] == EW_OVERLAP) {
      // the staged last level: one chunk a CTA (the schedule keeps its
      // chunks within the grid), its slice of the workspace
      uint8_t* buf = gws + h[D_TERM_OFF] + (size_t)blockIdx.x * h[H_TERM];
      int c = 0;
      const int* d = (int)blockIdx.x < tickets
          ? stage_of(d0, first, end, blockIdx.x, c) : nullptr;
      if (d) chain_chunk<1>(d, arena, gws, c, buf);
      grid_barrier(ctr + nl + l);  // every input of the level is read
      if (d) chain_chunk<2>(d, arena, gws, c, buf);
      return;
    }
    for (;;) {
      if (threadIdx.x == 0) s_ticket = atomicAdd(ctr + l, 1);
      __syncthreads();
      const int t = s_ticket;
      if (t >= tickets) break;
      int c;
      const int* d = stage_of(d0, first, end, t, c);
      const int kind = d[D_KIND];
      if (kind == K_CONCAT || kind == K_ELEMENTWISE) {
        chain_chunk<0>(d, arena, gws, c, nullptr);
        __syncthreads();  // the ticket is free
      } else {
        const uint8_t* in = (d[D_IN_SCR] ? gws : arena) + d[D_IN_OFF];
        uint8_t* out = (d[D_OUT_SCR] ? gws : arena) + d[D_OUT_OFF];
        if (d[D_QUANT])
          chain_tile<true>(d, in, out, wblob + d[D_WOFF], tile, wsm, c);
        else
          chain_tile<false>(d, in, out, wblob + d[D_WOFF], tile, wsm, c);
      }
    }
    if (l + 1 < nl) grid_barrier(ctr + nl + l);  // the level is stored
  }
}

}  // namespace arena
