// The softmax grid body, shared by arena_softmax (a softmax of the flat or
// row-blocked program) and arena_stream_stage (the staged softmax of the
// streaming program, run in place on the arena). Through the two entry
// points it replaces the TPU kernel
// src/repro/kernels/arena_ops.py::_softmax_kernel and the softmax body of
// ::_stream_stage_kernel (with ::_StreamStageMem).
//
// Softmax over the last axis: rows = the product of the leading dims, `last`
// values a row. int8: dequantise, subtract the row max, expf, IEEE division
// by the row sum, quantise (IEEE division by the output scale); f32: the
// same without the casts.
//
// - Bound: bytes (the zoo's 1,000-class heads: 1 to 4 KB a row), but a
//   few rows are bound by one row's latency. So the rows go over the card
//   by arena_ops.softmax_tiling, a function of (rows, last) and the
//   element type: a few rows (at most a grid's 264), and any row past
//   1,024 values, one CTA each, a column a thread, the row's values in a
//   buffer (shared memory, or a slice of the workspace a CTA, past 192
//   KB); many rows of at most 1,024 one warp each, 32 values a lane in
//   registers, in groups of 16 bytes' worth (4 f32, 16 int8), each group
//   one 16-byte load and store where the addressing keeps it contiguous
//   and aligned, warp rows on CTAs first (row r on warp r / grid of CTA r
//   % grid). One 1,000-class row on an H100 (a launch, f32 / int8;
//   scripts/torch_softmax_matmul_variants.py): a warp 11.6 / 9.2 us (32
//   exps and 32 IEEE divides a lane one after another), a CTA 3.6 / 3.7,
//   the one-CTA kernel this replaced 3.8 / 4.0.
// - A row's values stay in registers (or its buffer) from the max to the
//   store; each exp is computed once. Reductions: warp shuffles (no barrier
//   for a warp row), then for a CTA row the warps' values summed in
//   ascending warp order.
// - Reduction order, a function of (rows, last) and the element type only,
//   never of the layout or the offsets, so the flat, blocked and streaming
//   programs stay bit-equal: a thread sums its groups ascending, each
//   group's columns ascending; then the xor butterfly over the lanes; then
//   (a CTA row) the warps ascending.
// - Paper §III.F, read-all-before-write-all, by the descriptor's order word
//   (arena_ops.softmax_order, from the operands' byte ranges):
//   0, disjoint: no input byte meets the output's block; rows store as they
//   finish and the block padding is zeroed at any time.
//   1, aligned: every input byte in the output's block lies in an output
//   element of its own row (the flagship's in-place softmax); a row's
//   owner reads the whole row before it stores, and no other warp or CTA
//   reads those bytes, so nothing waits.
//   2, overlap: every CTA computes its rows' results into the workspace,
//   then one grid-wide barrier (every CTA resident: a cooperative launch the
//   entry point refuses, never shrinks, on a card that cannot hold it), then
//   the CTAs store the output's whole block between them.
// - Stores: the output's whole block (block padding zeroed, each tensor
//   element at elem_at).
#pragma once

#include "arena_common.cuh"

namespace arena {

// arena_ops.D_ORDER and D_TILING: the order word (ew_tiles.cuh's words),
// then arena_ops.SoftmaxTiling
enum { SM_D_ORDER = 100, SM_D_TILING = 101 };
// rows a warp (in registers), rows a CTA (through a buffer)
enum { SM_WARP = 0, SM_CTA = 1 };
enum { SM_OVERLAP = 2 };  // the order word that waits (0 and 1 do not)
constexpr int SM_WARP_VALS = 32;  // values a lane of a warp row at most

// arena_ops.SoftmaxTiling, field for field: the row policy, columns a
// group (a warp row's 16 bytes' worth, a CTA row's one; also template
// constants here), groups a thread
struct SmTiling {
  int mode, vec, per;
};

struct SmP {
  const uint8_t* in;
  Addr ia;
  int rows, last, n, x_zp, y_zp;
  float xs, ys;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// Max or sum over the T threads of a row: a warp's xor butterfly, then (T
// = NT) the warps' values in ascending order through `red`; every thread
// gets the result. A CTA row's threads all call it (two barriers).
template <int T, bool MAX>
__device__ __forceinline__ float row_reduce(float v, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, s);
    v = MAX ? fmaxf(v, o) : __fadd_rn(v, o);
  }
  if constexpr (T == 32) return v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < T / 32; ++i)
    v = MAX ? fmaxf(v, red[i]) : __fadd_rn(v, red[i]);
  __syncthreads();  // red is free for the next reduction
  return v;
}

// Is the group of G elements at element e of operand a one contiguous,
// 16-byte aligned run at `base`?
template <int G, int ISZ>
__device__ __forceinline__ bool sm_run(const uint8_t* base, const Addr& a,
                                       int e, int at) {
  return elem_at(a, e + G - 1) == at + G - 1
         && (((uintptr_t)(base + (size_t)at * ISZ)) & 15) == 0;
}

// Columns [c, c + G) of row r (its first element e0) into v, dequantised;
// columns past `last` get -inf.
template <bool Q, int G>
__device__ __forceinline__ void sm_read(const SmP& p, int e0, int c,
                                        float* v) {
  constexpr int ISZ = Q ? 1 : 4;
  const int at = elem_at(p.ia, e0 + c);
  if (G * ISZ == 16 && c + G <= p.last
      && sm_run<G, ISZ>(p.in, p.ia, e0 + c, at)) {
    const uint4 u = *(const uint4*)(p.in + (size_t)at * ISZ);
    const uint32_t* w = (const uint32_t*)&u;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if constexpr (Q)
        v[j] = dequant((int8_t)(w[j / 4] >> (8 * (j % 4))), p.xs, p.x_zp);
      else
        v[j] = __uint_as_float(w[j]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (c + j < p.last) {
      const int a = elem_at(p.ia, e0 + c + j);
      if constexpr (Q)
        v[j] = dequant(((const int8_t*)p.in)[a], p.xs, p.x_zp);
      else
        v[j] = ((const float*)p.in)[a];
    } else {
      v[j] = neg_inf();
    }
  }
}

// The stored bits of one result: e / sum, quantised (int8) or as is.
template <bool Q>
__device__ __forceinline__ uint32_t sm_bits(const SmP& p, float e, float s) {
  const float y = __fdiv_rn(e, s);
  if constexpr (Q) return (uint32_t)(uint8_t)quant_f(y, p.ys, p.y_zp);
  else return __float_as_uint(y);
}

// Columns [c, c + G) of row r from their exps v and the row sum s, to
// `dst` under addressing da (the output, or order 2's dense results).
template <bool Q, int G>
__device__ __forceinline__ void sm_write(const SmP& p, uint8_t* dst,
                                         const Addr& da, int e0, int c,
                                         const float* v, float s) {
  constexpr int ISZ = Q ? 1 : 4;
  const int at = elem_at(da, e0 + c);
  if (G * ISZ == 16 && c + G <= p.last
      && sm_run<G, ISZ>(dst, da, e0 + c, at)) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    uint32_t* w = (uint32_t*)&u;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if constexpr (Q)
        w[j / 4] |= sm_bits<true>(p, v[j], s) << (8 * (j % 4));
      else
        w[j] = sm_bits<false>(p, v[j], s);
    }
    *(uint4*)(dst + (size_t)at * ISZ) = u;
    return;
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (c + j < p.last) {
      const int a = elem_at(da, e0 + c + j);
      if constexpr (Q) dst[a] = (uint8_t)sm_bits<true>(p, v[j], s);
      else ((uint32_t*)dst)[a] = sm_bits<false>(p, v[j], s);
    }
  }
}

// Row r on a warp, lane t, its values in registers: groups t, t + 32, ...
// of G columns (SM_WARP_VALS values at most).
template <bool Q>
__device__ __forceinline__ void sm_row_warp(const SmP& p, uint8_t* dst,
                                            const Addr& da, int r, int t) {
  constexpr int T = 32, G = Q ? 16 : 4, MJ = SM_WARP_VALS / G;
  float v[SM_WARP_VALS];
  const int e0 = r * p.last;
  float mx = neg_inf();
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    const int c = (t + T * j) * G;
    if (c < p.last) {
      sm_read<Q, G>(p, e0, c, v + j * G);
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) v[j * G + i] = neg_inf();
    }
#pragma unroll
    for (int i = 0; i < G; ++i) mx = fmaxf(mx, v[j * G + i]);
  }
  mx = row_reduce<T, true>(mx, nullptr);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if ((t + T * j) * G + i < p.last) {
        v[j * G + i] = expf(__fsub_rn(v[j * G + i], mx));
        s = __fadd_rn(s, v[j * G + i]);
      }
    }
  }
  s = row_reduce<T, false>(s, nullptr);
#pragma unroll
  for (int j = 0; j < MJ; ++j) {
    const int c = (t + T * j) * G;
    if (c < p.last) sm_write<Q, G>(p, dst, da, e0, c, v + j * G, s);
  }
}

// Row r on the CTA through the buffer x (`last` f32 values): column c on
// thread c % NT, each thread summing its columns ascending and only ever
// touching them in x.
template <bool Q>
__device__ void sm_row_cta(const SmP& p, uint8_t* dst, const Addr& da,
                           int r, float* x, float* red) {
  const int e0 = r * p.last;
  float mx = neg_inf();
  for (int c = threadIdx.x; c < p.last; c += NT) {
    sm_read<Q, 1>(p, e0, c, x + c);
    mx = fmaxf(mx, x[c]);
  }
  mx = row_reduce<NT, true>(mx, red);
  float s = 0.0f;
  for (int c = threadIdx.x; c < p.last; c += NT) {
    x[c] = expf(__fsub_rn(x[c], mx));
    s = __fadd_rn(s, x[c]);
  }
  s = row_reduce<NT, false>(s, red);
  for (int c = threadIdx.x; c < p.last; c += NT)
    sm_write<Q, 1>(p, dst, da, e0, c, x + c, s);
}

// Every row of this CTA (its warps' rows, or its own) into dst.
template <bool Q>
__device__ void sm_rows(const SmP& p, const SmTiling& t, uint8_t* dst,
                        const Addr& da, float* x, float* red) {
  if (t.mode == SM_WARP) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = blockIdx.x + gridDim.x * warp; r < p.rows;
         r += gridDim.x * (NT / 32))
      sm_row_warp<Q>(p, dst, da, r, lane);
    return;
  }
  for (int r = blockIdx.x; r < p.rows; r += gridDim.x)
    sm_row_cta<Q>(p, dst, da, r, x, red);
}

template <bool Q>
__device__ void sm_run_grid(const SmP& p, const SmTiling& t, int order,
                            uint8_t* out, const Addr& oa, int* ctr,
                            uint8_t* results, float* x) {
  __shared__ float red[NT / 32];
  const bool flat = dense(oa, p.n);
  const int nb = flat ? p.n : oa.nblk;
  const int stride = gridDim.x * NT;
  if (order != SM_OVERLAP) {
    // no input in the padding (orders 0 and 1): zero it at any time
    if (!flat) {
      for (int b = blockIdx.x * NT + threadIdx.x; b < nb; b += stride)
        if (elem_of(oa, b, p.n) < 0) {
          if constexpr (Q) out[b] = 0;
          else ((uint32_t*)out)[b] = 0u;
        }
    }
    sm_rows<Q>(p, t, out, oa, x, red);
    return;
  }
  // overlap: every row's results by tensor element into the workspace, the
  // barrier, then the whole block between the CTAs
  Addr ra;
  ra.L = ra.used = ra.nblk = p.n;
  ra.c = ra.k = 1;
  ra.rl = 0;
  sm_rows<Q>(p, t, results, ra, x, red);
  grid_barrier(ctr);  // the input is read whole before any store
  for (int b = blockIdx.x * NT + threadIdx.x; b < nb; b += stride) {
    const int e = flat ? b : elem_of(oa, b, p.n);
    if constexpr (Q) out[b] = e >= 0 ? __ldcg(results + e) : 0;
    else
      ((uint32_t*)out)[b] = e >= 0 ? __ldcg((const uint32_t*)results + e)
                                   : 0u;
  }
}

// The grid body of softmax descriptor d on the arena: its tiling and order
// word, the counter at the workspace's start, order 2's results in the
// "stage" words' buffer (global), a CTA row's buffer in the "row" words'
// (shared memory, or a slice a CTA of the workspace).
__device__ __forceinline__ void softmax_grid(const int* d, uint8_t* arena,
                                             uint8_t* gws, uint8_t* smem) {
  SmP p;
  p.in = arena + d[D_IN_OFF];
  p.ia = load_addr(d, 1);
  p.rows = d[D_ROWS];
  p.last = d[D_LAST];
  p.n = p.rows * p.last;
  p.x_zp = d[D_X_ZP]; p.y_zp = d[D_Y_ZP];
  p.xs = fword(d, D_XSCALE); p.ys = fword(d, D_YSCALE);
  const int* tw = d + SM_D_TILING;
  const SmTiling t{tw[0], tw[1], tw[2]};
  float* x = nullptr;
  if (t.mode == SM_CTA) {
    uint8_t* b = buffer(d, D_ROW_G, smem, gws);
    if (d[D_ROW_G]) b += (size_t)blockIdx.x * ((p.last * 4 + 15) / 16 * 16);
    x = (float*)b;
  }
  uint8_t* out = arena + d[D_OUT_OFF];
  const Addr oa = load_addr(d, 0);
  uint8_t* results = buffer(d, D_STAGE_G, smem, gws);
  if (d[D_QUANT])
    sm_run_grid<true>(p, t, d[SM_D_ORDER], out, oa, (int*)gws, results, x);
  else
    sm_run_grid<false>(p, t, d[SM_D_ORDER], out, oa, (int*)gws, results, x);
}

}  // namespace arena
