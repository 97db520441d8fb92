// The elementwise grid body, shared by arena_elementwise (an elementwise op
// of the flat or row-blocked program) and arena_stream_stage (a staged
// elementwise op of the streaming program, run in place on the arena): it
// replaces the one-CTA elementwise_op of arena_common.cuh on those paths;
// the fused chains' elementwise stages keep that routine. Through the two
// entry points it replaces the TPU kernel
// src/repro/kernels/arena_ops.py::_elementwise_kernel and the elementwise
// bodies of ::_stream_stage_kernel (with ::_StreamStageMem).
//
// - The output's whole block (padding included, as write_block writes it)
//   is cut into units, 16 bytes of elements each where the element count
//   and every operand's base and rows allow a 16-byte access
//   (arena_ops.ew_tiling), else one element each; units go to contiguous
//   chunks, a CTA's threads stride over a chunk, and a CTA walks chunks
//   blockIdx.x, blockIdx.x + gridDim.x, ... Each element is
//   elementwise_op's: the same addressing (elem_at, elem_of), broadcast
//   index, dequant, ew_apply and quant_f, so results are bit-equal to it
//   whatever the mapping (a pointwise map: element i reads element i of
//   each operand only).
// - Bound: bytes (each operand read once, the output block written once).
// - Paper §III.F, read-all-before-write-all, by the descriptor's order word
//   (arena_ops.ew_order, from the operands' byte ranges):
//   0, disjoint: no input byte meets an output byte; chunks store as they
//   go, no waits.
//   1, aligned: the output meets only inputs that map each element where
//   the output does (not broadcast), so output element i is exactly input
//   element i's bytes, and block padding is no input's element. A thread
//   stores only the unit it has just read itself; nothing waits.
//   2, overlap (an output below or above its input, a broadcast operand
//   under the output): every chunk computes its units into staging (shared
//   memory, or its slice of the global workspace past the budget), then
//   one grid-wide barrier (a counter at the workspace's start, zeroed by
//   the entry point before the launch; every chunk resident at once, a
//   cooperative launch the entry point refuses on a card that cannot hold
//   it), then every chunk stores what it staged.
#pragma once

#include "arena_common.cuh"

namespace arena {

// arena_ops.D_ORDER and D_TILING: the order word, then arena_ops.EwTiling
enum { EW_D_ORDER = 100, EW_D_TILING = 101 };
enum { EW_DISJOINT = 0, EW_ALIGNED = 1, EW_OVERLAP = 2 };

struct EwTiling {
  int vec, units, per, chunks;
};

// An elementwise descriptor's operands and parameters.
struct EwP {
  const uint8_t* a;
  const uint8_t* b;
  uint8_t* out;
  Addr aa, ba, oa;
  int fn, n, a_zp, b_zp, y_zp;
  bool binary, bcast;
  float as, bs, ys;
  int dims[MAX_DIMS], bstr[MAX_DIMS];
};

__device__ __forceinline__ EwP load_ew(const int* d, uint8_t* arena) {
  EwP p;
  p.a = arena + d[D_IN_OFF];
  p.b = arena + d[D_IN2_OFF];
  p.out = arena + d[D_OUT_OFF];
  p.aa = load_addr(d, 1); p.ba = load_addr(d, 2); p.oa = load_addr(d, 0);
  p.fn = d[D_FN]; p.n = d[D_EN];
  p.binary = p.fn >= EW_ADD; p.bcast = d[D_BCAST] != 0;
  p.a_zp = d[D_X_ZP]; p.b_zp = d[D_BZP]; p.y_zp = d[D_Y_ZP];
  p.as = fword(d, D_ASCALE); p.bs = fword(d, D_BSCALE);
  p.ys = fword(d, D_OSCALE);
  for (int i = 0; i < MAX_DIMS; ++i) {
    p.dims[i] = d[D_EDIM0 + i];
    p.bstr[i] = d[D_BSTR0 + i];
  }
  return p;
}

// The second operand's element offset for output element e (elementwise_op's
// broadcast index, then its addressing).
__device__ __forceinline__ int ew_b_at(const EwP& p, int e) {
  int bi = e;
  if (p.bcast) {
    bi = 0;
    int rem = e;
    for (int i = MAX_DIMS - 1; i >= 0; --i) {
      bi += (rem % p.dims[i]) * p.bstr[i];
      rem /= p.dims[i];
    }
  }
  return elem_at(p.ba, bi);
}

// elementwise_op's result for element e from its operand values.
template <bool Q>
__device__ __forceinline__ uint32_t ew_finish(const EwP& p, float x,
                                              float y) {
  const float v = ew_apply(p.fn, x, y);
  if constexpr (Q) return (uint32_t)(uint8_t)quant_f(v, p.ys, p.y_zp);
  else return __float_as_uint(v);
}

template <bool Q>
__device__ __forceinline__ float ew_load(const uint8_t* base, int i,
                                         float scale, int zp) {
  if constexpr (Q) return dequant(((const int8_t*)base)[i], scale, zp);
  else return ((const float*)base)[i];
}

// One element unit: output block element u (0 in the padding).
template <bool Q>
__device__ __forceinline__ uint32_t ew_elem(const EwP& p, int u,
                                            bool flat) {
  const int e = flat ? u : elem_of(p.oa, u, p.n);
  if (e < 0) return 0u;
  const float x = ew_load<Q>(p.a, elem_at(p.aa, e), p.as, p.a_zp);
  const float y = p.binary ? ew_load<Q>(p.b, ew_b_at(p, e), p.bs, p.b_zp)
                           : 0.0f;
  return ew_finish<Q>(p, x, y);
}

// One 16-byte unit: output block elements [u * V, u * V + V), V = 16 /
// element size, every one a tensor element (consecutive e, consecutive in
// each operand that is not broadcast) or every one padding (zeros).
template <bool Q>
__device__ __forceinline__ uint4 ew_vec(const EwP& p, int u) {
  constexpr int V = Q ? 16 : 4;
  const int e0 = elem_of(p.oa, u * V, p.n);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (e0 < 0) return r;
  const uint4 av = *(const uint4*)(p.a + elem_at(p.aa, e0) * (Q ? 1 : 4));
  uint4 bv = r;
  if (p.binary && !p.bcast)
    bv = *(const uint4*)(p.b + elem_at(p.ba, e0) * (Q ? 1 : 4));
  uint32_t* rw = (uint32_t*)&r;
  const uint32_t* aw = (const uint32_t*)&av;
  const uint32_t* bw = (const uint32_t*)&bv;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float x, y = 0.0f;
    if constexpr (Q) {
      x = dequant((int8_t)(aw[j / 4] >> (8 * (j % 4))), p.as, p.a_zp);
      if (p.binary) {
        const int8_t bq = p.bcast
            ? ((const int8_t*)p.b)[ew_b_at(p, e0 + j)]
            : (int8_t)(bw[j / 4] >> (8 * (j % 4)));
        y = dequant(bq, p.bs, p.b_zp);
      }
      rw[j / 4] |= ew_finish<true>(p, x, y) << (8 * (j % 4));
    } else {
      x = __uint_as_float(aw[j]);
      if (p.binary)
        y = p.bcast ? ((const float*)p.b)[ew_b_at(p, e0 + j)]
                    : __uint_as_float(bw[j]);
      rw[j] = ew_finish<false>(p, x, y);
    }
  }
  return r;
}

// Store unit u's result (a 16-byte unit, or one element's low byte or
// bits).
template <bool Q, bool VEC, typename R>
__device__ __forceinline__ void ew_store(uint8_t* out, int u, const R& v) {
  if constexpr (VEC) ((uint4*)out)[u] = v;
  else if constexpr (Q) out[u] = (uint8_t)v;
  else ((uint32_t*)out)[u] = v;
}

template <bool Q, bool VEC>
__device__ void ew_run(const EwP& p, const EwTiling& t, int order,
                       uint8_t* stage, int* ctr) {
  typedef typename std::conditional<VEC, uint4, uint32_t>::type R;
  const bool flat = dense(p.oa, p.n);
  auto unit = [&](int u) -> R {
    if constexpr (VEC) return ew_vec<Q>(p, u);
    else return ew_elem<Q>(p, u, flat);
  };
  if (order != EW_OVERLAP) {
    for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
      const int end = min((c + 1) * t.per, t.units);
      for (int u = c * t.per + threadIdx.x; u < end; u += NT)
        ew_store<Q, VEC>(p.out, u, unit(u));
    }
    return;
  }
  // order 2: one chunk a CTA (the entry point launches exactly t.chunks,
  // all resident); stage (a unit's bytes), barrier, store what this
  // thread staged
  typedef typename std::conditional<
      VEC, uint4,
      typename std::conditional<Q, uint8_t, uint32_t>::type>::type S;
  const int c = blockIdx.x, u0 = c * t.per;
  const int end = min(u0 + t.per, t.units);
  S* s = (S*)stage;
  for (int u = u0 + threadIdx.x; u < end; u += NT) s[u - u0] = (S)unit(u);
  grid_barrier(ctr);
  for (int u = u0 + threadIdx.x; u < end; u += NT)
    ew_store<Q, VEC>(p.out, u, s[u - u0]);
}

// The grid body of elementwise descriptor d on the arena: its tiling and
// order word, its chunk's staging (order 2: shared memory, or the chunk's
// slice of the workspace after the barrier counter).
__device__ __forceinline__ void ew_grid(const int* d, uint8_t* arena,
                                        uint8_t* gws, uint8_t* smem) {
  const EwP p = load_ew(d, arena);
  const int* tw = d + EW_D_TILING;
  const EwTiling t{tw[0], tw[1], tw[2], tw[3]};
  const int order = d[EW_D_ORDER];
  uint8_t* stage = buffer(d, D_STAGE_G, smem, gws);
  if (order == EW_OVERLAP && d[D_STAGE_G])
    stage += (size_t)blockIdx.x * t.per * t.vec * (d[D_QUANT] ? 1 : 4);
  int* ctr = (int*)gws;
  if (d[D_QUANT]) {
    if (t.vec > 1) ew_run<true, true>(p, t, order, stage, ctr);
    else ew_run<true, false>(p, t, order, stage, ctr);
  } else {
    if (t.vec > 1) ew_run<false, true>(p, t, order, stage, ctr);
    else ew_run<false, false>(p, t, order, stage, ctr);
  }
}

}  // namespace arena
