// The chunk walk over the whole card, and the four grid bodies that run
// on it: elementwise, concat, mean and pad. arena_elementwise,
// arena_concat, arena_mean and arena_pad run them on an op of the flat or
// row-blocked program, and arena_stream_stage on a staged op of the
// streaming program, in place on the arena (its descriptor carries arena
// offsets and no window); the fused chains (chain_tiles.cuh) run the
// elementwise and concat bodies one chunk a ticket, their operands in the
// arena or the chain's workspace. Through the entry points they replace
// the TPU kernels src/repro/kernels/arena_ops.py::_elementwise_kernel,
// ::_concat_kernel with ::_rescale, ::_mean_kernel and ::_pad_kernel, and
// those bodies of ::_stream_stage_kernel (with ::_StreamStageMem).
//
// - Units and chunks: the output's whole block (padding included: zeros
//   in each row's padding and the dense tail) is cut into units, 16 bytes
//   of elements each where the element map of every operand allows a
//   16-byte access (arena_ops.ew_tiling, concat_tiling, pad_tiling), else
//   one element each (a mean's unit is always one output); units go to
//   contiguous chunks, a CTA's threads stride over a chunk, and a CTA
//   walks chunks blockIdx.x, blockIdx.x + gridDim.x, ... (chunk_walk).
//   Padding units get zeros.
// - Each element is computed the same way whatever the mapping, so
//   results do not depend on it:
//   elementwise: the operands' addressing (elem_at, elem_of), the
//   broadcast index, dequant, ew_apply and quant_f (a pointwise map:
//   element i reads element i of each operand only);
//   concat: output element e is column e % inner_out of outer row
//   e / inner_out, read from the input whose column range holds it and,
//   int8, rescaled to the output's params (requant_i of x - zp_i, as
//   ops.rescale_q);
//   pad: output element e at coordinate x reads the input element at x
//   less the leading pads where that lies inside the input's box, else
//   takes the pad value (f32 0; int8 x_zp); int8 then rescales it to the
//   output's params (requant_i of x - x_zp), the padded tensor's rescale
//   of the reference. A 16-byte unit lies wholly inside or wholly
//   outside the box (arena_ops.pad_tiling);
//   mean: one thread sums one output's reduction in one fixed order (r
//   ascending, the reduced axes' coordinates last axis fastest: the order
//   of the one-CTA mean this grid replaced), loads issued MEAN_BATCH at a
//   time, then divides (int8: (f32 sum / count) - x_zp, requantised), so
//   f32 results are the same on the flat, blocked and streaming programs.
// - Bound: bytes (each operand read once, the output block written once).
// - Paper §III.F, read-all-before-write-all, by the descriptor's order word
//   (arena_ops.ew_order, concat_order, pad_order, mean_order, from the
//   operands' byte ranges):
//   0, disjoint: no input byte meets an output byte; chunks store as they
//   go, no waits.
//   1, aligned (elementwise): the output meets only inputs that map each
//   element where the output does (not broadcast), so output element i is
//   exactly input element i's bytes, and block padding is no input's
//   element. A thread stores only the unit it has just read itself.
//   1, own (mean): every byte of output element o meets only input
//   elements of o's own reduction, and block padding meets none; the one
//   thread that owns o reads all of them before it stores o. Nothing
//   waits.
//   2, overlap (anything else: an output below or above its input, a
//   broadcast operand under the output, a concat, pad or mean written
//   over other elements' inputs): every chunk computes its units into
//   staging (shared memory, or its slice of the global workspace past the
//   budget), then one grid-wide barrier (a counter at the workspace's
//   start, zeroed by the entry point before the launch; every chunk
//   resident at once, a cooperative launch the entry point refuses on a
//   card that cannot hold it), then every chunk stores what it staged.
#pragma once

#include "arena_common.cuh"

namespace arena {

// arena_ops.D_ORDER and D_TILING: the order word, then arena_ops.EwTiling
enum { EW_D_ORDER = 100, EW_D_TILING = 101 };
enum { EW_DISJOINT = 0, EW_ALIGNED = 1, EW_OVERLAP = 2 };

// outputs of a mean whose loads a thread issues together
constexpr int MEAN_BATCH = 16;

struct EwTiling {
  int vec, units, per, chunks;
};

// An elementwise descriptor's operands and parameters; with a fused
// chain's workspace `ws`, each operand whose scratch word is set lies
// there (else in the arena).
struct EwP {
  static constexpr bool kVec = true;  // 16-byte units where allowed
  const uint8_t* a;
  const uint8_t* b;
  uint8_t* out;
  Addr aa, ba, oa;
  int fn, n, a_zp, b_zp, y_zp;
  bool binary, bcast;
  float as, bs, ys;
  int dims[MAX_DIMS], bstr[MAX_DIMS];
  bool flat;  // the output block is the tensor, element for element
};

__device__ __forceinline__ uint8_t* routed(const int* d, int flag,
                                           uint8_t* arena, uint8_t* ws) {
  return ws && d[flag] ? ws : arena;
}

__device__ __forceinline__ EwP load_ew(const int* d, uint8_t* arena,
                                       uint8_t* ws = nullptr) {
  EwP p;
  p.a = routed(d, D_IN_SCR, arena, ws) + d[D_IN_OFF];
  p.b = routed(d, D_IN2_SCR, arena, ws) + d[D_IN2_OFF];
  p.out = routed(d, D_OUT_SCR, arena, ws) + d[D_OUT_OFF];
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
  p.flat = dense(p.oa, p.n);
  return p;
}

// The second operand's element offset for output element e (its broadcast
// index, then its addressing).
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

// The stored bits of an elementwise result from its operand values.
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
__device__ __forceinline__ uint32_t ew_elem(const EwP& p, int u) {
  const int e = p.flat ? u : elem_of(p.oa, u, p.n);
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

// A concat descriptor's output and parameters (inputs are read through
// the descriptor's per-input words: input i in a fused chain's workspace
// `ws` where its scratch word is set, else in the arena).
struct CatP {
  static constexpr bool kVec = true;
  const int* d;
  uint8_t* arena;
  uint8_t* ws;
  uint8_t* out;
  Addr oa;
  int nin, inner_out, n, y_zp;
  bool flat;
};

__device__ __forceinline__ CatP load_cat(const int* d, uint8_t* arena,
                                         uint8_t* ws = nullptr) {
  CatP p;
  p.d = d;
  p.arena = arena;
  p.ws = ws;
  p.out = routed(d, D_OUT_SCR, arena, ws) + d[D_OUT_OFF];
  p.oa = load_addr(d, 0);
  p.nin = d[D_NIN];
  p.inner_out = d[D_INNER_OUT];
  p.n = d[D_OUTER] * p.inner_out;
  p.y_zp = d[D_Y_ZP];
  p.flat = dense(p.oa, p.n);
  return p;
}

// Output element e's input i and the element offset (elem_at) it reads
// there: column c = e % inner_out lies in input i's columns [c0, c0 +
// inner_i), at element (e / inner_out) * inner_i + c - c0 of the input.
__device__ __forceinline__ int cat_src(const CatP& p, int e, int& s) {
  const int o = e / p.inner_out;
  const int c = e - o * p.inner_out;
  int i = 0, c0 = 0;
  while (i < p.nin - 1 && c >= c0 + p.d[D_CINNER + i]) {
    c0 += p.d[D_CINNER + i];
    ++i;
  }
  s = elem_at(load_addr(p.d, 1 + i), o * p.d[D_CINNER + i] + c - c0);
  return i;
}

// Input i's first byte.
__device__ __forceinline__ const uint8_t* cat_in(const CatP& p, int i) {
  return routed(p.d, D_CIN_SCR + i, p.arena, p.ws) + p.d[D_CIN_OFF + i];
}

// The rescale of input i's int8 x to the output's params.
__device__ __forceinline__ uint32_t cat_rescale(const CatP& p, int i,
                                                int8_t x) {
  return (uint32_t)(uint8_t)requant_i((int)x - p.d[D_CZP + i],
                                      fword(p.d, D_CMULT + i), p.y_zp);
}

// One element unit: output block element u (0 in the padding).
template <bool Q>
__device__ __forceinline__ uint32_t cat_elem(const CatP& p, int u) {
  const int e = p.flat ? u : elem_of(p.oa, u, p.n);
  if (e < 0) return 0u;
  int s;
  const int i = cat_src(p, e, s);
  const uint8_t* src = cat_in(p, i);
  if constexpr (Q) return cat_rescale(p, i, ((const int8_t*)src)[s]);
  else return ((const uint32_t*)src)[s];
}

// One 16-byte unit: output block elements [u * V, u * V + V), padding only
// or consecutive elements of one input's columns, which that input holds
// as one 16-byte aligned run (arena_ops.concat_tiling).
template <bool Q>
__device__ __forceinline__ uint4 cat_vec(const CatP& p, int u) {
  constexpr int V = Q ? 16 : 4;
  const int e0 = elem_of(p.oa, u * V, p.n);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (e0 < 0) return r;
  int s;
  const int i = cat_src(p, e0, s);
  const uint4 v = *(const uint4*)(cat_in(p, i) + s * (Q ? 1 : 4));
  if constexpr (!Q) return v;
  uint32_t* rw = (uint32_t*)&r;
  const uint32_t* vw = (const uint32_t*)&v;
#pragma unroll
  for (int j = 0; j < V; ++j)
    rw[j / 4] |= cat_rescale(p, i, (int8_t)(vw[j / 4] >> (8 * (j % 4))))
                 << (8 * (j % 4));
  return r;
}

// A pad descriptor's operands and parameters: the input's dims, the
// leading pads and the output's dims, each padded to 4 with leading 1s
// (0s for the pads).
struct PadP {
  static constexpr bool kVec = true;
  const uint8_t* in;
  uint8_t* out;
  Addr ia, oa;
  int pin[4], plo[4], pout[4];
  int n, x_zp, y_zp;
  float mult;
  bool flat;
};

__device__ __forceinline__ PadP load_pad(const int* d, uint8_t* arena) {
  PadP p;
  p.in = arena + d[D_IN_OFF];
  p.out = arena + d[D_OUT_OFF];
  p.ia = load_addr(d, 1); p.oa = load_addr(d, 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    p.pin[i] = d[D_PIN0 + i];
    p.plo[i] = d[D_PLO0 + i];
    p.pout[i] = d[D_POUT0 + i];
  }
  p.n = d[D_PN];
  p.x_zp = d[D_X_ZP]; p.y_zp = d[D_Y_ZP]; p.mult = fword(d, D_AMULT);
  p.flat = dense(p.oa, p.n);
  return p;
}

// The input's element offset (elem_at) that output element e < n reads,
// or -1 where e lies outside the input's box (the pad value). The
// outermost coordinate is what the inner axes leave: no division.
__device__ __forceinline__ int pad_src(const PadP& p, int e) {
  int rem = e, idx = 0, stride = 1;
#pragma unroll
  for (int i = 3; i >= 1; --i) {
    const int c = rem % p.pout[i] - p.plo[i];
    rem /= p.pout[i];
    if (c < 0 || c >= p.pin[i]) return -1;
    idx += c * stride;
    stride *= p.pin[i];
  }
  const int c = rem - p.plo[0];
  if (c < 0 || c >= p.pin[0]) return -1;
  return elem_at(p.ia, idx + c * stride);
}

// int8: x (an input value, or x_zp outside the box) rescaled to the
// output's params (ops.rescale_q).
__device__ __forceinline__ uint32_t pad_rescale(const PadP& p, int x) {
  return (uint32_t)(uint8_t)requant_i(x - p.x_zp, p.mult, p.y_zp);
}

// One element unit: output block element u (0 in the padding).
template <bool Q>
__device__ __forceinline__ uint32_t pad_elem(const PadP& p, int u) {
  const int e = p.flat ? u : elem_of(p.oa, u, p.n);
  if (e < 0) return 0u;
  const int s = pad_src(p, e);
  if constexpr (Q)
    return pad_rescale(p, s >= 0 ? (int)((const int8_t*)p.in)[s] : p.x_zp);
  else
    return s >= 0 ? ((const uint32_t*)p.in)[s] : 0u;
}

// One 16-byte unit: output block elements [u * V, u * V + V), padding
// only, or consecutive elements of one innermost row wholly outside the
// input's box (pad values), or wholly inside it, where the input holds
// them as one aligned 16-byte run (arena_ops.pad_tiling).
template <bool Q>
__device__ __forceinline__ uint4 pad_vec(const PadP& p, int u) {
  constexpr int V = Q ? 16 : 4;
  const int e0 = p.flat ? u * V : elem_of(p.oa, u * V, p.n);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (e0 < 0) return r;
  const int s = pad_src(p, e0);
  if constexpr (!Q) {
    return s >= 0 ? *(const uint4*)(p.in + s * 4) : r;
  } else {
    if (s < 0) {
      const uint32_t f = pad_rescale(p, p.x_zp) * 0x01010101u;
      return make_uint4(f, f, f, f);
    }
    const uint4 v = *(const uint4*)(p.in + s);
    uint32_t* rw = (uint32_t*)&r;
    const uint32_t* vw = (const uint32_t*)&v;
#pragma unroll
    for (int j = 0; j < V; ++j)
      rw[j / 4] |= pad_rescale(p, (int8_t)(vw[j / 4] >> (8 * (j % 4))))
                   << (8 * (j % 4));
    return r;
  }
}

// A mean descriptor's operands and parameters: dims padded to 4 with
// leading 1s, their strides, bit i of rmask = axis i reduced.
struct MeanP {
  static constexpr bool kVec = false;  // one output a unit
  const uint8_t* in;
  uint8_t* out;
  Addr ia, oa;
  int dims[4], stride[4];
  int rmask, cnt, outn, x_zp, y_zp;
  int step;  // adjacent reduced axes: r's offset is r * step; else 0
  float amult;
  bool flat;
};

__device__ __forceinline__ MeanP load_mean(const int* d, uint8_t* arena) {
  MeanP p;
  p.in = arena + d[D_IN_OFF];
  p.out = arena + d[D_OUT_OFF];
  p.ia = load_addr(d, 1); p.oa = load_addr(d, 0);
  int total = 1;
  for (int i = 3; i >= 0; --i) {
    p.dims[i] = d[D_DIM0 + i];
    p.stride[i] = total;
    total *= p.dims[i];
  }
  p.rmask = d[D_RMASK]; p.cnt = d[D_CNT]; p.outn = d[D_OUTN];
  // reduced axes i0..i1, adjacent: r decodes to r * stride[i1] (every
  // global average pool of the zoo)
  p.step = 0;
  const int run = p.rmask ? p.rmask >> (__ffs(p.rmask) - 1) : 0;
  if (p.rmask && (run & (run + 1)) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (p.rmask & (1 << i)) p.step = p.stride[i];  // the last one, i1
  }
  p.x_zp = d[D_X_ZP]; p.y_zp = d[D_Y_ZP]; p.amult = fword(d, D_AMULT);
  p.flat = dense(p.oa, p.outn);
  return p;
}

// One output unit: output block element u (0 in the padding), its
// reduction summed r ascending, the reduced axes' coordinates last axis
// fastest, MEAN_BATCH loads in flight before their adds, which keep that
// order. Adjacent reduced axes step by a constant (p.step), so a batch's
// loads do not wait on each other's addresses; others step an odometer.
// The loops have no early exits, so they unroll with every index fixed.
template <bool Q>
__device__ __forceinline__ uint32_t mean_elem(const MeanP& p, int u) {
  typedef typename std::conditional<Q, int, float>::type acc_t;
  const int e = p.flat ? u : elem_of(p.oa, u, p.outn);
  if (e < 0) return 0u;
  int cur = 0, rem = e;
#pragma unroll
  for (int i = 3; i >= 0; --i) {  // coordinates of the kept axes
    if (!(p.rmask & (1 << i))) {
      cur += (rem % p.dims[i]) * p.stride[i];
      rem /= p.dims[i];
    }
  }
  int co[4] = {0, 0, 0, 0};
  acc_t acc = 0;
  for (int r = 0; r < p.cnt; r += MEAN_BATCH) {
    acc_t v[MEAN_BATCH];
#pragma unroll
    for (int j = 0; j < MEAN_BATCH; ++j) {
      v[j] = 0;
      if (r + j < p.cnt) {
        int x = cur + (r + j) * p.step;
        if (!p.step) {  // the odometer: x is cur, then cur steps
          x = cur;
          bool carry = true;
#pragma unroll
          for (int i = 3; i >= 0; --i) {
            if (carry && (p.rmask & (1 << i))) {
              cur += p.stride[i];
              if (++co[i] == p.dims[i]) {
                cur -= p.dims[i] * p.stride[i];
                co[i] = 0;
              } else {
                carry = false;
              }
            }
          }
        }
        x = elem_at(p.ia, x);
        if constexpr (Q) v[j] = ((const int8_t*)p.in)[x];
        else v[j] = ((const float*)p.in)[x];
      }
    }
#pragma unroll
    for (int j = 0; j < MEAN_BATCH; ++j)
      if (r + j < p.cnt) acc += v[j];
  }
  if constexpr (Q) {
    const float v = __fsub_rn(__fdiv_rn(__int2float_rn(acc), (float)p.cnt),
                              (float)p.x_zp);
    return (uint32_t)(uint8_t)requant_f(v, p.amult, p.y_zp);
  } else {
    return __float_as_uint(__fdiv_rn(acc, (float)p.cnt));
  }
}

// Unit u's result under each body: a 16-byte unit (VEC) or one element's
// low byte or bits.
template <bool Q, bool VEC>
__device__ __forceinline__ auto unit_of(const EwP& p, int u) {
  if constexpr (VEC) return ew_vec<Q>(p, u);
  else return ew_elem<Q>(p, u);
}

template <bool Q, bool VEC>
__device__ __forceinline__ auto unit_of(const CatP& p, int u) {
  if constexpr (VEC) return cat_vec<Q>(p, u);
  else return cat_elem<Q>(p, u);
}

template <bool Q, bool VEC>
__device__ __forceinline__ auto unit_of(const PadP& p, int u) {
  if constexpr (VEC) return pad_vec<Q>(p, u);
  else return pad_elem<Q>(p, u);
}

template <bool Q, bool VEC>
__device__ __forceinline__ uint32_t unit_of(const MeanP& p, int u) {
  static_assert(!VEC, "a mean's unit is one output");
  return mean_elem<Q>(p, u);
}

// Store unit u's result (a 16-byte unit, or one element's low byte or
// bits).
template <bool Q, bool VEC, typename R>
__device__ __forceinline__ void ew_store(uint8_t* out, int u, const R& v) {
  if constexpr (VEC) ((uint4*)out)[u] = v;
  else if constexpr (Q) out[u] = (uint8_t)v;
  else ((uint32_t*)out)[u] = v;
}

// Chunk c of tiling t, each unit computed by the body of p and stored as
// it goes, a CTA of THREADS threads striding over it.
template <bool Q, bool VEC, int THREADS = NT, typename P>
__device__ __forceinline__ void chunk_store(const P& p, const EwTiling& t,
                                            int c) {
  const int end = min((c + 1) * t.per, t.units);
  for (int u = c * t.per + threadIdx.x; u < end; u += THREADS)
    ew_store<Q, VEC>(p.out, u, unit_of<Q, VEC>(p, u));
}

// The chunks of tiling t under order word `order` (see the top), each
// unit computed by the body of p.
template <bool Q, bool VEC, typename P>
__device__ void chunk_walk(const P& p, const EwTiling& t, int order,
                           uint8_t* stage, int* ctr) {
  if (order != EW_OVERLAP) {
    for (int c = blockIdx.x; c < t.chunks; c += gridDim.x)
      chunk_store<Q, VEC>(p, t, c);
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
  for (int u = u0 + threadIdx.x; u < end; u += NT)
    s[u - u0] = (S)unit_of<Q, VEC>(p, u);
  grid_barrier(ctr);
  for (int u = u0 + threadIdx.x; u < end; u += NT)
    ew_store<Q, VEC>(p.out, u, s[u - u0]);
}

// The grid body of descriptor d with operands p: its tiling and order
// word, its chunk's staging (order 2: shared memory, or the chunk's slice
// of the workspace after the barrier counter).
template <typename P>
__device__ __forceinline__ void chunk_grid(const int* d, const P& p,
                                           uint8_t* gws, uint8_t* smem) {
  const int* tw = d + EW_D_TILING;
  const EwTiling t{tw[0], tw[1], tw[2], tw[3]};
  const int order = d[EW_D_ORDER];
  uint8_t* stage = buffer(d, D_STAGE_G, smem, gws);
  if (order == EW_OVERLAP && d[D_STAGE_G])
    stage += (size_t)blockIdx.x * t.per * t.vec * (d[D_QUANT] ? 1 : 4);
  int* ctr = (int*)gws;
  const bool vec = P::kVec && t.vec > 1;
  if (d[D_QUANT]) {
    if constexpr (P::kVec) {
      if (vec) return chunk_walk<true, true>(p, t, order, stage, ctr);
    }
    chunk_walk<true, false>(p, t, order, stage, ctr);
  } else {
    if constexpr (P::kVec) {
      if (vec) return chunk_walk<false, true>(p, t, order, stage, ctr);
    }
    chunk_walk<false, false>(p, t, order, stage, ctr);
  }
}

// The grid bodies of an elementwise, concat, mean or pad descriptor d on
// the arena.
__device__ __forceinline__ void ew_grid(const int* d, uint8_t* arena,
                                        uint8_t* gws, uint8_t* smem) {
  chunk_grid(d, load_ew(d, arena), gws, smem);
}

__device__ __forceinline__ void cat_grid(const int* d, uint8_t* arena,
                                         uint8_t* gws, uint8_t* smem) {
  chunk_grid(d, load_cat(d, arena), gws, smem);
}

__device__ __forceinline__ void mean_grid(const int* d, uint8_t* arena,
                                          uint8_t* gws, uint8_t* smem) {
  chunk_grid(d, load_mean(d, arena), gws, smem);
}

__device__ __forceinline__ void pad_grid(const int* d, uint8_t* arena,
                                         uint8_t* gws, uint8_t* smem) {
  chunk_grid(d, load_pad(d, arena), gws, smem);
}

}  // namespace arena
