// The product grid body, shared by arena_fully_connected (an FC op of the
// flat or row-blocked program), arena_matmul (a matmul of either program)
// and arena_stream_stage (the staged FC and matmul of the streaming
// program, run in place on the arena). Through the three entry points it
// replaces the TPU kernels src/repro/kernels/arena_ops.py::
// _fully_connected_kernel and ::_matmul_kernel and those bodies of
// ::_stream_stage_kernel (with ::_StreamStageMem).
//
// y = a . b, a (m, k) in the arena; b (k, n) either W, row-major beside the
// arena (FC), or an arena operand read at its offset through its flat,
// blocked or packed addressing (matmul). int8: an int32 dot of (a - a_zp)
// * (b - b_zp) (W symmetric: b_zp 0), then the shared requantisation; f32:
// an f32 dot on the FMA units (no TF32, no tensor cores).
//
// - Bound: bytes for the zoo's FCs (resnet_50_v2: W 2048 x 1000 f32, 8.2
//   MB, 2.45 us at 3.35 TB/s), operations for a large matmul (1024^3 f32:
//   32 us at 67 TFLOP/s). The product is cut over the card
//   (arena_ops.fc_tiling, a function of (m, k, n) only): column blocks of
//   FC_COLS outputs (four a lane, 16-byte loads of b along n, a warp
//   reading 512 contiguous bytes of a b row) x K slices of bk rows of b,
//   and, for a matmul, row blocks of bm = 16 * rm rows; one (row block,
//   column block, slice) item a CTA at a time, so every b element is read
//   by one CTA a row block and the grid fills the SMs.
//   An FC (its rows a batch of a few): the CTA's 16 warps split the slice,
//   rpt rows of W each, and sum their partials through shared memory, a
//   row of x at a time. A matmul: each warp takes rm rows of a and sums
//   the whole slice for them in registers (rm x 4 accumulators a thread),
//   four slice rows' loads in flight.
// - Reduction order, a function of (m, k, n) only, never of the layout or
//   the offsets, so the flat, blocked and streaming programs stay
//   bit-equal: a thread sums its rows of b in ascending k; an FC's CTA
//   sums its 16 warps in ascending order; each item's partial goes to
//   the workspace (after the counters); the K slices' partials are summed
//   in ascending slice order. No float atomics. int8 sums are exact int32,
//   so they are bit-equal to the reference.
// - Paper §III.F, read-all-before-write-all, by the descriptor's order
//   word (arena_ops.fc_order, matmul_order, from the byte ranges of the
//   arena operands and the output):
//   0, disjoint: nothing waits; the CTA that finishes a tile's last slice
//   (a counter a (row block, column block); with one slice, every CTA and
//   no counters) sums its partials and stores them (row blocks of one
//   slice: straight from their registers, no partials), and every CTA
//   zeroes its share of the block padding.
//   2, overlap (the output written over an operand: both FC main paths):
//   every CTA computes the partials of its items, then one grid-wide
//   barrier (every CTA resident: a cooperative launch the entry point
//   refuses, never shrinks, on a card that cannot hold it), then the CTAs
//   sum and store the output's whole block between them.
// - Stores: the output's whole block (block padding zeroed, each tensor
//   element at elem_at).
#pragma once

#include "arena_common.cuh"

namespace arena {

// arena_ops.D_ORDER and D_TILING: the order word (ew_tiles.cuh's words 0
// and 2), then arena_ops.FcTiling; then whether an arena b moves four
// columns a load
enum { FC_D_ORDER = 100, FC_D_TILING = 101, FC_D_VECB = 112 };
enum { FC_DISJOINT = 0, FC_OVERLAP = 2 };
constexpr int FC_COLS = 128;      // output columns of a CTA (arena_ops)
constexpr int FC_WARPS = NT / 32;  // warps of a CTA
constexpr int MM_RM = 4;          // rows of a a warp of a row block
// counters (arena_ops.fc_counter_bytes): the grid barrier, then from word
// FC_C_COLS the slices of each (row block, column block) that are done
enum { FC_C_BARRIER = 0, FC_C_COLS = 4 };

// arena_ops.FcTiling, field for field
struct FcTiling {
  int bo, bk, rpt, ncb, nks, ctas, bm, nrb, rm;
};

struct FcP {
  const uint8_t* x;  // a
  uint8_t* out;
  const uint8_t* w;  // b: W, or the arena operand's first byte
  Addr xa, oa, wa;   // wa: a matmul b's addressing
  int m, idim, odim, x_zp, w_zp, y_zp;
  float amult;
  bool vec;  // a matmul b's four columns of a lane one aligned run
};

// Output (r, o): its slices' partials in ascending slice order, finished
// (int8: requantised; f32: the sum's bits). `part` holds slice s's value
// of (r, o) at (s * m + r) * odim + o; other CTAs wrote it, so it is read
// from L2.
template <bool Q>
__device__ __forceinline__ uint32_t fc_finish(const FcP& p, const int* part,
                                              int nks, int r, int o) {
  const int step = p.m * p.odim;
  const int* q = part + r * p.odim + o;
  if constexpr (Q) {
    int acc = __ldcg(q);
    for (int s = 1; s < nks; ++s) acc += __ldcg(q + s * step);
    return (uint32_t)(uint8_t)requant_i(acc, p.amult, p.y_zp);
  } else {
    float acc = __int_as_float(__ldcg(q));
    for (int s = 1; s < nks; ++s)
      acc = __fadd_rn(acc, __int_as_float(__ldcg(q + s * step)));
    return __float_as_uint(acc);
  }
}

template <bool Q>
__device__ __forceinline__ void fc_store(uint8_t* out, int b, uint32_t v) {
  if constexpr (Q) out[b] = (uint8_t)v;
  else ((uint32_t*)out)[b] = v;
}

// One (column block, K slice) item: for each row r of x, this CTA's sum of
// x[r, k] * W[k, o] over its slice, into the slice's partials.
template <bool Q>
__device__ void fc_slice(const FcP& p, const FcTiling& t, int cb, int ks,
                         int* part, void* red_buf) {
  typedef typename std::conditional<Q, int, float>::type acc_t;
  typedef typename std::conditional<Q, int8_t, float>::type T;
  acc_t* red = (acc_t*)red_buf;  // FC_WARPS x FC_COLS
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = cb * t.bo + lane * 4;  // this thread's first column
  const int k0 = ks * t.bk + warp * t.rpt;
  const int k1 = min(k0 + t.rpt, p.idim);
  const T* w = (const T*)p.w;
  // four columns a 16-byte (int8: 4-byte) load where odim and W allow it
  const bool vec = (p.odim & 3) == 0
                   && ((uintptr_t)p.w & (4 * sizeof(T) - 1)) == 0;
  for (int r = 0; r < p.m; ++r) {
    acc_t acc[4] = {0, 0, 0, 0};
    if (o < p.odim) {
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const int xi = elem_at(p.xa, r * p.idim + k);
        acc_t xv;
        if constexpr (Q) xv = (int)((const int8_t*)p.x)[xi] - p.x_zp;
        else xv = ((const float*)p.x)[xi];
        const T* wr = w + (size_t)k * p.odim + o;
        T wv[4];
        if (vec) {
          if constexpr (Q) {
            const char4 v = __ldg((const char4*)wr);
            wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
          } else {
            const float4 v = __ldg((const float4*)wr);
            wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = o + j < p.odim ? __ldg(wr + j) : (T)0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += xv * (acc_t)wv[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp * FC_COLS + lane * 4 + j] = acc[j];
    __syncthreads();
    if (threadIdx.x < FC_COLS) {
      const int oc = cb * t.bo + threadIdx.x;
      if (oc < p.odim) {
        acc_t s = red[threadIdx.x];
        for (int i = 1; i < FC_WARPS; ++i) s += red[i * FC_COLS + threadIdx.x];
        acc_t* dst = (acc_t*)part + ((size_t)ks * p.m + r) * p.odim + oc;
        *dst = s;
      }
    }
    __syncthreads();  // red is free for the next row
  }
}

// b[k, o .. o + 3] of a matmul's arena operand into wv (0 past n; int8
// less b_zp), one load where the descriptor says a lane's four columns
// are one aligned run, else at elem_at each.
template <bool Q, typename acc_t>
__device__ __forceinline__ void mm_b4(const FcP& p, int k, int o,
                                      acc_t* wv) {
  typedef typename std::conditional<Q, int8_t, float>::type T;
  const int e = k * p.odim + o;
  const T* w = (const T*)p.w;
  if (p.vec) {
    const T* wr = w + elem_at(p.wa, e);
    if constexpr (Q) {
      const char4 v = *(const char4*)wr;
      wv[0] = v.x - p.w_zp; wv[1] = v.y - p.w_zp;
      wv[2] = v.z - p.w_zp; wv[3] = v.w - p.w_zp;
    } else {
      const float4 v = *(const float4*)wr;
      wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc_t v = 0;
    if (o + j < p.odim) {
      v = w[elem_at(p.wa, e + j)];
      if constexpr (Q) v -= p.w_zp;
    }
    wv[j] = v;
  }
}

// One (row block, column block, K slice) item of a matmul: warp w sums the
// slice for rows rb * bm + w * MM_RM .. (MM_RM of them), four columns a
// lane, in registers, into the slice's partials, or (`direct`: one slice,
// no overlap) finished straight into the output.
template <bool Q>
__device__ void mm_rows(const FcP& p, const FcTiling& t, int rb, int cb,
                        int ks, int* part, bool direct) {
  typedef typename std::conditional<Q, int, float>::type acc_t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = cb * t.bo + lane * 4;
  const int r0 = rb * t.bm + warp * MM_RM;
  const int k0 = ks * t.bk, k1 = min(k0 + t.bk, p.idim);
  if (o >= p.odim || r0 >= p.m) return;
  int rows[MM_RM];
#pragma unroll
  for (int i = 0; i < MM_RM; ++i) rows[i] = min(r0 + i, p.m - 1);
  acc_t acc[MM_RM][4] = {};
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    acc_t wv[4];
    mm_b4<Q>(p, k, o, wv);
#pragma unroll
    for (int i = 0; i < MM_RM; ++i) {
      const int xi = elem_at(p.xa, rows[i] * p.idim + k);
      acc_t xv;
      if constexpr (Q) xv = (int)((const int8_t*)p.x)[xi] - p.x_zp;
      else xv = ((const float*)p.x)[xi];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += xv * wv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < MM_RM; ++i) {
    if (r0 + i >= p.m) break;
    const int e = (r0 + i) * p.odim + o;
    acc_t* dst = (acc_t*)part + (size_t)ks * p.m * p.odim + e;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (o + j >= p.odim) break;
      if (!direct) {
        dst[j] = acc[i][j];
      } else if constexpr (Q) {
        p.out[elem_at(p.oa, e + j)] =
            (uint8_t)requant_i(acc[i][j], p.amult, p.y_zp);
      } else {
        ((float*)p.out)[elem_at(p.oa, e + j)] = acc[i][j];
      }
    }
  }
}

// A matmul of one item and at most NT outputs, one slice, order 0: one
// output a thread, its k ascending (the sum mm_rows takes), stored at
// once; the small operands take one pass of loads, not the row block's
// unrolled walk.
template <bool Q>
__device__ void mm_small(const FcP& p) {
  typedef typename std::conditional<Q, int, float>::type acc_t;
  const int e = threadIdx.x;
  if (e >= p.m * p.odim) return;
  const int r = e / p.odim, o = e - r * p.odim;
  acc_t acc = 0;
#pragma unroll 4
  for (int k = 0; k < p.idim; ++k) {
    const int xi = elem_at(p.xa, r * p.idim + k);
    const int wi = elem_at(p.wa, k * p.odim + o);
    if constexpr (Q) {
      acc += ((int)((const int8_t*)p.x)[xi] - p.x_zp)
             * ((int)((const int8_t*)p.w)[wi] - p.w_zp);
    } else {
      acc += ((const float*)p.x)[xi] * ((const float*)p.w)[wi];
    }
  }
  if constexpr (Q)
    p.out[elem_at(p.oa, e)] = (uint8_t)requant_i(acc, p.amult, p.y_zp);
  else
    ((float*)p.out)[elem_at(p.oa, e)] = acc;
}

// Item it: (row block, column block, K slice), the slice fastest: a
// matmul's row blocks (MM), an FC's slice over its few rows.
template <bool Q, bool MM>
__device__ __forceinline__ void fc_item(const FcP& p, const FcTiling& t,
                                        int it, int* part, void* red,
                                        bool direct, int& rb, int& cb) {
  if constexpr (MM) {
    const int ks = it % t.nks, rc = it / t.nks;
    cb = rc % t.ncb;
    rb = rc / t.ncb;
    mm_rows<Q>(p, t, rb, cb, ks, part, direct);
  } else {
    cb = it / t.nks;
    rb = 0;
    fc_slice<Q>(p, t, cb, it - cb * t.nks, part, red);
  }
}

template <bool Q, bool MM>
__device__ void fc_run(const FcP& p, const FcTiling& t, int order,
                       int* ctr, int* part, void* red) {
  __shared__ int s_last;
  const int n = p.m * p.odim;
  const bool flat = dense(p.oa, n);
  const int nb = flat ? n : p.oa.nblk;
  const int stride = gridDim.x * NT;
  int rb, cb;
  if (order != FC_OVERLAP) {
    // disjoint: this CTA's share of the block padding, at any time
    if (!flat) {
      for (int b = blockIdx.x * NT + threadIdx.x; b < nb; b += stride)
        if (elem_of(p.oa, b, n) < 0) fc_store<Q>(p.out, b, 0u);
    }
    // a matmul's row blocks of one slice store their sums as they go
    const bool direct = MM && t.nks == 1;
    if (direct && t.ctas == 1 && p.m * p.odim <= NT) {
      if constexpr (MM) mm_small<Q>(p);
      return;
    }
    for (int it = blockIdx.x; it < t.ctas; it += gridDim.x) {
      fc_item<Q, MM>(p, t, it, part, red, direct, rb, cb);
      if (direct) continue;
      __threadfence();  // this CTA's partials, before the count
      __syncthreads();
      if (threadIdx.x == 0)  // one slice: no counters (none were zeroed)
        s_last = t.nks == 1
                 || atomicAdd(ctr + FC_C_COLS + rb * t.ncb + cb, 1)
                    == t.nks - 1;
      __syncthreads();
      if (!s_last) continue;
      __threadfence();  // every slice's partials, after the count
      const int o0 = cb * t.bo, bw = min(t.bo, p.odim - o0);
      const int r0 = rb * t.bm, bh = min(t.bm, p.m - r0);
      for (int i = threadIdx.x; i < bh * bw; i += NT) {
        const int r = r0 + i / bw, o = o0 + i % bw;
        fc_store<Q>(p.out, elem_at(p.oa, r * p.odim + o),
                    fc_finish<Q>(p, part, t.nks, r, o));
      }
      __syncthreads();
    }
    return;
  }
  // overlap: the items over the resident grid (the entry point launches at
  // most FC_GRID CTAs, all resident; an FC, one item a CTA); partials,
  // the barrier, then the whole block between them
  if constexpr (MM) {
    for (int it = blockIdx.x; it < t.ctas; it += gridDim.x)
      fc_item<Q, MM>(p, t, it, part, red, false, rb, cb);
  } else {
    fc_item<Q, MM>(p, t, blockIdx.x, part, red, false, rb, cb);
  }
  grid_barrier(ctr + FC_C_BARRIER);  // a and b are read whole before any store
  for (int b = blockIdx.x * NT + threadIdx.x; b < nb; b += stride) {
    const int e = flat ? b : elem_of(p.oa, b, n);
    uint32_t v = 0u;
    if (e >= 0) {
      const int r = e / p.odim;
      v = fc_finish<Q>(p, part, t.nks, r, e - r * p.odim);
    }
    fc_store<Q>(p.out, b, v);
  }
}

// The tiling and order word of descriptor d, then the run: the counters at
// the workspace's start, the partials in the "stage" words' buffer
// (global), an FC's warp sums in the "row" words' (shared memory).
template <bool MM>
__device__ __forceinline__ void fc_body(const int* d, const FcP& p,
                                        uint8_t* gws, uint8_t* smem) {
  const int* tw = d + FC_D_TILING;
  const FcTiling t{tw[0], tw[1], tw[2], tw[3], tw[4],
                   tw[5], tw[6], tw[7], tw[8]};
  int* ctr = (int*)gws;
  int* part = (int*)buffer(d, D_STAGE_G, smem, gws);
  void* red = buffer(d, D_ROW_G, smem, gws);
  if (d[D_QUANT]) fc_run<true, MM>(p, t, d[FC_D_ORDER], ctr, part, red);
  else fc_run<false, MM>(p, t, d[FC_D_ORDER], ctr, part, red);
}

// The grid body of fully connected descriptor d on the arena (W beside
// it).
__device__ __forceinline__ void fc_grid(const int* d, uint8_t* arena,
                                        const uint8_t* w, uint8_t* gws,
                                        uint8_t* smem) {
  FcP p;
  p.x = arena + d[D_IN_OFF];
  p.out = arena + d[D_OUT_OFF];
  p.w = w;
  p.xa = load_addr(d, 1); p.oa = load_addr(d, 0);
  p.m = d[D_M]; p.idim = d[D_IDIM]; p.odim = d[D_ODIM];
  p.x_zp = d[D_X_ZP]; p.y_zp = d[D_Y_ZP]; p.amult = fword(d, D_AMULT);
  fc_body<false>(d, p, gws, smem);
}

// The grid body of matmul descriptor d on the arena: a the first operand,
// b the second (D_IN2_OFF, zero point D_BZP).
__device__ __forceinline__ void matmul_grid(const int* d, uint8_t* arena,
                                            uint8_t* gws, uint8_t* smem) {
  FcP p;
  p.x = arena + d[D_IN_OFF];
  p.out = arena + d[D_OUT_OFF];
  p.w = arena + d[D_IN2_OFF];
  p.xa = load_addr(d, 1); p.oa = load_addr(d, 0); p.wa = load_addr(d, 2);
  p.m = d[D_MM]; p.idim = d[D_MK]; p.odim = d[D_MN];
  p.x_zp = d[D_X_ZP]; p.w_zp = d[D_BZP]; p.y_zp = d[D_Y_ZP];
  p.amult = fword(d, D_AMULT);
  p.vec = d[FC_D_VECB] != 0;
  fc_body<true>(d, p, gws, smem);
}

}  // namespace arena
