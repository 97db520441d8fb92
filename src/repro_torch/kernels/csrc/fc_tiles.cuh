// The fully connected grid body, shared by arena_fully_connected (an FC op
// of the flat or row-blocked program) and arena_stream_stage (the staged
// FC of the streaming program, run in place on the arena). Through the two
// entry points it replaces the TPU kernel
// src/repro/kernels/arena_ops.py::_fully_connected_kernel and the FC body
// of ::_stream_stage_kernel (with ::_StreamStageMem).
//
// y = x . W, x (m, idim) in the arena, W (idim, odim) row-major beside it.
// int8: an int32 dot of (x - x_zp) * w (W symmetric), then the shared
// requantisation; f32: an f32 dot on the FMA units (no TF32, no tensor
// cores).
//
// - Bound: bytes, W's (resnet_50_v2: 2048 x 1000 f32, 8.2 MB, 2.45 us at
//   3.35 TB/s). So W is cut over the card (arena_ops.fc_tiling): column
//   blocks of FC_COLS outputs (four a lane, 16-byte loads along odim, a
//   warp reading 512 contiguous bytes of a W row) x K slices of bk = 16 *
//   rpt rows (rpt a warp), one (block, slice) a CTA, so every W element is
//   read by exactly one CTA and the grid fills the SMs.
// - Reduction order, a function of (m, idim, odim) only, never of the
//   layout or the offsets, so the flat, blocked and streaming programs
//   stay bit-equal: a thread sums its rpt rows in ascending k; the CTA sums
//   its 16 warps in ascending order into its slice's partial (the
//   workspace, after the counters); the K slices' partials are summed in
//   ascending slice order. No float atomics. int8 sums are exact int32,
//   so they are bit-equal to the one-CTA routine and to the reference.
// - Paper §III.F, read-all-before-write-all, by the descriptor's order
//   word (arena_ops.fc_order, from the byte ranges of x and the output):
//   0, disjoint: nothing waits; the CTA that finishes a column block's
//   last slice (a counter a block) sums its partials and stores them, and
//   every CTA zeroes its share of the block padding.
//   2, overlap (the output written over x, both main paths): every CTA
//   computes its partials, then one grid-wide barrier (every CTA resident:
//   a cooperative launch the entry point refuses, never shrinks, on a card
//   that cannot hold it), then the CTAs sum and store the output's whole
//   block between them.
// - Stores: the output's whole block, as write_block writes it (block
//   padding zeroed, each tensor element at elem_at).
#pragma once

#include "arena_common.cuh"

namespace arena {

// arena_ops.D_ORDER and D_TILING: the order word (ew_tiles.cuh's words 0
// and 2), then arena_ops.FcTiling
enum { FC_D_ORDER = 100, FC_D_TILING = 101 };
enum { FC_DISJOINT = 0, FC_OVERLAP = 2 };
constexpr int FC_COLS = 128;      // output columns of a CTA (arena_ops)
constexpr int FC_WARPS = NT / 32;  // warps of a CTA, each rpt rows of W
// counters (arena_ops.fc_counter_bytes): the grid barrier, then from word
// FC_C_COLS the slices of each column block that are done
enum { FC_C_BARRIER = 0, FC_C_COLS = 4 };

// arena_ops.FcTiling, field for field
struct FcTiling {
  int bo, bk, rpt, ncb, nks, ctas;
};

struct FcP {
  const uint8_t* x;
  uint8_t* out;
  const uint8_t* w;
  Addr xa, oa;
  int m, idim, odim, x_zp, y_zp;
  float amult;
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

template <bool Q>
__device__ void fc_run(const FcP& p, const FcTiling& t, int order,
                       int* ctr, int* part, void* red) {
  __shared__ int s_last;
  const int n = p.m * p.odim;
  const bool flat = dense(p.oa, n);
  const int nb = flat ? n : p.oa.nblk;
  const int stride = gridDim.x * NT;
  if (order != FC_OVERLAP) {
    // disjoint: this CTA's share of the block padding, at any time
    if (!flat) {
      for (int b = blockIdx.x * NT + threadIdx.x; b < nb; b += stride)
        if (elem_of(p.oa, b, n) < 0) fc_store<Q>(p.out, b, 0u);
    }
    for (int it = blockIdx.x; it < t.ctas; it += gridDim.x) {
      const int cb = it / t.nks, ks = it - cb * t.nks;
      fc_slice<Q>(p, t, cb, ks, part, red);
      __threadfence();  // this CTA's partials, before the count
      __syncthreads();
      if (threadIdx.x == 0)
        s_last = atomicAdd(ctr + FC_C_COLS + cb, 1) == t.nks - 1;
      __syncthreads();
      if (!s_last) continue;
      __threadfence();  // every slice's partials, after the count
      const int o0 = cb * t.bo, bw = min(t.bo, p.odim - o0);
      for (int i = threadIdx.x; i < p.m * bw; i += NT) {
        const int r = i / bw, o = o0 + i - r * bw;
        fc_store<Q>(p.out, elem_at(p.oa, r * p.odim + o),
                    fc_finish<Q>(p, part, t.nks, r, o));
      }
      __syncthreads();
    }
    return;
  }
  // overlap: one item a CTA (the entry point launches exactly t.ctas, all
  // resident); partials, the barrier, then the whole block between them
  const int cb = blockIdx.x / t.nks, ks = blockIdx.x - cb * t.nks;
  fc_slice<Q>(p, t, cb, ks, part, red);
  grid_barrier(ctr + FC_C_BARRIER);  // x is read whole before any store
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

// The grid body of fully connected descriptor d on the arena: its tiling
// and order word, the counters at the workspace's start, the partials in
// the "stage" words' buffer (global), the warps' sums in the "row" words'
// (shared memory).
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
  const int* tw = d + FC_D_TILING;
  const FcTiling t{tw[0], tw[1], tw[2], tw[3], tw[4], tw[5]};
  int* ctr = (int*)gws;
  int* part = (int*)buffer(d, D_STAGE_G, smem, gws);
  void* red = buffer(d, D_ROW_G, smem, gws);
  if (d[D_QUANT]) fc_run<true>(p, t, d[FC_D_ORDER], ctr, part, red);
  else fc_run<false>(p, t, d[FC_D_ORDER], ctr, part, red);
}

}  // namespace arena
