// Row tiles over the whole card, shared by arena_conv (the standalone
// conv2d / depthwise), arena_pool (max and average pooling of the flat and
// row-blocked programs), arena_stream_roll (conv2d, depthwise and pool
// of the streaming program) and the fused chains' conv2d, depthwise and
// pool stages (chain_tiles.cuh: one tile a ticket of its level, order
// word 0, operands in the arena or the chain's workspace).
//
// - A tile is (output row, a block of output columns, a block of output
//   channels), sized by arena_ops.conv_tiling so its input footprint (kh
//   input rows x the columns it reaches x every input channel, or the
//   channel block of a depthwise or pool tile) fits shared memory; a larger
//   one is staged in the CTA's slice of the spec's global workspace. CTAs
//   take tiles by an atomicAdd ticket in row-major order, so a CTA only
//   ever waits on tickets running CTAs hold; the launch is cooperative, so
//   all of them are resident, and the entry point refuses a grid smaller
//   than the tiles that must run at once (one row's, or one row group's).
// - A footprint tap row is found by a row policy `rows(a, r, iy)`: the
//   element offset, from the input pointer, of input image row iy as output
//   row r reads it (arena_conv and arena_pool: row_elem, ArenaRows below;
//   the rolling kernel: the row rebased on its streaming tile's fetch
//   start and clamped into the window). The policy also names output row
//   r's group of rows, [first(r), end(r, oh)), for order word 2 below.
// - A tile copies its footprint in, then (op overlapping its input, order
//   word >= 1) counts itself staged in its row's counter, computes from
//   the copy, and stores only once every tile of its row and of the rows
//   before has staged: the planner's overlap never lets a row's store
//   reach a later row's reads, so that is every read the store could
//   clobber. Where a later row reads an earlier row's store (order word 2,
//   only hand-built specs), the groups of rows run one after another: a
//   tile reads only once every row of the groups before is stored, and
//   stores only once every tile of its group (and before) has staged
//   (arena_conv: groups of one row, the one-CTA row walk's order; the
//   rolling kernel: its streaming tiles, the order of a window fetched per
//   tile). A disjoint op (order word 0) neither publishes nor waits.
//   The counters live at the start of the workspace and the entry point
//   zeroes them on the stream before each launch.
// - Each conv output keeps conv_point's accumulation exactly (one
//   accumulator, fy -> fx -> c ascending, `acc += x * w`, masked taps
//   skipped), each pool output pool_point's (max from -inf or -2147483647,
//   avg summed fy -> fx and divided by the valid taps), so f32 stays
//   bit-equal to the row walks. A thread holds VO output channels (one
//   16-byte filter load each input channel) of VP pixels in registers.
// - Stores: plain or spanning rows zero the rest of their k * L elements
//   (the row's last tile does it), packed rows write only their own lane
//   phase.
#pragma once

#include "arena_common.cuh"

namespace arena {

constexpr int CT = 256;  // threads of a tile CTA (arena_ops.CONV_THREADS)
enum { D_ORDER = 100, D_TILING = 101 };  // arena_ops.D_ORDER, D_TILING
// counters (arena_ops.conv_counter_bytes): the next ticket, tiles stored,
// then from word C_ROWS the tiles of each output row that have staged
enum { C_TICKET = 0, C_STORED = 1, C_ROWS = 4 };
// tile bodies: conv2d, depthwise, max pool, average pool
enum { B_CONV = 0, B_DW = 1, B_MAX = 2, B_AVG = 3 };

// arena_ops.ConvTiling, field for field
struct Tiling {
  int vp, vo, nog, tc, to, ib, fw, ncb, nob, tpr, ntiles, fp, ch, ps;
};

__device__ __forceinline__ Tiling load_tiling(const int* d) {
  const int* a = d + D_TILING;
  Tiling t;
  t.vp = a[0]; t.vo = a[1]; t.nog = a[2]; t.tc = a[3]; t.to = a[4];
  t.ib = a[5]; t.fw = a[6]; t.ncb = a[7]; t.nob = a[8]; t.tpr = a[9];
  t.ntiles = a[10]; t.fp = a[11]; t.ch = a[12]; t.ps = a[13];
  return t;
}

// Spin until counter *c reaches v; the fence (then the CTA's barrier)
// orders what the CTA does next after what that counter published.
__device__ __forceinline__ void wait_for(int* c, int v) {
  while (*(volatile int*)c < v) __nanosleep(32);
  __threadfence();
}

// `cols` columns of `n` bytes each, `sstride` bytes apart in the arena
// and `dstride` apart in the footprint, 16, 4 or 1 bytes a copy as both
// ends and the strides allow. The loads skip L1 (ld.global.cg): other
// CTAs store into the arena while the kernel runs, and an order-2 tile
// reads what they stored.
__device__ __forceinline__ void copy_columns(uint8_t* dst,
                                             const uint8_t* src, int cols,
                                             int n, int sstride,
                                             int dstride) {
  const uintptr_t al = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)n
                       | (uintptr_t)sstride | (uintptr_t)dstride;
  if ((al & 15) == 0) {
    const int u = n / 16;
    for (int e = threadIdx.x; e < cols * u; e += CT) {
      const int c = e / u, k = e - c * u;
      *(uint4*)(dst + c * dstride + k * 16) =
          __ldcg((const uint4*)(src + c * sstride) + k);
    }
  } else if ((al & 3) == 0) {
    const int u = n / 4;
    for (int e = threadIdx.x; e < cols * u; e += CT) {
      const int c = e / u, k = e - c * u;
      *(uint32_t*)(dst + c * dstride + k * 4) =
          __ldcg((const unsigned int*)(src + c * sstride) + k);
    }
  } else {
    for (int e = threadIdx.x; e < cols * n; e += CT) {
      const int c = e / n, k = e - c * n;
      dst[c * dstride + k] = __ldcg(src + c * sstride + k);
    }
  }
}

// cp.async of `bytes` (16 or 4) global -> shared, and its groups.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int VO, typename W>
__device__ __forceinline__ void load_w(W (&wv)[VO], const W* p, bool vec) {
  if constexpr (VO == 4) {
    if (vec) {
      if constexpr (sizeof(W) == 4) {
        const float4 v = __ldg((const float4*)p);
        wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
      } else {
        const char4 v = __ldg((const char4*)p);
        wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VO; ++j) wv[j] = __ldg(p + j);
}

// A conv2d tile's taps with its filter staged in shared memory: steps
// (tap, chunk of tl.ch input channels) run fy -> fx -> c ascending, as
// conv_point does per output; chunk st + 1 copies in (cp.async) while st
// computes. Every thread of the CTA takes part (the barriers); inactive
// ones only copy.
template <bool Q, int VP>
__device__ __forceinline__ void staged_taps(
    const ConvP& p, const Tiling& tl, const uint8_t* wbytes,
    const typename std::conditional<Q, int8_t, float>::type* S,
    uint8_t* wsm, int r, int x0, int o0, int og, const int (&lx)[VP],
    bool active,
    typename std::conditional<Q, int, float>::type (&acc)[VP][4]) {
  typedef typename std::conditional<Q, int8_t, float>::type T;
  const int tid = threadIdx.x;
  constexpr int isz = Q ? 1 : 4;
  const int nch = (p.ic + tl.ch - 1) / tl.ch;
  const int steps = p.kh * p.kw * nch;
  const int tow = min(tl.to, p.oc - o0);  // a multiple of four
  constexpr int U = Q ? 4 : 16;           // bytes a copy
  const int upr = tow * isz / U;
  T* wbuf = (T*)wsm;
  auto fetch = [&](int st) {
    const int tap = st / nch, c0 = (st - tap * nch) * tl.ch;
    const int iy = r * p.sh - p.ph + (tap / p.kw) * p.dh;
    if (iy < 0 || iy >= p.ih) return;
    const int rows = min(tl.ch, p.ic - c0);
    uint8_t* dst = (uint8_t*)(wbuf + (st & 1) * tl.ch * tl.to);
    const uint8_t* src = wbytes
        + ((size_t)(tap * p.ic + c0) * p.oc + o0) * isz;
    for (int e = tid; e < rows * upr; e += CT) {
      const int rr = e / upr, u = e - rr * upr;
      cp_async<U>(dst + rr * tl.to * isz + u * U,
                  src + (size_t)rr * p.oc * isz + u * U);
    }
  };
  fetch(0);
  cp_commit();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) fetch(st + 1);
    cp_commit();
    cp_wait_prev();
    __syncthreads();  // chunk st is in
    const int tap = st / nch, c0 = (st - tap * nch) * tl.ch;
    const int fy = tap / p.kw, fx = tap - fy * p.kw;
    const int iy = r * p.sh - p.ph + fy * p.dh;
    if (active && iy >= 0 && iy < p.ih) {
      const int rows = min(tl.ch, p.ic - c0);
      const T* srow = S + fy * tl.fw * tl.ps + c0;
      bool ok[VP];
      const T* xp[VP];
#pragma unroll
      for (int i = 0; i < VP; ++i) {
        const int ix = (x0 + lx[i]) * p.sw - p.pw + fx * p.dw;
        ok[i] = x0 + lx[i] < p.ow && ix >= 0 && ix < p.iw;
        xp[i] = srow + (lx[i] * p.sw + fx * p.dw) * tl.ps;
      }
      const T* wr = wbuf + (st & 1) * tl.ch * tl.to + og * 4;
#pragma unroll 8
      for (int c = 0; c < rows; ++c) {
        T wv[4];
        if constexpr (Q) {
          const char4 v = *(const char4*)(wr + c * tl.to);
          wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
        } else {
          const float4 v = *(const float4*)(wr + c * tl.to);
          wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < VP; ++i) {
          if (!ok[i]) continue;
          if constexpr (Q) {
            const int x = (int)xp[i][c] - p.x_zp;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += x * (int)wv[j];
          } else {
            const float x = xp[i][c];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += x * wv[j];
          }
        }
      }
    }
    __syncthreads();  // chunk st is free for st + 2
  }
}

// The stored bits of one output from its accumulator: a conv's int8
// requantisation or f32 sum; a pool's, as pool_point finishes it (cnt:
// its valid taps).
template <bool Q, int B, typename A>
__device__ __forceinline__ uint32_t finish(A acc, int cnt, const ConvP& p) {
  if constexpr (Q) {
    if constexpr (B == B_AVG) {
      const float v = __fsub_rn(
          __fdiv_rn(__int2float_rn(acc), fmaxf((float)cnt, 1.0f)),
          (float)p.x_zp);
      return (uint32_t)(uint8_t)requant_f(v, p.amult, p.y_zp);
    } else if constexpr (B == B_MAX) {
      return (uint32_t)(uint8_t)requant_i(acc - p.x_zp, p.amult, p.y_zp);
    } else {
      return (uint32_t)(uint8_t)requant_i(acc, p.amult, p.y_zp);
    }
  } else {
    if constexpr (B == B_AVG)
      return __float_as_uint(__fdiv_rn(acc, fmaxf((float)cnt, 1.0f)));
    else
      return __float_as_uint(acc);
  }
}

// Tile t of one op under order word `order`; `in` and `out` point at the
// input's and the output's first element, `rows` is the footprint's row
// policy, `staged_rows` the rows below which every tile has staged (order
// word >= 1: CTA-uniform, carried from tile to tile). Every thread of the
// CTA takes part; it ends with a barrier.
template <bool Q, int B, int VP, int VO, typename Rows>
__device__ __forceinline__ void conv_tile(const ConvP& p, const Tiling& tl,
                                          int order, const uint8_t* in,
                                          uint8_t* out,
                                          const uint8_t* wbytes,
                                          uint8_t* tile, uint8_t* wsm,
                                          int* ctr, const Rows& rows, int t,
                                          int& staged_rows) {
  typedef typename std::conditional<Q, int8_t, float>::type T;
  typedef typename std::conditional<Q, int, float>::type acc_t;
  constexpr bool POOL = B == B_MAX || B == B_AVG;
  constexpr bool CHB = B != B_CONV;  // one input channel an output
  const int tid = threadIdx.x;
  const int og = tid % tl.nog, slot = tid / tl.nog, npx = CT / tl.nog;
  const int m = B == B_DW ? p.m : 1;  // a pool's D_MULT is its mode
  const T* w = (const T*)wbytes;
  const T* S = (const T*)tile;
  const int isz = Q ? 1 : 4;
  // 16-byte (int8: 4-byte) filter loads: four channels from a multiple of
  // four, oc a multiple of four, the filter aligned
  const bool wvec = VO == 4 && ((uintptr_t)wbytes & (4 * isz - 1)) == 0;
  // such filters stage in shared memory, tl.ch input channels a chunk
  const bool wstage = wvec && tl.ch > 0;
  const int n = p.ow * p.oc;
  const int r = t / tl.tpr, rem = t - r * tl.tpr;
  const int cb = rem / tl.nob, ob = rem - cb * tl.nob;
  const int x0 = cb * tl.tc, o0 = ob * tl.to;
  const int c_lo = CHB ? o0 / m : 0;
  const int ix0 = x0 * p.sw - p.pw;
  if (order == 2) {  // reads follow every earlier group's store
    if (tid == 0) wait_for(ctr + C_STORED, rows.first(r) * tl.tpr);
    __syncthreads();
  }

  // 1. stage the footprint: tap row fy, column ix - ix0 (every tl.ps
  // elements), channel c - c_lo
  const int ixs = max(ix0, 0), ixe = min(ix0 + tl.fw, p.iw);
  const int pxb = min(tl.ib, p.ic - c_lo) * isz;  // bytes a column
  for (int fy = 0; fy < p.kh; ++fy) {
    const int iy = r * p.sh - p.ph + fy * p.dh;
    if (iy < 0 || iy >= p.ih || ixe <= ixs) continue;
    copy_columns(tile + (fy * tl.fw + (ixs - ix0)) * tl.ps * isz,
                 in + (rows(p.ia, r, iy) + ixs * p.ic + c_lo) * isz,
                 ixe - ixs, pxb, p.ic * isz, tl.ps * isz);
  }
  __syncthreads();  // the whole footprint is read
  if (order >= 1 && tid == 0) {
    __threadfence();
    atomicAdd(ctr + C_ROWS + r, 1);
  }

  // 2. compute from the copy, conv_point's or pool_point's order per
  // output
  int lx[VP];
#pragma unroll
  for (int i = 0; i < VP; ++i) lx[i] = slot + i * npx;
  const int ob0 = o0 + og * VO;  // this thread's first output channel
  const bool active = ob0 < p.oc;
  acc_t acc[VP][VO];
  int cnt[VP];
#pragma unroll
  for (int i = 0; i < VP; ++i) {
    cnt[i] = 0;
#pragma unroll
    for (int j = 0; j < VO; ++j) {
      if constexpr (B == B_MAX) {
        if constexpr (Q) acc[i][j] = -2147483647;
        else acc[i][j] = __int_as_float(0xff800000);  // -inf
      } else {
        acc[i][j] = 0;
      }
    }
  }
  if (B == B_CONV && VO == 4 && wstage) {
    if constexpr (B == B_CONV && VO == 4)
      staged_taps<Q, VP>(p, tl, wbytes, S, wsm, r, x0, o0, og, lx, active,
                         acc);
  } else if (active) {
    int c0 = 0, jm = 0;
    if constexpr (CHB) { c0 = ob0 / m; jm = ob0 - c0 * m; }
    for (int fy = 0; fy < p.kh; ++fy) {
      const int iy = r * p.sh - p.ph + fy * p.dh;
      if (iy < 0 || iy >= p.ih) continue;
      const T* srow = S + fy * tl.fw * tl.ps;
      for (int fx = 0; fx < p.kw; ++fx) {
        bool ok[VP];
        const T* xp[VP];
#pragma unroll
        for (int i = 0; i < VP; ++i) {
          const int ix = (x0 + lx[i]) * p.sw - p.pw + fx * p.dw;
          ok[i] = x0 + lx[i] < p.ow && ix >= 0 && ix < p.iw;
          xp[i] = srow + (lx[i] * p.sw + fx * p.dw) * tl.ps;
        }
        const int tap = fy * p.kw + fx;
        if constexpr (POOL) {
#pragma unroll
          for (int i = 0; i < VP; ++i) {
            if (!ok[i]) continue;
            acc_t v;
            if constexpr (Q) v = (int)xp[i][c0 - c_lo];
            else v = xp[i][c0 - c_lo];
            if constexpr (B == B_MAX && Q) acc[i][0] = max(acc[i][0], v);
            else if constexpr (B == B_MAX) acc[i][0] = fmaxf(acc[i][0], v);
            else acc[i][0] += v;
            ++cnt[i];
          }
        } else if constexpr (B == B_DW) {
          const acc_t wv = w[(tap * p.ic + c0) * m + jm];
#pragma unroll
          for (int i = 0; i < VP; ++i) {
            if (!ok[i]) continue;
            if constexpr (Q) acc[i][0] += ((int)xp[i][c0 - c_lo] - p.x_zp)
                                          * (int)wv;
            else acc[i][0] += xp[i][c0 - c_lo] * wv;
          }
        } else {
          const T* wr = w + tap * p.ic * p.oc + ob0;
#pragma unroll 8
          for (int c = 0; c < p.ic; ++c) {
            T wv[VO];
            load_w<VO>(wv, wr + c * p.oc, wvec);
#pragma unroll
            for (int i = 0; i < VP; ++i) {
              if (!ok[i]) continue;
              if constexpr (Q) {
                const int x = (int)xp[i][c] - p.x_zp;
#pragma unroll
                for (int j = 0; j < VO; ++j) acc[i][j] += x * (int)wv[j];
              } else {
                const float x = xp[i][c];
#pragma unroll
                for (int j = 0; j < VO; ++j) acc[i][j] += x * wv[j];
              }
            }
          }
        }
      }
    }
  }

  // 3. store once every tile of rows < hi has staged its input (a CTA's
  // tickets ascend, so the rows it has seen complete stay complete)
  if (order >= 1) {
    const int hi = order == 2 ? rows.end(r, p.oh) : r + 1;
    if (tid < 32) {  // warp 0 checks 32 rows at a time
      for (int row = staged_rows + tid; row < hi; row += 32)
        wait_for(ctr + C_ROWS + row, tl.tpr);
    }
    staged_rows = hi;
    __syncthreads();
  }
  const int r0 = row_elem(p.oa, r);
  if (active) {
#pragma unroll
    for (int i = 0; i < VP; ++i) {
      const int ox = x0 + lx[i];
      if (ox >= p.ow) continue;
#pragma unroll
      for (int j = 0; j < VO; ++j) {
        const int o = ob0 + j;
        if (o >= p.oc) continue;
        const int e = r0 + ox * p.oc + o;
        const uint32_t v = finish<Q, B>(acc[i][j], cnt[i], p);
        if constexpr (Q) out[e] = (uint8_t)v;
        else ((uint32_t*)out)[e] = v;
      }
    }
  }
  if (rem == tl.tpr - 1 && p.oa.c == 1) {  // the row's padding
    const int span = p.oa.k * p.oa.L;
    for (int e = n + tid; e < span; e += CT) {
      if constexpr (Q) out[r0 + e] = 0;
      else ((uint32_t*)out)[r0 + e] = 0u;
    }
  }
  __syncthreads();  // stored; the footprint and the ticket are free
  if (order == 2 && tid == 0) {
    __threadfence();
    atomicAdd(ctr + C_STORED, 1);
  }
}

// The tiles of one op, ticket after ticket, until none is left.
template <bool Q, int B, int VP, int VO, typename Rows>
__device__ void conv_tiles(const int* d, const ConvP& p, const Tiling& tl,
                           const uint8_t* in, uint8_t* out,
                           const uint8_t* wbytes, uint8_t* tile,
                           uint8_t* wsm, int* ctr, const Rows& rows) {
  __shared__ int s_ticket;
  const int order = d[D_ORDER];
  int staged_rows = 0;  // rows below this have all staged (CTA-uniform)
  for (;;) {
    if (threadIdx.x == 0) s_ticket = atomicAdd(ctr + C_TICKET, 1);
    __syncthreads();
    const int t = s_ticket;
    if (t >= tl.ntiles) break;
    conv_tile<Q, B, VP, VO>(p, tl, order, in, out, wbytes, tile, wsm, ctr,
                            rows, t, staged_rows);
  }
}

template <bool Q, int B, int VO, typename Rows>
__device__ void tiles_vp(const int* d, const ConvP& p, const Tiling& tl,
                         const uint8_t* in, uint8_t* out, const uint8_t* w,
                         uint8_t* tile, uint8_t* wsm, int* ctr,
                         const Rows& rows) {
  if (tl.vp == 4)
    conv_tiles<Q, B, 4, VO>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
  else if (tl.vp == 2)
    conv_tiles<Q, B, 2, VO>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
  else
    conv_tiles<Q, B, 1, VO>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
}

// Every tile of a conv2d or depthwise (and, POOLS, pool) descriptor d.
template <bool Q, bool POOLS, typename Rows>
__device__ void run_tiles_q(const int* d, const ConvP& p, const Tiling& tl,
                            const uint8_t* in, uint8_t* out,
                            const uint8_t* w, uint8_t* tile, uint8_t* wsm,
                            int* ctr, const Rows& rows) {
  const int kind = d[D_KIND];
  if (POOLS && kind == K_POOL) {
    if constexpr (POOLS) {
      if (p.m)
        tiles_vp<Q, B_MAX, 1>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
      else
        tiles_vp<Q, B_AVG, 1>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
    }
  } else if (kind == K_DEPTHWISE) {
    tiles_vp<Q, B_DW, 1>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
  } else if (tl.vo == 4) {
    tiles_vp<Q, B_CONV, 4>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
  } else {
    tiles_vp<Q, B_CONV, 1>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
  }
}

// The row policy of arena_conv and arena_pool: each footprint row where the
// operand addressing puts it; a group (order word 2) is one output row.
struct ArenaRows {
  __device__ __forceinline__ int operator()(const Addr& a, int, int iy)
      const {
    return row_elem(a, iy);
  }
  __device__ __forceinline__ int first(int r) const { return r; }
  __device__ __forceinline__ int end(int r, int) const { return r + 1; }
};

// A tile kernel's body: descriptor d's geometry, tiling and buffers (the
// footprint in the "stage" words, the filter chunks in the "row" words,
// the counters at the workspace's start), then every tile.
template <bool POOLS, typename Rows>
__device__ __forceinline__ void run_tiles(uint8_t* arena_buf, const int* d,
                                          const uint8_t* w, uint8_t* gws,
                                          uint8_t* smem,
                                          const Rows& rows) {
  const ConvP p = load_conv(d);
  const Tiling tl = load_tiling(d);
  uint8_t* tile = buffer(d, D_STAGE_G, smem, gws);
  if (d[D_STAGE_G]) tile += (size_t)blockIdx.x * tl.fp;
  uint8_t* wsm = smem + d[D_ROW_OFF];  // the filter chunks (shared)
  int* ctr = (int*)gws;
  const uint8_t* in = arena_buf + d[D_IN_OFF];
  uint8_t* out = arena_buf + d[D_OUT_OFF];
  if (d[D_QUANT])
    run_tiles_q<true, POOLS>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
  else
    run_tiles_q<false, POOLS>(d, p, tl, in, out, w, tile, wsm, ctr, rows);
}

}  // namespace arena
