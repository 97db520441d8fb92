// Shared device code of the arena kernels (sm_90a), for the reference's
// three in-place arena programs: flat, row-blocked and streaming (the
// blocked arena, each op run on its live window only; see the stream
// block words near the end).
//
// The arena is ONE device buffer. In the flat program it is uint8 bytes of
// exactly the planner's peak, every operand at a byte offset (f32 operands
// at 4-byte-aligned offsets, which the planner guarantees). In the
// row-blocked program it is a typed (rows, L) buffer (int8 or f32) laid out
// by the reference's legaliser: an operand's block starts at an arena row,
// and its image rows are packed (cols_per_row c > 1 image rows per arena
// row, at lane phase (iy % c) * rl), spanning (one image row over k > 1
// arena rows) or plain (one per arena row). In all three one image row is
// contiguous, so the kernels address it by one pointer (row_elem below) and
// index columns and channels as in the flat program, which is the
// degenerate case c = k = 1, L = used = one image row. Nothing assumes row
// alignment beyond the element type: a row of the standalone depthwise
// kernel is max(iw, ow) * c f32 elements, not a multiple of 16 bytes.
//
// Each op is described by a descriptor of DESC_WORDS int32 words built from
// the lowered OpSpec by repro_torch/kernels/arena_ops.py (the word offsets
// below are mirrored there; f32 constants travel as their IEEE bit
// patterns). Operand base offsets are bytes in both programs.
//
// Stores follow the reference's kernels exactly, since whole arenas are
// compared: a plain or spanning row store writes its used elements and
// zeroes the rest of its k * L arena elements (_pad_cols); a packed row
// store writes only its own lane phase (the reference's read-modify-write
// of the arena row); a whole-block op writes its whole padded (rows, L)
// block, zeros in the per-row padding and the dense tail (_enc_block).
//
// Paper §III.F: the planner overlaps an op's input and output diagonally
// (safe overlap O_s), which is only safe when output rows are produced in
// ascending order and every read of row oy happens after the row oy-1
// store. Kernels over the whole card keep that with counters in global
// memory: conv2d / depthwise (arena_conv.cu), pool (arena_pool.cu) and the
// streaming program's rolling conv, depthwise and pool
// (arena_stream_roll.cu) run row tiles whose stores wait for the reads of
// every tile of their row and the rows before (conv_tiles.cuh);
// elementwise, concat, mean and pad (arena_elementwise.cu,
// arena_concat.cu, arena_mean.cu, arena_pad.cu, and those staged bodies of
// arena_stream_stage.cu), softmax (arena_softmax.cu, and the staged
// softmax body), fully connected and matmul (arena_fully_connected.cu,
// arena_matmul.cu, and their staged bodies) read every input their output
// could clobber before one grid-wide barrier (grid_barrier below;
// ew_tiles.cuh, softmax_tiles.cuh, fc_tiles.cuh), or, where the byte
// ranges prove it needless, never wait; the fused chains
// (arena_fused_chain.cu, arena_stream_fused.cu) run their stages in levels
// with a grid-wide barrier between levels and write the arena only in the
// last (chain_tiles.cuh). In the row-blocked program the legaliser
// re-derives every diagonal distance in whole arena rows, so the padding a
// row store zeroes is dead.
//
// Buffers (a grid's staged results, a tile's footprint, a row) live in
// dynamic shared memory when they fit a CTA and otherwise in a global
// workspace the wrapper allocates once per spec; the descriptor says which
// (words D_STAGE_G.. below). Both placements are the kernel.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace arena {

constexpr int NT = 512;          // threads of a chunk-walk CTA
constexpr int DESC_WORDS = 256;  // int32 words per op/stage descriptor
constexpr int MAX_CAT = 16;      // concat inputs a descriptor can hold
constexpr int MAX_DIMS = 6;      // elementwise broadcast rank

// op kinds
enum { K_CONV2D = 0, K_DEPTHWISE = 1, K_CONCAT = 2, K_MEAN = 3, K_FC = 4,
       K_SOFTMAX = 5, K_POOL = 6, K_ELEMENTWISE = 7, K_MATMUL = 8,
       K_PAD = 9 };
// elementwise functions (the reference's _ELEMENTWISE table); the binary
// ones are EW_ADD and above
enum { EW_RELU = 0, EW_RELU6 = 1, EW_SIGMOID = 2, EW_IDENTITY = 3,
       EW_ADD = 4, EW_MUL = 5, EW_SUB = 6 };

// words every descriptor carries
enum { D_KIND = 0, D_QUANT = 1, D_WOFF = 2, D_IN_OFF = 3, D_OUT_OFF = 4,
       D_IN_SCR = 5, D_OUT_SCR = 6, D_X_ZP = 7, D_Y_ZP = 8, D_AMULT = 9 };
// conv2d / depthwise / pool (pool: D_MULT = 1 for max, 0 for avg)
enum { D_IH = 10, D_IW, D_IC, D_OH, D_OW, D_OC, D_KH, D_KW, D_SH, D_SW,
       D_DH, D_DW, D_PH, D_PW, D_MULT };
// mean: dims padded to 4 with leading 1s, bit i of RMASK = axis i reduced
enum { D_DIM0 = 10, D_RMASK = 14, D_CNT = 15, D_OUTN = 16 };
// fully connected
enum { D_M = 10, D_IDIM = 11, D_ODIM = 12 };
// softmax over the last axis
enum { D_ROWS = 10, D_LAST = 11, D_XSCALE = 12, D_YSCALE = 13 };
// concat: outer = product of the dims before the axis, inner = the rest
enum { D_NIN = 10, D_OUTER = 11, D_INNER_OUT = 12, D_CIN_OFF = 16,
       D_CIN_SCR = 32, D_CINNER = 48, D_CZP = 64, D_CMULT = 80 };
// elementwise: EDIM = the first operand's dims, BSTR = the second
// operand's strides over them (0 on a broadcast axis), both padded to
// MAX_DIMS with leading 1s / 0s
enum { D_FN = 10, D_EN = 11, D_BCAST = 12, D_IN2_OFF = 13, D_IN2_SCR = 14,
       D_ASCALE = 15, D_BZP = 16, D_BSCALE = 17, D_OSCALE = 18,
       D_EDIM0 = 20, D_BSTR0 = 26 };
// matmul: (M, K) x (K, N); the second operand at D_IN2_OFF, zero point D_BZP
enum { D_MM = 10, D_MK = 11, D_MN = 12 };
// pad: dims padded to 4 with leading 1s and zero pads
enum { D_PIN0 = 10, D_PLO0 = 14, D_POUT0 = 18, D_PN = 22 };
// buffer placement: a flag (1 = global workspace, 0 = dynamic shared
// memory) then a byte offset; a fused chain carries them in its header
enum { D_STAGE_G = 120, D_STAGE_OFF = 121, D_ROW_G = 122, D_ROW_OFF = 123 };
// operand addressing: slot 0 = the output, slot 1 + i = input i, each
// ADDR_WORDS words (L, c, k, rl, used, nblk)
enum { D_ADDR = 128, ADDR_WORDS = 6 };

// How one operand's tensor elements sit in the arena (see the top).
struct Addr {
  int L;     // arena row elements (flat: one image row)
  int c;     // image rows packed per arena row
  int k;     // arena rows one image row spans
  int rl;    // elements of one image row (packed and spanning)
  int used;  // used elements of each arena row (whole-block addressing)
  int nblk;  // elements a whole-block write covers (rows * L; flat: n)
};

__device__ __forceinline__ Addr load_addr(const int* d, int slot) {
  const int* a = d + D_ADDR + ADDR_WORDS * slot;
  Addr r;
  r.L = a[0]; r.c = a[1]; r.k = a[2]; r.rl = a[3]; r.used = a[4];
  r.nblk = a[5];
  return r;
}

// Element offset of image row iy's first element (_dec_row).
__device__ __forceinline__ int row_elem(const Addr& a, int iy) {
  if (a.c > 1) return (iy / a.c) * a.L + (iy % a.c) * a.rl;
  return iy * a.k * a.L;
}

// Element offset of tensor element e (_dec_block).
__device__ __forceinline__ int elem_at(const Addr& a, int e) {
  if (a.k > 1) return (e / a.rl) * a.k * a.L + e % a.rl;
  if (a.L == a.used) return e;
  return (e / a.used) * a.L + e % a.used;
}

// The tensor element block element b holds, or -1 for padding
// (_enc_block's inverse).
__device__ __forceinline__ int elem_of(const Addr& a, int b, int n) {
  const int r = b / a.L, j = b - r * a.L;
  int e;
  if (a.k > 1) {
    const int col = (r % a.k) * a.L + j;
    if (col >= a.rl) return -1;
    e = (r / a.k) * a.rl + col;
  } else {
    if (j >= a.used) return -1;
    e = r * a.used + j;
  }
  return e < n ? e : -1;
}

// Is the whole block exactly the tensor, element for element (the flat
// program, and dense blocks without padding)?
__device__ __forceinline__ bool dense(const Addr& a, int n) {
  return a.k == 1 && a.L == a.used && a.nblk == n;
}

__device__ __forceinline__ float fword(const int* d, int i) {
  return __int_as_float(d[i]);
}

__device__ __forceinline__ uint8_t* buffer(const int* d, int word,
                                           uint8_t* smem, uint8_t* gws) {
  return (d[word] ? gws : smem) + d[word + 1];
}

// ops.requantise, operation for operation: f32 product (no contraction),
// round half to even (np.round), + zero point, clip to int8.
__device__ __forceinline__ int8_t requant_f(float v, float mult, int zp) {
  float q = __fadd_rn(rintf(__fmul_rn(v, mult)), (float)zp);
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return (int8_t)(int)q;
}

__device__ __forceinline__ int8_t requant_i(int acc, float mult, int zp) {
  return requant_f(__int2float_rn(acc), mult, zp);
}

// ops.quantise: IEEE division by the scale, not a reciprocal product.
__device__ __forceinline__ int8_t quant_f(float v, float scale, int zp) {
  float q = __fadd_rn(rintf(__fdiv_rn(v, scale)), (float)zp);
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return (int8_t)(int)q;
}

__device__ __forceinline__ float dequant(int8_t q, float scale, int zp) {
  return __fmul_rn(__fsub_rn((float)q, (float)zp), scale);
}

struct ConvP {
  int ih, iw, ic, oh, ow, oc, kh, kw, sh, sw, dh, dw, ph, pw, m;
  int x_zp, y_zp;
  float amult;
  Addr ia, oa;  // the input's and the output's addressing
};

__device__ __forceinline__ ConvP load_conv(const int* d) {
  ConvP p;
  p.ih = d[D_IH]; p.iw = d[D_IW]; p.ic = d[D_IC];
  p.oh = d[D_OH]; p.ow = d[D_OW]; p.oc = d[D_OC];
  p.kh = d[D_KH]; p.kw = d[D_KW]; p.sh = d[D_SH]; p.sw = d[D_SW];
  p.dh = d[D_DH]; p.dw = d[D_DW]; p.ph = d[D_PH]; p.pw = d[D_PW];
  p.m = d[D_MULT];
  p.x_zp = d[D_X_ZP]; p.y_zp = d[D_Y_ZP]; p.amult = fword(d, D_AMULT);
  p.ia = load_addr(d, 1); p.oa = load_addr(d, 0);
  return p;
}

// One output element (oy, ox, o) of conv2d / depthwise (channel multiplier
// m: output channel = ic*m + j). Taps at iy = oy*sh - ph + fy*dh (ph may be
// negative for a producer band); out-of-range taps contribute nothing, which
// is the reference's clamp-and-mask (a masked int8 tap is x_zp - x_zp = 0).
// Returns the int8 result in the low byte, or the f32 result's bits.
template <bool Q, bool DW>
__device__ __forceinline__ uint32_t conv_point(const uint8_t* in,
                                               const uint8_t* w,
                                               const ConvP& p, int oy,
                                               int ox, int o) {
  typedef typename std::conditional<Q, int, float>::type acc_t;
  acc_t acc = 0;
  int c0 = 0, j = 0;
  if constexpr (DW) { c0 = o / p.m; j = o - c0 * p.m; }
  for (int fy = 0; fy < p.kh; ++fy) {
    const int iy = oy * p.sh - p.ph + fy * p.dh;
    if (iy < 0 || iy >= p.ih) continue;
    const int row = row_elem(p.ia, iy);
    for (int fx = 0; fx < p.kw; ++fx) {
      const int ix = ox * p.sw - p.pw + fx * p.dw;
      if (ix < 0 || ix >= p.iw) continue;
      const int pix = row + ix * p.ic;
      const int tap = fy * p.kw + fx;
      if constexpr (DW) {
        const int wi = (tap * p.ic + c0) * p.m + j;
        if constexpr (Q) {
          acc += ((int)((const int8_t*)in)[pix + c0] - p.x_zp)
                 * (int)((const int8_t*)w)[wi];
        } else {
          acc += ((const float*)in)[pix + c0] * ((const float*)w)[wi];
        }
      } else {
        const int wb = tap * p.ic * p.oc + o;
        for (int c = 0; c < p.ic; ++c) {
          if constexpr (Q) {
            acc += ((int)((const int8_t*)in)[pix + c] - p.x_zp)
                   * (int)((const int8_t*)w)[wb + c * p.oc];
          } else {
            acc += ((const float*)in)[pix + c]
                   * ((const float*)w)[wb + c * p.oc];
          }
        }
      }
    }
  }
  if constexpr (Q) return (uint32_t)(uint8_t)requant_i(acc, p.amult, p.y_zp);
  else return __float_as_uint(acc);
}

// One output element (oy, ox, c) of max or average pooling: taps at
// iy = oy*sh - ph + fy (ph, pw are the leading pads only: TF SAME pads
// unevenly), the average over the valid taps. int8 max starts at
// -2147483647 and requantises acc - x_zp; int8 avg requantises
// acc / max(cnt, 1) - x_zp in f32.
template <bool Q, bool MAX>
__device__ __forceinline__ uint32_t pool_point(const uint8_t* in,
                                               const ConvP& p, int oy,
                                               int ox, int c) {
  typedef typename std::conditional<Q, int, float>::type acc_t;
  acc_t acc;
  if constexpr (MAX) {
    if constexpr (Q) acc = -2147483647;
    else acc = __int_as_float(0xff800000);  // -inf
  } else {
    acc = 0;
  }
  int cnt = 0;
  for (int fy = 0; fy < p.kh; ++fy) {
    const int iy = oy * p.sh - p.ph + fy;
    if (iy < 0 || iy >= p.ih) continue;
    const int row = row_elem(p.ia, iy);
    for (int fx = 0; fx < p.kw; ++fx) {
      const int ix = ox * p.sw - p.pw + fx;
      if (ix < 0 || ix >= p.iw) continue;
      const int i = row + ix * p.ic + c;
      acc_t v;
      if constexpr (Q) v = ((const int8_t*)in)[i];
      else v = ((const float*)in)[i];
      if constexpr (MAX && Q) acc = max(acc, v);
      else if constexpr (MAX) acc = fmaxf(acc, v);
      else acc += v;
      ++cnt;
    }
  }
  if constexpr (Q) {
    if constexpr (MAX) {
      return (uint32_t)(uint8_t)requant_i(acc - p.x_zp, p.amult, p.y_zp);
    } else {
      const float v = __fsub_rn(
          __fdiv_rn(__int2float_rn(acc), fmaxf((float)cnt, 1.0f)),
          (float)p.x_zp);
      return (uint32_t)(uint8_t)requant_f(v, p.amult, p.y_zp);
    }
  } else {
    if constexpr (MAX) return __float_as_uint(acc);
    else return __float_as_uint(__fdiv_rn(acc, fmaxf((float)cnt, 1.0f)));
  }
}

// relu, relu6, sigmoid, identity, add, mul, sub of operand values a and b
// (the reference's _ELEMENTWISE table; IEEE operations, no contraction).
__device__ __forceinline__ float ew_apply(int fn, float a, float b) {
  switch (fn) {
    case EW_RELU: return fmaxf(a, 0.0f);
    case EW_RELU6: return fminf(fmaxf(a, 0.0f), 6.0f);
    case EW_SIGMOID: return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a)));
    case EW_IDENTITY: return a;
    case EW_ADD: return __fadd_rn(a, b);
    case EW_MUL: return __fmul_rn(a, b);
    default: return __fsub_rn(a, b);  // EW_SUB
  }
}

// One grid-wide barrier over a resident grid (a cooperative launch): every
// CTA's earlier reads are done, and its earlier stores visible, before any
// CTA goes on. `ctr` is a counter the entry point zeroed before the launch.
__device__ __forceinline__ void grid_barrier(int* ctr) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1);
    while (*(volatile int*)ctr < (int)gridDim.x) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The streaming program (arena_stream_*.cu): a rolling op reads its window
// in place, tile by tile (arena_stream_roll.cu); the staged bodies and the
// fused chains run in place on the arena. A streaming descriptor is a
// stream block, then the op's descriptor (or a fused chain's header and
// stages) at word S_BODY.
// ---------------------------------------------------------------------------

// stream block words: the body's word offset and the rolling statics (the
// input's arena row, window rows, image rows of a streaming tile, tiles,
// output rows); from S_COPY0 the planner's S_T fetch starts
enum { S_BODY = 0, S_IN_ROW = 1, S_WIN_IN = 2, S_TR = 3, S_T = 4, S_OH = 5,
       S_COPY0 = 8 };

}  // namespace arena

// The kernel opts in to each larger dynamic shared memory size it is
// launched with, not only past 48 KB: a kernel with static shared arrays
// (a CTA row's reduction) needs the opt-in below 48 KB of dynamic memory
// too.
template <typename K>
static cudaError_t set_smem(K kernel, int smem, int* configured) {
  if (smem > *configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    *configured = smem;
  }
  return cudaSuccess;
}

// What a grid entry point keeps between calls: the kernel's shared memory
// opt-in, the card's SMs and the kernel's CTAs an SM at the last shared
// memory size.
struct GridLaunch {
  int configured = 0, sms = 0, occ_smem = -1, occ = 0;
};

// The entry point of a kernel over the whole card (conv_tiles.cuh's row
// tiles, ew_tiles.cuh's elementwise, concat, mean and pad chunks,
// softmax_tiles.cuh's rows, fc_tiles.cuh's column blocks and K slices):
// zeroes `counter_bytes` of counters at the workspace's start on the
// stream, then launches `kernel`
// over as many CTAs of THREADS threads as the card holds at once, at most
// `grid` (a one-CTA launch, `grid` 1 and `group` 0, skips the count).
// With `group` > 0 CTAs wait on each other: the launch is cooperative (all
// resident), and a card that cannot hold `group` CTAs at once is refused
// with an error code, never run on fewer, where CTAs could wait on ones
// that never run.
template <int THREADS, typename K>
static int launch_grid(K kernel, GridLaunch& st, void* arena_buf,
                       const void* desc, const void* w, void* gws, int smem,
                       int grid, int group, int counter_bytes,
                       void* stream) {
  cudaError_t e = set_smem(kernel, smem, &st.configured);
  if (e != cudaSuccess) return (int)e;
  if (grid > 1 || group > 0) {
    if (!st.sms) {
      int dev = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
      if (e != cudaSuccess) return (int)e;
    }
    if (smem != st.occ_smem) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&st.occ, kernel,
                                                        THREADS, smem);
      if (e != cudaSuccess) return (int)e;
      st.occ_smem = smem;
    }
    grid = grid < st.sms * st.occ ? grid : st.sms * st.occ;
  }
  if (grid < group || grid < 1)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaStream_t s = (cudaStream_t)stream;
  if (counter_bytes) {
    e = cudaMemsetAsync(gws, 0, counter_bytes, s);
    if (e != cudaSuccess) return (int)e;
  }
  uint8_t* a = (uint8_t*)arena_buf;
  const int* dd = (const int*)desc;
  const uint8_t* ww = (const uint8_t*)w;
  uint8_t* g = (uint8_t*)gws;
  if (group > 0) {
    void* args[] = {&a, &dd, &ww, &g};
    e = cudaLaunchCooperativeKernel((const void*)kernel, grid, THREADS, args,
                                    (size_t)smem, s);
    if (e != cudaSuccess) return (int)e;
  } else {
    kernel<<<grid, THREADS, smem, s>>>(a, dd, ww, g);
  }
  return (int)cudaGetLastError();
}
