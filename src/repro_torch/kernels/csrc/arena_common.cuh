// Shared device code of the flat-arena kernels (sm_90a).
//
// The arena is ONE uint8 device buffer of exactly the planner's peak bytes;
// every operand lives at a byte offset (f32 operands at 4-byte-aligned
// offsets, which the planner guarantees). Each op is described by a
// descriptor of DESC_WORDS int32 words built from the lowered OpSpec by
// repro_torch/kernels/arena_ops.py (the word offsets below are mirrored
// there; f32 constants travel as their IEEE bit patterns).
//
// Paper §III.F: the planner overlaps an op's input and output diagonally
// (safe overlap O_s), which is only safe when output rows are produced in
// ascending order and every read of row oy happens after the row oy-1
// store. So every op here runs in ONE CTA that walks output rows in order;
// threads split the columns and channels of one row, hold the row's results
// in registers, and store only after a __syncthreads(); a second barrier
// orders the store before the next row's reads. Whole-block ops (mean,
// fully connected, softmax, concat) read all of their input into a staging
// buffer, synchronise, then write (read-all-before-write-all).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace arena {

constexpr int NT = 512;          // threads of the one CTA
constexpr int MAXPT = 16;        // row outputs one thread holds in registers
constexpr int DESC_WORDS = 128;  // int32 words per op/stage descriptor
constexpr int MAX_CAT = 16;      // concat inputs a descriptor can hold

// op kinds
enum { K_CONV2D = 0, K_DEPTHWISE = 1, K_CONCAT = 2, K_MEAN = 3, K_FC = 4,
       K_SOFTMAX = 5 };

// words every descriptor carries
enum { D_KIND = 0, D_QUANT = 1, D_WOFF = 2, D_IN_OFF = 3, D_OUT_OFF = 4,
       D_IN_SCR = 5, D_OUT_SCR = 6, D_X_ZP = 7, D_Y_ZP = 8, D_AMULT = 9 };
// conv2d / depthwise
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

__device__ __forceinline__ float fword(const int* d, int i) {
  return __int_as_float(d[i]);
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
};

__device__ __forceinline__ ConvP load_conv(const int* d) {
  ConvP p;
  p.ih = d[D_IH]; p.iw = d[D_IW]; p.ic = d[D_IC];
  p.oh = d[D_OH]; p.ow = d[D_OW]; p.oc = d[D_OC];
  p.kh = d[D_KH]; p.kw = d[D_KW]; p.sh = d[D_SH]; p.sw = d[D_SW];
  p.dh = d[D_DH]; p.dw = d[D_DW]; p.ph = d[D_PH]; p.pw = d[D_PW];
  p.m = d[D_MULT];
  p.x_zp = d[D_X_ZP]; p.y_zp = d[D_Y_ZP]; p.amult = fword(d, D_AMULT);
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
    for (int fx = 0; fx < p.kw; ++fx) {
      const int ix = ox * p.sw - p.pw + fx * p.dw;
      if (ix < 0 || ix >= p.iw) continue;
      const int pix = (iy * p.iw + ix) * p.ic;
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

// conv2d / depthwise over the whole op, rows ascending (see §III.F above).
// `scratch` routes scratch-flagged operands of a fused stage.
template <bool Q, bool DW>
__device__ void conv_op(const int* d, uint8_t* arena, uint8_t* scratch,
                        const uint8_t* w) {
  const ConvP p = load_conv(d);
  const uint8_t* in = (d[D_IN_SCR] ? scratch : arena) + d[D_IN_OFF];
  uint8_t* out = (d[D_OUT_SCR] ? scratch : arena) + d[D_OUT_OFF];
  const int n = p.ow * p.oc;
  for (int oy = 0; oy < p.oh; ++oy) {
    uint32_t res[MAXPT];
#pragma unroll
    for (int k = 0; k < MAXPT; ++k) {
      const int e = threadIdx.x + k * NT;
      if (e < n) {
        const int ox = e / p.oc;
        res[k] = conv_point<Q, DW>(in, w, p, oy, ox, e - ox * p.oc);
      }
    }
    __syncthreads();  // every read of row oy is done
#pragma unroll
    for (int k = 0; k < MAXPT; ++k) {
      const int e = threadIdx.x + k * NT;
      if (e < n) {
        if constexpr (Q) ((int8_t*)out)[oy * n + e] = (int8_t)(uint8_t)res[k];
        else ((float*)out)[oy * n + e] = __uint_as_float(res[k]);
      }
    }
    __syncthreads();  // row oy is stored before row oy+1 is read
  }
}

// Dispatch on the descriptor's kind and tier (uniform across the CTA).
__device__ __forceinline__ void conv_dispatch(const int* d, uint8_t* arena,
                                              uint8_t* scratch,
                                              const uint8_t* w) {
  const bool dw = d[D_KIND] == K_DEPTHWISE;
  if (d[D_QUANT]) {
    if (dw) conv_op<true, true>(d, arena, scratch, w);
    else conv_op<true, false>(d, arena, scratch, w);
  } else {
    if (dw) conv_op<false, true>(d, arena, scratch, w);
    else conv_op<false, false>(d, arena, scratch, w);
  }
}

// concat along the descriptor's axis: every input is read (and, int8,
// rescaled to the output's params as ops.rescale_q does) into `stage` in
// output order, then the whole output is written.
__device__ void concat_op(const int* d, uint8_t* arena, uint8_t* scratch,
                          uint8_t* stage) {
  const bool q = d[D_QUANT] != 0;
  const int nin = d[D_NIN], outer = d[D_OUTER], inner_out = d[D_INNER_OUT];
  const int y_zp = d[D_Y_ZP];
  int col = 0;
  for (int i = 0; i < nin; ++i) {
    const uint8_t* src = (d[D_CIN_SCR + i] ? scratch : arena)
                         + d[D_CIN_OFF + i];
    const int inner = d[D_CINNER + i];
    const int zp = d[D_CZP + i];
    const float mult = fword(d, D_CMULT + i);
    const int total = outer * inner;
    for (int e = threadIdx.x; e < total; e += NT) {
      const int o = e / inner;
      const int dst = o * inner_out + col + (e - o * inner);
      if (q) {
        ((int8_t*)stage)[dst] =
            requant_i((int)((const int8_t*)src)[e] - zp, mult, y_zp);
      } else {
        ((float*)stage)[dst] = ((const float*)src)[e];
      }
    }
    col += inner;
  }
  __syncthreads();  // all inputs read before any output byte is written
  uint8_t* out = (d[D_OUT_SCR] ? scratch : arena) + d[D_OUT_OFF];
  const int nbytes = outer * inner_out * (q ? 1 : 4);
  for (int e = threadIdx.x; e < nbytes; e += NT) out[e] = stage[e];
  __syncthreads();
}

// Copy `nbytes` arena bytes into the staging buffer (whole-block ops).
__device__ __forceinline__ void stage_in(uint8_t* stage, const uint8_t* src,
                                         int nbytes) {
  for (int e = threadIdx.x; e < nbytes; e += NT) stage[e] = src[e];
}

}  // namespace arena

// One launch configuration shared by every entry point: one CTA of NT
// threads, `smem` bytes of dynamic shared memory (opted in above 48 KB).
template <typename K>
static cudaError_t set_smem(K kernel, int smem, int* configured) {
  if (smem > 48 * 1024 && smem > *configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    *configured = smem;
  }
  return cudaSuccess;
}
