// arena_softmax: softmax over the last axis on the arena (flat or
// row-blocked). int8: dequantise, subtract the row max, expf, divide by the
// row sum, quantise (IEEE division by the output scale); f32: the same without
// the casts.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_softmax_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: 1000 bytes in and out and 1000 exponentials, far
// below a microsecond by either bound; the kernel is bound by its one CTA,
// its block reductions and launch. The flagship runs it in place, so the
// input is staged (as f32) before anything is written (paper §III.F); the
// result overwrites the staged input, then the block is written out.
#include "arena_common.cuh"

using namespace arena;

// Block-wide max or sum; every thread gets the result.
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
  for (int s = 16; s > 0; s >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, s);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < NT / 32; ++i) v = MAX ? fmaxf(v, red[i]) : v + red[i];
  __syncthreads();  // red is free for the next reduction
  return v;
}

__global__ void __launch_bounds__(NT)
arena_softmax_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                     uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[NT / 32];
  float* x = (float*)buffer(d, D_STAGE_G, smem, gws);
  const bool q = d[D_QUANT] != 0;
  const int rows = d[D_ROWS], last = d[D_LAST], n = rows * last;
  const int x_zp = d[D_X_ZP], y_zp = d[D_Y_ZP];
  const float xs = fword(d, D_XSCALE), ys = fword(d, D_YSCALE);
  const uint8_t* src = arena_buf + d[D_IN_OFF];
  const Addr ia = load_addr(d, 1);
  for (int e = threadIdx.x; e < n; e += NT) {
    const int s = elem_at(ia, e);
    x[e] = q ? dequant(((const int8_t*)src)[s], xs, x_zp)
             : ((const float*)src)[s];
  }
  __syncthreads();  // the whole input is read before any output is written
  for (int r = 0; r < rows; ++r) {
    float* xr = x + r * last;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int e = threadIdx.x; e < last; e += NT) mx = fmaxf(mx, xr[e]);
    mx = block_reduce<true>(mx, red);
    float sum = 0.0f;
    for (int e = threadIdx.x; e < last; e += NT)
      sum += expf(__fsub_rn(xr[e], mx));
    sum = block_reduce<false>(sum, red);
    // each thread overwrites only the elements it read above
    for (int e = threadIdx.x; e < last; e += NT)
      xr[e] = __fdiv_rn(expf(__fsub_rn(xr[e], mx)), sum);
  }
  __syncthreads();  // every row is done before the block is written
  write_block(arena_buf + d[D_OUT_OFF], load_addr(d, 0), n, q,
              [&](int e) -> uint32_t {
    return q ? (uint32_t)(uint8_t)quant_f(x[e], ys, y_zp)
             : __float_as_uint(x[e]);
  });
}

ARENA_ENTRY(arena_softmax, arena_softmax_kernel)
