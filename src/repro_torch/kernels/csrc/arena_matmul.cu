// arena_matmul: y = a . b with both operands in the arena (flat or
// row-blocked; (M, K) x (K, N)). int8: an int32 dot of (a - a_zp) * (b -
// b_zp), then the shared requantisation; f32: an f32 dot.
//
// Replaces the TPU kernel src/repro/kernels/arena_ops.py::_matmul_kernel
// (apply_op -> _plain_kernel over _FlatMem, and over
// _BlockMem in the row-blocked program).
//
// Bound on this card: at the shapes the zoo's graphs give it ((16, 8) x
// (8, 2)) a few hundred bytes and operations, far below a microsecond by
// either bound; the kernel is bound by its launch. One CTA because the
// output may overlap an operand: every output element is computed into a
// staging buffer (shared memory, or the global workspace past 227 KB), then
// a barrier, then the result is copied out (read-all-before-write-all).
#include "arena_common.cuh"

using namespace arena;

__global__ void __launch_bounds__(NT)
arena_matmul_kernel(uint8_t* arena_buf, const int* d, const uint8_t*,
                    uint8_t* gws) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stage = buffer(d, D_STAGE_G, smem, gws);
  const bool q = d[D_QUANT] != 0;
  const int m = d[D_MM], k = d[D_MK], n = d[D_MN];
  const uint8_t* a = arena_buf + d[D_IN_OFF];
  const uint8_t* b = arena_buf + d[D_IN2_OFF];
  const int a_zp = d[D_X_ZP], b_zp = d[D_BZP], y_zp = d[D_Y_ZP];
  const float amult = fword(d, D_AMULT);
  const Addr aa = load_addr(d, 1), ba = load_addr(d, 2);
  for (int e = threadIdx.x; e < m * n; e += NT) {
    const int r = e / n, c = e - r * n;
    if (q) {
      int acc = 0;
      for (int i = 0; i < k; ++i)
        acc += ((int)((const int8_t*)a)[elem_at(aa, r * k + i)] - a_zp)
               * ((int)((const int8_t*)b)[elem_at(ba, i * n + c)] - b_zp);
      ((int8_t*)stage)[e] = requant_i(acc, amult, y_zp);
    } else {
      float acc = 0.0f;
      for (int i = 0; i < k; ++i)
        acc += ((const float*)a)[elem_at(aa, r * k + i)]
               * ((const float*)b)[elem_at(ba, i * n + c)];
      ((float*)stage)[e] = acc;
    }
  }
  __syncthreads();  // both operands read before any output byte is written
  store_block(arena_buf + d[D_OUT_OFF], load_addr(d, 0), stage, m * n, q);
}

ARENA_ENTRY(arena_matmul, arena_matmul_kernel)
