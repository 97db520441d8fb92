// wkv_tiles.cuh: what the chunked WKV's forward (wkv_chunk.cu) and
// backward (wkv_chunk_bwd.cu) share: the tile geometry, the cp.async row
// loads into shared tiles of LD floats a row, the padding, the segmented
// scan of a logw tile into cumulative log-decays in units of log2, and a
// task's (b, h, chunk), and the opt-in to more than 48 KB of dynamic
// shared memory. Each source brings namespace wkv into its own anonymous
// namespace.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace wkv {

constexpr int NT = 256;       // threads of every CTA
constexpr int MAXD = 64;      // widest head and longest chunk
constexpr int SUB = 16;       // steps of a sub-chunk
constexpr int LD = MAXD + 4;  // floats of a shared tile row
constexpr float LOG2E = 1.4426950408889634f;

struct Shape {
  int s, h, d, q;
  int nc;    // chunks of one (b, h): s / q
  int qp;    // q rounded up to SUB
  int na;    // sub-chunks: qp / SUB
  int dp;    // d rounded up to 4
  bool vec;  // 16-byte copies and stores
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// n rows of d floats, row stride `rs` in global memory, into a tile of
// rows LD floats apart (a row's copies over MAXD / 4 or MAXD slots, so
// rows and columns come from shifts), by a CTA of N threads.
template <int N = NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long rs, int n, int d, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < n * (MAXD / 4); i += N) {
      const int t = i / (MAXD / 4), c = 4 * (i % (MAXD / 4));
      if (c < d) cp_async16(dst + t * LD + c, src + t * rs + c);
    }
  } else {
    for (int i = threadIdx.x; i < n * MAXD; i += N) {
      const int t = i / MAXD, c = i % MAXD;
      if (c < d) cp_async4(dst + t * LD + c, src + t * rs + c);
    }
  }
}

// Zero a tile's padding: columns [d, dp) of rows [0, n), rows [n, np),
// by a CTA of N threads.
template <int N = NT>
__device__ __forceinline__ void zero_pad(float* dst, int n, int np, int d,
                                         int dp) {
  if (n == np && d == dp) return;
  for (int i = threadIdx.x; i < np * MAXD; i += N) {
    const int t = i / MAXD, c = i % MAXD;
    if (c < dp && (t >= n || c >= d)) dst[t * LD + c] = 0.f;
  }
}

// a / b, in 32 bits where a fits (the usual case: no 64-bit division).
__device__ __forceinline__ long div_long(long a, int b) {
  return a <= INT_MAX ? (long)((int)a / b) : a / b;
}

// logw -> lwc in place over the tile's qp rows, in units of log2 (each
// logw times log2(e)), so every decay is one exp2f: thread (column c =
// tid % 64, segment g = tid / 64) sums rows 16g .. 16g + 15 in registers,
// then adds the totals of the segments before it, in order (threads of
// segments past qp, in a CTA of more than 256, only pass the barriers).
// Ends with a barrier.
__device__ __forceinline__ void scan_rows(float* L, float* tot,
                                          const Shape& sh) {
  const int c = threadIdx.x & (MAXD - 1), g = threadIdx.x / MAXD;
  const bool on = c < sh.dp && g < sh.na;
  float* p = L + g * SUB * LD + c;
  float x[SUB];
  if (on) {
#pragma unroll
    for (int i = 0; i < SUB; ++i) x[i] = p[i * LD] * LOG2E;
#pragma unroll
    for (int i = 1; i < SUB; ++i) x[i] += x[i - 1];
    tot[g * MAXD + c] = x[SUB - 1];
  }
  __syncthreads();
  if (on) {
    float off = 0.f;
    for (int k = 0; k < g; ++k) off += tot[k * MAXD + c];
#pragma unroll
    for (int i = 0; i < SUB; ++i) p[i * LD] = x[i] + off;
  }
  __syncthreads();
}

// (b, h, chunk) of a task and the offset of its first row in r, k, v,
// logw and y.
__device__ __forceinline__ long task_rows(const Shape& sh, long task,
                                          int* chunk, int* head) {
  const long bh = div_long(task, sh.nc);
  *chunk = (int)(task - bh * sh.nc);
  const long b = div_long(bh, sh.h);
  *head = (int)(bh - b * sh.h);
  const long rs = (long)sh.h * sh.d;
  return (b * sh.s + (long)*chunk * sh.q) * rs + (long)*head * sh.d;
}

// Raise a kernel's dynamic shared memory limit to `bytes` once.
template <typename F>
cudaError_t opt_in(F kernel, int bytes, int* configured) {
  if (*configured >= bytes) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *configured = bytes;
  return e;
}

}  // namespace wkv
