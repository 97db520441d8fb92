// wkv_chunk: the RWKV6 WKV recurrence in chunks of q steps, f32.
// r, k, v, logw: (B, S, H, D) (logw = log decay, <= 0); u: (H, D);
// y: (B, S, H, D); state: (B, H, D, D) (rows d_k, columns d_v), the state
// after the last step, starting from zero. Within a chunk, with lwc the
// cumulative sum of logw over the chunk's steps and lwp the same one step
// earlier (0 at the first):
//   att[t][j] = sum_d exp(lwp[t,d] - lwc[j,d]) r[t,d] k[j,d]   (j < t)
//   att[t][t] = sum_d r[t,d] u[d] k[t,d]
//   y[t]      = sum_j att[t][j] v[j] + (r[t] * exp(lwp[t])) @ S
//   S        <- exp(lwc[q-1])[:, None] * S + (k * exp(lwc[q-1] - lwc))^T v
// D and q are at most 64 and q divides S.
//
// Replaces the TPU kernel src/repro/kernels/wkv_chunk.py::wkv_chunk_kernel
// (body _kernel, grid (B * H,), pallas_call).
//
// Bound on this card: at B = 1, S = 4096, H = 32, D = q = 64 (rwkv6-1.6b)
// the kernel moves 168 MB (r, k, v, logw and y once, the state) and does
// 4.1 GFLOP of f32 work counting each exp as one operation: 0.050 ms by
// bytes, 0.061 ms by operations at 67 TFLOP/s. The design follows the
// reference's grid: one CTA per (b, h) walks the S/q chunks in order with
// the D x D state in shared memory (16 KB), so B * H = 32 CTAs fill at
// most 32 of the 132 SMs at that width (a split of the chunks' work across
// CTAs is later work). Inside a chunk the 1,024 threads (32 warps, to
// hide the latency of the shared-memory loads and exps with only one CTA
// on each SM) split the work by (t, j) for att, by (t, d_v) for y and by
// (d_k, d_v) for the state: 4 items each at q = D = 64. The
// (q, q, D) decay tensor (1 MiB at q = D = 64) is never built: each
// att[t][j] computes its D decays on the fly, keeping the difference of
// the two cumulative sums inside one exp (exp(lwp) * exp(-lwc) would
// overflow: logw runs far below zero). The cumulative sum runs
// sequentially per channel. Tiles are padded to D + 1 columns so lanes
// reading consecutive keys hit distinct banks; shared memory is 99,840 B
// at q = D = 64, opted in at every launch.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;

size_t smem_floats(int d, int q) {
  return (size_t)d * d + 4 * (size_t)q * (d + 1) + (size_t)q * (q + 1) + d;
}

__global__ void __launch_bounds__(NT)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ state_out, int s, int h, int d, int q) {
  extern __shared__ __align__(16) float sm[];
  const int ld = d + 1, lda = q + 1;
  float* S = sm;              // [d][d] state
  float* R = S + d * d;       // [q][ld] r, then r * exp(lwp)
  float* Kt = R + q * ld;     // [q][ld] k, then k * exp(lwc[q-1] - lwc)
  float* V = Kt + q * ld;     // [q][ld] v
  float* L = V + q * ld;      // [q][ld] logw, then lwc
  float* A = L + q * ld;      // [q][q + 1] att
  float* U = A + q * lda;     // [d] u of this head
  const int bh = blockIdx.x, b = bh / h, hh = bh - b * h;
  const int tid = threadIdx.x;
  const long rs = (long)h * d;
  const long base = (long)b * s * rs + (long)hh * d;

  for (int i = tid; i < d * d; i += NT) S[i] = 0.f;
  for (int i = tid; i < d; i += NT) U[i] = u[hh * d + i];

  for (int c0 = 0; c0 < s; c0 += q) {
    __syncthreads();  // the last chunk's reads and state writes are done
    for (int idx = tid; idx < q * d; idx += NT) {
      const int t = idx / d, c = idx - t * d;
      const long g = base + (long)(c0 + t) * rs + c;
      R[t * ld + c] = r[g];
      Kt[t * ld + c] = k[g];
      V[t * ld + c] = v[g];
      L[t * ld + c] = lw[g];
    }
    __syncthreads();
    for (int c = tid; c < d; c += NT) {  // lwc: cumulative sum over steps
      float run = 0.f;
      for (int t = 0; t < q; ++t) {
        run += L[t * ld + c];
        L[t * ld + c] = run;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < q * q; idx += NT) {
      const int t = idx / q, j = idx - t * q;
      float a = 0.f;
      if (j < t) {
        const float* lp = L + (t - 1) * ld;  // lwp[t] = lwc[t - 1]
        for (int c = 0; c < d; ++c)
          a += expf(lp[c] - L[j * ld + c]) * R[t * ld + c] * Kt[j * ld + c];
      } else if (j == t) {
        for (int c = 0; c < d; ++c) a += R[t * ld + c] * U[c] * Kt[t * ld + c];
      }
      A[t * lda + j] = a;
    }
    __syncthreads();
    for (int idx = tid; idx < q * d; idx += NT) {
      const int t = idx / d, c = idx - t * d;
      const float lwp = t ? L[(t - 1) * ld + c] : 0.f;
      R[t * ld + c] *= expf(lwp);
      Kt[t * ld + c] *= expf(L[(q - 1) * ld + c] - L[t * ld + c]);
    }
    __syncthreads();
    for (int idx = tid; idx < q * d; idx += NT) {
      const int t = idx / d, e = idx - t * d;
      float in = 0.f, cross = 0.f;
      for (int j = 0; j <= t; ++j) in += A[t * lda + j] * V[j * ld + e];
      for (int c = 0; c < d; ++c) cross += R[t * ld + c] * S[c * d + e];
      y[base + (long)(c0 + t) * rs + e] = in + cross;
    }
    __syncthreads();  // y has read the old state
    for (int idx = tid; idx < d * d; idx += NT) {
      const int c = idx / d, e = idx - c * d;
      float a = 0.f;
      for (int j = 0; j < q; ++j) a += Kt[j * ld + c] * V[j * ld + e];
      S[idx] = expf(L[(q - 1) * ld + c]) * S[idx] + a;
    }
  }
  __syncthreads();
  float* so = state_out + (long)bh * d * d;
  for (int i = tid; i < d * d; i += NT) so[i] = S[i];
}

}  // namespace

// (r, k, v, logw, u, y, state, b, s, h, d, q, stream); returns
// cudaGetLastError() after the launch.
extern "C" int wkv_chunk(const void* r, const void* k, const void* v,
                         const void* lw, const void* u, void* y, void* state,
                         int b, int s, int h, int d, int q, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || d <= 0 || d > 64 || q <= 0 || q > 64 ||
      s % q)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(d, q);
  cudaError_t e = cudaFuncSetAttribute(
      wkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wkv_kernel<<<b * h, NT, smem, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)lw,
      (const float*)u, (float*)y, (float*)state, s, h, d, q);
  return (int)cudaGetLastError();
}
