// flash_attention: online-softmax attention of one batch. q: (S, H, D);
// k, v: (T, H, D); out: (S, H, D) in q's type; f32 or bf16 (one flag for
// all four), every value computed in f32. q is scaled by 1/sqrt(D) as it
// is loaded; with `causal` a key is seen when kpos <= qpos + (T - S)
// (bottom-right aligned) and a masked score is the finite -1e30, never
// -inf, so a row that sees no key (T < S) averages v over all T keys, as
// the reference does; out = acc / max(l, 1e-30). D is any multiple of 8
// from 16 to 128.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_kernel (body
// _kernel, grid (heads, query blocks), pallas_call).
//
// Bound on this card: operations. Causal at S = T = 4096, H = 16, D = 128
// the products take 68.7 GFLOP against 134 MB moved (f32): 1.03 ms at the
// 67 TFLOP/s of f32 outside the tensor cores, 0.040 ms by bytes. f32 must
// stay out of the TF32 tensor cores (the reference's tolerance is 2e-4),
// and this first kernel keeps bf16 on the same f32 FMA path too (the
// tensor cores' 989 TFLOP/s would bound bf16 at 0.069 ms; mma.sync or
// wgmma is later work). The design: one CTA per (query tile of 64 rows,
// head), 256 threads; the scaled Q tile, a 64-key K and V tile and the
// 64 x 64 probabilities sit in shared memory (115,456 B at D = 128, f32,
// opted in at every launch), the running (m, l, acc) in registers. Each
// thread owns rows ty + 16i (i < 4) in both products, so the online
// softmax's rescaling never leaves registers; the row max and sum reduce
// over the 16 lanes of a half-warp. K is padded to D + 1 columns so the 16
// lanes reading 16 keys hit 16 banks. The key tiles end at the last key
// the tile's rows can see when every row sees one (T >= S), where a
// skipped tile would add exactly zero; with T < S every tile is walked.
// Keys past T in the last tile (the kernel's own tile, where the reference
// shrinks its blocks to a divisor of T) take no part at all.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // query rows of a CTA
constexpr int BK = 64;   // keys of a tile
constexpr int NT = 256;  // threads: 16 x 16
constexpr int LDP = BK + 1;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// max / sum over the 16 lanes of a half-warp (the threads of one ty)
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)BQ * (d + 1) + (size_t)BK * (d + 1) + (size_t)BK * d +
          (size_t)BQ * LDP);
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int s, int t, int h,
             int d, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = d + 1, ldk = d + 1;
  float* Qs = smem;              // [BQ][d + 1], scaled
  float* Ks = Qs + BQ * ldq;     // [BK][d + 1]
  float* Vs = Ks + BK * ldk;     // [BK][d]
  float* Ps = Vs + BK * d;       // [BQ][BK + 1], probabilities
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long rs = (long)h * d;   // elements between sequence positions
  const long hoff = (long)head * d;
  const int offset = t - s;
  const float root = sqrtf((float)d);

  for (int idx = tid; idx < BQ * d; idx += NT) {
    const int i = idx / d, c = idx - i * d;
    const int row = q0 + i;
    Qs[i * ldq + c] = row < s ? load(q, row * rs + hoff + c) / root : 0.f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  int kend = t;
  if (causal && t >= s) {
    const int last_row = (q0 + BQ < s ? q0 + BQ : s) - 1;
    const int last_key = last_row + offset;
    kend = last_key + 1 < t ? last_key + 1 : t;
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    const int nk = t - k0 < BK ? t - k0 : BK;  // keys of this tile
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    for (int idx = tid; idx < BK * d; idx += NT) {
      const int j = idx / d, c = idx - j * d;
      const bool ok = j < nk;
      const long g = (long)(k0 + j) * rs + hoff + c;
      Ks[j * ldk + c] = ok ? load(k, g) : 0.f;
      Vs[j * d + c] = ok ? load(v, g) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ldq + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * ldk + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = offset + q0 + row;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        if (key < nk) {
          if (causal && k0 + key > qpos) sc[i][j] = NEG;
          mx = fmaxf(mx, sc[i][j]);
        }
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = tx + 16 * j < nk ? expf(sc[i][j] - m_new) : 0.f;
        sum += p[j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[row * LDP + tx + 16 * j] = p[j];
    }
    __syncthreads();

    for (int kk = 0; kk < nk; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          const float vv = Vs[kk * d + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(o, row * rs + hoff + c, acc[i][j] / den);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int s, int t, int h, int d, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  // opt in to this launch's size every time (a size at or under 48 KB
  // needs none, but asking is harmless)
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s + BQ - 1) / BQ, h);
  flash_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s, t, h, d, causal);
  return cudaGetLastError();
}

}  // namespace

// (q, k, v, out, s, t, h, d, causal, bf16, stream); returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int s, int t, int h, int d,
                               int causal, int bf16, void* stream) {
  if (s <= 0 || t <= 0 || h <= 0 || h > 65535 || d < 16 || d > 128 ||
      d % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16>(q, k, v, o, s, t, h, d, causal,
                                            st)
                    : launch<float>(q, k, v, o, s, t, h, d, causal, st));
}
