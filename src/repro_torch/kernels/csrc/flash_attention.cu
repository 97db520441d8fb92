// flash_attention: online-softmax attention of one batch. q: (S, H, D);
// k, v: (T, H, D); out: (S, H, D) in q's type; f32 or bf16 (one flag for
// all four). With `causal` a key is seen when kpos <= qpos + (T - S)
// (bottom-right aligned) and a masked score is the finite -1e30, never
// -inf, so a row that sees no key (T < S) averages v over all T keys, as
// the reference does; keys past T in the last tile take no part; out =
// acc / max(l, 1e-30), with every softmax statistic (m, l, the rescaling)
// in f32. D is any multiple of 8 from 16 to 128; q, k, v and out start on
// 16-byte boundaries (the wrapper checks), so every row of 2·D or 4·D
// bytes moves in 16-byte copies.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_kernel (body
// _kernel, grid (heads, query blocks), pallas_call).
//
// Bound on this card: operations. Causal at S = T = 4096, H = 16, D = 128
// the products take 68.7 GFLOP against 134 MB moved (f32): 1.03 ms at the
// 67 TFLOP/s of f32 outside the tensor cores, 0.069 ms at the 989 TFLOP/s
// of the bf16 tensor cores, 0.040 ms by bytes. Two bodies, one per type:
//
// With a non-null `lse` both bodies also write each row's logsumexp of its
// scaled scores, m + log l in natural units (f32, (S, H)), for the
// backward (csrc/flash_attention_bwd.cu); serving passes null.
//
// bf16 on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).
// One CTA of 8 warps per (query tile of 128 rows, head); each warp owns 16
// query rows. Q moves once through shared memory into registers (ldmatrix)
// and stays there for the whole key walk. q is not scaled before the
// product (q / sqrt(D) is no bf16 value): S = Q K^T on the raw bf16 q and
// k, then the f32 scores are scaled by log2(e) / sqrt(D) for exp2f. The K
// and V tiles (64 keys) arrive through cp.async in two stages, tile j + 1
// in flight while tile j is computed; a shared row is D_pad + 8 elements
// (D_pad: D rounded up to 16, the product's depth, the pad zero-filled by
// the copies), so the 8 rows an ldmatrix reads fall in 8 distinct 16-byte
// bank groups. V is read with ldmatrix.trans. The online softmax runs on
// the accumulator fragments: row max and sum over the 4 lanes of a quad,
// the mask only on tiles that cross the diagonal or T; P is rounded to
// bf16 in registers and is the A operand of P V as it stands (the C
// fragment of m16n8k16 pairs into its A fragment), so it never touches
// shared memory. The body is templated on D_pad (8 instantiations).
// Shared memory: 4 tiles of 64 x (D_pad + 8) bf16, 69,632 B at D = 128
// (Q staged in stage 1's K and V tiles before the walk starts), room for
// 3 CTAs an SM; the registers (211 at D = 128) hold one. 8 warps of 128
// rows beat 4 warps of 64 at 2 CTAs an SM (half the K/V tiles read per
// query row), and a cap of 168 registers for 3 CTAs of 4 warps spills
// and is slower (scripts/torch_ab_standalone.py on an H100).
//
// f32 on the FMA units (no TF32: the reference's tolerance is 2e-4). One
// CTA of 256 threads (16 x 16) per (query tile of 128 rows, head); thread
// (ty, tx) owns rows ty + 16i (i < 8) in both products, the 8 x 4 scores
// of keys tx + 16j and the 8 x 4·NC outputs of columns 4tx + 64c (NC = 1
// for D <= 64, else 2), so the rescaling never leaves registers; the row
// max reduces over the 16 lanes of a half-warp. Every shared operand is a
// float4 load: Q (scaled by 1/sqrt(D) as it is loaded) and K row-major
// along D, K's rows padded by 4 floats so 8 lanes reading 8 keys hit 8
// bank groups; P row-major along the keys; V row-major along D. K and V
// arrive through cp.async in two stages. Shared memory: 231,424 B at
// D = 128, opted in at every launch.
//
// Both bodies: the key tiles end at the last key the tile's rows can see
// when every row sees one (T >= S), where a skipped tile would add
// exactly zero; with T < S every tile is walked. The query tiles launch
// heaviest first (tile index reversed, heads the fastest grid dimension),
// so the causal tail does not leave SMs idle at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 64;          // keys of a tile, both bodies
constexpr float NEG = -1e30f;   // the reference's finite mask value

constexpr int WARPS16 = 8;      // bf16: warps of a CTA, 16 query rows each
constexpr int BQ16 = 16 * WARPS16;
constexpr int NT16 = 32 * WARPS16;
constexpr int BQ32 = 128;       // f32: query rows of a CTA
constexpr int NT32 = 256;       // f32: 16 x 16 threads

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false the 16 bytes are zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a b: a 16 x 16 (row), b 16 x 8 (col), c 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// Keys [0, key_end) of the query tile starting at q0: up to the last key
// its last row sees when every row sees one (T >= S), else all T.
__device__ __forceinline__ int key_end(int q0, int bq, int s, int t,
                                       int causal) {
  if (!causal || t < s) return t;
  const int last = min(q0 + bq, s) - 1 + (t - s);
  return min(last + 1, t);
}

// Rows [r0, r0 + ROWS) of one head of a (rows, H, D) tensor into a shared
// tile of row stride LD elements, 16 bytes a copy; CH copies a row, of
// which those at or past D and the rows at or past `limit` are zero-filled.
template <typename T, int ROWS, int CH, int LD, int NTH>
__device__ __forceinline__ void copy_rows(T* dst, const T* g, int r0,
                                          int limit, long rs, long hoff,
                                          int d, int tid) {
  constexpr int E = 16 / sizeof(T);  // elements of a copy
#pragma unroll
  for (int i = 0; i < (ROWS * CH + NTH - 1) / NTH; ++i) {
    const int idx = tid + i * NTH;
    if (ROWS * CH % NTH == 0 || idx < ROWS * CH) {
      const int r = idx / CH, c = idx - r * CH;
      const int row = r0 + r;
      const bool ok = row < limit && c * E < d;
      cp_async16(dst + r * LD + c * E, ok ? g + row * rs + hoff + c * E : g,
                 ok);
    }
  }
}

// ---------------------------------------------------------------- bf16

template <int DP>
__global__ void __launch_bounds__(NT16, 1)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
           float* __restrict__ lse, int s, int t, int h, int d, int causal) {
  constexpr int LD = DP + 8;   // row stride of a shared tile (elements)
  constexpr int TILE = BK * LD;
  constexpr int CH = DP / 8;   // 16-byte copies a row
  constexpr int KS = DP / 16;  // k steps of Q K^T
  constexpr int NV = DP / 8;   // 8-column tiles of the output
  static_assert(BQ16 <= 2 * BK, "Q is staged in stage 1's K and V tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // stage st: K at sm + 2·st·TILE, V right after it
  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ16;  // heaviest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long rs = (long)h * d, hoff = (long)head * d;
  const int offset = t - s;
  const int ntiles = (key_end(q0, BQ16, s, t, causal) + BK - 1) / BK;

  copy_rows<__nv_bfloat16, BQ16, CH, LD, NT16>(sm + 2 * TILE, q, q0, s, rs,
                                               hoff, d, tid);
  copy_rows<__nv_bfloat16, BK, CH, LD, NT16>(sm, k, 0, t, rs, hoff, d, tid);
  copy_rows<__nv_bfloat16, BK, CH, LD, NT16>(sm + TILE, v, 0, t, rs, hoff,
                                             d, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], sm + 2 * TILE + (warp * 16 + (lane & 15)) * LD +
                        kk * 16 + (lane >> 4) * 8);

  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  const float sl2 = 1.4426950408889634f / sqrtf((float)d);
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int tig2 = (lane & 3) * 2;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    // every warp is done with stage st ^ 1 (tile j - 1; at j = 0 the
    // staged Q) before the copies of tile j + 1 overwrite it
    __syncthreads();
    if (j + 1 < ntiles) {
      __nv_bfloat16* nk = sm + 2 * (st ^ 1) * TILE;
      copy_rows<__nv_bfloat16, BK, CH, LD, NT16>(nk, k, (j + 1) * BK, t, rs,
                                                 hoff, d, tid);
      copy_rows<__nv_bfloat16, BK, CH, LD, NT16>(nk + TILE, v, (j + 1) * BK,
                                                 t, rs, hoff, d, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const __nv_bfloat16* Ks = sm + 2 * st * TILE;
    const __nv_bfloat16* Vs = Ks + TILE;
    const int k0 = j * BK;

    // S = Q K^T: 8 tiles of 8 keys; sc[n][0..1] row g, [2..3] row g + 8,
    // keys n·8 + tig2 (+1)
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];
        ldsm_x4(b, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // online softmax in log2 units, on the fragments
    const bool edge = k0 + BK > t || (causal && k0 + BK - 1 > q0 + offset);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * sl2;
        if (edge) {
          const int key = k0 + n * 8 + tig2 + (e & 1);
          if (key >= t)
            x = -INFINITY;  // past T: no part at all
          else if (causal && key > row0 + (e >> 1) * 8 + offset)
            x = NEG;
        }
        sc[n][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sc[n][0] = exp2f(sc[n][0] - m0);
      sc[n][1] = exp2f(sc[n][1] - m0);
      sc[n][2] = exp2f(sc[n][2] - m1);
      sc[n][3] = exp2f(sc[n][3] - m1);
      sum0 += sc[n][0] + sc[n][1];
      sum1 += sc[n][2] + sc[n][3];
    }
    // a lane's partial sums: corr is the same on the 4 lanes of a row
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V: P's C fragments are the A fragments of 4 k steps of 16 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NV / 2; ++dp) {
        unsigned b[4];
        ldsm_x4_trans(b, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float den0 = fmaxf(sum0, 1e-30f), den1 = fmaxf(sum1, 1e-30f);
  if (lse != nullptr && (lane & 3) == 0) {
    // m is in log2 units of the scaled score: lse = (m + log2 l) ln 2
    constexpr float LN2 = 0.6931471805599453f;
    if (row0 < s) lse[(long)row0 * h + head] = (m0 + log2f(sum0)) * LN2;
    if (row0 + 8 < s)
      lse[(long)(row0 + 8) * h + head] = (m1 + log2f(sum1)) * LN2;
  }
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int c = n * 8 + tig2;
    if (c >= d) continue;
    if (row0 < s)
      *reinterpret_cast<__nv_bfloat162*>(o + row0 * rs + hoff + c) =
          __floats2bfloat162_rn(acc[n][0] / den0, acc[n][1] / den0);
    if (row0 + 8 < s)
      *reinterpret_cast<__nv_bfloat162*>(o + (row0 + 8) * rs + hoff + c) =
          __floats2bfloat162_rn(acc[n][2] / den1, acc[n][3] / den1);
  }
}

// ----------------------------------------------------------------- f32

template <int NC>
__global__ void __launch_bounds__(NT32, 1)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int s, int t, int h, int d, int causal) {
  constexpr int W = 64 * NC;  // columns of a shared Q or V row (D padded)
  constexpr int LDK = W + 4;  // K's row stride
  constexpr int CH = W / 4;   // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ32][W], scaled
  float* Ks = Qs + BQ32 * W;                       // [2][BK][LDK]
  float* Vs = Ks + 2 * BK * LDK;                   // [2][BK][W]
  float* Ps = Vs + 2 * BK * W;                     // [BQ32][BK]
  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ32;  // heaviest first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long rs = (long)h * d, hoff = (long)head * d;
  const int offset = t - s;
  const int ntiles = (key_end(q0, BQ32, s, t, causal) + BK - 1) / BK;

  copy_rows<float, BK, CH, LDK, NT32>(Ks, k, 0, t, rs, hoff, d, tid);
  copy_rows<float, BK, CH, W, NT32>(Vs, v, 0, t, rs, hoff, d, tid);
  cp_async_commit();
  {
    const float root = sqrtf((float)d);
#pragma unroll
    for (int i = 0; i < BQ32 * CH / NT32; ++i) {
      const int idx = tid + i * NT32;
      const int r = idx / CH, c = idx - r * CH;
      const int row = q0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < s && c * 4 < d) {
        x = *reinterpret_cast<const float4*>(q + row * rs + hoff + c * 4);
        x.x /= root;
        x.y /= root;
        x.z /= root;
        x.w /= root;
      }
      *reinterpret_cast<float4*>(Qs + r * W + c * 4) = x;
    }
  }

  float m[8], l[8], acc[8][4 * NC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    // every thread is done with stage st ^ 1 and with Ps (tile j - 1; at
    // j = 0 the scaled Q is written) before they are overwritten
    __syncthreads();
    if (j + 1 < ntiles) {
      copy_rows<float, BK, CH, LDK, NT32>(Ks + (st ^ 1) * BK * LDK, k,
                                          (j + 1) * BK, t, rs, hoff, d, tid);
      copy_rows<float, BK, CH, W, NT32>(Vs + (st ^ 1) * BK * W, v,
                                        (j + 1) * BK, t, rs, hoff, d, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed
    __syncthreads();
    const float* Kt = Ks + st * BK * LDK;
    const float* Vt = Vs + st * BK * W;
    const int k0 = j * BK;

    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; c += 4) {
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * W + c);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        b[jj] =
            *reinterpret_cast<const float4*>(Kt + (tx + 16 * jj) * LDK + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float x = sc[i][jj];
          x = fmaf(a[i].x, b[jj].x, x);
          x = fmaf(a[i].y, b[jj].y, x);
          x = fmaf(a[i].z, b[jj].z, x);
          sc[i][jj] = fmaf(a[i].w, b[jj].w, x);
        }
    }

    const bool edge = k0 + BK > t || (causal && k0 + BK - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (edge) {
          const int key = k0 + tx + 16 * jj;
          if (key >= t)
            sc[i][jj] = -INFINITY;  // past T: no part at all
          else if (causal && key > q0 + row + offset)
            sc[i][jj] = NEG;
        }
        mx = fmaxf(mx, sc[i][jj]);
      }
      const float m_new = half_max(mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(sc[i][jj] - m_new);
        sum += p;
        Ps[row * BK + tx + 16 * jj] = p;
      }
      // a lane's partial sum: corr is the same on the 16 lanes of a row
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * BK + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[c] = *reinterpret_cast<const float4*>(Vt + (kk + u) * W +
                                                   4 * tx + 64 * c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pu = u == 0 ? p[i].x
                           : u == 1 ? p[i].y
                           : u == 2 ? p[i].z
                                    : p[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[i][4 * c + 0] = fmaf(pu, vv[c].x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(pu, vv[c].y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pu, vv[c].z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pu, vv[c].w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float sum = half_sum(l[i]);
    const float den = fmaxf(sum, 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (lse != nullptr && tx == 0 && row < s)
      lse[(long)row * h + head] = m[i] + logf(sum);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (row < s && col < d)
        *reinterpret_cast<float4*>(o + row * rs + hoff + col) = make_float4(
            acc[i][4 * c] / den, acc[i][4 * c + 1] / den,
            acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den);
    }
  }
}

// ------------------------------------------------------------- launches

template <typename K, typename T>
cudaError_t launch(K kernel, int bq, int threads, size_t smem, const void* q,
                   const void* k, const void* v, void* o, float* lse, int s,
                   int t, int h, int d, int causal, cudaStream_t stream) {
  // opt in to this launch's size every time (a size at or under 48 KB
  // needs none, but asking is harmless)
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles = (s + bq - 1) / bq;
  if (tiles > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(h, tiles), threads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, s, t, h, d, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int s, int t, int h, int d, int causal,
                        cudaStream_t stream) {
  const size_t smem = 4 * BK * (DP + 8) * sizeof(__nv_bfloat16);
  return launch<decltype(&flash_bf16<DP>), __nv_bfloat16>(
      flash_bf16<DP>, BQ16, NT16, smem, q, k, v, o, lse, s, t, h, d, causal,
      stream);
}

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int s, int t, int h, int d, int causal,
                       cudaStream_t stream) {
  constexpr int W = 64 * NC;
  const size_t smem = sizeof(float) * ((size_t)BQ32 * W +
                                       2 * BK * (W + 4) + 2 * BK * W +
                                       (size_t)BQ32 * BK);
  return launch<decltype(&flash_f32<NC>), float>(
      flash_f32<NC>, BQ32, NT32, smem, q, k, v, o, lse, s, t, h, d, causal,
      stream);
}

}  // namespace

// (q, k, v, out, lse or null, s, t, h, d, causal, bf16, stream); returns
// cudaGetLastError() after the launch. With lse non-null, each row's f32
// logsumexp of its scaled scores (m + log l, natural units) is written to
// lse[row * h + head], an (S, H) tensor, for the backward.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* lse_p, int s, int t, int h,
                               int d, int causal, int bf16, void* stream) {
  if (s <= 0 || t <= 0 || h <= 0 || d < 16 || d > 128 || d % 8 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* lse = (float*)lse_p;
  if (!bf16)
    return (int)(d <= 64
                     ? launch_f32<1>(q, k, v, o, lse, s, t, h, d, causal, st)
                     : launch_f32<2>(q, k, v, o, lse, s, t, h, d, causal, st));
  switch ((d + 15) / 16) {
    case 1:
      return (int)launch_bf16<16>(q, k, v, o, lse, s, t, h, d, causal, st);
    case 2:
      return (int)launch_bf16<32>(q, k, v, o, lse, s, t, h, d, causal, st);
    case 3:
      return (int)launch_bf16<48>(q, k, v, o, lse, s, t, h, d, causal, st);
    case 4:
      return (int)launch_bf16<64>(q, k, v, o, lse, s, t, h, d, causal, st);
    case 5:
      return (int)launch_bf16<80>(q, k, v, o, lse, s, t, h, d, causal, st);
    case 6:
      return (int)launch_bf16<96>(q, k, v, o, lse, s, t, h, d, causal, st);
    case 7:
      return (int)launch_bf16<112>(q, k, v, o, lse, s, t, h, d, causal, st);
    default:
      return (int)launch_bf16<128>(q, k, v, o, lse, s, t, h, d, causal, st);
  }
}
