// flash_attention_bwd: the backward of csrc/flash_attention.cu, from its
// saved output and per-row logsumexp. q, dq: (S, H, D); k, v, dk, dv:
// (T, H, D); out, dout: (S, H, D); f32 or bf16 (one flag for all), lse
// and the workspace `delta` (S, H) f32. With scale s = 1/sqrt(D) and
// score_ij = s q_i k_j (masked where the forward masks: key j > i + T - S
// when causal), the backward recomputes P_ij = exp(score_ij - lse_i) and
// takes
//   D_i  = sum_c dout_ic out_ic
//   dS   = P o (dout V^T - D)
//   dQ   = s dS K,   dK = s dS^T Q,   dV = P^T dout.
// Its domain is the forward's: D a multiple of 8 from 16 to 128, causal
// with T >= S (every row sees a key, so lse is finite) or non-causal, and
// 16-byte aligned contiguous inputs (the wrapper checks).
//
// The backward of the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_kernel, which the
// reference never differentiates: its training takes the blockwise path
// through XLA. Here the long causal attention of training runs the forward
// kernel, so the port needs this one.
//
// Two launches on the stream, no atomics, so every sum runs in an order
// fixed by the shapes and repeated calls are bit-equal:
//   dQ: one CTA per (64-row query tile, head), heaviest tile first. It
//       computes D for its rows (written to `delta`), then walks the key
//       tiles the forward walked: S and dout V^T, then P and dS, then
//       dQ += dS K.
//   dK, dV: one CTA per (64-key tile, head), the first key tiles (which
//       the most query rows see) first. It walks the query tiles that see
//       its keys: S^T and V dout^T, then P^T and dS^T (D read back from
//       `delta`, written by the first launch), then dV += P^T dout and
//       dK += dS^T Q.
// Bound on this card: operations. The five products of the backward at
// causal S = T = 4096, H = 16, D = 128 take 172 GFLOP (the recomputation
// of S and dout V^T in the second launch adds two more): 2.56 ms at the
// 67 TFLOP/s of f32 outside the tensor cores, 0.17 ms at the 989 TFLOP/s
// of bf16 on them. Two bodies, one per type:
//
// bf16 on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate),
// with the forward's fragment code. 4 warps a CTA, each owning 16 rows
// (dQ) or 16 keys (dK, dV) of the tile; the tiles (Q, dout, K, V: 64 x
// D_pad + 8 bf16 each, D_pad = D rounded up to 16, the pad zero-filled)
// arrive in shared memory through cp.async. Each product runs on
// fragments read with ldmatrix (.trans for the right-hand operand of
// dS K, P^T dout and dS^T Q); P and dS stay in the C fragments in f32,
// are rounded to bf16 in registers and are the A operand of the next
// product as they stand, as the forward passes P to P V. So P and dS are
// rounded to bf16 before dV, dQ and dK take them (flash_backward_plain
// rounds at the same places). q is not scaled before a product (q/sqrt(D)
// is no bf16 value): the scale goes into exp2 with log2(e), and onto dq
// and dk at the end. The bodies are templated on D_pad (8 instantiations);
// 70,144 B of shared memory at D = 128.
//
// f32 on the FMA units (no TF32): 256 threads (16 x 16) a CTA; thread
// (ty, tx) owns the 4 x 4 scores of rows ty + 16i and keys tx + 16j, and
// the 4 x 4·NC outputs of rows (or keys) ty + 16i and columns 4tx + 64c
// (NC = 1 for D <= 64, else 2). Q is scaled by s as it is stored, as the
// f32 forward does; P and dS pass through shared memory. K and V rows are
// padded by 4 floats so 8 lanes reading 8 keys hit 8 bank groups; P and
// dS rows by 1 float. 150,272 B (dQ) and 166,912 B (dK, dV) of shared
// memory at D = 128, one CTA an SM.
//
// wgmma, TMA, a second cp.async stage and a fused single-pass design are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;   // query rows of a tile
constexpr int BK = 64;   // keys of a tile
constexpr int NT = 256;  // threads of a CTA, 16 x 16
constexpr int LDP = BK + 1;  // row stride of the P and dS tiles

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float4 scale4(float4 x, float c) {
  return make_float4(x.x * c, x.y * c, x.z * c, x.w * c);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows [r0, r0 + ROWS) of one head of a (rows, H, D) f32 tensor into a
// shared tile of row stride LD, times `mul`; the columns at or past D (up
// to W) and the rows at or past `limit` are zero.
template <int ROWS, int W, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* g, int r0,
                                          int limit, long rs, long hoff,
                                          int d, float mul, int tid) {
  constexpr int CH = W / 4;
#pragma unroll 4
  for (int idx = tid; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = idx - r * CH;
    const int row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < limit && c * 4 < d)
      x = scale4(load4(g + row * rs + hoff + c * 4), mul);
    store4(dst + r * LD + c * 4, x);
  }
}

// The keys [0, key_end) a query tile's rows see, as the forward walks them.
__device__ __forceinline__ int key_end(int q0, int s, int t, int causal) {
  if (!causal || t < s) return t;
  return min(min(q0 + BQ, s) - 1 + (t - s) + 1, t);
}

// sc = Q K^T and dp = dO V^T over the depth D for this thread's 4 x 4
// (rows ty + 16i of Qs / dOs, keys tx + 16j of Ks / Vs)
template <int W, int LDK>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int d, int ty, int tx,
                                       float (&sc)[4][4], float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < d; c += 4) {
    float4 a[4], g[4], b[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = load4(Qs + (ty + 16 * i) * W + c);
      g[i] = load4(dOs + (ty + 16 * i) * W + c);
      b[i] = load4(Ks + (tx + 16 * i) * LDK + c);
      w[i] = load4(Vs + (tx + 16 * i) * LDK + c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = dot4(a[i], b[j], sc[i][j]);
        dp[i][j] = dot4(g[i], w[j], dp[i][j]);
      }
  }
}

// P and dS of this thread's 4 x 4 into the shared tiles (P only when Ps is
// non-null): zero for a masked pair, a row past S or a key past T.
__device__ __forceinline__ void probs(const float (&sc)[4][4],
                                      const float (&dp)[4][4],
                                      const float* Ls, const float* Ds,
                                      float* Ps, float* dSs, int q0, int k0,
                                      int s, int t, int causal, int ty,
                                      int tx) {
  const int offset = t - s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = tx + 16 * j, key = k0 + kk;
      const bool seen = row < s && key < t && (!causal || key <= row + offset);
      const float p = seen ? expf(sc[i][j] - Ls[r]) : 0.f;
      if (Ps != nullptr) Ps[r * LDP + kk] = p;
      dSs[r * LDP + kk] = p * (dp[i][j] - Ds[r]);
    }
  }
}

// ------------------------------------------------------------- f32: dQ

template <int NC>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ o,
             const float* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, float* __restrict__ dq, int s, int t,
             int h, int d, int causal) {
  constexpr int W = 64 * NC;  // columns of a shared Q / dO row (D padded)
  constexpr int LDK = W + 4;  // K and V row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BQ][W], scaled
  float* dOs = Qs + BQ * W;                        // [BQ][W]
  float* Ks = dOs + BQ * W;                        // [BK][LDK]
  float* Vs = Ks + BK * LDK;                       // [BK][LDK]
  float* dSs = Vs + BK * LDK;                      // [BQ][LDP]
  float* Ls = dSs + BQ * LDP;                      // [BQ]
  float* Ds = Ls + BQ;                             // [BQ]
  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long rs = (long)h * d, hoff = (long)head * d;
  const float sc_mul = rsqrtf((float)d);
  const int ntiles = (key_end(q0, s, t, causal) + BK - 1) / BK;

  load_tile<BQ, W, W>(Qs, q, q0, s, rs, hoff, d, sc_mul, tid);
  load_tile<BQ, W, W>(dOs, dout, q0, s, rs, hoff, d, 1.f, tid);
  __syncthreads();
  {
    // D = rowsum(dO o O): 4 lanes a row, columns 4·part + 16·n, summed
    // across the quad in a fixed order
    const int r = tid >> 2, part = tid & 3, row = q0 + r;
    float acc = 0.f;
    if (row < s)
      for (int c = 4 * part; c < d; c += 16)
        acc = dot4(load4(o + row * rs + hoff + c), load4(dOs + r * W + c),
                   acc);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      Ds[r] = acc;
      Ls[r] = row < s ? lse[(long)row * h + head] : 0.f;
      if (row < s) delta[(long)row * h + head] = acc;
    }
  }

  float acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    // every thread is done with the last tile's K and dS
    __syncthreads();
    load_tile<BK, W, LDK>(Ks, k, k0, t, rs, hoff, d, 1.f, tid);
    load_tile<BK, W, LDK>(Vs, v, k0, t, rs, hoff, d, 1.f, tid);
    __syncthreads();
    float sc[4][4], dp[4][4];
    scores<W, LDK>(Qs, dOs, Ks, Vs, d, ty, tx, sc, dp);
    probs(sc, dp, Ls, Ds, nullptr, dSs, q0, k0, s, t, causal, ty, tx);
    __syncthreads();
    // dQ += dS K (the scale at the end)
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float4 kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kv[c] = load4(Ks + kk * LDK + 4 * tx + 64 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * LDP + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][4 * c + 0] = fmaf(ds, kv[c].x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(ds, kv[c].y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(ds, kv[c].z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(ds, kv[c].w, acc[i][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (row < s && col < d)
        store4(dq + row * rs + hoff + col,
               make_float4(acc[i][4 * c] * sc_mul, acc[i][4 * c + 1] * sc_mul,
                           acc[i][4 * c + 2] * sc_mul,
                           acc[i][4 * c + 3] * sc_mul));
    }
  }
}

// --------------------------------------------------------- f32: dK, dV

template <int NC>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, int s, int t,
              int h, int d, int causal) {
  constexpr int W = 64 * NC;
  constexpr int LDK = W + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [BK][LDK]
  float* Vs = Ks + BK * LDK;                       // [BK][LDK]
  float* Qs = Vs + BK * LDK;                       // [BQ][W], scaled
  float* dOs = Qs + BQ * W;                        // [BQ][W]
  float* Ps = dOs + BQ * W;                        // [BQ][LDP]
  float* dSs = Ps + BQ * LDP;                      // [BQ][LDP]
  float* Ls = dSs + BQ * LDP;                      // [BQ]
  float* Ds = Ls + BQ;                             // [BQ]
  const int head = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // the first key tiles see the most rows
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long rs = (long)h * d, hoff = (long)head * d;
  const float sc_mul = rsqrtf((float)d);
  const int offset = t - s;
  // the first query row that sees key k0 (every row when not causal)
  const int qfirst = causal ? max(0, k0 - offset) : 0;
  const int nq = (s + BQ - 1) / BQ;

  load_tile<BK, W, LDK>(Ks, k, k0, t, rs, hoff, d, 1.f, tid);
  load_tile<BK, W, LDK>(Vs, v, k0, t, rs, hoff, d, 1.f, tid);

  float adk[4][4 * NC], adv[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) adk[i][c] = adv[i][c] = 0.f;

  for (int qt = qfirst / BQ; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    // every thread is done with the last tile's Q, dO, P and dS
    __syncthreads();
    load_tile<BQ, W, W>(Qs, q, q0, s, rs, hoff, d, sc_mul, tid);
    load_tile<BQ, W, W>(dOs, dout, q0, s, rs, hoff, d, 1.f, tid);
    if (tid < BQ) {
      const int row = q0 + tid;
      Ls[tid] = row < s ? lse[(long)row * h + head] : 0.f;
      Ds[tid] = row < s ? delta[(long)row * h + head] : 0.f;
    }
    __syncthreads();
    float sc[4][4], dp[4][4];
    scores<W, LDK>(Qs, dOs, Ks, Vs, d, ty, tx, sc, dp);
    probs(sc, dp, Ls, Ds, Ps, dSs, q0, k0, s, t, causal, ty, tx);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q (Q already scaled): keys ty + 16i
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float4 go[NC], qq[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        go[c] = load4(dOs + r * W + 4 * tx + 64 * c);
        qq[c] = load4(Qs + r * W + 4 * tx + 64 * c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[r * LDP + ty + 16 * i];
        const float ds = dSs[r * LDP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          adv[i][4 * c + 0] = fmaf(p, go[c].x, adv[i][4 * c + 0]);
          adv[i][4 * c + 1] = fmaf(p, go[c].y, adv[i][4 * c + 1]);
          adv[i][4 * c + 2] = fmaf(p, go[c].z, adv[i][4 * c + 2]);
          adv[i][4 * c + 3] = fmaf(p, go[c].w, adv[i][4 * c + 3]);
          adk[i][4 * c + 0] = fmaf(ds, qq[c].x, adk[i][4 * c + 0]);
          adk[i][4 * c + 1] = fmaf(ds, qq[c].y, adk[i][4 * c + 1]);
          adk[i][4 * c + 2] = fmaf(ds, qq[c].z, adk[i][4 * c + 2]);
          adk[i][4 * c + 3] = fmaf(ds, qq[c].w, adk[i][4 * c + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (key < t && col < d) {
        store4(dk + key * rs + hoff + col,
               make_float4(adk[i][4 * c], adk[i][4 * c + 1],
                           adk[i][4 * c + 2], adk[i][4 * c + 3]));
        store4(dv + key * rs + hoff + col,
               make_float4(adv[i][4 * c], adv[i][4 * c + 1],
                           adv[i][4 * c + 2], adv[i][4 * c + 3]));
      }
    }
  }
}

// ------------------------------------------------- bf16, tensor cores

constexpr int WARPS = 4;           // bf16: warps of a CTA, 16 rows each
constexpr int NT16 = 32 * WARPS;   // bf16: threads of a CTA
static_assert(16 * WARPS == BQ && BQ == BK, "a warp's 16 rows of a tile");
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; with ok false the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
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

// Rows [r0, r0 + 64) of one head of a (rows, H, D) bf16 tensor into a
// shared tile of row stride LD, 16 bytes a copy; the copies at or past D
// (up to DP) and the rows at or past `limit` are zero-filled.
template <int DP, int LD>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* g, int r0,
                                          int limit, long rs, long hoff,
                                          int d, int tid) {
  constexpr int CH = DP / 8;
#pragma unroll
  for (int i = 0; i < (64 * CH + NT16 - 1) / NT16; ++i) {
    const int idx = tid + i * NT16;
    if (64 * CH % NT16 == 0 || idx < 64 * CH) {
      const int r = idx / CH, c = idx - r * CH;
      const int row = r0 + r;
      const bool ok = row < limit && c * 8 < d;
      cp_async16(dst + r * LD + c * 8, ok ? g + row * rs + hoff + c * 8 : g,
                 ok);
    }
  }
}

// C = A B^T over the depth DP for one warp: A's 16 rows at `a` (row
// stride LD) against the 64 rows of `b`; c[n] holds the 16 x 8 tile of
// b's rows n·8 .. n·8 + 7 (mma.sync's C fragments)
template <int DP, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[8][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    unsigned af[4];
    ldsm_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bf[4];
      ldsm_x4(bf, b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], af, bf[0], bf[1]);
      mma_bf16(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc += X B for one warp: X the 16 x 64 f32 C fragments x (rounded to
// bf16 here, the A operand), B the 64 x DP tile at `b` (row stride LD)
template <int DP, int LD>
__device__ __forceinline__ void mma_xb(float (&acc)[DP / 8][4],
                                       const float (&x)[8][4],
                                       const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      unsigned bf[4];
      ldsm_x4_trans(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LD + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], xa, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], xa, bf[2], bf[3]);
    }
  }
}

// One warp's 16 x DP f32 fragments, times `mul`, as bf16 rows of out
// [r0 + 16 rows) (the rows at or past `limit` and the columns at or past
// D are not written)
template <int DP>
__device__ __forceinline__ void store_frags(__nv_bfloat16* out,
                                            const float (&acc)[DP / 8][4],
                                            float mul, int row0, int limit,
                                            long rs, long hoff, int d,
                                            int lane) {
  const int tig2 = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int c = n * 8 + tig2;
    if (c >= d) continue;
    if (row0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(out + row0 * rs + hoff + c) =
          __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    if (row0 + 8 < limit)
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + 8) * rs + hoff + c) =
          __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// dQ, bf16: one CTA of 4 warps per (64-row query tile, head), heaviest
// first; warp w owns rows 16w .. 16w + 15 of the tile. Each key tile: S
// and dO V^T on the tensor cores, P and dS in the C fragments, dS (bf16)
// as the A operand of dQ += dS K.
template <int DP>
__global__ void __launch_bounds__(NT16)
bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ o,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dq, int s, int t, int h, int d,
            int causal) {
  constexpr int LD = DP + 8;  // row stride of a shared tile (elements)
  constexpr int TILE = 64 * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + TILE;
  __nv_bfloat16* Ks = dOs + TILE;
  __nv_bfloat16* Vs = Ks + TILE;
  float* L2 = reinterpret_cast<float*>(Vs + TILE);  // lse·log2(e), [64]
  float* Ds = L2 + 64;                               // [64]
  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long rs = (long)h * d, hoff = (long)head * d;
  const int offset = t - s;
  const int ntiles = (key_end(q0, s, t, causal) + BK - 1) / BK;
  const float sl2 = LOG2E * rsqrtf((float)d);

  copy_tile<DP, LD>(Qs, q, q0, s, rs, hoff, d, tid);
  copy_tile<DP, LD>(dOs, dout, q0, s, rs, hoff, d, tid);
  cp_async_wait_all();
  __syncthreads();
  {
    // D = rowsum(dO o O): 2 lanes a row, 8 columns a step, summed across
    // the pair in a fixed order
    const int r = tid >> 1, part = tid & 1, row = q0 + r;
    float acc = 0.f;
    if (row < s)
      for (int c = 8 * part; c < d; c += 16)
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(o + row * rs + hoff +
                                                       c + e));
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dOs + r * LD + c + e));
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
        }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      Ds[r] = acc;
      L2[r] = row < s ? lse[(long)row * h + head] * LOG2E : 0.f;
      if (row < s) delta[(long)row * h + head] = acc;
    }
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int rl = warp * 16 + (lane >> 2);  // the fragments' rows rl, rl + 8
  const int tig2 = (lane & 3) * 2;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the last K and V
    copy_tile<DP, LD>(Ks, k, k0, t, rs, hoff, d, tid);
    copy_tile<DP, LD>(Vs, v, k0, t, rs, hoff, d, tid);
    cp_async_wait_all();
    __syncthreads();
    float sc[8][4], dp[8][4];
    mma_abt<DP, LD>(sc, Qs + warp * 16 * LD, Ks, lane);
    mma_abt<DP, LD>(dp, dOs + warp * 16 * LD, Vs, lane);
    const bool edge = k0 + BK > t || q0 + BQ > s ||
                      (causal && k0 + BK - 1 > q0 + offset);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rl + (e >> 1) * 8;
        const int key = k0 + n * 8 + tig2 + (e & 1);
        const bool seen = !edge || (q0 + r < s && key < t &&
                                    (!causal || key <= q0 + r + offset));
        const float p = seen ? exp2f(sc[n][e] * sl2 - L2[r]) : 0.f;
        sc[n][e] = p * (dp[n][e] - Ds[r]);  // dS
      }
    mma_xb<DP, LD>(acc, sc, Ks, lane);
  }
  store_frags<DP>(dq, acc, rsqrtf((float)d), q0 + rl, s, rs, hoff, d, lane);
}

// dK, dV, bf16: one CTA of 4 warps per (64-key tile, head), the first key
// tiles first; warp w owns keys 16w .. 16w + 15 of the tile. Each query
// tile that sees the keys: S^T = K Q^T and V dO^T on the tensor cores,
// P^T and dS^T in the C fragments, then (bf16) the A operands of
// dV += P^T dO and dK += dS^T Q.
template <int DP>
__global__ void __launch_bounds__(NT16)
bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             int s, int t, int h, int d, int causal) {
  constexpr int LD = DP + 8;
  constexpr int TILE = 64 * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + TILE;
  __nv_bfloat16* Qs = Vs + TILE;
  __nv_bfloat16* dOs = Qs + TILE;
  float* L2 = reinterpret_cast<float*>(dOs + TILE);  // [64]
  float* Ds = L2 + 64;                               // [64]
  const int head = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long rs = (long)h * d, hoff = (long)head * d;
  const int offset = t - s;
  const int qfirst = causal ? max(0, k0 - offset) : 0;
  const int nq = (s + BQ - 1) / BQ;
  const float sl2 = LOG2E * rsqrtf((float)d);

  copy_tile<DP, LD>(Ks, k, k0, t, rs, hoff, d, tid);
  copy_tile<DP, LD>(Vs, v, k0, t, rs, hoff, d, tid);

  float adk[DP / 8][4], adv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  const int kl = warp * 16 + (lane >> 2);  // the fragments' keys kl, kl + 8
  const int tig2 = (lane & 3) * 2;

  for (int qt = qfirst / BQ; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // every warp is done with the last Q and dO
    copy_tile<DP, LD>(Qs, q, q0, s, rs, hoff, d, tid);
    copy_tile<DP, LD>(dOs, dout, q0, s, rs, hoff, d, tid);
    if (tid < BQ) {
      const int row = q0 + tid;
      L2[tid] = row < s ? lse[(long)row * h + head] * LOG2E : 0.f;
      Ds[tid] = row < s ? delta[(long)row * h + head] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    float st[8][4], dpt[8][4];
    mma_abt<DP, LD>(st, Ks + warp * 16 * LD, Qs, lane);
    mma_abt<DP, LD>(dpt, Vs + warp * 16 * LD, dOs, lane);
    const bool edge = k0 + BK > t || q0 + BQ > s ||
                      (causal && k0 + BK - 1 > q0 + offset);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kl + (e >> 1) * 8;
        const int r = n * 8 + tig2 + (e & 1);  // the query row in the tile
        const bool seen = !edge || (q0 + r < s && key < t &&
                                    (!causal || key <= q0 + r + offset));
        const float p = seen ? exp2f(st[n][e] * sl2 - L2[r]) : 0.f;
        st[n][e] = p;                            // P^T
        dpt[n][e] = p * (dpt[n][e] - Ds[r]);     // dS^T
      }
    mma_xb<DP, LD>(adv, st, dOs, lane);
    mma_xb<DP, LD>(adk, dpt, Qs, lane);
  }
  store_frags<DP>(dk, adk, rsqrtf((float)d), k0 + kl, t, rs, hoff, d, lane);
  store_frags<DP>(dv, adv, 1.f, k0 + kl, t, rs, hoff, d, lane);
}

// ------------------------------------------------------------- launches

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int s,
                       int t, int h, int d, int causal, cudaStream_t stream) {
  constexpr int W = 64 * NC, LDK = W + 4;
  const size_t smem_dq =
      sizeof(float) * (2 * BQ * W + 2 * BK * LDK + BQ * LDP + 2 * BQ);
  const size_t smem_dkv =
      sizeof(float) * (2 * BK * LDK + 2 * BQ * W + 2 * BQ * LDP + 2 * BQ);
  const int nq = (s + BQ - 1) / BQ, nk = (t + BK - 1) / BK;
  if (nq > 65535 || nk > 65535) return cudaErrorInvalidValue;
  auto* kdq = &flash_bwd_dq<NC>;
  auto* kdkv = &flash_bwd_dkv<NC>;
  // opt in to each launch's size every time
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return e;
  kdq<<<dim3(h, nq), NT, smem_dq, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, lse, delta, (float*)dq, s, t, h, d, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(
      kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (e != cudaSuccess) return e;
  kdkv<<<dim3(h, nk), NT, smem_dkv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, s, t, h, d, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* delta, void* dq, void* dk, void* dv, int s,
                        int t, int h, int d, int causal,
                        cudaStream_t stream) {
  typedef __nv_bfloat16 B;
  const size_t smem = 4 * 64 * (DP + 8) * sizeof(B) + 2 * 64 * sizeof(float);
  const int nq = (s + BQ - 1) / BQ, nk = (t + BK - 1) / BK;
  if (nq > 65535 || nk > 65535) return cudaErrorInvalidValue;
  auto* kdq = &bwd_dq_bf16<DP>;
  auto* kdkv = &bwd_dkv_bf16<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kdq<<<dim3(h, nq), NT16, smem, stream>>>(
      (const B*)q, (const B*)k, (const B*)v, (const B*)o, (const B*)dout, lse,
      delta, (B*)dq, s, t, h, d, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(
      kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kdkv<<<dim3(h, nk), NT16, smem, stream>>>(
      (const B*)q, (const B*)k, (const B*)v, (const B*)dout, lse, delta,
      (B*)dk, (B*)dv, s, t, h, d, causal);
  return cudaGetLastError();
}

}  // namespace

// (q, k, v, out, dout, lse, delta workspace, dq, dk, dv, s, t, h, d, causal,
// bf16, stream): the two launches; returns cudaGetLastError() after them.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int s, int t, int h, int d, int causal,
                                   int bf16, void* stream) {
  if (s <= 0 || t <= 0 || h <= 0 || d < 16 || d > 128 || d % 8 ||
      (causal && t < s) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  if (!bf16)
    return (int)(d <= 64 ? launch_f32<1>(q, k, v, o, dout, l, dl, dq, dk, dv,
                                         s, t, h, d, causal, st)
                         : launch_f32<2>(q, k, v, o, dout, l, dl, dq, dk, dv,
                                         s, t, h, d, causal, st));
#define FLASH_BWD_BF16(DP)                                                  \
  return (int)launch_bf16<DP>(q, k, v, o, dout, l, dl, dq, dk, dv, s, t, h, \
                              d, causal, st)
  switch ((d + 15) / 16) {
    case 1: FLASH_BWD_BF16(16);
    case 2: FLASH_BWD_BF16(32);
    case 3: FLASH_BWD_BF16(48);
    case 4: FLASH_BWD_BF16(64);
    case 5: FLASH_BWD_BF16(80);
    case 6: FLASH_BWD_BF16(96);
    case 7: FLASH_BWD_BF16(112);
    default: FLASH_BWD_BF16(128);
  }
#undef FLASH_BWD_BF16
}
