// flash_attention_bwd: the backward of csrc/flash_attention.cu, from its
// saved output and per-row logsumexp. q, dq: (S, H, D); k, v, dk, dv:
// (T, H, D); out, dout: (S, H, D); f32 or bf16 (one flag for all), lse
// (S, H) f32, and a f32 workspace of 2·H·S_pad floats, S_pad = S rounded up
// to 128 (flash_attention.py::bwd_workspace_floats). With scale s =
// 1/sqrt(D) and score_ij = s q_i k_j (masked where the forward masks: key
// j > i + T - S when causal), the backward recomputes P_ij = exp(score_ij
// - lse_i) and takes
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
// Two launches on the stream and no atomics, so every sum runs in an order
// fixed by the shapes and a second call is bit-equal to the first:
//   dQ: one CTA per (query tile, head), heaviest tile first, heads the
//       fastest grid dimension. It computes D for its rows (and, in the
//       bf16 body, writes D and lse·log2(e) to the workspace in (H, S_pad)
//       order), then walks the key tiles the forward walked: S and dout
//       V^T, then P and dS, then dQ += dS K.
//   dK, dV: one CTA per (key tile, head), the first key tiles (which the
//       most query rows see) first. It walks the query tiles that see its
//       keys: S^T and V dout^T, then P^T and dS^T (D read back from the
//       workspace the first launch wrote), then dV += P^T dout and dK +=
//       dS^T Q.
// One pass that also accumulates dQ would need atomics or a second sum in
// a fixed order; the two launches pay for that with two products more
// (S and dout V^T again in the second launch: seven products, not five).
// Bound on this card: operations. The five products of the backward at
// causal S = T = 4096, H = 16, D = 128 take 172 GFLOP: 2.56 ms at the
// 67 TFLOP/s of f32 outside the tensor cores, 0.17 ms at the 989 TFLOP/s
// of bf16 on them. Two bodies, one per type:
//
// bf16 on the tensor cores through wgmma (bf16 in, f32 accumulate). It
// replaces a body of 4 warps on mma.sync m16n8k16 fed by ldmatrix, whose
// every tile copy (cp.async) was waited for at once, and which spilled at
// several D. A CTA is three warpgroups: two consumers, each owning 64
// query rows (dQ: 128-row tiles) or 64 keys (dK, dV: 128-key tiles), and a
// producer, one thread of which starts every copy (a whole warpgroup, so
// that setmaxnreg can hand its registers to the consumers: 240 a consumer
// thread, 24 a producer thread, so the dK/dV accumulators, 2 x 64 x 64·NB
// f32 a warpgroup, 128 a thread at D = 128, stay in registers). The
// producer loads the CTA's own tiles once (Q and dout, or K and V) and
// fills a ring of STAGES = 2 tiles in shared memory with what the CTA
// walks: K and V tiles of 64 keys, or Q and dout tiles of 64 rows with
// their 64 lse·log2(e) and D values. Tiles come through TMA
// (cp.async.bulk.tensor over a CUtensorMap a tensor, passed as a
// __grid_constant__ parameter: a 3-D view (D, H, rows) with boxes of 64
// columns of one head, 128-byte swizzled as wgmma's descriptors expect),
// the values through a 1-D bulk copy; a "full" and an "empty" mbarrier a
// stage let the copies of the next tile run under the products of this
// one. Each consumer, per walked tile:
//   S = Q K^T and dP = dout V^T (dK/dV: S^T = K Q^T and dP^T = V dout^T):
//       wgmma m64n64k16 with both operands in shared memory, K-major, in
//       two commit groups, so P is computed while dP is still on the cores;
//   P = 2^(S·log2(e)/sqrt(D) - lse·log2(e)) on ex2.approx, one MUFU
//       instruction (the exact exp2f costs several more an element, and
//       this exponent is most of the work between products), masked only
//       on the tiles that cross the causal edge or the ends of S and T;
//   P and dS stay in the f32 accumulators, are rounded to bf16 in registers
//       (flash_backward_plain rounds at the same places) and are the A
//       operand of dQ += dS K (dV += P^T dout, dK += dS^T Q): wgmma
//       m64n64k16 from registers, B read MN-major from the same swizzled
//       tile (the descriptor's transpose bit).
// Columns past D are zero-filled by TMA and the products run over whole
// 64-column slabs (NB = 1 for D <= 64, else 2); rows past S and keys past
// T are zero-filled likewise and masked. q is not scaled before a product
// (q/sqrt(D) is no bf16 value): the scale goes into the exponent, and onto
// dq and dk at the end. Shared memory at D = 128: 133,160 B (dQ) and
// 134,184 B (dK, dV), one CTA an SM. Measured slower on an H100: the two
// warpgroups taking turns at issuing products (named barriers), the next
// tile's S and dP started with this tile's last product, a ring of 3.
//
// f32 on the FMA units (no TF32): 256 threads (16 x 16) a CTA, 64-row and
// 64-key tiles; thread (ty, tx) owns the 4 x 4 scores of rows ty + 16i and
// keys tx + 16j, and the 4 x 4·NC outputs of rows (or keys) ty + 16i and
// columns 4tx + 64c (NC = 1 for D <= 64, else 2). Q is scaled by s as it
// is stored, as the f32 forward does; P and dS pass through shared memory.
// K and V rows are padded by 4 floats so 8 lanes reading 8 keys hit 8 bank
// groups; P and dS rows by 1 float. 150,272 B (dQ) and 166,912 B (dK, dV)
// of shared memory at D = 128, one CTA an SM; D goes to the workspace in
// (S, H) order.
#include <cuda.h>
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

// The keys [0, end) that rows [r0, min(r0 + rows, s)) see, as the forward
// walks them.
__device__ __forceinline__ int key_end(int r0, int rows, int s, int t,
                                       int causal) {
  if (!causal || t < s) return t;
  return min(min(r0 + rows, s) - 1 + (t - s) + 1, t);
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
  const int ntiles = (key_end(q0, BQ, s, t, causal) + BK - 1) / BK;

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

// ------------------------------------------------ bf16, wgmma and TMA

constexpr int DQ_ROWS = 128;    // bf16 dQ: rows of a CTA, 64 a warpgroup
constexpr int DQ_KEYS = 64;     // bf16 dQ: keys of a ring tile
constexpr int DKV_KEYS = 128;   // bf16 dK/dV: keys of a CTA, 64 a warpgroup
constexpr int DKV_ROWS = 64;    // bf16 dK/dV: query rows of a ring tile
constexpr int STAGES = 2;       // tiles of the ring
constexpr int CONSUMERS = 256;  // two warpgroups
constexpr int NT_WG = CONSUMERS + 128;  // and the producer warpgroup
constexpr int ROW_BYTES = 128;  // a row of a 64-column slab, swizzled
constexpr int PAD_ROWS = 128;   // S_pad: S rounded up to this
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// arrive and expect `bytes` of copies on the barrier's current phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// the box at (column c, head, row r) of a tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int head,
                                         int r) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(head),
      "r"(r)
      : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// 2^x in one MUFU instruction (exp2f's exact path costs several more)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The wgmma descriptor of an operand in shared memory at `addr` laid out
// as TMA's 128-byte swizzle leaves it: 8-row groups `sbo` bytes apart; for
// an MN-major operand, 64-column slabs `lbo` bytes apart (K-major: 16).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of x across a wgmma
__device__ __forceinline__ void pin(float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
// keeps the A fragments of a wgmma in their registers until its wait: the
// product reads them after the instruction has gone out
template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// d (+)= A B for a 64 x 64 f32 tile of one warpgroup, K = 16: A and B in
// shared memory, both K-major; d is overwritten when `acc` is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}
// d += A B, K = 16: A the warpgroup's bf16 fragments in registers (four
// 32-bit words a thread, mma.sync's A layout for each warp's 16 rows), B
// in shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// x = A B^T and y = A2 B2^T over 64·NB columns (K-major slabs ASLAB and
// BSLAB bytes apart), as two commit groups
template <int NB, uint32_t ASLAB, uint32_t BSLAB>
__device__ __forceinline__ void products_ss(float (&x)[32], float (&y)[32],
                                            uint32_t a, uint32_t b,
                                            uint32_t a2, uint32_t b2) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_ss(x,
             wg_desc(a + (kk >> 2) * ASLAB + (kk & 3) * 32, 16,
                     8 * ROW_BYTES),
             wg_desc(b + (kk >> 2) * BSLAB + (kk & 3) * 32, 16,
                     8 * ROW_BYTES),
             kk);
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_ss(y,
             wg_desc(a2 + (kk >> 2) * ASLAB + (kk & 3) * 32, 16,
                     8 * ROW_BYTES),
             wg_desc(b2 + (kk >> 2) * BSLAB + (kk & 3) * 32, 16,
                     8 * ROW_BYTES),
             kk);
  wg_commit();
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// acc + a·b over 8 bf16 pairs, in order
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 u = __bfloat1622float2(x[e]), w = __bfloat1622float2(y[e]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}
// The four A words of K-step kk (columns 16kk .. 16kk + 15) from a 64 x 64
// f32 accumulator, rounded to bf16: the C layout of columns 16kk .. + 7 and
// + 8 .. + 15 is mma.sync's A layout of the pair
__device__ __forceinline__ void to_a(uint32_t (&a)[16], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[4 * kk + 0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    a[4 * kk + 1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[4 * kk + 2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[4 * kk + 3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}
// One warpgroup's 64 x 64·NB f32 accumulators, times `mul`, as bf16 rows
// [row0 .. row0 + 63] of out (its warp's rows 16·warp + g, + 8); rows at
// or past `limit` and columns at or past D are not written
template <int NB>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out,
                                          const float (&acc)[NB][32],
                                          float mul, int row0, int limit,
                                          long rs, long hoff, int d,
                                          int warp, int lane) {
  const int ra = row0 + warp * 16 + (lane >> 2), tig2 = (lane & 3) * 2;
#pragma unroll
  for (int a = 0; a < NB; ++a)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = ra + ((i >> 1) & 1) * 8;
      const int col = a * 64 + (i >> 2) * 8 + tig2;
      if (row < limit && col < d)
        *reinterpret_cast<__nv_bfloat162*>(out + row * rs + hoff + col) =
            __floats2bfloat162_rn(acc[a][i] * mul, acc[a][i + 1] * mul);
    }
}

// Shared memory of the dQ kernel (byte offsets from a 1024-aligned base):
// Q and dout, NB slabs of DQ_ROWS rows each; the ring of K and V tiles;
// lse·log2(e) and D of the CTA's rows; the barriers
template <int NB>
struct DqSmem {
  static constexpr uint32_t QSLAB = DQ_ROWS * ROW_BYTES;
  static constexpr uint32_t KSLAB = DQ_KEYS * ROW_BYTES;
  static constexpr uint32_t Q = 0, DO = NB * QSLAB, RING = 2 * NB * QSLAB;
  static constexpr uint32_t STAGE = 2 * NB * KSLAB;  // K, then V
  static constexpr uint32_t STATS = RING + STAGES * STAGE;
  static constexpr uint32_t BARS = STATS + 2 * DQ_ROWS * 4;
  static constexpr uint32_t BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};
// of the dK/dV kernel: K and V, NB slabs of DKV_KEYS keys each; the ring
// of Q and dout tiles, each with its rows' lse·log2(e) and D; the barriers
template <int NB>
struct DkvSmem {
  static constexpr uint32_t KSLAB = DKV_KEYS * ROW_BYTES;
  static constexpr uint32_t QSLAB = DKV_ROWS * ROW_BYTES;
  static constexpr uint32_t K = 0, V = NB * KSLAB, RING = 2 * NB * KSLAB;
  static constexpr uint32_t TILE = 2 * NB * QSLAB;  // Q, then dout
  static constexpr uint32_t STATS = 2 * DKV_ROWS * 4;
  static constexpr uint32_t STAGE = TILE + 1024;    // and the stats
  static constexpr uint32_t BARS = RING + STAGES * STAGE;
  static constexpr uint32_t BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;
};

// dQ, bf16: one CTA per (128-row query tile, head), heaviest first;
// warpgroup w owns rows 64w .. 64w + 63 of the tile; the producer loads Q
// and dout once and K and V tiles into the ring.
template <int NB>
__global__ void __launch_bounds__(NT_WG, 1)
bwd_dq_wg(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mdo,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ ws,
          __nv_bfloat16* __restrict__ dq, int s, int t, int h, int d,
          int causal, int s_pad) {
  typedef DqSmem<NB> L;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const uint32_t qbar = base + L::BARS, full0 = qbar + 8,
                 empty0 = full0 + 8 * STAGES;
  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;  // heaviest first
  const int ntiles =
      (key_end(q0, DQ_ROWS, s, t, causal) + DQ_KEYS - 1) / DQ_KEYS;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, CONSUMERS / 32);  // a lane of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      mbar_expect(qbar, 2 * NB * L::QSLAB);
      for (int a = 0; a < NB; ++a) {
        tma_load(base + L::Q + a * L::QSLAB, &mq, qbar, 64 * a, head, q0);
        tma_load(base + L::DO + a * L::QSLAB, &mdo, qbar, 64 * a, head, q0);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * st, (j / STAGES - 1) & 1);
        const uint32_t kb = base + L::RING + st * L::STAGE,
                       full = full0 + 8 * st;
        mbar_expect(full, L::STAGE);
        for (int a = 0; a < NB; ++a) {
          tma_load(kb + a * L::KSLAB, &mk, full, 64 * a, head, j * DQ_KEYS);
          tma_load(kb + (NB + a) * L::KSLAB, &mv, full, 64 * a, head,
                   j * DQ_KEYS);
        }
      }
    }
  } else {  // the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
    const int r0 = q0 + 64 * wg;  // the warpgroup's first row
    const long rs = (long)h * d, hoff = (long)head * d;
    float* L2s = reinterpret_cast<float*>(sm + L::STATS) + 64 * wg;
    float* Ds = L2s + DQ_ROWS;
    {
      // D = rowsum(dO o O): 2 threads a row, 8 columns a step, summed
      // across the pair in a fixed order; D and lse·log2(e) also to the
      // workspace, zero for the rows past S
      const int r = wt >> 1, part = wt & 1, row = r0 + r;
      float acc = 0.f;
      if (row < s)
        for (int c = 8 * part; c < d; c += 16)
          acc = dot8(*reinterpret_cast<const uint4*>(o + row * rs + hoff + c),
                     *reinterpret_cast<const uint4*>(dout + row * rs + hoff +
                                                     c),
                     acc);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (part == 0) {
        const float l2 = row < s ? lse[(long)row * h + head] * LOG2E : 0.f;
        L2s[r] = l2;
        Ds[r] = acc;
        ws[(long)head * s_pad + row] = l2;
        ws[(long)(h + head) * s_pad + row] = acc;
      }
    }
    wg_bar(1 + wg);
    const int g = lane >> 2, tig2 = (lane & 3) * 2;
    const int ra = warp * 16 + g;  // the fragments' rows ra, ra + 8
    const float la = L2s[ra], lb = L2s[ra + 8];
    const float da = Ds[ra], db = Ds[ra + 8];
    const int offset = t - s;
    const int mine =  // the key tiles this warpgroup's rows see
        r0 >= s ? 0
                : (key_end(r0, 64, s, t, causal) + DQ_KEYS - 1) /
                      DQ_KEYS;
    const float sl2 = LOG2E * rsqrtf((float)d);
    const uint32_t qa = base + L::Q + 64 * wg * ROW_BYTES,
                   oa = base + L::DO + 64 * wg * ROW_BYTES;
    float acc[NB][32];
#pragma unroll
    for (int a = 0; a < NB; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
    mbar_wait(qbar, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES;
      const uint32_t kb = base + L::RING + st * L::STAGE,
                     vb = kb + NB * L::KSLAB;
      mbar_wait(full0 + 8 * st, (j / STAGES) & 1);
      if (j < mine) {
        const int k0 = j * DQ_KEYS;
        float sc[32], dp[32];
        wg_fence();
        products_ss<NB, L::QSLAB, L::KSLAB>(sc, dp, qa, kb, oa, vb);
        wg_wait<1>();
        pin(sc);
        if (k0 + DQ_KEYS > t || r0 + 64 > s ||
            (causal && k0 + DQ_KEYS - 1 > r0 + offset)) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int row = r0 + ra + ((i >> 1) & 1) * 8;
            const int key = k0 + (i >> 2) * 8 + tig2 + (i & 1);
            const bool seen = row < s && key < t &&
                              (!causal || key <= row + offset);
            sc[i] = seen ? ex2(fmaf(sc[i], sl2, (i & 2) ? -lb : -la)) : 0.f;
          }
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = ex2(fmaf(sc[i], sl2, (i & 2) ? -lb : -la));
        }
        wg_wait<0>();
        pin(dp);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] = sc[i] * (dp[i] - ((i & 2) ? db : da));  // dS
        uint32_t ds[16];
        to_a(ds, sc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int a = 0; a < NB; ++a)
            wgmma_rs(acc[a], ds + 4 * kk,
                     wg_desc(kb + a * L::KSLAB + kk * 16 * ROW_BYTES,
                             L::KSLAB, 8 * ROW_BYTES));
        wg_commit();
        wg_wait<0>();
        pin(ds);
#pragma unroll
        for (int a = 0; a < NB; ++a) pin(acc[a]);
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    store_acc<NB>(dq, acc, rsqrtf((float)d), r0, s, rs, hoff, d, warp, lane);
  }
}

// dK, dV, bf16: one CTA per (128-key tile, head), the first key tiles
// first; warpgroup w owns keys 64w .. 64w + 63 of the tile; the producer
// loads K and V once and Q and dout tiles (with their rows' lse·log2(e)
// and D from the workspace) into the ring.
template <int NB>
__global__ void __launch_bounds__(NT_WG, 1)
bwd_dkv_wg(const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mdo,
           const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk,
           __nv_bfloat16* __restrict__ dv, int s, int t, int h, int d,
           int causal, int s_pad) {
  typedef DkvSmem<NB> L;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const uint32_t kvbar = base + L::BARS, full0 = kvbar + 8,
                 empty0 = full0 + 8 * STAGES;
  const int head = blockIdx.x;
  const int k0 = blockIdx.y * DKV_KEYS;  // the first key tiles see the most
  const int offset = t - s;
  // the first query tile holding a row that sees key k0 (every row when
  // not causal)
  const int qfirst = (causal ? max(0, k0 - offset) : 0) / DKV_ROWS;
  const int ntiles = (s + DKV_ROWS - 1) / DKV_ROWS - qfirst;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kvbar, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warpgroup: one thread loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      mbar_expect(kvbar, 2 * NB * L::KSLAB);
      for (int a = 0; a < NB; ++a) {
        tma_load(base + L::K + a * L::KSLAB, &mk, kvbar, 64 * a, head, k0);
        tma_load(base + L::V + a * L::KSLAB, &mv, kvbar, 64 * a, head, k0);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(empty0 + 8 * st, (j / STAGES - 1) & 1);
        const uint32_t qb = base + L::RING + st * L::STAGE,
                       full = full0 + 8 * st;
        const int q0 = (qfirst + j) * DKV_ROWS;
        mbar_expect(full, L::TILE + L::STATS);
        for (int a = 0; a < NB; ++a) {
          tma_load(qb + a * L::QSLAB, &mq, full, 64 * a, head, q0);
          tma_load(qb + (NB + a) * L::QSLAB, &mdo, full, 64 * a, head, q0);
        }
        bulk_load(qb + L::TILE, ws + (long)head * s_pad + q0, 4 * DKV_ROWS,
                  full);
        bulk_load(qb + L::TILE + 4 * DKV_ROWS,
                  ws + (long)(h + head) * s_pad + q0, 4 * DKV_ROWS, full);
      }
    }
  } else {  // the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
    const int kw0 = k0 + 64 * wg;  // the warpgroup's first key
    const int g = lane >> 2, tig2 = (lane & 3) * 2;
    const int kl = warp * 16 + g;  // the fragments' keys kl, kl + 8
    // the first walked tile with a pair this warpgroup's keys see
    const int mine = kw0 >= t ? ntiles + qfirst
                              : (causal ? max(0, kw0 - offset) : 0) /
                                    DKV_ROWS;
    const float sl2 = LOG2E * rsqrtf((float)d);
    const uint32_t ka = base + L::K + 64 * wg * ROW_BYTES,
                   va = base + L::V + 64 * wg * ROW_BYTES;
    float adk[NB][32], adv[NB][32];
#pragma unroll
    for (int a = 0; a < NB; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) adk[a][i] = adv[a][i] = 0.f;
    mbar_wait(kvbar, 0);
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES, qt = qfirst + j;
      const uint32_t qb = base + L::RING + st * L::STAGE,
                     ob = qb + NB * L::QSLAB;
      const float* L2s = reinterpret_cast<const float*>(
          sm + L::RING + st * L::STAGE + L::TILE);
      const float* Ds = L2s + DKV_ROWS;
      mbar_wait(full0 + 8 * st, (j / STAGES) & 1);
      if (qt >= mine) {
        const int q0 = qt * DKV_ROWS;
        float sc[32], dp[32];
        wg_fence();
        products_ss<NB, L::KSLAB, L::QSLAB>(sc, dp, ka, qb, va, ob);
        wg_wait<1>();
        pin(sc);
        const bool edge = kw0 + 64 > t || q0 + DKV_ROWS > s ||
                          (causal && kw0 + 63 > q0 + offset);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          // the rows 8n + tig2, + 1 of the tile: P^T
          const float2 l2 =
              *reinterpret_cast<const float2*>(L2s + 8 * n + tig2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * n + e;
            const float x = ex2(fmaf(sc[i], sl2, (e & 1) ? -l2.y : -l2.x));
            if (edge) {
              const int key = kw0 + kl + (e >> 1) * 8;
              const int row = q0 + 8 * n + tig2 + (e & 1);
              sc[i] = row < s && key < t && (!causal || key <= row + offset)
                          ? x
                          : 0.f;
            } else {
              sc[i] = x;
            }
          }
        }
        wg_wait<0>();
        pin(dp);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 dd =
              *reinterpret_cast<const float2*>(Ds + 8 * n + tig2);
#pragma unroll
          for (int e = 0; e < 4; ++e)  // dS^T
            dp[4 * n + e] =
                sc[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? dd.y : dd.x));
        }
        uint32_t pa[16], sa[16];
        to_a(pa, sc);
        to_a(sa, dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int a = 0; a < NB; ++a) {
            wgmma_rs(adv[a], pa + 4 * kk,
                     wg_desc(ob + a * L::QSLAB + kk * 16 * ROW_BYTES,
                             L::QSLAB, 8 * ROW_BYTES));
            wgmma_rs(adk[a], sa + 4 * kk,
                     wg_desc(qb + a * L::QSLAB + kk * 16 * ROW_BYTES,
                             L::QSLAB, 8 * ROW_BYTES));
          }
        wg_commit();
        wg_wait<0>();
        pin(pa);
        pin(sa);
#pragma unroll
        for (int a = 0; a < NB; ++a) {
          pin(adv[a]);
          pin(adk[a]);
        }
      }
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
    const long rs = (long)h * d, hoff = (long)head * d;
    store_acc<NB>(dk, adk, rsqrtf((float)d), kw0, t, rs, hoff, d, warp,
                  lane);
    store_acc<NB>(dv, adv, 1.f, kw0, t, rs, hoff, d, warp, lane);
  }
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

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (the
// library links no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a (rows, H, D) bf16 tensor as a 3-D view (D, H, rows) whose
// boxes are 64 columns of one head by `box_rows` rows, 128-byte swizzled;
// what falls past D or past the rows reads as zero.
bool rows_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rows,
              int h, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)h,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
  const cuuint32_t one[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* ws, void* dq, void* dk, void* dv, int s, int t,
                        int h, int d, int causal, cudaStream_t stream) {
  typedef __nv_bfloat16 B;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mdo, mk, mv, mk2, mv2, mq2, mdo2;
  if (!rows_map(enc, &mq, q, s, h, d, DQ_ROWS) ||
      !rows_map(enc, &mdo, dout, s, h, d, DQ_ROWS) ||
      !rows_map(enc, &mk, k, t, h, d, DQ_KEYS) ||
      !rows_map(enc, &mv, v, t, h, d, DQ_KEYS) ||
      !rows_map(enc, &mk2, k, t, h, d, DKV_KEYS) ||
      !rows_map(enc, &mv2, v, t, h, d, DKV_KEYS) ||
      !rows_map(enc, &mq2, q, s, h, d, DKV_ROWS) ||
      !rows_map(enc, &mdo2, dout, s, h, d, DKV_ROWS))
    return cudaErrorInvalidValue;
  const int s_pad = (s + PAD_ROWS - 1) / PAD_ROWS * PAD_ROWS;
  const int nq = s_pad / DQ_ROWS, nk = (t + DKV_KEYS - 1) / DKV_KEYS;
  if (nq > 65535 || nk > 65535) return cudaErrorInvalidValue;
  auto* kdq = &bwd_dq_wg<NB>;
  auto* kdkv = &bwd_dkv_wg<NB>;
  cudaError_t e = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, DqSmem<NB>::BYTES);
  if (e != cudaSuccess) return e;
  kdq<<<dim3(h, nq), NT_WG, DqSmem<NB>::BYTES, stream>>>(
      mq, mdo, mk, mv, (const B*)o, (const B*)dout, lse, ws, (B*)dq, s, t, h,
      d, causal, s_pad);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kdkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DkvSmem<NB>::BYTES);
  if (e != cudaSuccess) return e;
  kdkv<<<dim3(h, nk), NT_WG, DkvSmem<NB>::BYTES, stream>>>(
      mk2, mv2, mq2, mdo2, ws, (B*)dk, (B*)dv, s, t, h, d, causal, s_pad);
  return cudaGetLastError();
}

}  // namespace

// (q, k, v, out, dout, lse, workspace of 2·H·S_pad floats, dq, dk, dv, s,
// t, h, d, causal, bf16, stream): the two launches; returns
// cudaGetLastError() after them.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* ws, void* dq, void* dk, void* dv,
                                   int s, int t, int h, int d, int causal,
                                   int bf16, void* stream) {
  if (s <= 0 || t <= 0 || h <= 0 || d < 16 || d > 128 || d % 8 ||
      (causal && t < s) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) % 16 ||
      (uintptr_t)ws % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* w = (float*)ws;
  if (!bf16)
    return (int)(d <= 64 ? launch_f32<1>(q, k, v, o, dout, l, w, dq, dk, dv,
                                         s, t, h, d, causal, st)
                         : launch_f32<2>(q, k, v, o, dout, l, w, dq, dk, dv,
                                         s, t, h, d, causal, st));
  return (int)(d <= 64 ? launch_bf16<1>(q, k, v, o, dout, l, w, dq, dk, dv,
                                        s, t, h, d, causal, st)
                       : launch_bf16<2>(q, k, v, o, dout, l, w, dq, dk, dv,
                                        s, t, h, d, causal, st));
}
