// wkv_chunk_bwd: the backward of csrc/wkv_chunk.cu, f32. From the
// forward's inputs r, k, v, logw (B, S, H, D), u (H, D), its workspace
// (per (b, h, chunk) the state S_c the chunk starts from, then the
// chunks' decays w_c), the gradient dy of y and the gradient dS of the
// final state (null: zero, as in training), it writes dr, dk, dv, dlogw
// (B, S, H, D) and du (H, D). Within a chunk, with lwc and lwp the
// cumulative log-decays of the forward (lwp one step earlier, 0 at the
// first) and att, y as the forward defines them:
//   datt[t][j] = dy_t . v_j                          (j <= t)
//   G_c        = gradient of the state chunk c ends with: G = dS for the
//                last chunk, G_{c-1} = w_c G_c + (r * exp(lwp))^T dy
//   dv_j  = sum_{t >= j} att[t][j] dy_t + (k_j * exp(lwc[q-1] - lwc_j)) G_c
//   d^r_t = sum_{j < t} datt[t][j] k_j exp(lwp_t - lwc_j)
//           + exp(lwp_t) (S_c dy_t)                 (dr less the u term)
//   d^k_j = sum_{t > j} datt[t][j] r_t exp(lwp_t - lwc_j)
//           + exp(lwc[q-1] - lwc_j) (G_c v_j)       (dk less the u term)
//   dr_t  = d^r_t + datt[t][t] u k_t,  dk_j = d^k_j + datt[j][j] r_j u
//   du    = sum over the batch and the steps of datt[t][t] r_t k_t
// and the decays: a chunk's y and the state it ends with depend on its
// logw only through its own cumulative sums (S_c does not depend on
// them), so the gradient of lwc_j is
//   r_{j+1} d^r_{j+1} (j + 1 in the chunk) - k_j d^k_j
//   + at j = q - 1: sum_j k_j exp(lwc[q-1] - lwc_j) (G_c v_j)
//                   + exp(lwc[q-1]) sum_e G_c S_c
// and dlogw_m is its sum over j >= m in the chunk. No carry crosses a
// chunk, and every exp takes an argument <= 0, as in the forward. The
// forward's log-decays are kept in units of log2 here too, so each exp
// is one exp2f, and the gradient is that of the natural logw.
//
// The backward of the TPU kernel
// src/repro/kernels/wkv_chunk.py::wkv_chunk_kernel, which had none: the
// reference trains RWKV through its chunked form in XLA. The port trains
// through the forward kernel, so it needs this one.
//
// Four launches on the caller's stream, no atomics, every sum in an order
// fixed by the shapes, so repeated calls are bit-equal:
//   A' (grad_parts): per (b, h, chunk), (r * 2^lwp)^T dy, a D x D product
//      on a 4 x 4 FMA register tile per thread (the forward's phase A
//      with r and dy for k and v), into the workspace `gws`.
//   B' (grad_scan): one thread per state element (b, h, i, e) walks the
//      chunks from the last: G = dS, then for c = nc - 1 .. 0 it writes
//      G_c over A'_c and takes G = w_c[i] G + A'_c.
//   C' (chunk_grads): per (b, h, chunk), from r, k, v, logw, dy, S_c, G_c
//      in shared memory: att and datt by pairs (the pairwise exps of the
//      reference's chunk body, no sub-chunk factors), then dv and dr in
//      one pass, then dk, each thread owning rows tr + 16a and columns
//      tc + 16m (a, m < 4: the loads of a warp fall on distinct banks or
//      broadcast), then one thread a column sums the gradient of lwc from
//      the last step into dlogw, and the chunk's share of du.
//   D' (du_sum): one thread per (h, i) sums the shares over the batch,
//      then the chunks, in order.
// 0 < D <= 64 and 0 < q <= 64 (ragged q and D included: tiles zero-padded
// to q rounded up to 16 rows and D to 4 columns), as the forward.
//
// Bound on this card: operations. At B = 1, S = 4096, H = 32, D = q = 64
// (rwkv6-1.6b) the backward reads r, k, v, logw, dy and writes dr, dk,
// dv, dlogw (302 MB, 0.090 ms) and needs about 7.7 G operations of f32
// work, each exp counted as one and att, dr and dk cut into sub-chunks of
// 16 steps as the forward cuts att (chip_smoke.py::wkv_bwd_cost): 0.114
// ms at 67 TFLOP/s. This first kernel computes each pair's decay afresh in
// three passes (att, dr, dk: 3 x 129,024 exps a chunk) and recomputes
// dv's k decays per column group, on one CTA an SM (its 176 KB of
// shared memory); the forward's sub-chunk factors, which turn most pairs
// into products on register tiles, and a second CTA an SM are later
// work.
//
// Shared memory: A' 53,248 B (r, dy and logw tiles and the scan's
// totals, as phase A); C' 175,616 B: ten tiles of 64 rows of 68 floats
// (r, k, v, lwc, dy, G_c, G_c^T, S_c^T, att, datt; dy's tile later holds
// k * the state part of d^k, S_c^T's k * d^k, att's r * d^r), u, the last
// step's state term and the scan's totals. The workspace `gws` holds
// B * H * (S / q) * (D * D + D) floats: G_c per task, then each task's
// share of du.
#include "wkv_tiles.cuh"

namespace {

using namespace wkv;

constexpr int SMEM_GA = 4 * (3 * MAXD * LD + 4 * MAXD);
constexpr int SMEM_GC = 4 * (10 * MAXD * LD + 6 * MAXD);

// Phase A' for one task: (r * 2^lwp)^T dy of the chunk into gs.
__device__ void grad_part(const Shape& sh, long task,
                          const float* __restrict__ r,
                          const float* __restrict__ dy,
                          const float* __restrict__ lw,
                          float* __restrict__ gs, float* sm) {
  float* R = sm;
  float* Y = R + MAXD * LD;
  float* L = Y + MAXD * LD;
  float* tot = L + MAXD * LD;
  const int tid = threadIdx.x, d = sh.d, q = sh.q, dp = sh.dp;
  int chunk, head;
  const long g0 = task_rows(sh, task, &chunk, &head);
  const long rs = (long)sh.h * d;
  load_rows(R, r + g0, rs, q, d, sh.vec);
  load_rows(Y, dy + g0, rs, q, d, sh.vec);
  load_rows(L, lw + g0, rs, q, d, sh.vec);
  cp_commit();
  zero_pad(R, q, sh.qp, d, dp);
  zero_pad(Y, q, sh.qp, d, dp);
  zero_pad(L, q, sh.qp, d, dp);
  cp_wait<0>();
  __syncthreads();
  scan_rows(L, tot, sh);

  // r~ = r * 2^lwp, lwp[t] = lwc[t - 1] (and r~ = r at t = 0)
  for (int i = tid; i < q * MAXD; i += NT) {
    const int t = i / MAXD, c = i & (MAXD - 1);
    if (t && c < dp) R[t * LD + c] *= exp2f(L[(t - 1) * LD + c]);
  }
  __syncthreads();

  const int i0 = 4 * (tid >> 4), e0 = 4 * (tid & 15);
  if (i0 < dp && e0 < dp) {
    float acc[4][4] = {};
    for (int t = 0; t < q; ++t) {
      const float4 a = ld4(R + t * LD + i0), b = ld4(Y + t * LD + e0);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += av[i] * bv[e];
    }
    float* o = gs + task * d * d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = o + (i0 + i) * d + e0;
      if (i0 + i < d && sh.vec) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else if (i0 + i < d) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e0 + e < d) row[e] = acc[i][e];
      }
    }
  }
  __syncthreads();  // the tiles are free for the next task
}

// Phase B' for one state element idx of (B, H, D, D): G_c over A'_c.
__device__ __forceinline__ void grad_element(const Shape& sh, long idx,
                                             float* __restrict__ gs,
                                             const float* __restrict__ wd,
                                             const float* __restrict__ ds) {
  constexpr int BATCH = 16;
  const long dd = (long)sh.d * sh.d;
  const long bh = idx / dd, ie = idx - bh * dd;
  const int i = (int)(ie / sh.d);
  float* p = gs + bh * sh.nc * dd + ie;
  const float* pw = wd + bh * sh.nc * sh.d + i;
  float g = ds ? ds[idx] : 0.f;
  for (int c1 = sh.nc; c1 > 0; c1 -= BATCH) {  // chunks c1 - 1 down
    float a[BATCH], f[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (c1 - 1 - u >= 0) {
        a[u] = __ldcg(p + (c1 - 1 - u) * dd);
        f[u] = __ldcg(pw + (long)(c1 - 1 - u) * sh.d);
      }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (c1 - 1 - u >= 0) {
        p[(c1 - 1 - u) * dd] = g;
        g = f[u] * g + a[u];
      }
  }
}

// Phase C' for one task: dr, dk, dv and dlogw of the chunk, and its share
// of du, from S_c (ss) and G_c (gs).
__device__ void chunk_grad(const Shape& sh, long task,
                           const float* __restrict__ r,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ lw,
                           const float* __restrict__ u,
                           const float* __restrict__ dy,
                           const float* __restrict__ ss,
                           const float* __restrict__ gs,
                           float* __restrict__ dr, float* __restrict__ dk,
                           float* __restrict__ dv, float* __restrict__ dlw,
                           float* __restrict__ dup, float* sm) {
  float* R = sm;
  float* K = R + MAXD * LD;
  float* V = K + MAXD * LD;
  float* L = V + MAXD * LD;    // logw, then lwc
  float* Y = L + MAXD * LD;    // dy, then k * the state part of d^k
  float* G = Y + MAXD * LD;    // G_c
  float* GT = G + MAXD * LD;   // G_c^T
  float* ST = GT + MAXD * LD;  // S_c^T, then k * d^k
  float* A = ST + MAXD * LD;   // S_c as loaded, then att, then r * d^r
  float* DA = A + MAXD * LD;   // datt
  float* U = DA + MAXD * LD;
  float* X = U + MAXD;         // the last step's state term per column
  float* tot = X + MAXD;
  const int tid = threadIdx.x, d = sh.d, q = sh.q, qp = sh.qp, dp = sh.dp;
  int chunk, head;
  const long g0 = task_rows(sh, task, &chunk, &head);
  const long rs = (long)sh.h * d;
  const long dd = (long)d * d;

  load_rows(R, r + g0, rs, q, d, sh.vec);
  load_rows(K, k + g0, rs, q, d, sh.vec);
  load_rows(V, v + g0, rs, q, d, sh.vec);
  load_rows(L, lw + g0, rs, q, d, sh.vec);
  load_rows(Y, dy + g0, rs, q, d, sh.vec);
  load_rows(A, ss + task * dd, d, d, d, sh.vec);
  load_rows(G, gs + task * dd, d, d, d, sh.vec);
  cp_commit();
  zero_pad(R, q, qp, d, dp);
  zero_pad(K, q, qp, d, dp);
  zero_pad(V, q, qp, d, dp);
  zero_pad(L, q, qp, d, dp);
  zero_pad(Y, q, qp, d, dp);
  zero_pad(A, d, dp, d, dp);
  zero_pad(G, d, dp, d, dp);
  if (tid < MAXD) U[tid] = tid < d ? u[head * d + tid] : 0.f;
  cp_wait<0>();
  __syncthreads();
  scan_rows(L, tot, sh);
  for (int i = tid; i < dp * dp; i += NT) {
    const int a = i / dp, e = i - a * dp;
    GT[e * LD + a] = G[a * LD + e];
    ST[e * LD + a] = A[a * LD + e];
  }
  __syncthreads();

  // Rows tr + 16a, columns tc + 16m of every (rows, columns) tile below.
  // Rows and columns past qp and dp hold whatever the tiles hold there:
  // they reach no stored value, and every sum runs over valid indices.
  const int tr = tid >> 4, tc = tid & 15;
  const float* last = L + (q - 1) * LD;

  // att[t][j] (j <= t, u on the diagonal) and datt[t][j] (j <= t); zeros
  // above the diagonal
  {
    float at[4][4] = {}, da[4][4] = {};
    for (int c = 0; c < dp; ++c) {
      float rv[4], lp[4], yv[4], kv[4], lc[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = tr + 16 * a;
        rv[a] = R[t * LD + c];
        lp[a] = t ? L[(t - 1) * LD + c] : 0.f;
        yv[a] = Y[t * LD + c];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = tc + 16 * m;
        kv[m] = K[j * LD + c];
        lc[m] = L[j * LD + c];
        vv[m] = V[j * LD + c];
      }
      const float uc = U[c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m <= a; ++m) {
          const int t = tr + 16 * a, j = tc + 16 * m;
          if (j < t)
            at[a][m] += exp2f(lp[a] - lc[m]) * rv[a] * kv[m];
          else if (j == t)
            at[a][m] += rv[a] * uc * kv[m];
          da[a][m] += yv[a] * vv[m];
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t = tr + 16 * a, j = tc + 16 * m;
        const bool on = m <= a && j <= t;
        A[t * LD + j] = on ? at[a][m] : 0.f;
        DA[t * LD + j] = on ? da[a][m] : 0.f;
      }
  }
  __syncthreads();

  // dv (rows j, columns e) and dr (rows t, columns c); r * d^r kept
  float pr[4][4];
  {
    float acc[4][4] = {};
    for (int t = tr; t < q; ++t) {
      float av[4], yv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = A[t * LD + tr + 16 * a];
#pragma unroll
      for (int m = 0; m < 4; ++m) yv[m] = Y[t * LD + tc + 16 * m];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[a][m] += av[a] * yv[m];
    }
    for (int i = 0; i < dp; ++i) {
      float kd[4], gv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = tr + 16 * a;
        kd[a] = K[j * LD + i] * exp2f(last[i] - L[j * LD + i]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) gv[m] = G[i * LD + tc + 16 * m];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[a][m] += kd[a] * gv[m];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = tr + 16 * a, e = tc + 16 * m;
        if (j < q && e < d) dv[g0 + j * rs + e] = acc[a][m];
      }
  }
  {
    float acc[4][4] = {}, lpv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t = tr + 16 * a;
        lpv[a][m] = t ? L[(t - 1) * LD + tc + 16 * m] : 0.f;
      }
    const int jend = min(q, tr + 48);  // j < t <= tr + 48
    for (int j = 0; j < jend; ++j) {
      float kv[4], lc[4], dav[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        kv[m] = K[j * LD + tc + 16 * m];
        lc[m] = L[j * LD + tc + 16 * m];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) dav[a] = DA[(tr + 16 * a) * LD + j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (j < tr + 16 * a) {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            acc[a][m] += dav[a] * kv[m] * exp2f(lpv[a][m] - lc[m]);
        }
    }
    float sv[4][4] = {};
    for (int e = 0; e < dp; ++e) {
      float yv[4], st[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) yv[a] = Y[(tr + 16 * a) * LD + e];
#pragma unroll
      for (int m = 0; m < 4; ++m) st[m] = ST[e * LD + tc + 16 * m];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m < 4; ++m) sv[a][m] += yv[a] * st[m];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int t = tr + 16 * a, c = tc + 16 * m;
        const float dh = acc[a][m] + exp2f(lpv[a][m]) * sv[a][m];
        pr[a][m] = R[t * LD + c] * dh;
        if (t < q && c < d)
          dr[g0 + t * rs + c] = dh + DA[t * LD + t] * U[c] * K[t * LD + c];
      }
  }
  if (tid < dp) {  // exp(lwc[q-1]) sum_e G_c S_c, by column
    float x = 0.f;
    for (int e = 0; e < dp; ++e) x += GT[e * LD + tid] * ST[e * LD + tid];
    X[tid] = exp2f(last[tid]) * x;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      A[(tr + 16 * a) * LD + tc + 16 * m] = pr[a][m];

  // dk (rows j, columns c); k * d^k into ST, k * its state part into Y
  // (neither read here)
  {
    float acc[4][4] = {}, lj[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        lj[a][m] = L[(tr + 16 * a) * LD + tc + 16 * m];
    for (int t = tr + 1; t < q; ++t) {  // t > j >= tr
      float rv[4], lp[4], dav[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        rv[m] = R[t * LD + tc + 16 * m];
        lp[m] = L[(t - 1) * LD + tc + 16 * m];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) dav[a] = DA[t * LD + tr + 16 * a];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (t > tr + 16 * a) {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            acc[a][m] += dav[a] * rv[m] * exp2f(lp[m] - lj[a][m]);
        }
    }
    float sv[4][4] = {};
    for (int e = 0; e < dp; ++e) {
      float vv[4], gt[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) vv[a] = V[(tr + 16 * a) * LD + e];
#pragma unroll
      for (int m = 0; m < 4; ++m) gt[m] = GT[e * LD + tc + 16 * m];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m < 4; ++m) sv[a][m] += vv[a] * gt[m];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = tr + 16 * a, c = tc + 16 * m;
        const float ks = exp2f(last[c] - lj[a][m]) * sv[a][m];
        const float dh = acc[a][m] + ks, kjc = K[j * LD + c];
        if (j < q && c < d)
          dk[g0 + j * rs + c] = dh + DA[j * LD + j] * R[j * LD + c] * U[c];
        ST[j * LD + c] = kjc * dh;
        Y[j * LD + c] = kjc * ks;
      }
  }
  __syncthreads();

  // the gradient of lwc, summed from the last step into dlogw; du's share
  if (tid < dp) {
    const int c = tid;
    float x = X[c];
    for (int j = 0; j < q; ++j) x += Y[j * LD + c];
    float acc = 0.f, du = 0.f;
    for (int j = q - 1; j >= 0; --j) {
      acc += (j + 1 < q ? A[(j + 1) * LD + c] : x) - ST[j * LD + c];
      if (c < d) dlw[g0 + j * rs + c] = acc;
      du += DA[j * LD + j] * R[j * LD + c] * K[j * LD + c];
    }
    if (c < d) dup[task * d + c] = du;
  }
  __syncthreads();  // the tiles are free for the next task
}

__global__ void __launch_bounds__(NT, 3)
grad_parts(Shape sh, long tasks, const float* __restrict__ r,
           const float* __restrict__ dy, const float* __restrict__ lw,
           float* __restrict__ gs) {
  extern __shared__ __align__(16) float sm[];
  for (long t = blockIdx.x; t < tasks; t += gridDim.x)
    grad_part(sh, t, r, dy, lw, gs, sm);
}

__global__ void __launch_bounds__(NT)
grad_scan(Shape sh, long n, float* __restrict__ gs,
          const float* __restrict__ wd, const float* __restrict__ ds) {
  const long idx = (long)blockIdx.x * NT + threadIdx.x;
  if (idx < n) grad_element(sh, idx, gs, wd, ds);
}

__global__ void __launch_bounds__(NT, 1)
chunk_grads(Shape sh, long tasks, const float* __restrict__ r,
            const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ lw, const float* __restrict__ u,
            const float* __restrict__ dy, const float* __restrict__ ss,
            const float* __restrict__ gs, float* __restrict__ dr,
            float* __restrict__ dk, float* __restrict__ dv,
            float* __restrict__ dlw, float* __restrict__ dup) {
  extern __shared__ __align__(16) float sm[];
  for (long t = blockIdx.x; t < tasks; t += gridDim.x)
    chunk_grad(sh, t, r, k, v, lw, u, dy, ss, gs, dr, dk, dv, dlw, dup, sm);
}

// du[h][i]: the tasks' shares summed over the batch, then the chunks.
__global__ void __launch_bounds__(NT)
du_sum(Shape sh, int b, const float* __restrict__ dup,
       float* __restrict__ du) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= sh.h * sh.d) return;
  const int hh = idx / sh.d, c = idx - hh * sh.d;
  float s = 0.f;
  for (int bi = 0; bi < b; ++bi) {
    const float* p = dup + ((long)bi * sh.h + hh) * sh.nc * sh.d + c;
    for (int ci = 0; ci < sh.nc; ++ci) s += p[(long)ci * sh.d];
  }
  du[idx] = s;
}

}  // namespace

// (r, k, v, logw, u, dy, dstate or null, forward workspace, workspace, dr,
// dk, dv, dlogw, du, b, s, h, d, q, stream): both workspaces hold
// B * H * (S / q) * (D * D + D) floats; returns cudaGetLastError() after
// the four launches.
extern "C" int wkv_chunk_bwd(const void* r, const void* k, const void* v,
                             const void* lw, const void* u, const void* dy,
                             const void* dstate, const void* ws, void* gws,
                             void* dr, void* dk, void* dv, void* dlw,
                             void* du, int b, int s, int h, int d, int q,
                             void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || d <= 0 || d > MAXD || q <= 0 ||
      q > MAXD || s % q)
    return (int)cudaErrorInvalidValue;
  Shape sh;
  sh.s = s;
  sh.h = h;
  sh.d = d;
  sh.q = q;
  sh.nc = s / q;
  sh.qp = (q + SUB - 1) / SUB * SUB;
  sh.na = sh.qp / SUB;
  sh.dp = (d + 3) / 4 * 4;
  sh.vec = d % 4 == 0 &&
           ((uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)lw |
            (uintptr_t)dy | (uintptr_t)ws | (uintptr_t)gws) % 16 == 0;
  const long tasks = (long)b * h * sh.nc;
  const long n = (long)b * h * d * d;
  const float* ss = (const float*)ws;
  const float* wd = ss + tasks * d * d;
  float* gs = (float*)gws;
  float* dup = gs + tasks * d * d;
  cudaStream_t st = (cudaStream_t)stream;
  const int grid_t = (int)(tasks < (1L << 30) ? tasks : 1L << 30);
  const long grid_e = (n + NT - 1) / NT;
  if (grid_e > INT_MAX || (long)h * d > INT_MAX)
    return (int)cudaErrorInvalidValue;
  static int conf_a = 0, conf_c = 0;
  cudaError_t e = opt_in(grad_parts, SMEM_GA, &conf_a);
  if (e == cudaSuccess) e = opt_in(chunk_grads, SMEM_GC, &conf_c);
  if (e != cudaSuccess) return (int)e;
  grad_parts<<<grid_t, NT, SMEM_GA, st>>>(
      sh, tasks, (const float*)r, (const float*)dy, (const float*)lw, gs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  grad_scan<<<(int)grid_e, NT, 0, st>>>(sh, n, gs, wd,
                                        (const float*)dstate);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_grads<<<grid_t, NT, SMEM_GC, st>>>(
      sh, tasks, (const float*)r, (const float*)k, (const float*)v,
      (const float*)lw, (const float*)u, (const float*)dy, ss, gs,
      (float*)dr, (float*)dk, (float*)dv, (float*)dlw, dup);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  du_sum<<<(h * d + NT - 1) / NT, NT, 0, st>>>(sh, b, dup, (float*)du);
  return (int)cudaGetLastError();
}
