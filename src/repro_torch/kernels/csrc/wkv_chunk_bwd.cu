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
//   C' (chunk_grads): per (b, h, chunk), a CTA of 512 threads (16 warps)
//      over r, k, v, logw, dy, S_c and G_c in shared memory, cut into
//      sub-chunks of 16 steps as the forward's phase C cuts att, in five
//      steps between barriers:
//      1. the scan into lwc, then the factors, one exp each: r~ = r
//         2^(lwp - ref_a) (ref_a = lwc at the step before sub-chunk a,
//         s_a its first step; 0 for the first), k's decay 2^(last - lwc),
//         k~_a = k 2^(ref_a - lwc) on the rows before s_a, E_a = 2^ref_a;
//      2. att: below the diagonal blocks r~_a k~_a^T (warps 0-5, the
//         forward's product, a lane pair a 4 x 4 tile), on them pairwise
//         with u at j = t (warps 8-15, the forward's sub-tiles and
//         shuffles); the last step's state term (warps 6-7);
//      3. dv = att^T dy + (k 2^(last - lwc)) G_c (warps 0-7) beside
//         datt = dy v^T (warps 8-15);
//      4. d^r (warps 0-7) and d^k (warps 8-15), a thread rows x0 .. x0 + 3
//         of one sub-chunk and columns cb + 16m:
//           d^r_t = 2^(lwp_t - ref_a) (E_a (S_c dy_t) + datt[t, :s_a] k~_a)
//                   + sum_{s_a <= j < t} datt[t][j] k_j 2^(lwp_t - lwc_j)
//           d^k_j = 2^(last - lwc_j) (G_c v_j)
//                   + sum_{a > sub(j)} 2^(ref_a - lwc_j)
//                                      (datt[s_a .. s_a + 15, j]^T r~_a)
//                   + sum_{j < t in sub(j)} datt[t][j] r_t 2^(lwp_t - lwc_j)
//         (2^lwp_t = 2^(lwp_t - ref_a) E_a, as the forward's cross-chunk
//         term); the state products read both operands along their rows
//         by float4, consecutive lanes on consecutive rows of S_c or G_c,
//         so no tile is copied transposed;
//      5. the gradient of lwc summed from the last step into dlogw (a
//         thread 8 rows of a column, then the totals of the segments
//         after it, in order), and the chunk's share of du.
//      The products run on 4 x 4 FMA register tiles fed by float4 loads.
//   D' (du_sum): one thread per (h, i) sums the shares over the batch,
//      then the chunks, in order.
// 0 < D <= 64 and 0 < q <= 64 (ragged q and D included: tiles zero-padded
// to q rounded up to 16 rows and D to 4 columns, and padded rows add
// nothing), as the forward.
//
// The exps, at q = D = 64. The pairwise form takes D exps per pair j < t
// and per pass, 3 x 129,024 a chunk for att, dr and dk. Here only pairs
// inside one sub-chunk keep the pairwise decay, and each of att, d^r and
// d^k takes its own: 3 x 30,720. The factors: r~'s 4,096 twice (step 1
// and d^r), k's decay 4,096 once (dv and d^k share it), k~'s 6,144 twice
// (step 1 and d^k), E 192 and the state term's 64: 116,992 a chunk in C',
// and 4,096 in A'. Each is one exp2f (precise; no fast-math intrinsics:
// dw = dlogw / w magnifies rounding).
//
// Why nothing overflows: the forward's argument, carried to d^r and d^k.
// logw <= 0, so lwc falls monotonically over a chunk, and rounding and the
// segmented scan keep that order. Every exp takes a later cumulative sum
// minus an earlier one: lwp_t - ref_a (t >= s_a), ref_a - lwc_j (j <
// s_a), last - lwc_j, lwp_t - lwc_j (j < t), ref_a, last. So every factor
// lies in [0, 1], and a factor that underflows marks a term below f32's
// range anyway (the exact product of two factors is no larger than
// either).
//
// Bound on this card: operations. At B = 1, S = 4096, H = 32, D = q = 64
// (rwkv6-1.6b) the backward reads r, k, v, logw, dy and writes dr, dk,
// dv, dlogw (302 MB, 0.090 ms) and needs about 7.7 G operations of f32
// work, each exp counted as one and att, dr and dk cut into sub-chunks of
// 16 steps (chip_smoke.py::wkv_bwd_cost): 0.114 ms at 67 TFLOP/s.
//
// Shared memory and occupancy: A' 53,248 B (r, dy and logw tiles and the
// scan's totals, as phase A), 3 CTAs of 8 warps an SM by its 80
// registers. C' 227,328 B: eleven tiles of 64 rows of 68 floats (r, k,
// lwc, v, dy, S_c, G_c, att then r * d^r, datt, r~, k's decay then
// k * d^k), k~'s 96 rows, u, E, the state terms and the scans' totals;
// one CTA of 16 warps an SM, at most 128 registers a thread by its launch
// bounds (wkv_chunk_bwd_occupancy reports each launch's CTAs an SM). The
// workspace `gws` holds B * H * (S / q) * (D * D + D) floats: G_c per
// task, then each task's share of du.
#include "wkv_tiles.cuh"

namespace {

using namespace wkv;

constexpr int NTC = 2 * NT;        // threads of a C' CTA: 16 warps
constexpr int TILE = MAXD * LD;    // floats of a 64-row tile
constexpr int KT_ROWS = 6 * SUB;   // k~ rows of sub-chunks 1, 2 and 3
constexpr int SMEM_GA = 4 * (3 * TILE + 4 * MAXD);
constexpr int SMEM_GC = 4 * (11 * TILE + KT_ROWS * LD + 38 * MAXD);

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

// Phase C' for one task, by a CTA of NTC threads: dr, dk, dv and dlogw of
// the chunk, and its share of du, from S_c (ss) and G_c (gs).
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
  float* K = R + TILE;
  float* L = K + TILE;      // logw, then lwc
  float* V = L + TILE;
  float* Y = V + TILE;      // dy
  float* S = Y + TILE;      // S_c
  float* G = S + TILE;      // G_c
  float* A = G + TILE;      // att, then r * d^r
  float* DA = A + TILE;     // datt
  float* RT = DA + TILE;    // r~
  float* KD = RT + TILE;    // k's decay 2^(last - lwc), then k * d^k
  float* KT = KD + TILE;    // k~ of sub-chunk a at row 8 a (a - 1)
  float* U = KT + KT_ROWS * LD;
  float* E = U + MAXD;      // E_a, 4 x 64
  float* X = E + 4 * MAXD;  // 2^last sum_e G_c S_c, by column
  float* WP = X + MAXD;     // sum_j k_dec (G_c v_j) by 4-row block, 16 x 64
  float* SEG = WP + 16 * MAXD;  // the scan's totals, then dlwc's, 8 x 64
  float* DUS = SEG + 8 * MAXD;  // du's shares by 8-row segment, 8 x 64
  const int tid = threadIdx.x, d = sh.d, q = sh.q, qp = sh.qp, na = sh.na,
            dp = sh.dp;
  int chunk, head;
  const long g0 = task_rows(sh, task, &chunk, &head);
  const long rs = (long)sh.h * d;
  const long dd = (long)d * d;

  load_rows<NTC>(R, r + g0, rs, q, d, sh.vec);
  load_rows<NTC>(K, k + g0, rs, q, d, sh.vec);
  load_rows<NTC>(L, lw + g0, rs, q, d, sh.vec);
  load_rows<NTC>(V, v + g0, rs, q, d, sh.vec);
  load_rows<NTC>(Y, dy + g0, rs, q, d, sh.vec);
  load_rows<NTC>(S, ss + task * dd, d, d, d, sh.vec);
  load_rows<NTC>(G, gs + task * dd, d, d, d, sh.vec);
  cp_commit();
  zero_pad<NTC>(R, q, qp, d, dp);
  zero_pad<NTC>(K, q, qp, d, dp);
  zero_pad<NTC>(L, q, qp, d, dp);
  zero_pad<NTC>(V, q, qp, d, dp);
  zero_pad<NTC>(Y, q, qp, d, dp);
  zero_pad<NTC>(S, d, dp, d, dp);
  zero_pad<NTC>(G, d, dp, d, dp);
  if (tid < MAXD) {
    U[tid] = tid < d ? u[head * d + tid] : 0.f;
    E[tid] = 1.f;  // E_0: lwp[s_0] = 0
  }
  cp_wait<0>();
  __syncthreads();
  scan_rows(L, SEG, sh);
  const float* last = L + (q - 1) * LD;

  // The factors, one exp each, thread (column c, rows r0 + 8m): r~ = r
  // 2^(lwp - ref_a) and k's decay 2^(last - lwc) on every row, k~_a =
  // k 2^(ref_a - lwc) on the rows before sub-chunk a, E_a = 2^ref_a.
  // Rows past qp and columns past dp are left as they are: nothing reads
  // them into a stored value.
  {
    const int c = tid & (MAXD - 1), r0 = tid / MAXD;
    if (c < dp) {
      const float lc = last[c];
      for (int t = r0; t < qp; t += NTC / MAXD) {
        const int a = t / SUB;
        const float ref = a ? L[(a * SUB - 1) * LD + c] : 0.f;
        const float lp = t ? L[(t - 1) * LD + c] : 0.f;
        RT[t * LD + c] = R[t * LD + c] * exp2f(lp - ref);
        KD[t * LD + c] = exp2f(lc - L[t * LD + c]);
      }
      for (int kr = r0; kr < 8 * na * (na - 1); kr += NTC / MAXD) {
        const int a = kr < SUB ? 1 : kr < 3 * SUB ? 2 : 3;
        const int j = kr - 8 * a * (a - 1);
        KT[kr * LD + c] = K[j * LD + c] * exp2f(L[(a * SUB - 1) * LD + c] -
                                                L[j * LD + c]);
      }
      if (r0 && r0 < na) E[r0 * MAXD + c] = exp2f(L[(r0 * SUB - 1) * LD + c]);
    }
  }
  __syncthreads();

  // att. Warps 0-5: the blocks below the diagonal ones, r~_a k~_a^T, a
  // 4 x 4 tile of (t, j) per lane pair, each lane half of the channels,
  // summed by a shuffle (the forward's product); warps 6-7: X. Warps
  // 8-15: the diagonal blocks, pairwise, as the forward's phase C takes
  // them (4 x 4 sub-tiles of (t, j), 8 lanes a sub-tile below the
  // diagonal, 4 on it, u at j = t, the lanes' sums met by a reduce-scatter
  // of shuffles), then zeros in the sub-tiles above the diagonal.
  if (tid < 6 * 32) {
    const int hf = tid & 1, it = tid >> 1;
    const bool on = it < 8 * na * (na - 1);  // 16 a tiles for sub-chunk a
    float acc[4][4] = {};
    int t0 = 0, j0 = 0;
    if (on) {
      const int a = it < SUB ? 1 : it < 3 * SUB ? 2 : 3;
      const int loc = it - 8 * a * (a - 1), tt = loc / (4 * a);
      t0 = a * SUB + 4 * tt;
      j0 = 4 * (loc - tt * 4 * a);
      const float* kb = KT + (8 * a * (a - 1) + j0) * LD;
      for (int cc = 4 * hf; cc < dp; cc += 8) {
        float4 ra[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ra[i] = ld4(RT + (t0 + i) * LD + cc);
          ka[i] = ld4(kb + i * LD + cc);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][jj] += ra[i].x * ka[jj].x + ra[i].y * ka[jj].y +
                          ra[i].z * ka[jj].z + ra[i].w * ka[jj].w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        acc[i][jj] += __shfl_xor_sync(0xffffffffu, acc[i][jj], 1);
    if (on) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if ((i >> 1) == hf)
          *reinterpret_cast<float4*>(A + (t0 + i) * LD + j0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  } else if (tid < NT) {
    const int c = tid - 6 * 32;
    if (c < dp) {
      float x = 0.f;
      for (int e = 0; e < dp; e += 4) {
        const float4 gv = ld4(G + c * LD + e), sv = ld4(S + c * LD + e);
        x += gv.x * sv.x + gv.y * sv.y + gv.z * sv.z + gv.w * sv.w;
      }
      X[c] = exp2f(last[c]) * x;
    }
  } else {
    const int ln = tid - NT;
    const int lower = (48 * na + 31) / 32 * 32;  // lanes of the 6 na below
    const bool on_diag = ln >= lower;
    const int nl = on_diag ? 4 : 8;              // lanes an item
    const int it = on_diag ? (ln - lower) / 4 : ln / 8;
    const int g = ln % nl;
    const bool live = it < (on_diag ? 4 : 6) * na;
    float w16[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w16[i] = 0.f;
    int t0 = 0, j0 = 0;
    if (live) {
      int a, ti, tj;
      if (on_diag) {
        a = it / 4;
        ti = tj = it % 4;
      } else {
        a = it / 6;
        const int k6 = it % 6;  // (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
        ti = k6 < 1 ? 1 : k6 < 3 ? 2 : 3;
        tj = k6 - ti * (ti - 1) / 2;
      }
      t0 = a * SUB + 4 * ti;
      j0 = a * SUB + 4 * tj;
      for (int c = 4 * g; c < dp; c += 4 * nl) {
        float4 rr[4], lp[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rr[i] = ld4(R + (t0 + i) * LD + c);
          lp[i] = ld4(L + max(t0 + i - 1, 0) * LD + c);  // lwp[t0 + i]
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 kk = ld4(K + (j0 + jj) * LD + c);
          const float4 lc = ld4(L + (j0 + jj) * LD + c);
          if (on_diag) {
            const float4 uu = ld4(U + c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (jj < i)
                w16[4 * i + jj] += exp2f(lp[i].x - lc.x) * rr[i].x * kk.x +
                                   exp2f(lp[i].y - lc.y) * rr[i].y * kk.y +
                                   exp2f(lp[i].z - lc.z) * rr[i].z * kk.z +
                                   exp2f(lp[i].w - lc.w) * rr[i].w * kk.w;
              else if (jj == i)
                w16[4 * i + jj] += rr[i].x * uu.x * kk.x +
                                   rr[i].y * uu.y * kk.y +
                                   rr[i].z * uu.z * kk.z +
                                   rr[i].w * uu.w * kk.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              w16[4 * i + jj] += exp2f(lp[i].x - lc.x) * rr[i].x * kk.x +
                                 exp2f(lp[i].y - lc.y) * rr[i].y * kk.y +
                                 exp2f(lp[i].z - lc.z) * rr[i].z * kk.z +
                                 exp2f(lp[i].w - lc.w) * rr[i].w * kk.w;
          }
        }
      }
    }
    // reduce-scatter over the item's lanes: lane g ends with the sums of
    // pairs 16 g / nl onwards (8 lanes: 2 a lane; 4 lanes: one row, 4)
    const bool b4 = g & 4, b2 = g & 2, b1 = g & 1;
    float w[8], x[4], z[2];
    if (on_diag) {  // a whole warp of 4-lane items
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = (b2 ? w16[i + 8] : w16[i]) +
               __shfl_xor_sync(0xffffffffu, b2 ? w16[i] : w16[i + 8], 2);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = (b1 ? w[i + 4] : w[i]) +
               __shfl_xor_sync(0xffffffffu, b1 ? w[i] : w[i + 4], 1);
      if (live)
        *reinterpret_cast<float4*>(A + (t0 + g) * LD + j0) =
            make_float4(x[0], x[1], x[2], x[3]);
    } else {        // a whole warp of 8-lane items
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = (b4 ? w16[i + 8] : w16[i]) +
               __shfl_xor_sync(0xffffffffu, b4 ? w16[i] : w16[i + 8], 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = (b2 ? w[i + 4] : w[i]) +
               __shfl_xor_sync(0xffffffffu, b2 ? w[i] : w[i + 4], 2);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        z[i] = (b1 ? x[i + 2] : x[i]) +
               __shfl_xor_sync(0xffffffffu, b1 ? x[i] : x[i + 2], 1);
      if (live) {
        float* o = A + (t0 + (g >> 1)) * LD + j0 + 2 * (g & 1);
        o[0] = z[0];
        o[1] = z[1];
      }
    }
    for (int i = ln; i < na * SUB * SUB; i += NT) {
      const int a = i / (SUB * SUB), tl = (i / SUB) % SUB, jl = i % SUB;
      if (jl / 4 > tl / 4) A[(a * SUB + tl) * LD + a * SUB + jl] = 0.f;
    }
  }
  __syncthreads();

  if (tid < NT) {
    // dv = att^T dy + (k 2^(last - lwc)) G_c: thread (rows j0 .. j0 + 3,
    // columns e0 .. e0 + 3); att holds zeros above the diagonal
    const int j0 = 4 * (tid >> 4), e0 = 4 * (tid & 15);
    if (j0 < qp && e0 < dp) {
      float acc[4][4] = {};
      for (int i = 0; i < dp; i += 4) {
        float4 kd[4], gv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 f = ld4(KD + (j0 + jj) * LD + i);
          const float4 kk = ld4(K + (j0 + jj) * LD + i);
          kd[jj] = make_float4(kk.x * f.x, kk.y * f.y, kk.z * f.z,
                               kk.w * f.w);
          gv[jj] = ld4(G + (i + jj) * LD + e0);  // G_c row i + jj
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float kv[4] = {kd[jj].x, kd[jj].y, kd[jj].z, kd[jj].w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[jj][0] += kv[m] * gv[m].x;
            acc[jj][1] += kv[m] * gv[m].y;
            acc[jj][2] += kv[m] * gv[m].z;
            acc[jj][3] += kv[m] * gv[m].w;
          }
        }
      }
      for (int t = j0; t < qp; ++t) {
        const float4 at = ld4(A + t * LD + j0), yv = ld4(Y + t * LD + e0);
        const float av[4] = {at.x, at.y, at.z, at.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[jj][0] += av[jj] * yv.x;
          acc[jj][1] += av[jj] * yv.y;
          acc[jj][2] += av[jj] * yv.z;
          acc[jj][3] += av[jj] * yv.w;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float* row = dv + g0 + (j0 + jj) * rs + e0;
        if (j0 + jj < q && sh.vec) {
          *reinterpret_cast<float4*>(row) =
              make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]);
        } else if (j0 + jj < q) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e0 + e < d) row[e] = acc[jj][e];
        }
      }
    }
  } else {
    // datt[t][j] = dy_t . v_j: thread (rows t0 .. t0 + 3, columns jb +
    // 16m), both operands along their rows by float4, consecutive lanes
    // on consecutive rows of v
    const int ln = tid - NT, t0 = 4 * (ln >> 4), jb = ln & 15;
    if (t0 < qp) {
      float acc[4][4] = {};
      for (int e = 0; e < dp; e += 4) {
        float4 yv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yv[i] = ld4(Y + (t0 + i) * LD + e);
          vv[i] = ld4(V + (jb + 16 * i) * LD + e);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m)
            acc[i][m] += yv[i].x * vv[m].x + yv[i].y * vv[m].y +
                         yv[i].z * vv[m].z + yv[i].w * vv[m].w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int m = 0; m < 4; ++m)
          DA[(t0 + i) * LD + jb + 16 * m] = acc[i][m];
    }
  }
  __syncthreads();

  // d^r (warps 0-7) and d^k (warps 8-15), each thread rows x0 .. x0 + 3
  // of sub-chunk x0 / 16 and columns cb + 16m; their state products read
  // dy or v and S_c or G_c along rows by float4, consecutive lanes on
  // consecutive rows of the state.
  {
    const int ln = tid & (NT - 1), x0 = 4 * (ln >> 4), cb = ln & 15;
    const int a = x0 / SUB;
    if (tid < NT && x0 < qp) {
      // d^r_t = 2^(lwp_t - ref_a) (E_a (S_c dy_t) + datt[t, :s_a] k~_a)
      //         + the pairs of the sub-chunk
      float acc[4][4] = {};
      for (int e = 0; e < dp; e += 4) {
        float4 yv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          yv[i] = ld4(Y + (x0 + i) * LD + e);
          sv[i] = ld4(S + (cb + 16 * i) * LD + e);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m)
            acc[i][m] += yv[i].x * sv[m].x + yv[i].y * sv[m].y +
                         yv[i].z * sv[m].z + yv[i].w * sv[m].w;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float ea = E[a * MAXD + cb + 16 * m];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][m] *= ea;
      }
      const float* kb = KT + 8 * a * (a - 1) * LD + cb;
      for (int j = 0; j < a * SUB; j += 4) {
        float4 da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) da[i] = ld4(DA + (x0 + i) * LD + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float kt[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) kt[m] = kb[(j + jj) * LD + 16 * m];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = (&da[i].x)[jj];
#pragma unroll
            for (int m = 0; m < 4; ++m) acc[i][m] += w * kt[m];
          }
        }
      }
      float lp[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c = cb + 16 * m;
        const float ref = a ? L[(a * SUB - 1) * LD + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = x0 + i;
          lp[i][m] = t ? L[(t - 1) * LD + c] : 0.f;
          acc[i][m] *= exp2f(lp[i][m] - ref);
        }
      }
      for (int j = a * SUB; j < x0 + 3; ++j) {
        float kv[4], lc[4], da[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          kv[m] = K[j * LD + cb + 16 * m];
          lc[m] = L[j * LD + cb + 16 * m];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) da[i] = DA[(x0 + i) * LD + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j < x0 + i) {
#pragma unroll
            for (int m = 0; m < 4; ++m)
              acc[i][m] += da[i] * kv[m] * exp2f(lp[i][m] - lc[m]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = x0 + i;
        const float dt = DA[t * LD + t];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int c = cb + 16 * m;
          A[t * LD + c] = R[t * LD + c] * acc[i][m];
          if (t < q && c < d)
            dr[g0 + t * rs + c] = acc[i][m] + dt * U[c] * K[t * LD + c];
        }
      }
    } else if (tid >= NT && x0 < qp) {
      // d^k_j = 2^(last - lwc_j) (G_c v_j)
      //         + sum_{a' > a} 2^(ref_a' - lwc_j) (datt[s_a'.., j]^T r~_a')
      //         + the pairs of the sub-chunk
      float acc[4][4] = {};
      for (int e = 0; e < dp; e += 4) {
        float4 vv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          vv[i] = ld4(V + (x0 + i) * LD + e);
          gv[i] = ld4(G + (cb + 16 * i) * LD + e);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int m = 0; m < 4; ++m)
            acc[i][m] += vv[i].x * gv[m].x + vv[i].y * gv[m].y +
                         vv[i].z * gv[m].z + vv[i].w * gv[m].w;
      }
      float lj[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int c = cb + 16 * m;
        float wp = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lj[i][m] = L[(x0 + i) * LD + c];
          acc[i][m] *= KD[(x0 + i) * LD + c];
          wp += K[(x0 + i) * LD + c] * acc[i][m];
        }
        WP[(ln >> 4) * MAXD + c] = wp;
      }
      for (int a2 = a + 1; a2 < na; ++a2) {
        float mc[4][4] = {};
        for (int t = a2 * SUB; t < (a2 + 1) * SUB; ++t) {
          const float4 da = ld4(DA + t * LD + x0);
          float rv[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) rv[m] = RT[t * LD + cb + 16 * m];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            mc[0][m] += da.x * rv[m];
            mc[1][m] += da.y * rv[m];
            mc[2][m] += da.z * rv[m];
            mc[3][m] += da.w * rv[m];
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float ref = L[(a2 * SUB - 1) * LD + cb + 16 * m];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][m] += exp2f(ref - lj[i][m]) * mc[i][m];
        }
      }
      const int tend = min((a + 1) * SUB, qp);
      for (int t = x0 + 1; t < tend; ++t) {
        const float4 da4 = ld4(DA + t * LD + x0);
        const float da[4] = {da4.x, da4.y, da4.z, da4.w};
        float rv[4], lp[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          rv[m] = R[t * LD + cb + 16 * m];
          lp[m] = L[(t - 1) * LD + cb + 16 * m];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (t > x0 + i) {
#pragma unroll
            for (int m = 0; m < 4; ++m)
              acc[i][m] += da[i] * rv[m] * exp2f(lp[m] - lj[i][m]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = x0 + i;
        const float dj = DA[j * LD + j];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int c = cb + 16 * m;
          const float kv = K[j * LD + c];
          KD[j * LD + c] = kv * acc[i][m];
          if (j < q && c < d)
            dk[g0 + j * rs + c] = acc[i][m] + dj * R[j * LD + c] * U[c];
        }
      }
    }
  }
  __syncthreads();

  // the gradient of lwc, r_{j+1} d^r_{j+1} - k_j d^k_j, summed from the
  // last step into dlogw, with the last step's state terms: thread
  // (column c, rows 8g .. 8g + 7) sums its rows from the last, then adds
  // the totals of the segments after it, in order; du's share by segment
  {
    const int c = tid & (MAXD - 1), g = tid / MAXD;
    constexpr int SEGR = MAXD / (NTC / MAXD);  // 8 rows a segment
    float z[SEGR];
    if (c < dp) {
      float du = 0.f;
#pragma unroll
      for (int i = SEGR - 1; i >= 0; --i) {
        const int j = SEGR * g + i;
        z[i] = 0.f;
        if (j < q) {
          z[i] = (j + 1 < q ? A[(j + 1) * LD + c] : 0.f) - KD[j * LD + c];
          du += DA[j * LD + j] * R[j * LD + c] * K[j * LD + c];
        }
        if (i < SEGR - 1) z[i] += z[i + 1];
      }
      SEG[g * MAXD + c] = z[0];
      DUS[g * MAXD + c] = du;
    }
    __syncthreads();
    if (c < dp) {
      float off = X[c];
      for (int jb = 0; jb < qp / 4; ++jb) off += WP[jb * MAXD + c];
      for (int g2 = NTC / MAXD - 1; g2 > g; --g2) off += SEG[g2 * MAXD + c];
      if (c < d) {
#pragma unroll
        for (int i = 0; i < SEGR; ++i) {
          const int j = SEGR * g + i;
          if (j < q) dlw[g0 + j * rs + c] = z[i] + off;
        }
        if (g == 0) {
          float du = 0.f;
          for (int g2 = 0; g2 < NTC / MAXD; ++g2) du += DUS[g2 * MAXD + c];
          dup[task * d + c] = du;
        }
      }
    }
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

__global__ void __launch_bounds__(NTC, 1)
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

// The opt-ins of A' and C' to their shared memory, once.
cudaError_t opt_in_all() {
  static int conf_a = 0, conf_c = 0;
  cudaError_t e = opt_in(grad_parts, SMEM_GA, &conf_a);
  if (e == cudaSuccess) e = opt_in(chunk_grads, SMEM_GC, &conf_c);
  return e;
}

}  // namespace

// For A', B', C' and D' in launch order: the CTAs an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's threads
// and shared memory) and the threads of a CTA, into out[0 .. 7]; returns
// the first CUDA error.
extern "C" int wkv_chunk_bwd_occupancy(int* out) {
  cudaError_t e = opt_in_all();
  const void* fns[4] = {(const void*)grad_parts, (const void*)grad_scan,
                        (const void*)chunk_grads, (const void*)du_sum};
  const int threads[4] = {NT, NT, NTC, NT};
  const int smem[4] = {SMEM_GA, 0, SMEM_GC, 0};
  for (int i = 0; i < 4 && e == cudaSuccess; ++i) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2 * i], fns[i],
                                                      threads[i], smem[i]);
    out[2 * i + 1] = threads[i];
  }
  return (int)e;
}

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
            (uintptr_t)dy | (uintptr_t)ws | (uintptr_t)gws |
            (uintptr_t)dv) % 16 == 0;
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
  cudaError_t e = opt_in_all();
  if (e != cudaSuccess) return (int)e;
  grad_parts<<<grid_t, NT, SMEM_GA, st>>>(
      sh, tasks, (const float*)r, (const float*)dy, (const float*)lw, gs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  grad_scan<<<(int)grid_e, NT, 0, st>>>(sh, n, gs, wd,
                                        (const float*)dstate);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_grads<<<grid_t, NTC, SMEM_GC, st>>>(
      sh, tasks, (const float*)r, (const float*)k, (const float*)v,
      (const float*)lw, (const float*)u, (const float*)dy, ss, gs,
      (float*)dr, (float*)dk, (float*)dv, (float*)dlw, dup);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  du_sum<<<(h * d + NT - 1) / NT, NT, 0, st>>>(sh, b, dup, (float*)du);
  return (int)cudaGetLastError();
}
