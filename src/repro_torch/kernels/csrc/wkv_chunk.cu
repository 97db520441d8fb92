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
// 0 < D <= 64, 0 < q <= 64 and q divides S.
//
// Replaces the TPU kernel src/repro/kernels/wkv_chunk.py::wkv_chunk_kernel
// (body _kernel, grid (B * H,), pallas_call).
//
// Bound on this card: operations. At B = 1, S = 4096, H = 32, D = q = 64
// (rwkv6-1.6b) the recurrence moves 168 MB (r, k, v, logw and y once, the
// state) and does 3.5 G operations of f32 work with att taken by
// sub-chunks as below, each exp counted as one (chip_smoke.py::wkv_cost):
// 0.050 ms by bytes, 0.053 ms by operations at 67 TFLOP/s.
//
// The reference walks the chunks of one (b, h) in order, so a grid of
// B * H CTAs fills 32 of the 132 SMs at that width. Here the only
// sequential part, the state carried from chunk to chunk, is a linear
// recurrence per state element, so the work splits into three launches
// on the caller's stream, the first and last over every (b, h, chunk)
// (2,048 CTAs at that width):
//
//   A (state_parts): each chunk's contribution to the state, all chunks at
//     once. dS_c = (k * exp(lwc[q-1] - lwc))^T v, a D x D product on a
//     4 x 4 FMA register tile per thread, and w_c = exp(lwc[q-1]), into
//     the workspace.
//   B (state_scan): one thread per state element (b, h, i, e), coalesced
//     over e, runs S_0 = 0, S_{c+1} = w_c[i] S_c + dS_c, the reference's
//     update in its order; it overwrites dS_c with S_c, the state chunk c
//     starts from, and writes the last S to `state`. Loads go out 16
//     chunks at a time, ahead of the dependent multiply-adds.
//   C (chunk_outputs): each chunk's y, all chunks at once, from S_c:
//     y = att v + (r * exp(lwp)) S_c as one product [att | r~] [v ; S_c]
//     on a 4 x 4 FMA register tile per thread, fed by float4 loads. The
//     diagonal blocks of att run as 4 x 4 sub-tiles of (t, j) in one pass
//     of the CTA's lanes (a lane loads 4 rows of r, lwp, k and lwc for 16
//     pairs, so a pair's exps cost a quarter of the shared-memory bytes
//     that one row each would), their lanes' sums meeting in a
//     reduce-scatter of shuffles; the blocks below them are r~ k~^T on
//     4 x 4 tiles, two lanes a tile.
//
// The exps. The pairwise form takes D exps per pair j < t: 129,024 a chunk
// at q = D = 64. C cuts the chunk into sub-chunks of 16 steps (the last
// one ragged where q is no multiple of 16: the tiles are zero-padded to
// the next multiple, and padded steps add nothing). Pairs inside one
// sub-chunk keep the pairwise exp(lwp[t] - lwc[j]) (30,720 exps a chunk).
// A pair below the diagonal blocks (t in sub-chunk a, starting at step
// s_a, and j < s_a) splits at the reference point lwp[s_a] = lwc[s_a - 1]:
//   exp(lwp[t] - lwc[j]) = exp(lwp[t] - lwp[s_a]) * exp(lwp[s_a] - lwc[j])
// so those blocks are the product r~_a k~_a^T, with
// r~[t] = r[t] exp(lwp[t] - lwp[s_a]) (4,096 exps; lwp[s_0] = 0, so
// r~ = r exp(lwp) on the first sub-chunk) and k~_a[j] = k[j] exp(lwc[s_a -
// 1] - lwc[j]) (6,144 exps for a = 1, 2, 3). The cross-chunk term takes
// r exp(lwp[t]) = r~[t] E_a with E_a = exp(lwp[s_a]) (D exps a
// sub-chunk). 41,152 exps a chunk in all. The cumulative sums are kept in
// units of log2 (each logw times log2(e) before the scan), so each exp is
// one exp2f (precise, 2 ulp; no fast-math intrinsics), a few instructions
// where expf takes about nine.
//
// Why nothing overflows. logw <= 0, so lwc falls monotonically over a
// chunk (down to -1,860 on strongly decaying inputs), and rounding keeps
// that order. The naive split exp(lwp) * exp(-lwc) overflows: exp(-lwc)
// passes f32's range once lwc < -88.7, which ordinary inputs reach at
// q = 64. Every exp here takes an argument <= 0: a later cumulative sum
// minus an earlier one (lwp[t] <= lwp[s_a] for t >= s_a, and lwc[s_a - 1]
// <= lwc[j] for j < s_a), so every factor lies in [0, 1]. A factor that
// underflows marks a term below f32's range anyway: the exact product of
// the two factors is no larger than either. The cumulative sum is a
// parallel scan (each of 4 threads of a column sums 16 steps in
// registers, then adds the totals of the segments before it); each
// segment's offset is the previous segment's last lwc, so lwc stays
// monotone across the segments' joins.
//
// Shared memory: A 53,248 B (k, v and logw tiles of 64 rows of 68 floats,
// padded by 4 floats so the float4 loads of 8 lanes hit distinct banks),
// 3 CTAs an SM by its 80 registers; C 106,752 B (r, k and logw tiles,
// later r~ and the k~ tiles in the same place; v, S_c, att, E, u), 2 CTAs
// an SM. Tiles arrive through cp.async, 16-byte copies where D % 4 == 0
// and the pointers are 16-byte aligned, else 4-byte copies (a row's copies
// over fixed slots, so rows and columns come from shifts); the padding is
// zeroed. The workspace (dS_c, then S_c, and w_c) takes
// B * H * (S / q) * (D * D + D) * 4 bytes, 33.6 MB at rwkv6-1.6b width.
// Its own byte floor is about 400 MB there (k, v and logw read by A and
// C, r by C, the workspace written and read twice, y), 0.12 ms.
#include "wkv_tiles.cuh"

namespace {

using namespace wkv;

// Shared bytes: A's k, v and logw tiles and the scan's segment totals;
// C's r/r~, k/k~, logw, v, S_c and att tiles, E (4 x 64), u and totals.
constexpr int SMEM_A = 4 * (3 * MAXD * LD + 4 * MAXD);
constexpr int SMEM_C = 4 * (6 * MAXD * LD + 9 * MAXD);

// Phase A for one task: dS and w of the chunk into the workspace.
__device__ void state_part(const Shape& sh, long task,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ lw,
                           float* __restrict__ ds, float* __restrict__ wd,
                           float* sm) {
  float* K = sm;
  float* V = K + MAXD * LD;
  float* L = V + MAXD * LD;
  float* tot = L + MAXD * LD;
  const int tid = threadIdx.x, d = sh.d, q = sh.q, dp = sh.dp;
  int chunk, head;
  const long g0 = task_rows(sh, task, &chunk, &head);
  const long rs = (long)sh.h * d;
  load_rows(K, k + g0, rs, q, d, sh.vec);
  load_rows(V, v + g0, rs, q, d, sh.vec);
  load_rows(L, lw + g0, rs, q, d, sh.vec);
  cp_commit();
  zero_pad(K, q, sh.qp, d, dp);
  zero_pad(V, q, sh.qp, d, dp);
  zero_pad(L, q, sh.qp, d, dp);
  cp_wait<0>();
  __syncthreads();
  scan_rows(L, tot, sh);

  const float* last = L + (q - 1) * LD;
  for (int i = tid; i < q * MAXD; i += NT) {
    const int t = i / MAXD, c = i & (MAXD - 1);
    if (c < dp) K[t * LD + c] *= exp2f(last[c] - L[t * LD + c]);
  }
  if (tid < d) wd[task * d + tid] = exp2f(last[tid]);
  __syncthreads();

  const int i0 = 4 * (tid >> 4), e0 = 4 * (tid & 15);
  if (i0 < dp && e0 < dp) {
    float acc[4][4] = {};
    for (int t = 0; t < q; ++t) {
      const float4 a = ld4(K + t * LD + i0), b = ld4(V + t * LD + e0);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += av[i] * bv[e];
    }
    float* o = ds + task * d * d;
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

// Phase B for one state element idx of (B, H, D, D).
__device__ __forceinline__ void state_element(const Shape& sh, long idx,
                                              float* __restrict__ ds,
                                              const float* __restrict__ wd,
                                              float* __restrict__ state) {
  constexpr int BATCH = 16;
  const long dd = (long)sh.d * sh.d;
  const long bh = idx / dd, ie = idx - bh * dd;
  const int i = (int)(ie / sh.d);
  float* p = ds + bh * sh.nc * dd + ie;
  const float* pw = wd + bh * sh.nc * sh.d + i;
  float s = 0.f;
  for (int c0 = 0; c0 < sh.nc; c0 += BATCH) {
    float a[BATCH], f[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (c0 + u < sh.nc) {
        a[u] = __ldcg(p + (c0 + u) * dd);
        f[u] = __ldcg(pw + (long)(c0 + u) * sh.d);
      }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (c0 + u < sh.nc) {
        p[(c0 + u) * dd] = s;
        s = f[u] * s + a[u];
      }
  }
  state[idx] = s;
}

// Phase C for one task: the chunk's y from S_c (in the workspace).
__device__ void chunk_out(const Shape& sh, long task,
                          const float* __restrict__ r,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ lw,
                          const float* __restrict__ u,
                          float* __restrict__ y,
                          const float* __restrict__ ss, float* sm) {
  float* R = sm;                // r, then r~ (rows 0 .. qp - 1)
  float* K = R + MAXD * LD;     // k, then with L's first rows the k~ tiles
  float* L = K + MAXD * LD;     // logw, then lwc
  float* V = L + MAXD * LD;
  float* S = V + MAXD * LD;     // S_c
  float* A = S + MAXD * LD;     // att
  float* E = A + MAXD * LD;     // E_a, 4 x 64
  float* U = E + 4 * MAXD;
  float* tot = U + MAXD;
  float* KT = K;                // k~ of sub-chunk a at row 8 a (a - 1)
  const int tid = threadIdx.x, d = sh.d, q = sh.q, qp = sh.qp, na = sh.na,
            dp = sh.dp;
  int chunk, head;
  const long g0 = task_rows(sh, task, &chunk, &head);
  const long rs = (long)sh.h * d;
  const float* s0 = ss + task * d * d;

  load_rows(R, r + g0, rs, q, d, sh.vec);
  load_rows(K, k + g0, rs, q, d, sh.vec);
  load_rows(L, lw + g0, rs, q, d, sh.vec);
  cp_commit();
  load_rows(V, v + g0, rs, q, d, sh.vec);
  load_rows(S, s0, d, d, d, sh.vec);
  cp_commit();
  zero_pad(R, q, qp, d, dp);
  zero_pad(K, q, qp, d, dp);
  zero_pad(L, q, qp, d, dp);
  zero_pad(V, q, qp, d, dp);
  zero_pad(S, d, dp, d, dp);
  if (tid < MAXD) {
    U[tid] = tid < d ? u[head * d + tid] : 0.f;
    E[tid] = 1.f;  // E_0: lwp[s_0] = 0
  }
  cp_wait<1>();
  __syncthreads();
  scan_rows(L, tot, sh);

  // att on the diagonal blocks, pairwise, by 4 x 4 sub-tiles of (t, j),
  // all in one pass of the CTA's lanes: per sub-chunk a, the 6 sub-tiles
  // below the diagonal take 8 lanes each, 8 of the D channels a lane (4 at
  // c and 4 at c + 32); the 4 on it (j <= t only, u at j = t) take 4 lanes
  // each, 16 channels a lane, from the next whole warp on, so a warp holds
  // one kind only. A lane loads 4 rows of r and lwp and 4 of k and lwc for
  // its 16 pairs (a quarter-warp reads 128 or 2 x 64 contiguous bytes a
  // row), and the lanes' 16 sums meet in a reduce-scatter of shuffles.
  // Padded rows hold zeros in r and k, so they add nothing.
  {
    const int lower = (48 * na + 31) / 32 * 32;  // lanes of the 6 na below
    const bool on_diag = tid >= lower;
    const int nl = on_diag ? 4 : 8;              // lanes an item
    const int it = on_diag ? (tid - lower) / 4 : tid / 8;
    const int g = tid % nl;
    const bool live = it < (on_diag ? 4 : 6) * na;
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 0.f;
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
                v[4 * i + jj] += exp2f(lp[i].x - lc.x) * rr[i].x * kk.x +
                                 exp2f(lp[i].y - lc.y) * rr[i].y * kk.y +
                                 exp2f(lp[i].z - lc.z) * rr[i].z * kk.z +
                                 exp2f(lp[i].w - lc.w) * rr[i].w * kk.w;
              else if (jj == i)
                v[4 * i + jj] += rr[i].x * uu.x * kk.x +
                                 rr[i].y * uu.y * kk.y +
                                 rr[i].z * uu.z * kk.z +
                                 rr[i].w * uu.w * kk.w;
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[4 * i + jj] += exp2f(lp[i].x - lc.x) * rr[i].x * kk.x +
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
        w[i] = (b2 ? v[i + 8] : v[i]) +
               __shfl_xor_sync(0xffffffffu, b2 ? v[i] : v[i + 8], 2);
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
        w[i] = (b4 ? v[i + 8] : v[i]) +
               __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 8], 4);
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
  }
  // zeros in the sub-tiles above them
  for (int i = tid; i < na * SUB * SUB; i += NT) {
    const int a = i / (SUB * SUB), tl = (i / SUB) % SUB, jl = i % SUB;
    if (jl / 4 > tl / 4) A[(a * SUB + tl) * LD + a * SUB + jl] = 0.f;
  }

  // r~, k~ and E into registers (column c, rows r0 + 4m), then in place of
  // r, k and logw once every thread has read them. Row r0 + 4m lies in
  // sub-chunk m / 4, and k~ row r0 + 4m in sub-chunk 1, 2, 3 for m < 4,
  // 12, 24: compile-time constants. Rows and columns past qp and dp take
  // whatever the tiles hold there; nothing reads them.
  const int c = tid & (MAXD - 1), r0 = tid / MAXD;
  float rt[MAXD / 4], kt[6 * SUB / 4];
#pragma unroll
  for (int m = 0; m < MAXD / 4; ++m) {
    const int t = r0 + 4 * m, a = m / 4;
    const float ref = a ? L[(a * SUB - 1) * LD + c] : 0.f;
    const float lp = m || r0 ? L[(t - 1) * LD + c] : 0.f;
    rt[m] = R[t * LD + c] * exp2f(lp - ref);
  }
#pragma unroll
  for (int m = 0; m < 6 * SUB / 4; ++m) {
    const int a = m < 4 ? 1 : m < 12 ? 2 : 3;
    const int j = r0 + 4 * m - 8 * a * (a - 1);
    kt[m] = K[j * LD + c] * exp2f(L[(a * SUB - 1) * LD + c] -
                                  L[j * LD + c]);
  }
  const float ev = r0 ? exp2f(L[(r0 * SUB - 1) * LD + c]) : 1.f;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MAXD / 4; ++m) R[(r0 + 4 * m) * LD + c] = rt[m];
#pragma unroll
  for (int m = 0; m < 6 * SUB / 4; ++m) KT[(r0 + 4 * m) * LD + c] = kt[m];
  if (r0) E[r0 * MAXD + c] = ev;
  cp_wait<0>();
  __syncthreads();

  // att below the diagonal blocks: r~_a k~_a^T, a 4 x 4 tile of (t, j)
  // per lane pair, each lane half of the channels, summed by a shuffle.
  {
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
          ra[i] = ld4(R + (t0 + i) * LD + cc);
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
  }
  __syncthreads();

  // y = att v + (r~ E_a) S_c: thread (rows t0 .. t0 + 3, columns e0 ..
  // e0 + 3); a row of sub-chunk a sees att up to the sub-chunk's end.
  const int t0 = 4 * (tid >> 4), e0 = 4 * (tid & 15);
  if (t0 < q && e0 < dp) {
    const int a = t0 / SUB, jend = SUB * (a + 1);
    float acc[4][4] = {};
    for (int j = 0; j < jend; j += 4) {
      float4 at[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        at[i] = ld4(A + (t0 + i) * LD + j);
        vv[i] = ld4(V + (j + i) * LD + e0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {at[i].x, at[i].y, at[i].z, at[i].w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i][0] += av[jj] * vv[jj].x;
          acc[i][1] += av[jj] * vv[jj].y;
          acc[i][2] += av[jj] * vv[jj].z;
          acc[i][3] += av[jj] * vv[jj].w;
        }
      }
    }
    const float* Ea = E + a * MAXD;
    for (int cc = 0; cc < dp; cc += 4) {
      const float4 ee = ld4(Ea + cc);
      float4 rr[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rr[i] = ld4(R + (t0 + i) * LD + cc);
        sv[i] = ld4(S + (cc + i) * LD + e0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float rv[4] = {rr[i].x * ee.x, rr[i].y * ee.y, rr[i].z * ee.z,
                             rr[i].w * ee.w};
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[i][0] += rv[m] * sv[m].x;
          acc[i][1] += rv[m] * sv[m].y;
          acc[i][2] += rv[m] * sv[m].z;
          acc[i][3] += rv[m] * sv[m].w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = y + g0 + (t0 + i) * rs + e0;
      if (t0 + i < q && sh.vec) {
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else if (t0 + i < q) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e0 + e < d) row[e] = acc[i][e];
      }
    }
  }
  __syncthreads();  // the tiles are free for the next task
}

__global__ void __launch_bounds__(NT, 3)
state_parts(Shape sh, long tasks, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            float* __restrict__ ds, float* __restrict__ wd) {
  extern __shared__ __align__(16) float sm[];
  for (long t = blockIdx.x; t < tasks; t += gridDim.x)
    state_part(sh, t, k, v, lw, ds, wd, sm);
}

__global__ void __launch_bounds__(NT)
state_scan(Shape sh, long n, float* __restrict__ ds,
           const float* __restrict__ wd, float* __restrict__ state) {
  const long idx = (long)blockIdx.x * NT + threadIdx.x;
  if (idx < n) state_element(sh, idx, ds, wd, state);
}

__global__ void __launch_bounds__(NT, 2)
chunk_outputs(Shape sh, long tasks, const float* __restrict__ r,
              const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ lw, const float* __restrict__ u,
              float* __restrict__ y, const float* __restrict__ ss) {
  extern __shared__ __align__(16) float sm[];
  for (long t = blockIdx.x; t < tasks; t += gridDim.x)
    chunk_out(sh, t, r, k, v, lw, u, y, ss, sm);
}

}  // namespace

// (r, k, v, logw, u, y, state, workspace, b, s, h, d, q, stream): the
// workspace holds B * H * (S / q) * (D * D + D) floats; returns
// cudaGetLastError() after the three launches.
extern "C" int wkv_chunk(const void* r, const void* k, const void* v,
                         const void* lw, const void* u, void* y, void* state,
                         void* ws, int b, int s, int h, int d, int q,
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
            (uintptr_t)y | (uintptr_t)ws) % 16 == 0;
  const long tasks = (long)b * h * sh.nc;
  const long n = (long)b * h * d * d;
  float* ds = (float*)ws;
  float* wd = ds + tasks * d * d;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  // phases A and C: at most 2^30 CTAs, each taking tasks a grid apart;
  // phase B: one thread per state element (the state of 2^39 bytes this
  // would refuse fits on no card)
  const int grid_t = (int)(tasks < (1L << 30) ? tasks : 1L << 30);
  const long grid_e = (n + NT - 1) / NT;
  if (grid_e > INT_MAX) return (int)cudaErrorInvalidValue;
  static int conf_a = 0, conf_c = 0;
  e = opt_in(state_parts, SMEM_A, &conf_a);
  if (e == cudaSuccess) e = opt_in(chunk_outputs, SMEM_C, &conf_c);
  if (e != cudaSuccess) return (int)e;
  state_parts<<<grid_t, NT, SMEM_A, st>>>(
      sh, tasks, (const float*)k, (const float*)v, (const float*)lw, ds, wd);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  state_scan<<<(int)grid_e, NT, 0, st>>>(sh, n, ds, wd, (float*)state);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_outputs<<<grid_t, NT, SMEM_C, st>>>(
      sh, tasks, (const float*)r, (const float*)k, (const float*)v,
      (const float*)lw, (const float*)u, (float*)y, ds);
  return (int)cudaGetLastError();
}
