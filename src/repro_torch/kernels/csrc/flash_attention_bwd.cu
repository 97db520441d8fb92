// flash_attention_bwd: the backward of csrc/flash_attention.cu, from its
// saved output and per-row logsumexp. q, dq: (S, H, D); k, v, dk, dv:
// (T, H, D); out, dout: (S, H, D); f32 or bf16 (one flag for all), lse
// (S, H) f32, and a f32 workspace of 2·H·S_pad floats, S_pad = S rounded up
// to 128, then the f32 body's counters (flash_attention.py::
// bwd_workspace_floats). With scale s = 1/sqrt(D) and score_ij = s q_i k_j
// (masked where the forward masks: key j > i + T - S when causal), the
// backward recomputes P_ij = exp(score_ij - lse_i) and takes
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
// Two launches on the stream a call, and no atomic on dq, dk or dv, so
// every sum runs in an order fixed by the shapes and a second call is
// bit-equal to the first. Bound on this card: operations. The five
// products of the backward at causal S = T = 4096, H = 16, D = 128 take
// 172 GFLOP: 2.56 ms at the 67 TFLOP/s of f32 outside the tensor cores,
// 0.17 ms at the 989 TFLOP/s of bf16 on them. Two bodies, one per type:
//
// bf16 on the tensor cores through wgmma (bf16 in, f32 accumulate), two
// passes:
//   dQ: one CTA per (query tile, head), heaviest tile first, heads the
//       fastest grid dimension. It computes D for its rows, writes D and
//       lse·log2(e) to the workspace in (H, S_pad) order, then walks the
//       key tiles the forward walked: S and dout V^T, then P and dS, then
//       dQ += dS K.
//   dK, dV: one CTA per (key tile, head), the first key tiles (which the
//       most query rows see) first. It walks the query tiles that see its
//       keys: S^T and V dout^T, then P^T and dS^T (D read back from the
//       workspace the first launch wrote), then dV += P^T dout and dK +=
//       dS^T Q.
// It replaces a body of 4 warps on mma.sync m16n8k16 fed by ldmatrix, whose
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
// f32 on the FMA units (no TF32), one pass of the five products. It
// replaces two launches (dQ over query tiles, then dK and dV over key
// tiles) that computed S and dout V^T twice, seven products for five, with
// every tile copied synchronously:
//   pre-pass (flash_bwd_f32_pre): 8 lanes a (row, head) pair write D and
//       lse·log2(e) to the workspace in (H, S_pad) order (zero past S), and
//       zero the counters below;
//   main pass (flash_bwd_f32): one CTA of 256 threads per (64-key tile,
//       head) holds its K and V in shared memory and walks the 64-row query
//       tiles that see its keys from the last down to the first. Per tile:
//       warps 0-3 compute S = Q K^T, then P = 2^(S·log2(e)/sqrt(D) -
//       lse·log2(e)) on ex2.approx (masked per element) into a shared P
//       tile, while warps 4-7 compute dP = dout V^T (8 rows x 4 keys a
//       thread: a float loaded from shared memory feeds 2.67 products,
//       not 2 as with both products 4 x 4 a thread). Then warps 0-3 take
//       dV += P^T dout while warps 4-7 write dS = P (dP - D) to a shared
//       dS tile and take dK += dS^T Q (8 keys x 8 columns a thread at
//       W = 128: 4 products a float loaded); all 8 warps then take dQ's
//       partial dS K (4 rows x 8 columns a thread at W = 128). dV and dK
//       stay in registers for the whole walk; dq gets each partial times
//       s, added in a fixed order.
// The order of dQ's sum: CTAs take tickets from a counter in the workspace,
// key tiles ascending and heads the fastest (as csrc/conv_tiles.cuh), so a
// CTA's ticket says which tile it owns. Warp w of key tile j adds its part
// of a query tile's partial once the (head, query tile, w) counter reads j
// (an acquire load) and then sets it to j + 1 (__syncwarp, then a release
// store, which orders the warp's adds before it); key tile 0 writes
// without reading (every query tile is its), so dq needs no zeroing. Each
// element of dq is thus summed over the key tiles in ascending order, the
// same on every call. No wait can deadlock: a CTA waits only on the one key
// tile before it in its head, whose ticket is earlier (so it is resident
// or done), and which walks the same descending query tiles from the same
// last one, ahead of it; a walk from the first query tile up would leave
// key tile j j tiles behind key tile 0 in every head. Key tiles that start
// together still form a chain in each head, each a wait behind the one
// before, so the span from a warp's wait to its release is kept short: it
// waits after dV and dK, reads dq (through L2, ld.global.cg) under dQ's
// partial, adds and releases at once (releasing a tile after the next
// tile's S and dP made the chain's waits cost more than the fence saved;
// __threadfence before the release store cost 2 % and orders nothing the
// release does not).
// Every shared operand is a float4 load, and the lanes of one load read
// one 128-byte row segment or broadcast. Rows of K, V, Q and dout in
// shared memory are W + 4 floats (W = D rounded up to 32, 64 or 128, the
// pad zero-filled by the copies) and of P and dS 68, so 8 lanes reading 8
// rows hit 8 bank groups. The next tile's Q and its rows' lse·log2(e) and
// D come in (cp.async) at a tile's start, into the second of two Q
// buffers, its dout once dV and dK are done with this one's: three tiles
// for two stages. Shared memory 204,816 B at W = 128 (one CTA an SM),
// 81,936 B at W = 32 (two CTAs an SM by the launch bounds). q is not
// scaled: the scale goes into the exponent, onto each dQ partial and onto
// dk at the end. What each part costs on an H100:
// scripts/torch_flash_bwd_variants.py.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;   // f32: query rows of a walked tile
constexpr int BK = 64;   // f32: keys of a CTA
constexpr int NT = 256;  // f32: threads of a CTA
constexpr int WARPS = 8;  // f32: warps of a CTA, counters a query tile
constexpr int LDP = BK + 4;  // f32: row stride of the P / dS tile
constexpr int CTR0 = 4;      // f32: the counters after the ticket

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The keys [0, end) that rows [r0, min(r0 + rows, s)) see, as the forward
// walks them.
__device__ __forceinline__ int key_end(int r0, int rows, int s, int t,
                                       int causal) {
  if (!causal || t < s) return t;
  return min(min(r0 + rows, s) - 1 + (t - s) + 1, t);
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

// ------------------------------------------------------------ f32, FMA

// 16 bytes global -> shared through cp.async; with ok false the 16 bytes
// are zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ float part_of(float4 x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}
// N floats from shared memory (N a multiple of 4): 4 at p, 4 at p + 32,
// ... (the keys of a thread in dV and dK, so 8 lanes read 128 bytes)
template <int N>
__device__ __forceinline__ void load_keys(float (&x)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 a = load4(p + 8 * i);
    x[i] = a.x, x[i + 1] = a.y, x[i + 2] = a.z, x[i + 3] = a.w;
  }
}
// acc[e][4c + .] += x[e] y[c]: a thread's KPT x 4·NF outer product
template <int KPT, int NF>
__device__ __forceinline__ void outer(float (&acc)[KPT][4 * NF],
                                      const float (&x)[KPT],
                                      const float4 (&y)[NF]) {
#pragma unroll
  for (int e = 0; e < KPT; ++e)
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      acc[e][4 * c + 0] = fmaf(x[e], y[c].x, acc[e][4 * c + 0]);
      acc[e][4 * c + 1] = fmaf(x[e], y[c].y, acc[e][4 * c + 1]);
      acc[e][4 * c + 2] = fmaf(x[e], y[c].z, acc[e][4 * c + 2]);
      acc[e][4 * c + 3] = fmaf(x[e], y[c].w, acc[e][4 * c + 3]);
    }
}

// The pre-pass: D = rowsum(dout o out) and lse·log2(e) of every (row,
// head) pair of S_pad x H into the workspace in (H, S_pad) order, zero for
// the rows past S; 8 lanes a pair (consecutive pairs are consecutive heads
// of one row, so a warp reads 4 contiguous rows of D floats), summed
// across the 8 in a fixed order. Also zeroes the main pass's `nctr`
// counters (its ticket first).
__global__ void __launch_bounds__(NT)
flash_bwd_f32_pre(const float* __restrict__ o, const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ ws,
                  int* __restrict__ ctr, int nctr, int s, int h, int d,
                  int s_pad) {
  const long gt = (long)blockIdx.x * NT + threadIdx.x;
  const long pair = gt >> 3;
  const int part = (int)(gt & 7);
  const int row = (int)(pair / h), head = (int)(pair - (long)row * h);
  float acc = 0.f;
  if (row < s) {
    const long base = pair * d;  // (row, head) of a contiguous (S, H, D)
    for (int c = 4 * part; c < d; c += 32)
      acc = dot4(load4(o + base + c), load4(dout + base + c), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (part == 0 && row < s_pad) {
    ws[(long)head * s_pad + row] =
        row < s ? lse[(long)row * h + head] * LOG2E : 0.f;
    ws[(long)(h + head) * s_pad + row] = acc;
  }
  for (long i = gt; i < nctr; i += (long)gridDim.x * NT) ctr[i] = 0;
}

// Shared memory of the main pass, in floats: K and V, BK rows each; two
// buffers of the walked Q tiles and one of the dout tile (BQ rows each:
// the next tile's Q comes in at a tile's start, its dout once dV and dK
// are done with this one's); two stages of the rows' lse·log2(e) and D;
// the P and the dS tiles; the CTA's ticket. Rows of W + 4.
template <int W>
struct F32Smem {
  static constexpr int LD = W + 4;
  static constexpr int TILE = BQ * LD;
  static constexpr int K = 0, V = BK * LD, Q = 2 * BK * LD;
  static constexpr int DO = Q + 2 * TILE;
  static constexpr int STATS = DO + TILE;  // [stage][lse·log2e, D][BQ]
  static constexpr int P = STATS + 4 * BQ;
  static constexpr int DS = P + BQ * LDP;
  static constexpr int TICKET = DS + BQ * LDP;
  static constexpr int BYTES = 4 * (TICKET + 4);
};

// The main pass, W = D rounded up to 32, 64 or 128.
template <int W>
__global__ void __launch_bounds__(NT, W == 32 ? 2 : 1)
flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ ws, int* __restrict__ ctr,
              float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, int s, int t, int h, int d, int causal,
              int s_pad) {
  typedef F32Smem<W> L;
  constexpr int LD = L::LD;
  // dQ's partial over all 8 warps: KPT rows x 4·NF columns a thread
  constexpr int KPT = W == 32 ? 2 : 4;
  constexpr int NF = W == 128 ? 2 : 1;
  constexpr int CB = WARPS / (BK / (8 * KPT));  // warps along the columns
  // dV (warps 0-3) and dK (warps 4-7): GK keys x 4·GF columns a thread
  constexpr int GK = W == 128 ? 8 : 4;
  constexpr int GF = W == 32 ? 1 : 2;
  constexpr int GCB = 4 / (BK / (8 * GK));  // a group's warps along columns
  static_assert(GCB * 16 * GF == W && CB * 16 * NF == W, "f32 tiles");
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* const ticket = reinterpret_cast<int*>(sm + L::TICKET);
  if (tid == 0) *ticket = atomicAdd(ctr, 1);
  __syncthreads();
  const int head = *ticket % h, kt = *ticket / h, k0 = kt * BK;
  const int offset = t - s, nq = (s + BQ - 1) / BQ;
  // the query tiles nq - 1 down to the first holding a row that sees k0
  const int ntiles = nq - (causal ? max(0, k0 - offset) : 0) / BQ;
  const long rs = (long)h * d, hoff = (long)head * d;
  int* const counters = ctr + CTR0 + head * nq * WARPS + warp;

  // rows [r0, r0 + 64) of one head of a (rows, H, D) tensor into a shared
  // tile, zero at or past `limit` and at or past column D
  auto rows_in = [&](float* dst, const float* g, int r0, int limit) {
#pragma unroll 4
    for (int idx = tid; idx < 64 * (W / 4); idx += NT) {
      const int r = idx / (W / 4), c = (idx % (W / 4)) * 4;
      const bool ok = r0 + r < limit && c < d;
      cp_async16(dst + r * LD + c, ok ? g + (r0 + r) * rs + hoff + c : g,
                 ok);
    }
  };
  // walked tile n's Q and its rows' lse·log2(e) and D (query tile
  // nq - 1 - n) into buffer and stage n & 1
  auto q_in = [&](int n) {
    const int st = n & 1, q0 = (nq - 1 - n) * BQ;
    rows_in(sm + L::Q + st * L::TILE, q, q0, s);
    if (tid < 32) {  // lse·log2(e), then D
      const int which = tid >> 4, c = (tid & 15) * 4;
      cp_async16(sm + L::STATS + (2 * st + which) * BQ + c,
                 ws + (long)(which * h + head) * s_pad + q0 + c, true);
    }
    cp_async_commit();
  };
  auto dout_in = [&](int n) {
    rows_in(sm + L::DO, dout, (nq - 1 - n) * BQ, s);
    cp_async_commit();
  };
  rows_in(sm + L::K, k, k0, t);
  rows_in(sm + L::V, v, k0, t);
  dout_in(0);
  q_in(0);

  // S (warps 0-3: Q K^T, then P) or dP (warps 4-7: dout V^T, then dS):
  // rows r1 + 4i, keys c1 + 8j of the tile
  const bool first4 = warp < WARPS / 2;
  const int gw = warp & 3;
  const int r1 = (gw >> 1) * 32 + (lane >> 3);
  const int c1 = (gw & 1) * 32 + (lane & 7);
  const int la = lane & 7, lc = lane >> 3;
  // dV (warps 0-3) or dK (warps 4-7): keys gk + (e & 3) + 32 (e >> 2),
  // columns gc + 16c
  const int gk = (gw / GCB) * 32 + 4 * la;
  const int gc = (gw % GCB) * 16 * GF + 4 * lc;
  // dQ's partial: rows ro + 8i, columns cw + 16c
  const int ro = (warp / CB) * 8 * KPT + la;
  const int cw = (warp % CB) * 16 * NF + 4 * lc;
  const float scale = rsqrtf((float)d), sl2 = scale * LOG2E;
  const float* Ks = sm + L::K;
  const float* Bs = sm + (first4 ? L::K : L::V);
  const float* Os = sm + L::DO;
  float* const Ps = sm + L::P;
  float* const dSs = sm + L::DS;
  // dV (warps 0-3) or dK (warps 4-7, scaled at the end)
  float acc[GK][4 * GF];
#pragma unroll
  for (int e = 0; e < GK; ++e)
#pragma unroll
    for (int c = 0; c < 4 * GF; ++c) acc[e][c] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    const int st = n & 1, qt = nq - 1 - n, q0 = qt * BQ;
    const float* Qs = sm + L::Q + st * L::TILE;
    const float* Ls = sm + L::STATS + 2 * st * BQ;
    const float* Ds = Ls + BQ;
    cp_async_wait_all();
    // tile n has landed for every thread, and every thread is done with
    // tile n - 1 (its Q buffer, the P and dS tiles)
    __syncthreads();
    if (n + 1 < ntiles) q_in(n + 1);

    // S = Q K^T or dP = dout V^T over the depth D (two steps at a time but
    // at W = 32, where two CTAs an SM leave 128 registers a thread)
    const float* As = first4 ? Qs : Os;
    float x[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
#pragma unroll(W == 32 ? 1 : 2)
    for (int c = 0; c < d; c += 4) {
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = load4(As + (r1 + 4 * i) * LD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = load4(Bs + (c1 + 8 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[i][j] = dot4(a[i], b[j], x[i][j]);
    }
    // P to its tile: zero for a masked pair, a row past S or a key past T
    if (first4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r1 + 4 * i, row = q0 + r;
        const float l2 = Ls[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + c1 + 8 * j;
          const bool seen =
              row < s && key < t && (!causal || key <= row + offset);
          Ps[r * LDP + c1 + 8 * j] =
              seen ? ex2(fmaf(x[i][j], sl2, -l2)) : 0.f;
        }
      }
    }
    __syncthreads();
    if (first4) {
      // dV += P^T dout
#pragma unroll(W == 128 ? 4 : 2)
      for (int r = 0; r < BQ; ++r) {
        float z[GK];
        float4 y[GF];
        load_keys<GK>(z, Ps + r * LDP + gk);
#pragma unroll
        for (int c = 0; c < GF; ++c) y[c] = load4(Os + r * LD + gc + 16 * c);
        outer<GK, GF>(acc, z, y);
      }
    } else {
      // dS = P (dP - D) to its tile, then dK += dS^T Q
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r1 + 4 * i;
        const float dd = Ds[r];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dSs[r * LDP + c1 + 8 * j] =
              Ps[r * LDP + c1 + 8 * j] * (x[i][j] - dd);
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
#pragma unroll(W == 128 ? 4 : 2)
      for (int r = 0; r < BQ; ++r) {
        float z[GK];
        float4 y[GF];
        load_keys<GK>(z, dSs + r * LDP + gk);
#pragma unroll
        for (int c = 0; c < GF; ++c) y[c] = load4(Qs + r * LD + gc + 16 * c);
        outer<GK, GF>(acc, z, y);
      }
    }
    // every thread is done with this tile's dout, and dS is in
    __syncthreads();
    if (n + 1 < ntiles) dout_in(n + 1);

    // the ordered add: once key tile kt - 1 has added its part of this
    // tile (this warp's rows and columns), read what dq holds; the read's
    // latency hides under dQ's partial
    int* const counter = counters + qt * WARPS;
    if (kt > 0) {
      if (lane == 0)
        while (ld_acquire(counter) != kt) {
        }
      __syncwarp();
    }
    float4 old[KPT][NF];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int c = 0; c < NF; ++c) {
        const int row = q0 + ro + 8 * i, col = cw + 16 * c;
        old[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kt > 0 && row < s && col < d)
          old[i][c] = __ldcg(
              reinterpret_cast<const float4*>(dq + row * rs + hoff + col));
      }
    // dQ's partial dS K, rows ro + 8i
    float part[KPT][4 * NF];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NF; ++c) part[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        a[i] = load4(dSs + (ro + 8 * i) * LDP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 b[NF];
        float z[KPT];
#pragma unroll
        for (int c = 0; c < NF; ++c)
          b[c] = load4(Ks + (kk + u) * LD + cw + 16 * c);
#pragma unroll
        for (int i = 0; i < KPT; ++i) z[i] = part_of(a[i], u);
        outer<KPT, NF>(part, z, b);
      }
    }
    // dq = what it held + s · the partial; then the counter reads kt + 1
    // (the warp's stores before lane 0's release store)
#pragma unroll
    for (int i = 0; i < KPT; ++i)
#pragma unroll
      for (int c = 0; c < NF; ++c) {
        const int row = q0 + ro + 8 * i, col = cw + 16 * c;
        if (row < s && col < d)
          __stcg(reinterpret_cast<float4*>(dq + row * rs + hoff + col),
                 make_float4(fmaf(part[i][4 * c + 0], scale, old[i][c].x),
                             fmaf(part[i][4 * c + 1], scale, old[i][c].y),
                             fmaf(part[i][4 * c + 2], scale, old[i][c].z),
                             fmaf(part[i][4 * c + 3], scale, old[i][c].w)));
      }
    __syncwarp();
    if (lane == 0) st_release(counter, kt + 1);
  }

  // dV (warps 0-3) or dK (warps 4-7, times s)
  float* const out = first4 ? dv : dk;
  const float mul = first4 ? 1.f : scale;
#pragma unroll
  for (int e = 0; e < GK; ++e) {
    const int key = k0 + gk + (e & 3) + 32 * (e >> 2);
#pragma unroll
    for (int c = 0; c < GF; ++c) {
      const int col = gc + 16 * c;
      if (key < t && col < d)
        store4(out + key * rs + hoff + col,
               make_float4(acc[e][4 * c] * mul, acc[e][4 * c + 1] * mul,
                           acc[e][4 * c + 2] * mul,
                           acc[e][4 * c + 3] * mul));
    }
  }
}

// ------------------------------------------------------------- launches

template <int W>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* ws, void* dq, void* dk, void* dv, int s, int t,
                       int h, int d, int causal, cudaStream_t stream) {
  typedef F32Smem<W> L;
  const int s_pad = (s + PAD_ROWS - 1) / PAD_ROWS * PAD_ROWS;
  const int nq = (s + BQ - 1) / BQ, nk = (t + BK - 1) / BK;
  const long nctr = CTR0 + (long)h * nq * WARPS;
  const long pre = ((long)s_pad * h * 8 + NT - 1) / NT;
  if ((long)nk * h > 0x7fffffffL || pre > 0x7fffffffL || nctr > 0x7fffffffL)
    return cudaErrorInvalidValue;
  int* ctr = reinterpret_cast<int*>(ws + 2L * h * s_pad);
  flash_bwd_f32_pre<<<(unsigned)pre, NT, 0, stream>>>(
      (const float*)o, (const float*)dout, lse, ws, ctr, (int)nctr, s, h, d,
      s_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto* kern = &flash_bwd_f32<W>;
  // opt in to the launch's size every time
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::BYTES);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)(nk * h), NT, L::BYTES, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      ws, ctr, (float*)dq, (float*)dk, (float*)dv, s, t, h, d, causal, s_pad);
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

// (q, k, v, out, dout, lse, workspace (flash_attention.py::
// bwd_workspace_floats), dq, dk, dv, s, t, h, d, causal, bf16, stream): the
// two launches; returns cudaGetLastError() after them.
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
    return (int)(d <= 32   ? launch_f32<32>(q, k, v, o, dout, l, w, dq, dk,
                                            dv, s, t, h, d, causal, st)
                 : d <= 64 ? launch_f32<64>(q, k, v, o, dout, l, w, dq, dk,
                                            dv, s, t, h, d, causal, st)
                           : launch_f32<128>(q, k, v, o, dout, l, w, dq, dk,
                                             dv, s, t, h, d, causal, st));
  return (int)(d <= 64 ? launch_bf16<1>(q, k, v, o, dout, l, w, dq, dk, dv,
                                        s, t, h, d, causal, st)
                       : launch_bf16<2>(q, k, v, o, dout, l, w, dq, dk, dv,
                                        s, t, h, d, causal, st));
}
