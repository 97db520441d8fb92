// arena_fused_chain: one launch runs a fused band chain's stages in graph
// order (op-major when batched): band convs and depthwise convs whose
// chain-internal tensors live in a scratch buffer, then the reassembling
// concat (each int8 input rescaled to the output's params) that alone
// writes the arena.
//
// Replaces the TPU kernels src/repro/kernels/arena_ops.py::_fused_kernel
// with _RoutedFlatMem (the stages) and ::_concat_kernel with ::_rescale
// (the terminal concat), reached through apply_op.
//
// The scratch lives in dynamic shared memory when it fits a CTA (at most
// 232,448 bytes: the flagship's 25,600 B int8 and 102,400 B f32 chains) and
// otherwise in a global buffer the wrapper allocates
// (mobilenet_v1_1.0_224_8bit's 308,224 B); both are this kernel. The
// concat's staging buffer follows the scratch in shared memory when both
// fit, else it is global too.
//
// Bound on this card: the chain moves a few tens of KB and does a few MMACs,
// microseconds or less by either bound; the kernel is bound by running 17
// stages row after row in one CTA. One CTA is the paper's §III.F choice:
// stages must run in order, and each stage's rows in ascending order, for
// the planner's overlaps (chain input and output share arena bytes) to hold.
#include "arena_common.cuh"

using namespace arena;

// desc: a header of DESC_WORDS words (word 0 = stage count), then one
// DESC_WORDS descriptor per stage.
__global__ void __launch_bounds__(NT)
arena_fused_chain_kernel(uint8_t* arena_buf, const int* desc,
                         const uint8_t* wblob, uint8_t* gscratch,
                         uint8_t* gstage, int scratch_smem) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* scratch = gscratch ? gscratch : smem;
  uint8_t* stage = gstage ? gstage : smem + scratch_smem;
  const int ns = desc[0];
  for (int s = 0; s < ns; ++s) {
    const int* d = desc + (s + 1) * DESC_WORDS;
    if (d[D_KIND] == K_CONCAT) concat_op(d, arena_buf, scratch, stage);
    else conv_dispatch(d, arena_buf, scratch, wblob + d[D_WOFF]);
  }
}

extern "C" int arena_fused_chain(void* arena_buf, const void* desc,
                                 const void* wblob, void* gscratch,
                                 void* gstage, int scratch_smem, int smem,
                                 void* stream) {
  static int configured = 0;
  cudaError_t e = set_smem(arena_fused_chain_kernel, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  arena_fused_chain_kernel<<<1, NT, smem, (cudaStream_t)stream>>>(
      (uint8_t*)arena_buf, (const int*)desc, (const uint8_t*)wblob,
      (uint8_t*)gscratch, (uint8_t*)gstage, scratch_smem);
  return (int)cudaGetLastError();
}
