// Fused pre-norm ViT block, backward.
//
// Replaces: deltakd_tpu/ops/fused_block.py `_bwd_kernel` (called by
// `_fused_block_bwd_call`; math in `_block_fwd_stash`, `_block_bwd_reverse`
// and `_attention_bwd_one`). Like the TPU kernel it takes only the block
// input x and the drop-path scales, recomputes the forward keeping its stash,
// then runs the reverse sweep. The cotangent at the block output may be joined
// by an extra cotangent on the feature output. It returns dx (bf16) and the
// 12 weight gradients in fp32, summed over the batch.
//
// The reverse sweep itself is `reverse_chain` (fused_block_reverse.cuh),
// shared with the block-pair backward.
//
// What bounds it on an H100: about three forwards of tensor-core work (the
// recompute plus two products per forward product) on the same 4ND-scale
// inputs, so again the tensor cores set the floor. The sum over the batch is
// carried across a sequential grid on the TPU; here blocks run in parallel, so
// each weight gradient is a split-K product writing fp32 partials per chunk
// of KCHUNK rows, and a second pass sums the partials in a fixed order
// (deterministic, no atomics). The recompute's four linear products run on
// the forward's TMA + wgmma GEMM (gemm_sm90.cuh); the reverse sweep, the
// stash's materialised scores and the weight gradients stay on the plain
// WMMA tile of fused_block_common.cuh, and with the workspace round trips
// they keep this design well above its floor.

#include "fused_block_reverse.cuh"

using namespace dk;

extern "C" size_t dk_fused_block_bwd_workspace(int B, int N, int D, int H, int F) {
  Shape sh{B, N, D, H, F};
  Carver c{nullptr, 0};
  FwdBuffers f;
  f.carve(c, sh, true);
  BwdBuffers g;
  g.carve(c, sh);
  return c.off;
}

// ptr: x, s_attn, s_mlp, 12 weights, g_out, g_feat|null, dx, then the 12 fp32
// weight gradients in the same order as the weights, then the workspace.
// Returns cudaGetLastError() after the launches.
extern "C" int dk_fused_block_bwd(void* const* ptr, int B, int N, int D, int H, int F,
                                  float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Shape sh{B, N, D, H, F};
  const bf16* x = (const bf16*)ptr[0];
  const float* s_attn = (const float*)ptr[1];
  const float* s_mlp = (const float*)ptr[2];
  const BlockWeights w = unpack_weights(ptr + 3);
  const bf16* g_out = (const bf16*)ptr[15];
  const bf16* g_feat = (const bf16*)ptr[16];
  bf16* dx = (bf16*)ptr[17];
  float* const* dW = (float* const*)(ptr + 18);

  Carver c{(char*)ptr[30], 0};
  FwdBuffers f;
  f.carve(c, sh, true);
  BwdBuffers g;
  g.carve(c, sh);

  // recompute the forward up to the hidden, keeping the stash
  const cudaError_t err =
      forward_chain(x, s_attn, s_mlp, w, sh, eps, f, true, nullptr, nullptr, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  reverse_chain(g_out, g_feat, s_attn, s_mlp, w, sh, f, g, dW, nullptr, dx, st);
  return (int)cudaGetLastError();
}
