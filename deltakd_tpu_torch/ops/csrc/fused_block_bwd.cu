// Fused pre-norm ViT block, backward.
//
// Replaces: deltakd_tpu/ops/fused_block.py `_bwd_kernel` (called by
// `_fused_block_bwd_call`; math in `_block_fwd_stash`, `_block_bwd_reverse`
// and `_attention_bwd_one`). Like the TPU kernel it takes only the block
// input x and the drop-path scales, recomputes the forward keeping its stash,
// then runs the reverse sweep. The cotangent at the block output may be joined
// by an extra cotangent on the feature output. It returns dx (bf16) and the
// 12 weight gradients in fp32, summed over the batch. Its fp32 form
// (`dk_fused_block_bwd_f32`) takes and returns fp32 and runs every product
// 3xTF32 on TF32 wgmma.
//
// The reverse sweep itself is `reverse_chain` (fused_block_reverse.cuh),
// shared with the block-pair backward.
//
// What bounds it on an H100: about three forwards of tensor-core work (the
// recompute up to the GELU, then two products per forward product) on the
// same 4ND-scale inputs, so the tensor cores set the floor; above it, the
// bytes of the activations that the chain carries through its workspace.
// The design puts all twelve products on the TMA + wgmma GEMM of
// gemm_sm90.cuh (the recompute's four linears and the sweep's four input
// gradients on `linear_sm90`, the four weight gradients on
// `weight_grad_kernel`), and keeps the attention's [N, N] scores on chip in
// both directions (attention_fwd.cuh with its lse for the recompute,
// attention_bwd.cuh for the sweep), so that the workspace holds per-token
// activations only. The sum over the batch, carried across a sequential grid
// on the TPU, is here a split over row ranges into fp32 partials that a
// second pass adds in a fixed order (deterministic, no atomics).

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
// Returns the first launch error, or cudaErrorInvalidValue, before any
// launch, for a shape the attention kernels do not take (head dim 64).
extern "C" int dk_fused_block_bwd(void* const* ptr, int B, int N, int D, int H, int F,
                                  float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Shape sh{B, N, D, H, F};
  if (!attention_bwd_takes(sh.hd(), N)) return (int)cudaErrorInvalidValue;
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
  return (int)reverse_chain(g_out, g_feat, s_attn, s_mlp, w, sh, f, g, dW, nullptr, dx, st);
}

// The fp32 form: x, g_out, g_feat and dx fp32, the 12 weights fp32, every
// product 3xTF32 on TF32 wgmma (fused_block_common.cuh). The same pointer table and
// return as dk_fused_block_bwd.
extern "C" size_t dk_fused_block_bwd_f32_workspace(int B, int N, int D, int H, int F) {
  Shape sh{B, N, D, H, F};
  Carver c{nullptr, 0};
  FwdBuffersT<float> f;
  f.carve(c, sh, true);
  BwdBuffersT<float> g;
  g.carve(c, sh);
  return c.off;
}

extern "C" int dk_fused_block_bwd_f32(void* const* ptr, int B, int N, int D, int H, int F,
                                      float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Shape sh{B, N, D, H, F};
  if (!attention_bwd_f32_takes(sh.hd(), N)) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)ptr[0];
  const float* s_attn = (const float*)ptr[1];
  const float* s_mlp = (const float*)ptr[2];
  const BlockWeightsT<float> w = unpack_weights<float>(ptr + 3);
  Carver c{(char*)ptr[30], 0};
  FwdBuffersT<float> f;
  f.carve(c, sh, true);
  BwdBuffersT<float> g;
  g.carve(c, sh);
  const cudaError_t err =
      forward_chain(x, s_attn, s_mlp, w, sh, eps, f, true, nullptr, nullptr, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)reverse_chain((const float*)ptr[15], (const float*)ptr[16], s_attn, s_mlp, w, sh,
                            f, g, (float* const*)(ptr + 18), (float*)ptr[17], nullptr, st);
}

// Bytes of scratch for dk_weight_grad_sm90 at (M, O, I): the row-range
// partials.
extern "C" size_t dk_weight_grad_sm90_workspace(int M, int O, int I) {
  return (size_t)weight_grad_partial_len(M, O, I) * sizeof(float);
}

// One weight gradient of the backward alone, on gemm_sm90.cuh (a kernel-only
// check; no model path calls it): out [O, I] fp32 = g^T x, g [M, O] and
// x [M, I] bf16 row-major, `partial` the workspace above. Returns the launch
// error, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int dk_weight_grad_sm90(const void* g, const void* x, int M, int O, int I,
                                   void* partial, void* out, void* stream) {
  return (int)weight_grad_sm90((const bf16*)g, (const bf16*)x, M, O, I, (float*)partial,
                               (float*)out, (cudaStream_t)stream);
}

// The fp32 form of the two above (the fp32 backward's weight gradients,
// `weight_grad_f32_kernel`, 3xTF32): g and x fp32, the same arguments.
extern "C" size_t dk_weight_grad_sm90_f32_workspace(int M, int O, int I) {
  return (size_t)weight_grad_partial_len<float>(M, O, I) * sizeof(float);
}

extern "C" int dk_weight_grad_sm90_f32(const void* g, const void* x, int M, int O, int I,
                                       void* partial, void* out, void* stream) {
  return (int)weight_grad_sm90((const float*)g, (const float*)x, M, O, I, (float*)partial,
                               (float*)out, (cudaStream_t)stream);
}
