// Fused pre-norm ViT block, forward.
//
// Replaces: deltakd_tpu/ops/fused_block.py `_fwd_kernel` (called by
// `_fused_block_fwd_call`). Computes, for x [B, N, D] bf16 and per-sample
// drop-path scales s_attn, s_mlp [B] fp32:
//   x2  = x  + s_attn * proj(attention(LN1(x)))
//   out = x2 + s_mlp * feat,   feat = fc2(gelu(fc1(LN2(x2))))
// with the optional second output `feat` (post-MLP, pre-drop-path,
// pre-residual). Matmul operands are bf16 with fp32 accumulation; LN,
// softmax, GELU (exact erff) and residuals run in fp32.
//
// What bounds it on an H100: at the main-path shapes (B=256, N=198,
// D=192/384) the block is about 24ND^2 + 4N^2D FLOPs per element against
// 4ND bytes of input and output, far above the card's ~295 FLOP/byte ridge,
// so its floor is the tensor cores (989 TFLOP/s bf16). This first design does
// not reach that floor: the intermediates (qkv, the [N, N] scores, the
// [N, 4D] hidden) round-trip through a global workspace because one
// element's block does not fit in 227 KB of shared memory, and the GEMM is a
// plain 64x64x32 WMMA tile without TMA, wgmma or pipelining. Those are the
// levers for a later pass; this one is right first.

#include "fused_block_common.cuh"

using namespace dk;

extern "C" size_t dk_fused_block_fwd_workspace(int B, int N, int D, int H, int F) {
  Shape sh{B, N, D, H, F};
  Carver c{nullptr, 0};
  FwdBuffers f;
  f.carve(c, sh, false);
  return c.off;
}

// ptr: x, s_attn, s_mlp, 12 weights from ptr[3] (see unpack_weights), out,
// feat|null, workspace. Returns cudaGetLastError() after the launches.
extern "C" int dk_fused_block_fwd(void* const* ptr, int B, int N, int D, int H, int F,
                                  float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Shape sh{B, N, D, H, F};
  Carver c{(char*)ptr[17], 0};
  FwdBuffers f;
  f.carve(c, sh, false);
  forward_chain((const bf16*)ptr[0], (const float*)ptr[1], (const float*)ptr[2],
                unpack_weights(ptr + 3), sh, eps, f, false, (bf16*)ptr[15], nullptr,
                (bf16*)ptr[16], st);
  return (int)cudaGetLastError();
}
