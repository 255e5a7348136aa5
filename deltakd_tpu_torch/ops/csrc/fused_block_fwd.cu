// Fused pre-norm ViT block, forward.
//
// Replaces: deltakd_tpu/ops/fused_block.py `_fwd_kernel` (called by
// `_fused_block_fwd_call`). Computes, for x [B, N, D] bf16 and per-sample
// drop-path scales s_attn, s_mlp [B] fp32:
//   x2  = x  + s_attn * proj(attention(LN1(x)))
//   out = x2 + s_mlp * feat,   feat = fc2(gelu(fc1(LN2(x2))))
// with the optional second output `feat` (post-MLP, pre-drop-path,
// pre-residual). Matmul operands are bf16 with fp32 accumulation; LN,
// softmax, GELU (exact erff) and residuals run in fp32. Its fp32 form
// (`dk_fused_block_fwd_f32`, for x and weights in fp32, as the TPU kernel
// runs at its input's dtype) takes fp32 operands, 3xTF32 on TF32 wgmma.
//
// What bounds it on an H100: at the main-path shapes (B=256, N=198,
// D=192/384) the block is about 24ND^2 + 4N^2D FLOPs per element against
// 4ND bytes of input and output, far above the card's ~295 FLOP/byte ridge,
// so its floor is the tensor cores (989 TFLOP/s bf16). The four linear
// products (92% of the operations at D=384) run on the TMA + wgmma GEMM of
// gemm_sm90.cuh, and the attention on attention_fwd.cuh, whose [N, N] scores
// never leave the chip. What keeps it above the floor now: one element's
// block still does not fit in 227 KB of shared memory, so qkv, the merged
// heads, x2 and the [N, 4D] hidden round-trip through the workspace
// (about 20 bytes per token and unit of D, written and read once each,
// with two LayerNorm passes between the products); the GEMM itself reaches
// about half of cuBLAS's rate on these short-K products; the attention pads
// 198 keys to 256; and each product is a launch of its own, whose tail
// leaves SMs idle.

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
  return (int)forward_chain((const bf16*)ptr[0], (const float*)ptr[1], (const float*)ptr[2],
                            unpack_weights(ptr + 3), sh, eps, f, false, (bf16*)ptr[15],
                            nullptr, (bf16*)ptr[16], st);
}

// The fp32 form (rows of an fp32 model): x, out and feat fp32, the 12
// weights fp32; every product 3xTF32 on TF32 wgmma with fp32 accumulation, nothing
// rounded to bf16 (fused_block_common.cuh). The same pointer table and
// return as dk_fused_block_fwd.
extern "C" size_t dk_fused_block_fwd_f32_workspace(int B, int N, int D, int H, int F) {
  Shape sh{B, N, D, H, F};
  Carver c{nullptr, 0};
  FwdBuffersT<float> f;
  f.carve(c, sh, false);
  return c.off;
}

extern "C" int dk_fused_block_fwd_f32(void* const* ptr, int B, int N, int D, int H, int F,
                                      float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Shape sh{B, N, D, H, F};
  Carver c{(char*)ptr[17], 0};
  FwdBuffersT<float> f;
  f.carve(c, sh, false);
  return (int)forward_chain((const float*)ptr[0], (const float*)ptr[1], (const float*)ptr[2],
                            unpack_weights<float>(ptr + 3), sh, eps, f, false, nullptr,
                            (float*)ptr[15], (float*)ptr[16], st);
}

// One linear product alone, on gemm_sm90.cuh (a kernel-only check; no model
// path calls it): out = a w^T with the epilogue of `Linear`, as the forward's
// products and the backward's input gradients run it. ptr: a [M, K] bf16,
// w [N, K] bf16, then each of bias, act_grad, pre_lp, res_f32, res_bf16,
// res_scale, out_f32, out_lp, mul, col_part or null. Returns the launch
// error, or cudaErrorInvalidValue for a shape it does not take.
template <typename T>
static LinearT<T> linear_from_table(void* const* ptr, const T* w, int M, int N, int K,
                                    int scale_cols, float col_scale, int gelu,
                                    int rows_per_sample) {
  LinearT<T> l = linear_of((const T*)ptr[0], w, M, N, K);
  l.bias = (const float*)ptr[2];
  l.scale_cols = scale_cols; l.col_scale = col_scale;
  l.gelu = gelu; l.act_grad = (float*)ptr[3];
  l.pre_lp = (T*)ptr[4];
  l.res_f32 = (const float*)ptr[5]; l.res_bf16 = (const bf16*)ptr[6];
  l.res_scale = (const float*)ptr[7]; l.rows_per_sample = rows_per_sample;
  l.out_f32 = (float*)ptr[8]; l.out_lp = (T*)ptr[9];
  l.mul = (const float*)ptr[10]; l.col_part = (float*)ptr[11];
  return l;
}

extern "C" int dk_linear_sm90(void* const* ptr, int M, int N, int K, int scale_cols,
                              float col_scale, int gelu, int rows_per_sample, void* stream) {
  return (int)linear_sm90(linear_from_table(ptr, (const bf16*)ptr[1], M, N, K, scale_cols,
                                            col_scale, gelu, rows_per_sample),
                          (cudaStream_t)stream);
}

// Its fp32 form (linear_f32_kernel): a, w, pre_lp and out_lp fp32, the same
// table and one more entry, ptr[12], the workspace of
// dk_linear_sm90_f32_workspace(N, K) bytes into which w is split first
// (split_weights_tf32_kernel), as an entry point of the chains splits its
// weights.
extern "C" size_t dk_linear_sm90_f32_workspace(int N, int K) {
  return (size_t)2 * N * K * sizeof(float);
}

extern "C" int dk_linear_sm90_f32(void* const* ptr, int M, int N, int K, int scale_cols,
                                  float col_scale, int gelu, int rows_per_sample, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* w = (const float*)ptr[1];
  float* split = (float*)ptr[12];
  const long long n = (long long)N * K;
  if (K % 8) return (int)cudaErrorInvalidValue;
  const cudaError_t err = split_weights_tf32(1, &w, &split, &n, st);
  if (err != cudaSuccess) return (int)err;
  return (int)linear_sm90(linear_from_table(ptr, (const float*)ptr[12], M, N, K, scale_cols,
                                            col_scale, gelu, rows_per_sample),
                          st);
}

// The fp32 weight operand alone (a kernel-only check): w [R, C] fp32 split
// into out [2][R][C] by split_weights_tf32_kernel, or, with `transposed`,
// w^T into out [2][C][R] by the backward's transpose_kernel<float>. Takes C
// (R when transposed) a multiple of 8 and 16-byte-aligned w and out.
extern "C" int dk_tf32_split(const void* w, int R, int C, int transposed, void* out,
                             void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (R < 1 || C < 1 || (transposed ? R : C) % 8 || ((uintptr_t)w | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (transposed) {
    transpose((const float*)w, R, C, (float*)out, st);
    return (int)cudaGetLastError();
  }
  const float* src = (const float*)w;
  float* split = (float*)out;
  const long long n = (long long)R * C;
  return (int)split_weights_tf32(1, &src, &split, &n, st);
}
