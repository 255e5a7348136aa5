// Building blocks shared by the fused ViT block forward and backward kernels
// and the block-pair kernels (fused_block_pair.cu); the fused-MLP backward
// (fused_mlp.cu) builds on the weight-gradient sum and the transpose.
//
// The TPU kernels (deltakd_tpu/ops/fused_block.py `_fwd_kernel`,
// `_bwd_kernel`) keep one batch element's whole block in 16+ MB of VMEM. An
// H100 thread block has at most 227 KB of shared memory, and the teacher's
// [198, 1536] hidden alone is about 600 KB in bf16, so this port runs the
// block as a short chain of hand-written kernels launched by one C entry
// point, with per-element intermediates (qkv, the hidden) in a global-memory
// workspace the wrapper allocates:
//
//   LN -> qkv, proj, fc1, fc2: the TMA + wgmma GEMM of gemm_sm90.cuh with a
//         fused epilogue (bias, q's scaling, erf-GELU, drop-path-scaled
//         residual)
//   attention: attention_fwd.cuh, the scores stay on chip; the backward's
//         recompute runs the same kernel and keeps its row statistic lse
//
// What bounds the chain on an H100: the tensor cores for its products (a few
// hundred operations a byte), and the bytes of the intermediates that the
// workspace carries between its kernels (about 20 bytes per token and unit
// of D in the forward; about 80 in the backward, its stash and its sweep's
// cotangents). The design keeps every [N, N] score tile on chip, puts every
// product on the TMA + wgmma GEMM, and takes the bias and LayerNorm-gain
// gradients (column sums) inside the passes that already hold their operands
// rather than from fp32 copies of them.
//
// Sums over all rows (weight and bias gradients) are fp32 partials over row
// ranges, added in a fixed order by a second pass: no atomics, two runs give
// the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd.cuh"
#include "gemm_sm90.cuh"

namespace dk {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ld(const float* p) { return *p; }

// ---------------------------------------------------------------------------
// Sums over all rows (weight gradients): fp32 partials per row range, then a
// second pass that adds them in range order. Deterministic; no atomics.
// ---------------------------------------------------------------------------

// out[j] = sum_c partial[c, j], in range order.
__global__ void reduce_partials_kernel(const float* partial, int chunks, long long len,
                                       float* out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[c * len + j];
  out[j] = s;
}

inline int blocks_of(long long n, int t) { return (int)((n + t - 1) / t); }

// dW [O, I] = sum_m G[m, O]^T X[m, I] on the TMA + wgmma GEMM: fp32 partials
// over row ranges (gemm_sm90.cuh `weight_grad_kernel`), then their sum in
// range order. `partial` holds weight_grad_partial_len(M, O, I) floats.
inline cudaError_t weight_grad_sm90(const bf16* g, const bf16* x, int M, int O, int I,
                                    float* partial, float* out, cudaStream_t st) {
  int splits = 0;
  const cudaError_t e = weight_grad_partials_sm90(g, x, M, O, I, partial, &splits, st);
  if (e != cudaSuccess) return e;
  reduce_partials_kernel<<<blocks_of((long long)O * I, 256), 256, 0, st>>>(
      partial, splits, (long long)O * I, out);
  return cudaGetLastError();
}

// out [C, R] = in [R, C]^T, bf16: an nn.Linear weight [O, I] as the K-major
// [I, O] operand of an input gradient dX = G W on linear_sm90.
__global__ void transpose_kernel(const bf16* in, int R, int C, bf16* out) {
  __shared__ bf16 t[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const int r = r0 + dy, c = c0 + threadIdx.x;
    if (r < R && c < C) t[dy][threadIdx.x] = in[(long long)r * C + c];
  }
  __syncthreads();
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const int c = c0 + dy, r = r0 + threadIdx.x;
    if (r < R && c < C) out[(long long)c * R + r] = t[threadIdx.x][dy];
  }
}

inline void transpose(const bf16* in, int R, int C, bf16* out, cudaStream_t st) {
  transpose_kernel<<<dim3(blocks_of(C, 32), blocks_of(R, 32)), dim3(32, 8), 0, st>>>(in, R, C,
                                                                                   out);
}

// ---------------------------------------------------------------------------
// Row kernels: one warp per row.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int ROW_THREADS = 256, ROWS_PER_BLOCK = ROW_THREADS / 32;

inline int row_blocks(long long rows) {
  return (int)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
}

// LayerNorm (two-pass fp32 statistics, like _ln_fwd): y = xhat*g + b in bf16;
// optionally keeps xhat and rstd for the backward.
template <typename T>
__global__ void ln_fwd_kernel(const T* x, const float* g, const float* b, int M,
                              int D, float eps, bf16* y, float* xhat, float* rstd_out) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (long long)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += ld(xr + d);
  const float mu = warp_sum(s) / D;
  float v = 0.f;
  for (int d = lane; d < D; d += 32) { const float c = ld(xr + d) - mu; v += c * c; }
  const float rstd = rsqrtf(warp_sum(v) / D + eps);
  for (int d = lane; d < D; d += 32) {
    const float xh = (ld(xr + d) - mu) * rstd;
    y[(long long)row * D + d] = __float2bfloat16(xh * g[d] + b[d]);
    if (xhat) xhat[(long long)row * D + d] = xh;
  }
  if (rstd_out && lane == 0) rstd_out[row] = rstd;
}

// ---------------------------------------------------------------------------
// Forward chain, shared by the forward kernel and the backward's recompute.
// ---------------------------------------------------------------------------

struct BlockWeights {
  const float *g1, *b1; const bf16* wqkv; const float* bqkv;
  const bf16* wproj; const float* bproj;
  const float *g2, *b2; const bf16* w1; const float* bf1;
  const bf16* w2; const float* bf2;
};

struct Shape {
  int B, N, D, H, F;
  long long M() const { return (long long)B * N; }
  int hd() const { return D / H; }
  long long BH() const { return (long long)B * H; }
};

// Bump allocator over the wrapper's workspace (256-byte aligned slices).
struct Carver {
  char* base; size_t off;
  template <typename T> T* take(long long n) {
    T* ptr = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += ((size_t)n * sizeof(T) + 255) / 256 * 256;
    return ptr;
  }
};

// Intermediates of one block forward. The forward kernel keeps the first
// group; the backward's recompute also keeps the stash group: the attention's
// row statistic lse [B*H, N] and the LayerNorm and GELU derivatives, no
// [N, N] scores.
struct FwdBuffers {
  bf16* y; bf16* qkv_lp; bf16* merged; float* x2; bf16* z; bf16* h;
  // stash (backward only)
  float *lse, *xhat1, *rstd1, *xhat2, *rstd2, *hgrad;

  void carve(Carver& c, const Shape& sh, bool stash) {
    const long long M = sh.M();
    y = c.take<bf16>(M * sh.D);
    qkv_lp = c.take<bf16>(M * 3 * sh.D);
    merged = c.take<bf16>(M * sh.D);
    x2 = c.take<float>(M * sh.D);
    z = c.take<bf16>(M * sh.D);
    h = c.take<bf16>(M * sh.F);
    lse = xhat1 = rstd1 = xhat2 = rstd2 = hgrad = nullptr;
    if (stash) {
      lse = c.take<float>(sh.BH() * sh.N);
      xhat1 = c.take<float>(M * sh.D);
      rstd1 = c.take<float>(M);
      xhat2 = c.take<float>(M * sh.D);
      rstd2 = c.take<float>(M);
      hgrad = c.take<float>(M * sh.F);
    }
  }
};

// The block input as the residual operand of the proj epilogue: bf16 at a
// kernel boundary, fp32 for the second block of a pair.
inline void set_residual(Linear& p, const bf16* x) { p.res_bf16 = x; }
inline void set_residual(Linear& p, const float* x) { p.res_f32 = x; }

// LN1 -> qkv -> per-head softmax(q k^T) v -> proj -> x + s_attn*attn ->
// LN2 -> fc1 -> GELU; then, when `out` or `out32` is given, fc2 ->
// x2 + s_mlp*feat, written as bf16 (`out`) and/or unrounded (`out32`, the
// activation between the two blocks of a pair). The input x is bf16 or fp32.
// The attention is attention_fwd.cuh's (head dim 64 only) with or without
// the stash, so the recompute's `merged` has the forward's bits; the stash
// adds its lse and the LayerNorm and GELU derivatives. Returns the first
// launch error, or cudaErrorInvalidValue for a shape the kernels do not take
// (nothing after it is launched).
template <typename TX>
inline cudaError_t forward_chain(const TX* x, const float* s_attn, const float* s_mlp,
                                 const BlockWeights& w, const Shape& sh, float eps,
                                 FwdBuffers& f, bool stash, bf16* out, float* out32,
                                 bf16* feat, cudaStream_t st) {
  const int N = sh.N, D = sh.D, H = sh.H, hd = sh.hd(), F = sh.F;
  const long long M = sh.M();
  const float scale = 1.0f / sqrtf((float)hd);
  cudaError_t err;

  ln_fwd_kernel<TX><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      x, w.g1, w.b1, (int)M, D, eps, f.y, stash ? f.xhat1 : nullptr,
      stash ? f.rstd1 : nullptr);

  // qkv = y Wqkv^T + b, packed (3, H, hd); q pre-scaled by hd^-1/2
  Linear l = linear_of(f.y, w.wqkv, (int)M, 3 * D, D);
  l.bias = w.bqkv; l.scale_cols = D; l.col_scale = scale;
  l.out_bf16 = f.qkv_lp;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;

  // merged[b, :, h] = softmax(q k^T) v, q, k, v read in place from qkv_lp
  AttnArgs a = {};
  a.q = f.qkv_lp; a.k = f.qkv_lp + D; a.v = f.qkv_lp + 2 * D;
  a.q_sb = a.k_sb = a.v_sb = (long long)N * 3 * D;
  a.q_sh = a.k_sh = a.v_sh = hd;
  a.q_sn = a.k_sn = a.v_sn = 3 * D;
  a.o = f.merged; a.o_sb = (long long)N * D; a.o_sh = hd; a.o_sn = D;
  a.lse = stash ? f.lse : nullptr;
  a.B = sh.B; a.H = H; a.N = N;
  a.scale = 1.0f;
  if ((err = attention_fwd(a, hd, st)) != cudaSuccess) return err;

  // x2 = x + s_attn * (merged Wproj^T + b)
  l = linear_of(f.merged, w.wproj, (int)M, D, D);
  l.bias = w.bproj;
  set_residual(l, x); l.res_scale = s_attn; l.rows_per_sample = N;
  l.out_f32 = f.x2;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;

  ln_fwd_kernel<float><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      f.x2, w.g2, w.b2, (int)M, D, eps, f.z, stash ? f.xhat2 : nullptr,
      stash ? f.rstd2 : nullptr);

  // h = gelu(z W1^T + b1)
  l = linear_of(f.z, w.w1, (int)M, F, D);
  l.bias = w.bf1; l.gelu = 1;
  if (stash) l.act_grad = f.hgrad;
  l.out_bf16 = f.h;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;

  if (out || out32) {
    // feat = h W2^T + b2 ; out = x2 + s_mlp * feat
    l = linear_of(f.h, w.w2, (int)M, D, F);
    l.bias = w.bf2; l.pre_bf16 = feat;
    l.res_f32 = f.x2; l.res_scale = s_mlp; l.rows_per_sample = N;
    l.out_bf16 = out; l.out_f32 = out32;
    if ((err = linear_sm90(l, st)) != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Unpacks one block's 12 weights from the wrapper's pointer table, `w`
// pointing at the first of them, in _weight_arrays order (g1, b1, wqkv, bqkv,
// wproj, bproj, g2, b2, w1, bf1, w2, bf2).
inline BlockWeights unpack_weights(void* const* w) {
  BlockWeights r;
  r.g1 = (const float*)w[0]; r.b1 = (const float*)w[1];
  r.wqkv = (const bf16*)w[2]; r.bqkv = (const float*)w[3];
  r.wproj = (const bf16*)w[4]; r.bproj = (const float*)w[5];
  r.g2 = (const float*)w[6]; r.b2 = (const float*)w[7];
  r.w1 = (const bf16*)w[8]; r.bf1 = (const float*)w[9];
  r.w2 = (const bf16*)w[10]; r.bf2 = (const float*)w[11];
  return r;
}

}  // namespace dk
