// Building blocks shared by the fused ViT block forward and backward kernels
// and the block-pair kernels (fused_block_pair.cu); the fused-MLP backward
// (fused_mlp.cu) builds on the weight-gradient sum and the weight transpose.
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
//
// The chain is written once for its operand type T: bf16, or fp32 on the
// TF32 tensor cores (the fp32 form, for an fp32 model: deltakd_tpu's kernels
// run at the input's dtype). In the fp32 form every buffer that the bf16
// form keeps in bf16 is fp32 and unrounded: nothing is rounded to bf16, and
// every product, the GEMM's (gemm_sm90.cuh) and the attention cores', is
// 3xTF32 on fp32 operands. The matmul weights are split into TF32 hi and lo
// once per call, into the workspace: forward_chain splits the four it
// multiplies by (`split_weights_tf32`), the backward's transpose writes W^T
// split; the activations are split in registers by the GEMM itself
// (`linear_f32_kernel`). Its weight gradients read G and X as they lie and
// make their K-major TF32 operands on chip (gemm_sm90.cuh
// `weight_grad_f32_kernel`), as the bf16 form reads them MN-major.

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

// A parameter of type T whose argument takes no part in deducing T.
template <typename T>
struct same { using type = T; };
template <typename T>
using same_t = typename same<T>::type;

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

// out [C, R] = in [R, C]^T, of T: an nn.Linear weight [O, I] as the K-major
// [I, O] operand of an input gradient dX = G W on linear_sm90. fp32: out is
// the split operand of linear_f32_kernel ([2][C][R]: hi = TF32(v), lo =
// TF32(v - hi), each k-step's 8 columns in tf32_key_slot order; R % 8 ==
// 0), written in the same pass.
template <typename T>
__global__ void transpose_kernel(const T* in, int R, int C, T* out) {
  __shared__ T t[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const int r = r0 + dy, c = c0 + threadIdx.x;
    if (r < R && c < C) t[dy][threadIdx.x] = in[(long long)r * C + c];
  }
  __syncthreads();
  for (int dy = threadIdx.y; dy < 32; dy += blockDim.y) {
    const int c = c0 + dy, r = r0 + threadIdx.x;
    if (r >= R || c >= C) continue;
    if constexpr (is_f32<T>) {
      const float2 x = tf32_split(t[threadIdx.x][dy]);
      const long long o = (long long)c * R + ((r & ~7) | tf32_key_slot(r & 7));
      out[o] = x.x;
      out[(long long)C * R + o] = x.y;
    } else {
      out[(long long)c * R + r] = t[threadIdx.x][dy];
    }
  }
}

template <typename T>
inline void transpose(const T* in, int R, int C, T* out, cudaStream_t st) {
  transpose_kernel<T><<<dim3(blocks_of(C, 32), blocks_of(R, 32)), dim3(32, 8), 0, st>>>(
      in, R, C, out);
}

// Elements of T of an [R, C] weight as linear_sm90's B operand
// (LinearT::w): R C in bf16, 2 R C in the fp32 form (its TF32 hi and lo).
template <typename T>
constexpr long long weight_operand_len(long long R, long long C) {
  return (is_f32<T> ? 2 : 1) * R * C;
}

// dW [O, I] = sum_m G[m, O]^T X[m, I] on the TMA + wgmma GEMM: fp32 partials
// over row ranges (gemm_sm90.cuh `weight_grad_kernel`), then their sum in
// range order. `partial` holds weight_grad_partial_len<T>(M, O, I) floats.
// G and X are read as they lie, at either operand type.
template <typename T>
inline cudaError_t weight_grad_sm90(const T* g, const T* x, int M, int O, int I, float* partial,
                                    float* out, cudaStream_t st) {
  int splits = 0;
  const cudaError_t e = weight_grad_partials_sm90(g, x, M, O, I, partial, &splits, st);
  if (e != cudaSuccess) return e;
  reduce_partials_kernel<<<blocks_of((long long)O * I, 256), 256, 0, st>>>(
      partial, splits, (long long)O * I, out);
  return cudaGetLastError();
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

// LayerNorm (two-pass fp32 statistics, like _ln_fwd): y = xhat*g + b as a
// product operand of type T (to_lp); optionally keeps xhat and rstd for the
// backward.
template <typename TX, typename T>
__global__ void ln_fwd_kernel(const TX* x, const float* g, const float* b, int M,
                              int D, float eps, T* y, float* xhat, float* rstd_out) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const TX* xr = x + (long long)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += ld(xr + d);
  const float mu = warp_sum(s) / D;
  float v = 0.f;
  for (int d = lane; d < D; d += 32) { const float c = ld(xr + d) - mu; v += c * c; }
  const float rstd = rsqrtf(warp_sum(v) / D + eps);
  for (int d = lane; d < D; d += 32) {
    const float xh = (ld(xr + d) - mu) * rstd;
    y[(long long)row * D + d] = to_lp<T>(xh * g[d] + b[d]);
    if (xhat) xhat[(long long)row * D + d] = xh;
  }
  if (rstd_out && lane == 0) rstd_out[row] = rstd;
}

// ---------------------------------------------------------------------------
// Forward chain, shared by the forward kernel and the backward's recompute.
// ---------------------------------------------------------------------------

template <typename T>
struct BlockWeightsT {
  const float *g1, *b1; const T* wqkv; const float* bqkv;
  const T* wproj; const float* bproj;
  const float *g2, *b2; const T* w1; const float* bf1;
  const T* w2; const float* bf2;
};

using BlockWeights = BlockWeightsT<bf16>;

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
template <typename T>
struct FwdBuffersT {
  T* y; T* qkv_lp; T* merged; float* x2; T* z; T* h;
  // stash (backward only)
  float *lse, *xhat1, *rstd1, *xhat2, *rstd2, *hgrad;
  // fp32: the four matmul weights (qkv, proj, fc1, fc2) split into TF32
  // parts, the products' B operands (split_weights_tf32)
  T* w_split[4];

  void carve(Carver& c, const Shape& sh, bool stash) {
    const long long M = sh.M(), D = sh.D, F = sh.F;
    y = c.take<T>(M * D);
    qkv_lp = c.take<T>(M * 3 * D);
    merged = c.take<T>(M * D);
    x2 = c.take<float>(M * D);
    z = c.take<T>(M * D);
    h = c.take<T>(M * F);
    lse = xhat1 = rstd1 = xhat2 = rstd2 = hgrad = nullptr;
    if (stash) {
      lse = c.take<float>(sh.BH() * sh.N);
      xhat1 = c.take<float>(M * sh.D);
      rstd1 = c.take<float>(M);
      xhat2 = c.take<float>(M * sh.D);
      rstd2 = c.take<float>(M);
      hgrad = c.take<float>(M * sh.F);
    }
    const long long wn[4] = {3 * D * D, D * D, F * D, D * F};
    for (int j = 0; j < 4; ++j) w_split[j] = is_f32<T> ? c.take<T>(2 * wn[j]) : nullptr;
  }
};

using FwdBuffers = FwdBuffersT<bf16>;

// The block input as the residual operand of the proj epilogue: bf16 at a
// bf16 kernel boundary, fp32 in the fp32 form and for the second block of a
// pair.
template <typename T>
inline void set_residual(LinearT<T>& p, const bf16* x) { p.res_bf16 = x; }
template <typename T>
inline void set_residual(LinearT<T>& p, const float* x) { p.res_f32 = x; }

// LN1 -> qkv -> per-head softmax(q k^T) v -> proj -> x + s_attn*attn ->
// LN2 -> fc1 -> GELU; then, when `out` or `out32` is given, fc2 ->
// x2 + s_mlp*feat, written as bf16 (`out`) and/or unrounded (`out32`, the
// activation between the two blocks of a pair). The input x is bf16 or fp32.
// In the fp32 form (T = float) `out` is null: the output goes to `out32`,
// and `feat` is written unrounded too.
// The attention is attention_fwd.cuh's (head dim 64 only) with or without
// the stash, so the recompute's `merged` has the forward's bits; the stash
// adds its lse and the LayerNorm and GELU derivatives. Returns the first
// launch error, or cudaErrorInvalidValue for a shape the kernels do not take
// (nothing after it is launched).
template <typename T, typename TX>
inline cudaError_t forward_chain(const TX* x, const float* s_attn, const float* s_mlp,
                                 BlockWeightsT<T> w, const Shape& sh, float eps,
                                 FwdBuffersT<T>& f, bool stash, same_t<T>* out, float* out32,
                                 same_t<T>* feat, cudaStream_t st) {
  const int N = sh.N, D = sh.D, H = sh.H, hd = sh.hd(), F = sh.F;
  const long long M = sh.M();
  const float scale = 1.0f / sqrtf((float)hd);
  cudaError_t err;

  if constexpr (is_f32<T>) {
    // the weights split into TF32 hi and lo once, for every row tile of their
    // products (fc2's only where it runs)
    const T* ws[4] = {w.wqkv, w.wproj, w.w1, w.w2};
    const long long wn[4] = {3LL * D * D, (long long)D * D, (long long)F * D, (long long)D * F};
    if ((err = split_weights_tf32(out || out32 ? 4 : 3, ws, f.w_split, wn, st)) != cudaSuccess)
      return err;
    w.wqkv = f.w_split[0]; w.wproj = f.w_split[1]; w.w1 = f.w_split[2]; w.w2 = f.w_split[3];
  }

  ln_fwd_kernel<TX, T><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      x, w.g1, w.b1, (int)M, D, eps, f.y, stash ? f.xhat1 : nullptr,
      stash ? f.rstd1 : nullptr);

  // qkv = y Wqkv^T + b, packed (3, H, hd); q pre-scaled by hd^-1/2
  LinearT<T> l = linear_of<T>(f.y, w.wqkv, (int)M, 3 * D, D);
  l.bias = w.bqkv; l.scale_cols = D; l.col_scale = scale;
  l.out_lp = f.qkv_lp;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;

  // merged[b, :, h] = softmax(q k^T) v, q, k, v read in place from qkv_lp
  AttnArgsT<T> a = {};
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
  l = linear_of<T>(f.merged, w.wproj, (int)M, D, D);
  l.bias = w.bproj;
  set_residual(l, x); l.res_scale = s_attn; l.rows_per_sample = N;
  l.out_f32 = f.x2;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;

  ln_fwd_kernel<float, T><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      f.x2, w.g2, w.b2, (int)M, D, eps, f.z, stash ? f.xhat2 : nullptr,
      stash ? f.rstd2 : nullptr);

  // h = gelu(z W1^T + b1)
  l = linear_of<T>(f.z, w.w1, (int)M, F, D);
  l.bias = w.bf1; l.gelu = 1;
  if (stash) l.act_grad = f.hgrad;
  l.out_lp = f.h;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;

  if (out || out32) {
    // feat = h W2^T + b2 ; out = x2 + s_mlp * feat
    l = linear_of<T>(f.h, w.w2, (int)M, D, F);
    l.bias = w.bf2;
    l.res_f32 = f.x2; l.res_scale = s_mlp; l.rows_per_sample = N;
    l.out_f32 = out32;
    l.pre_lp = feat;
    l.out_lp = out;
    if ((err = linear_sm90(l, st)) != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Unpacks one block's 12 weights from the wrapper's pointer table, `w`
// pointing at the first of them, in _weight_arrays order (g1, b1, wqkv, bqkv,
// wproj, bproj, g2, b2, w1, bf1, w2, bf2); the matmul weights of type T.
template <typename T = bf16>
inline BlockWeightsT<T> unpack_weights(void* const* w) {
  BlockWeightsT<T> r;
  r.g1 = (const float*)w[0]; r.b1 = (const float*)w[1];
  r.wqkv = (const T*)w[2]; r.bqkv = (const float*)w[3];
  r.wproj = (const T*)w[4]; r.bproj = (const float*)w[5];
  r.g2 = (const float*)w[6]; r.b2 = (const float*)w[7];
  r.w1 = (const T*)w[8]; r.bf1 = (const float*)w[9];
  r.w2 = (const T*)w[10]; r.bf2 = (const float*)w[11];
  return r;
}

}  // namespace dk
