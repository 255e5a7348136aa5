// The reverse sweep of one fused ViT block, shared by the single-block
// backward (fused_block_bwd.cu) and the block-pair backward
// (fused_block_pair.cu), which runs it twice.
//
// Math: deltakd_tpu/ops/fused_block.py `_block_bwd_reverse` and
// `_attention_bwd_one`, the attention in its flash form: from the
// recompute's lse and delta = rowsum(dO * O), attention_bwd.cuh recomputes
// the scores on chip, so no [N, N] tensor reaches the workspace. Every
// product runs on the TMA + wgmma GEMM of gemm_sm90.cuh: the four input
// gradients on `linear_sm90` against the weights transposed once per sweep,
// the four weight gradients on `weight_grad_sm90`. Like the forward chain it
// is written once for its operand type T (bf16, or fp32 in 3xTF32; the bf16
// names of the comments below read as T).

#pragma once

#include "attention_bwd.cuh"
#include "fused_block_common.cuh"

namespace dk {

// ---------------------------------------------------------------------------
// Row kernels that also sum columns (the bias and LayerNorm-gain gradients):
// a CTA of ROWS_PER_BLOCK warps takes CS_ROWS consecutive rows, each warp
// every ROWS_PER_BLOCK-th of them, one lane per 32nd column. Each warp adds
// its rows into its own [nsums][D] slice of shared memory (a lane owns its
// columns: no races), the CTA adds its warps' slices in warp order and writes
// partial[s][chunk][D]; reduce_chunks_kernel then adds the chunks in a
// fixed order. No atomics: two runs give the same bits.
// ---------------------------------------------------------------------------

constexpr int CS_ROWS = 128;

inline int cs_chunks(long long M) { return (int)((M + CS_ROWS - 1) / CS_ROWS); }

inline size_t cs_smem(int nsums, int D) {
  return (size_t)ROWS_PER_BLOCK * nsums * D * sizeof(float);
}

__device__ __forceinline__ float* cs_warp_slice(float* acc, int nsums, int D) {
  float* w = acc + (threadIdx.x / 32) * nsums * D;
  for (int i = threadIdx.x % 32; i < nsums * D; i += 32) w[i] = 0.f;
  return w;
}

__device__ __forceinline__ void cs_write(const float* acc, int nsums, int D, float* partial) {
  __syncthreads();
  const int n = nsums * D;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < ROWS_PER_BLOCK; ++w) s += acc[w * n + i];
    const int sum = i / D, d = i % D;
    partial[((long long)sum * gridDim.x + blockIdx.x) * D + d] = s;
  }
}

// out[j] = sum over c of partial[c * len + j], for a short row of many
// chunks: a CTA of ROWS_PER_BLOCK warps takes 32 columns, warp w adds chunks
// w, w + ROWS_PER_BLOCK, ... in order, then the CTA adds its warps in order.
__global__ void reduce_chunks_kernel(const float* partial, int chunks, int len, float* out) {
  __shared__ float part[ROWS_PER_BLOCK][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < len)
    for (int c = warp; c < chunks; c += ROWS_PER_BLOCK) s += partial[(long long)c * len + j];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < len) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < ROWS_PER_BLOCK; ++w) t += part[w][lane];
    out[j] = t;
  }
}

inline void reduce_chunks(const float* partial, int chunks, int len, float* out,
                          cudaStream_t st) {
  reduce_chunks_kernel<<<blocks_of(len, 32), ROW_THREADS, 0, st>>>(partial, chunks, len, out);
}

// out_s[d] = sum over the chunks of partial[s][chunk][d], in chunk order.
inline void cs_reduce(const float* partial, int chunks, int D, int s, float* out,
                      cudaStream_t st) {
  reduce_chunks(partial + (long long)s * chunks * D, chunks, D, out, st);
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// after the opt-in; at D = 1024 three sums take 96 KB).
template <typename K>
inline cudaError_t cs_opt_in(K kernel, size_t bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
             : cudaSuccess;
}

// g_feat = g_out * s_mlp + g_feat_extra as a product operand (to_lp), and
// its column sums (the fc2 bias gradient) in partial[0]; g_out is bf16 at a
// bf16 kernel boundary, fp32 in the fp32 form and between the two blocks of a
// pair
template <typename TG, typename T>
__global__ void gfeat_kernel(const TG* g_out, const T* g_extra, const float* s_mlp, int M,
                             int rows_per_sample, int D, T* g_lp, float* partial) {
  extern __shared__ float cs_acc[];
  float* acc = cs_warp_slice(cs_acc, 1, D);
  const int r0 = blockIdx.x * CS_ROWS, r1 = min(M, r0 + CS_ROWS);
  for (int r = r0 + threadIdx.x / 32; r < r1; r += ROWS_PER_BLOCK) {
    const float sc = s_mlp[r / rows_per_sample];
    for (int d = threadIdx.x % 32; d < D; d += 32) {
      const long long i = (long long)r * D + d;
      float v = ld(g_out + i) * sc;
      if (g_extra) v += ld(g_extra + i);
      g_lp[i] = to_lp<T>(v);
      acc[d] += v;
    }
  }
  cs_write(cs_acc, 1, D, partial);
}

// LayerNorm backward (_ln_bwd) plus the residual cotangent:
//   dx = add + (dy*g - mean(dy*g) - xhat*mean(dy*g*xhat)) * rstd
// written as fp32 and/or as a product operand (to_lp), and with a row_scale
// also dx * row_scale[sample] as one; the column sums of dy*xhat (the gain gradient), dy (the bias
// gradient) and, with a row_scale, dx * row_scale (the bias gradient of the
// branch before it) in partial[0], [1], [2].
template <typename TA, typename T>
__global__ void ln_bwd_kernel(const float* dy, const float* xhat, const float* rstd,
                              const float* g, const TA* add, int M, int D, float* out32,
                              T* out_lp, const float* row_scale, int rows_per_sample,
                              T* sc_lp, float* partial) {
  extern __shared__ float cs_acc[];
  const int nsums = row_scale ? 3 : 2;
  float* acc = cs_warp_slice(cs_acc, nsums, D);
  const int lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * CS_ROWS, r1 = min(M, r0 + CS_ROWS);
  for (int row = r0 + threadIdx.x / 32; row < r1; row += ROWS_PER_BLOCK) {
    const long long o = (long long)row * D;
    float m1 = 0.f, m2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float dxh = dy[o + d] * g[d];
      m1 += dxh;
      m2 += dxh * xhat[o + d];
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
    const float r = rstd[row];
    const float sc = row_scale ? row_scale[row / rows_per_sample] : 0.f;
    for (int d = lane; d < D; d += 32) {
      const float dyv = dy[o + d], xh = xhat[o + d];
      const float v = ld(add + o + d) + (dyv * g[d] - m1 - xh * m2) * r;
      if (out32) out32[o + d] = v;
      if (out_lp) out_lp[o + d] = to_lp<T>(v);
      acc[d] += dyv * xh;
      acc[D + d] += dyv;
      if (row_scale) {
        sc_lp[o + d] = to_lp<T>(v * sc);
        acc[2 * D + d] += v * sc;
      }
    }
  }
  cs_write(cs_acc, nsums, D, partial);
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// delta[b, h, n] = sum over the head's 64 columns of dO * O, one warp per
// (row, head); dO and O [M, D] of T, delta [B*H, N] fp32.
template <typename T>
__global__ void attn_delta_kernel(const T* dout, const T* o, long long M, int N, int D, int H,
                                  float* delta) {
  const long long w = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= M * H) return;
  const long long row = w / H;
  const int h = (int)(w % H);
  const long long i = row * D + h * 64 + 2 * lane;
  const float2 a = ld2(dout + i);
  const float2 b = ld2(o + i);
  const float s = warp_sum(a.x * b.x + a.y * b.y);
  if (lane == 0) delta[(row / N * H + h) * N + row % N] = s;
}

// fp32 elements of the partials of the widest weight gradient.
template <typename T>
inline long long wgrad_partial_len(const Shape& sh) {
  const int M = (int)sh.M(), D = sh.D, F = sh.F;
  const long long a = weight_grad_partial_len<T>(M, D, F), b = weight_grad_partial_len<T>(M, F, D);
  const long long c = weight_grad_partial_len<T>(M, D, D),
                  d = weight_grad_partial_len<T>(M, 3 * D, D);
  const long long ab = a > b ? a : b, cd = c > d ? c : d;
  return ab > cd ? ab : cd;
}

// fp32 elements of the largest set of column-sum partials: three sums over
// the row chunks of the LayerNorm backward, the fc2 input gradient's per
// 128-row tile, or the attention backward's per element.
inline long long colsum_partial_len(const Shape& sh) {
  const long long a = 3LL * cs_chunks(sh.M()) * sh.D;
  const long long b = (long long)linear_row_tiles((int)sh.M()) * sh.F;
  const long long c = 3LL * sh.B * sh.D;
  const long long ab = a > b ? a : b;
  return ab > c ? ab : c;
}

// The sweep's own buffers: the cotangents it carries between its kernels
// (of T where only a product reads them, fp32 where a LayerNorm backward
// does), the four matmul weights transposed ([I, O], K-major for
// linear_sm90; fp32: split into TF32 hi and lo by the transpose), and the
// partials of the weight and column sums. The attention backward's workspace
// (attention_bwd.cuh: `attention_bwd_f32_workspace` in the fp32 form,
// `attention_bwd_workspace` in bf16, which is empty up to N = 256 and above
// it holds the split route's column-sum partials) shares its slice with
// dhpre, which is dead from the fc1 input gradient on; the slice is the
// larger of the two.
template <typename T>
struct BwdBuffersT {
  float *dz, *dx2, *delta, *dy;
  T *gfeat_lp, *dhpre_lp, *dattn_lp, *do_lp, *dqkv_lp;
  T *wqkv_t, *wproj_t, *w1_t, *w2_t;
  float *attn_work;
  float *partial, *col_partial;

  void carve(Carver& c, const Shape& sh) {
    const long long M = sh.M();
    const int D = sh.D, F = sh.F;
    gfeat_lp = c.take<T>(M * D);
    const long long dh = M * F * (long long)sizeof(T);
    const long long aw = (long long)(is_f32<T> ? attention_bwd_f32_workspace(sh.B, sh.H, sh.N)
                                               : attention_bwd_workspace(sh.B, sh.H, sh.N));
    dhpre_lp = reinterpret_cast<T*>(c.take<char>(dh > aw ? dh : aw));
    attn_work = reinterpret_cast<float*>(dhpre_lp);
    dz = c.take<float>(M * D);       dx2 = c.take<float>(M * D);
    dattn_lp = c.take<T>(M * D);
    do_lp = c.take<T>(M * D);
    delta = c.take<float>(sh.BH() * sh.N);
    dqkv_lp = c.take<T>(M * 3 * D);
    dy = c.take<float>(M * D);
    wqkv_t = c.take<T>(weight_operand_len<T>(D, 3 * D));
    wproj_t = c.take<T>(weight_operand_len<T>(D, D));
    w1_t = c.take<T>(weight_operand_len<T>(D, F));
    w2_t = c.take<T>(weight_operand_len<T>(F, D));
    partial = c.take<float>(wgrad_partial_len<T>(sh));
    col_partial = c.take<float>(colsum_partial_len(sh));
  }
};

using BwdBuffers = BwdBuffersT<bf16>;

// From the stash `f` of one block's recomputed forward and the cotangent
// `g_out` at its output (bf16, or fp32 in the fp32 form and between the
// blocks of a pair; plus the optional `g_feat` of T on the feature output):
// the 12 weight gradients `dW` (fp32, summed over the batch, in the weights'
// order) and the input cotangent as fp32 (`dx32`) and/or as T (`dx`,
// rounded as a product operand). `g` is scratch. Returns the first launch
// error (nothing after it is launched).
template <typename T, typename TG>
inline cudaError_t reverse_chain(const TG* g_out, const same_t<T>* g_feat, const float* s_attn,
                                 const float* s_mlp, const BlockWeightsT<T>& w, const Shape& sh,
                                 FwdBuffersT<T>& f, BwdBuffersT<T>& g, float* const* dW,
                                 float* dx32, same_t<T>* dx, cudaStream_t st) {
  const int N = sh.N, D = sh.D, F = sh.F, H = sh.H, hd = sh.hd();
  const int M = (int)sh.M();
  const float scale = 1.0f / sqrtf((float)hd);
  float *dg1 = dW[0], *db1 = dW[1], *dwqkv = dW[2], *dbqkv = dW[3], *dwproj = dW[4],
        *dbproj = dW[5], *dg2 = dW[6], *db2 = dW[7], *dw1 = dW[8], *dbf1 = dW[9],
        *dw2 = dW[10], *dbf2 = dW[11];
  cudaError_t err;

  // the weights as the K-major operands of the input gradients
  transpose(w.wqkv, 3 * D, D, g.wqkv_t, st);
  transpose(w.wproj, D, D, g.wproj_t, st);
  transpose(w.w1, F, D, g.w1_t, st);
  transpose(w.w2, D, F, g.w2_t, st);

  // MLP: feat = h W2^T + b2; dhpre = (g_feat W2) * gelu', its column sums
  // per 128-row tile from the GEMM's epilogue
  const int chunks = cs_chunks(M);
  if ((err = cs_opt_in(gfeat_kernel<TG, T>, cs_smem(1, D))) != cudaSuccess) return err;
  gfeat_kernel<TG, T><<<chunks, ROW_THREADS, cs_smem(1, D), st>>>(
      g_out, g_feat, s_mlp, M, N, D, g.gfeat_lp, g.col_partial);
  cs_reduce(g.col_partial, chunks, D, 0, dbf2, st);
  if ((err = weight_grad_sm90(g.gfeat_lp, f.h, M, D, F, g.partial, dw2, st)) != cudaSuccess)
    return err;
  LinearT<T> l = linear_of<T>(g.gfeat_lp, g.w2_t, M, F, D);
  l.mul = f.hgrad; l.col_part = g.col_partial;
  l.out_lp = g.dhpre_lp;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;
  cs_reduce(g.col_partial, linear_row_tiles(M), F, 0, dbf1, st);
  if ((err = weight_grad_sm90(g.dhpre_lp, f.z, M, F, D, g.partial, dw1, st)) != cudaSuccess)
    return err;
  l = linear_of<T>(g.dhpre_lp, g.w1_t, M, D, F);
  l.out_f32 = g.dz;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;

  // LN2 backward; dx2 = g_out + dLN2 ; dattn = dx2 * s_attn; the sums of
  // the LN2 gain and bias and the proj bias
  if ((err = cs_opt_in(ln_bwd_kernel<TG, T>, cs_smem(3, D))) != cudaSuccess) return err;
  ln_bwd_kernel<TG, T><<<chunks, ROW_THREADS, cs_smem(3, D), st>>>(
      g.dz, f.xhat2, f.rstd2, w.g2, g_out, M, D, g.dx2, nullptr, s_attn, N, g.dattn_lp,
      g.col_partial);
  cs_reduce(g.col_partial, chunks, D, 0, dg2, st);
  cs_reduce(g.col_partial, chunks, D, 1, db2, st);
  cs_reduce(g.col_partial, chunks, D, 2, dbproj, st);

  // proj: attn = merged Wproj^T + bproj; dO = dattn Wproj
  if ((err = weight_grad_sm90(g.dattn_lp, f.merged, M, D, D, g.partial, dwproj, st)) !=
      cudaSuccess)
    return err;
  l = linear_of<T>(g.dattn_lp, g.wproj_t, M, D, D);
  l.out_lp = g.do_lp;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;

  // attention, per (element, head): dq (times the q-column scale), dk, dv
  // straight into the q, k, v columns of dqkv, their column sums per element
  attn_delta_kernel<T><<<row_blocks((long long)M * H), ROW_THREADS, 0, st>>>(
      g.do_lp, f.merged, M, N, D, H, g.delta);
  AttnBwdArgsT<T> a = {};
  a.q = f.qkv_lp; a.k = f.qkv_lp + D; a.v = f.qkv_lp + 2 * D; a.dout = g.do_lp;
  a.q_sb = a.k_sb = a.v_sb = (long long)N * 3 * D;
  a.q_sh = a.k_sh = a.v_sh = hd;
  a.q_sn = a.k_sn = a.v_sn = 3 * D;
  a.d_sb = (long long)N * D; a.d_sh = hd; a.d_sn = D;
  a.lse = f.lse; a.delta = g.delta;
  a.dq = g.dqkv_lp; a.dk = g.dqkv_lp + D; a.dv = g.dqkv_lp + 2 * D;
  a.g_sb = (long long)N * 3 * D; a.g_sh = hd; a.g_sn = 3 * D;
  a.colsum = g.col_partial; a.cs_b = 3 * D; a.cs_part = D;
  a.scale = 1.0f;   // q arrives scaled
  a.dq_scale = scale;
  a.B = sh.B; a.H = H; a.N = N;
  if ((err = attention_bwd(a, hd, g.attn_work, st)) != cudaSuccess) return err;
  reduce_chunks(g.col_partial, sh.B, 3 * D, dbqkv, st);

  // qkv = LN1(x) Wqkv^T + bqkv
  if ((err = weight_grad_sm90(g.dqkv_lp, f.y, M, 3 * D, D, g.partial, dwqkv, st)) !=
      cudaSuccess)
    return err;
  l = linear_of<T>(g.dqkv_lp, g.wqkv_t, M, D, 3 * D);
  l.out_f32 = g.dy;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return err;

  // LN1 backward; dx = dx2 + dLN1; the sums of the LN1 gain and bias
  if ((err = cs_opt_in(ln_bwd_kernel<float, T>, cs_smem(2, D))) != cudaSuccess) return err;
  ln_bwd_kernel<float, T><<<chunks, ROW_THREADS, cs_smem(2, D), st>>>(
      g.dy, f.xhat1, f.rstd1, w.g1, g.dx2, M, D, dx32, dx, nullptr, N, nullptr, g.col_partial);
  cs_reduce(g.col_partial, chunks, D, 0, dg1, st);
  cs_reduce(g.col_partial, chunks, D, 1, db1, st);
  return cudaGetLastError();
}

}  // namespace dk
