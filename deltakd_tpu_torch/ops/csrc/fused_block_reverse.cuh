// The reverse sweep of one fused ViT block, shared by the single-block
// backward (fused_block_bwd.cu) and the block-pair backward
// (fused_block_pair.cu), which runs it twice.
//
// Math: deltakd_tpu/ops/fused_block.py `_block_bwd_reverse` and
// `_attention_bwd_one`. The softmax normalisations are folded into row
// scalings: with p = e * rS,
//   dv = e^T (do * rS),  t = e (dp - c),  c = rowsum(dp e) rS,
//   dq = (t k) scale rS,  dk = t^T (q scale rS).

#pragma once

#include "fused_block_common.cuh"

namespace dk {

// g_feat = g_out * s_mlp + g_feat_extra   (fp32 and bf16 copies); g_out is
// bf16 at a kernel boundary, fp32 between the two blocks of a pair
template <typename TG>
__global__ void gfeat_kernel(const TG* g_out, const bf16* g_extra, const float* s_mlp,
                             long long total, int rows_per_sample, int D, float* g32,
                             bf16* g_lp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long row = i / D;
  float v = ld(g_out + i) * s_mlp[row / rows_per_sample];
  if (g_extra) v += __bfloat162float(g_extra[i]);
  g32[i] = v;
  g_lp[i] = __float2bfloat16(v);
}

// LayerNorm backward (_ln_bwd) plus the residual cotangent:
//   dx = add + (dy*g - mean(dy*g) - xhat*mean(dy*g*xhat)) * rstd
// written as fp32/bf16, and optionally dx * row_scale[sample] as fp32/bf16.
template <typename TA>
__global__ void ln_bwd_kernel(const float* dy, const float* xhat, const float* rstd,
                              const float* g, const TA* add, int M, int D, float* out32,
                              bf16* out_lp, const float* row_scale, int rows_per_sample,
                              float* sc32, bf16* sc_lp) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
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
    const float v = ld(add + o + d) + (dy[o + d] * g[d] - m1 - xhat[o + d] * m2) * r;
    if (out32) out32[o + d] = v;
    if (out_lp) out_lp[o + d] = __float2bfloat16(v);
    if (sc32) sc32[o + d] = v * sc;
    if (sc_lp) sc_lp[o + d] = __float2bfloat16(v * sc);
  }
}

// Per (row, column) of [M, D]: do = bf16(dmerged), do*rS, and q*scale*rS
// (qkv32 already holds q*scale), with rS the row's reciprocal softmax sum.
__global__ void attn_prep_kernel(const float* dmerged, const float* qkv32, const float* rs,
                                 long long total, int N, int D, int H, bf16* do_lp,
                                 bf16* do_rs, bf16* qsr) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long row = i / D;
  const int col = (int)(i % D);
  const int h = col / (D / H);
  const long long b = row / N, n = row % N;
  const float r = rs[(b * H + h) * N + n];
  const float dm = dmerged[i];
  do_lp[i] = __float2bfloat16(dm);
  do_rs[i] = __float2bfloat16(dm * r);
  qsr[i] = __float2bfloat16(qkv32[row * 3 * D + col] * r);
}

// Per score row: c = rowsum(dp * e) * rS ; t = bf16(e * (dp - c)).
__global__ void attn_bwd_rows_kernel(const float* dp, const float* e, const float* rs,
                                     long long rows, int n, bf16* t) {
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* dpr = dp + row * n;
  const float* er = e + row * n;
  float c = 0.f;
  for (int j = lane; j < n; j += 32) c += dpr[j] * er[j];
  c = warp_sum(c) * rs[row];
  for (int j = lane; j < n; j += 32) t[row * n + j] = __float2bfloat16(er[j] * (dpr[j] - c));
}

struct BwdBuffers {
  float *gfeat32, *dhpre32, *dz, *dx2, *dattn32, *dmerged, *dp, *dqkv32, *dy;
  bf16 *gfeat_lp, *dhpre_lp, *dattn_lp, *do_lp, *do_rs, *qsr, *t, *dqkv_lp;
  float *partial, *col_partial;

  void carve(Carver& c, const Shape& sh) {
    const long long M = sh.M();
    const int D = sh.D, F = sh.F;
    gfeat32 = c.take<float>(M * D);  gfeat_lp = c.take<bf16>(M * D);
    dhpre32 = c.take<float>(M * F);  dhpre_lp = c.take<bf16>(M * F);
    dz = c.take<float>(M * D);       dx2 = c.take<float>(M * D);
    dattn32 = c.take<float>(M * D);  dattn_lp = c.take<bf16>(M * D);
    dmerged = c.take<float>(M * D);
    do_lp = c.take<bf16>(M * D);     do_rs = c.take<bf16>(M * D);
    qsr = c.take<bf16>(M * D);
    dp = c.take<float>(sh.BH() * sh.N * sh.N);
    t = c.take<bf16>(sh.BH() * sh.N * sh.N);
    dqkv32 = c.take<float>(M * 3 * D); dqkv_lp = c.take<bf16>(M * 3 * D);
    dy = c.take<float>(M * D);
    const long long widest = (long long)D * (F > 3 * D ? F : 3 * D);
    partial = c.take<float>(chunks_of(M) * widest);
    col_partial = c.take<float>((long long)chunks_of(M) * (F > 3 * D ? F : 3 * D));
  }
};

// From the stash `f` of one block's recomputed forward and the cotangent
// `g_out` at its output (bf16, or fp32 between the blocks of a pair; plus the
// optional bf16 `g_feat` on the feature output): the 12 weight gradients
// `dW` (fp32, summed over the batch, in the weights' order) and the input
// cotangent as fp32 (`dx32`) and/or bf16 (`dx`). `g` is scratch.
template <typename TG>
inline void reverse_chain(const TG* g_out, const bf16* g_feat, const float* s_attn,
                          const float* s_mlp, const BlockWeights& w, const Shape& sh,
                          FwdBuffers& f, BwdBuffers& g, float* const* dW, float* dx32,
                          bf16* dx, cudaStream_t st) {
  const int N = sh.N, D = sh.D, F = sh.F, hd = sh.hd();
  const long long M = sh.M();
  const long long BH = sh.BH();
  const float scale = 1.0f / sqrtf((float)hd);
  float *dg1 = dW[0], *db1 = dW[1], *dwqkv = dW[2], *dbqkv = dW[3], *dwproj = dW[4],
        *dbproj = dW[5], *dg2 = dW[6], *db2 = dW[7], *dw1 = dW[8], *dbf1 = dW[9],
        *dw2 = dW[10], *dbf2 = dW[11];

  // MLP: feat = h W2^T + b2
  gfeat_kernel<TG><<<blocks_of(M * D, 256), 256, 0, st>>>(g_out, g_feat, s_mlp, M * D, N,
                                                          D, g.gfeat32, g.gfeat_lp);
  weight_grad(g.gfeat_lp, f.h, (int)M, D, F, g.partial, dw2, st);
  col_sum(g.gfeat32, nullptr, (int)M, D, g.col_partial, dbf2, st);
  GemmArgs p = grad_input_args(g.gfeat_lp, w.w2, (int)M, F, D);
  p.mul = f.hgrad;
  p.out_f32 = g.dhpre32; p.out_bf16 = g.dhpre_lp;
  gemm(p, 1, st);
  weight_grad(g.dhpre_lp, f.z, (int)M, F, D, g.partial, dw1, st);
  col_sum(g.dhpre32, nullptr, (int)M, F, g.col_partial, dbf1, st);
  p = grad_input_args(g.dhpre_lp, w.w1, (int)M, D, F);
  p.out_f32 = g.dz;
  gemm(p, 1, st);

  // LN2 backward; dx2 = g_out + dLN2 ; dattn = dx2 * s_attn
  ln_bwd_kernel<TG><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      g.dz, f.xhat2, f.rstd2, w.g2, g_out, (int)M, D, g.dx2, nullptr, s_attn, N,
      g.dattn32, g.dattn_lp);
  col_sum(g.dz, f.xhat2, (int)M, D, g.col_partial, dg2, st);
  col_sum(g.dz, nullptr, (int)M, D, g.col_partial, db2, st);

  // proj: attn = merged Wproj^T + bproj
  weight_grad(g.dattn_lp, f.merged, (int)M, D, D, g.partial, dwproj, st);
  col_sum(g.dattn32, nullptr, (int)M, D, g.col_partial, dbproj, st);
  p = grad_input_args(g.dattn_lp, w.wproj, (int)M, D, D);
  p.out_f32 = g.dmerged;
  gemm(p, 1, st);

  // attention, per (element, head)
  attn_prep_kernel<<<blocks_of(M * D, 256), 256, 0, st>>>(g.dmerged, f.qkv32, f.rs, M * D, N,
                                                          D, sh.H, g.do_lp, g.do_rs, g.qsr);
  const long long zN3D = (long long)N * 3 * D, zND = (long long)N * D;
  const long long zHNN = (long long)sh.H * N * N, zNN = (long long)N * N;
  // dv = e^T (do rS)
  p = gemm_args(N, hd, N);
  p.A = f.e_lp; p.a_sm = 1; p.a_sk = N; p.a_z1 = zHNN; p.a_z2 = zNN;
  p.B = g.do_rs; p.b_sk = D; p.b_sn = 1; p.b_z1 = zND; p.b_z2 = hd;
  p.Z2 = sh.H;
  p.c_sm = 3 * D; p.c_z1 = zN3D; p.c_z2 = hd;
  p.out_f32 = g.dqkv32 + 2 * D; p.out_bf16 = g.dqkv_lp + 2 * D;
  gemm(p, (int)BH, st);
  // dp = do v^T
  p = gemm_args(N, N, hd);
  p.A = g.do_lp; p.a_sm = D; p.a_sk = 1; p.a_z1 = zND; p.a_z2 = hd;
  p.B = f.qkv_lp + 2 * D; p.b_sk = 1; p.b_sn = 3 * D; p.b_z1 = zN3D; p.b_z2 = hd;
  p.Z2 = sh.H;
  p.c_sm = N; p.c_z1 = zHNN; p.c_z2 = zNN;
  p.out_f32 = g.dp;
  gemm(p, (int)BH, st);
  attn_bwd_rows_kernel<<<row_blocks(BH * N), ROW_THREADS, 0, st>>>(g.dp, f.s, f.rs, BH * N,
                                                                  N, g.t);
  // dq = (t k) * scale * rS
  p = gemm_args(N, hd, N);
  p.A = g.t; p.a_sm = N; p.a_sk = 1; p.a_z1 = zHNN; p.a_z2 = zNN;
  p.B = f.qkv_lp + D; p.b_sk = 3 * D; p.b_sn = 1; p.b_z1 = zN3D; p.b_z2 = hd;
  p.Z2 = sh.H;
  p.c_sm = 3 * D; p.c_z1 = zN3D; p.c_z2 = hd;
  p.alpha = scale; p.row_scale = f.rs; p.rs_z = N;
  p.out_f32 = g.dqkv32; p.out_bf16 = g.dqkv_lp;
  gemm(p, (int)BH, st);
  // dk = t^T (q scale rS)
  p = gemm_args(N, hd, N);
  p.A = g.t; p.a_sm = 1; p.a_sk = N; p.a_z1 = zHNN; p.a_z2 = zNN;
  p.B = g.qsr; p.b_sk = D; p.b_sn = 1; p.b_z1 = zND; p.b_z2 = hd;
  p.Z2 = sh.H;
  p.c_sm = 3 * D; p.c_z1 = zN3D; p.c_z2 = hd;
  p.out_f32 = g.dqkv32 + D; p.out_bf16 = g.dqkv_lp + D;
  gemm(p, (int)BH, st);

  // qkv = LN1(x) Wqkv^T + bqkv
  weight_grad(g.dqkv_lp, f.y, (int)M, 3 * D, D, g.partial, dwqkv, st);
  col_sum(g.dqkv32, nullptr, (int)M, 3 * D, g.col_partial, dbqkv, st);
  p = grad_input_args(g.dqkv_lp, w.wqkv, (int)M, D, 3 * D);
  p.out_f32 = g.dy;
  gemm(p, 1, st);

  // LN1 backward; dx = dx2 + dLN1
  ln_bwd_kernel<float><<<row_blocks(M), ROW_THREADS, 0, st>>>(
      g.dy, f.xhat1, f.rstd1, w.g1, g.dx2, (int)M, D, dx32, dx, nullptr, N, nullptr,
      nullptr);
  col_sum(g.dy, f.xhat1, (int)M, D, g.col_partial, dg1, st);
  col_sum(g.dy, nullptr, (int)M, D, g.col_partial, db1, st);
}

}  // namespace dk
