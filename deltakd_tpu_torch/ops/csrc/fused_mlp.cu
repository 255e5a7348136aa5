// Fused transformer MLP (fc1 -> erf-GELU -> fc2), forward and recompute
// backward.
//
// Replaces: deltakd_tpu/ops/fused_mlp.py `_mlp_kernel` (called by `fused_mlp`)
// and `_mlp_bwd_kernel` (called by `_fused_mlp_bwd_call`). With x [M, D] and
// nn.Linear weights W1 [F, D], W2 [D, F]:
//
//   forward   h = gelu(x W1^T + b1) rounded to bf16, o = h W2^T + b2
//   backward  hpre and h recomputed from x; dh = dy W2, dhpre = dh gelu'(hpre),
//             dx = dhpre W1, dW1 = dhpre^T x, dW2 = h^T dy,
//             db1 = colsum(dhpre), db2 = colsum(dy)        (fp32 sums)
//
// What bounds it on an H100: operations. 4 M D F operations on 2 M D bf16 of
// input and output are some 1500 operations a byte at D = 384, far above the
// card's 295, provided the [M, F] hidden never reaches device memory (it is
// four times the input). The TPU kernel holds a 256-row tile's whole hidden in
// VMEM; at 227 KB a block cannot, so the forward chunks the hidden axis:
//
// * forward: a block takes 64 rows of x (32 or 16 for wide models) into
//   shared memory and holds their [64, D] fp32 output tile there. For each
//   chunk of 128 hidden units it computes gelu(x W1_c^T + b1_c), rounds it to
//   bf16 into a [64, 128] shared tile, and adds h_c W2_c^T to the output tile.
//   The hidden exists only as that tile. Weight fragments are read straight
//   from device memory (the two matrices stay in L2). The last row tile is
//   masked: x is not padded.
// * backward: a chain of kernels behind one entry point, as the fused block's
//   backward: the shared tiled GEMM with fused epilogues computes every
//   product, reading W2 and W1 untransposed through strides; h, gelu'(hpre)
//   and dhpre pass through a workspace; the sums over all rows are fp32
//   partials per 512-row chunk added in chunk order by a second pass
//   (deterministic, no atomics; on the TPU they are carried across a
//   sequential grid).
//
// GELU uses erff (the TPU kernel a polynomial erf within 1.5e-7 of it).

#include "fused_block_common.cuh"

using namespace dk;

namespace {

constexpr int FC = 128;            // hidden chunk of the forward
constexpr int LDH = FC + 8;        // bf16 row stride of the hidden tile
constexpr int MLP_THREADS = 256, MLP_WARPS = 8;
constexpr int MAX_RT = 4;          // row tiles of 16 a block (BM = 64)
constexpr int MAX_SMEM = 232448;   // 227 KB

inline size_t fwd_smem(int BM, int D) {
  return (size_t)BM * ((D + 8) * sizeof(bf16) + LDH * sizeof(bf16) + (D + 4) * sizeof(float))
         + (size_t)MLP_WARPS * 256 * sizeof(float);
}

// The most rows (64, 32 or 16) whose tiles fit one block; 0 if none does.
inline int fwd_rows(int D) {
  for (int BM = 16 * MAX_RT; BM >= 16; BM /= 2)
    if (fwd_smem(BM, D) <= (size_t)MAX_SMEM) return BM;
  return 0;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__global__ void __launch_bounds__(MLP_THREADS)
mlp_fwd_kernel(const bf16* x, const bf16* w1, const float* b1, const bf16* w2, const float* b2,
               bf16* out, int M, int D, int F, int BM) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, RT = BM / 16;
  const int ldX = D + 8, ldO = D + 4;

  bf16* Xs = reinterpret_cast<bf16*>(smem);
  bf16* Hs = Xs + BM * ldX;
  float* Os = reinterpret_cast<float*>(Hs + BM * LDH);
  float* scr = Os + BM * ldO + warp * 256;

  // x tile, 16 bytes a thread; rows at or beyond M are zero
  for (int i = tid; i < BM * (D / 8); i += MLP_THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * D + c);
    *reinterpret_cast<uint4*>(Xs + r * ldX + c) = v;
  }
  for (int i = tid; i < BM * D; i += MLP_THREADS) Os[(i / D) * ldO + i % D] = b2[i % D];
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += FC) {
    const int nct = min(FC, F - f0) / 16;
    // h_c = gelu(x W1_c^T + b1_c): a warp owns 16 hidden units, every row tile
    for (int ct = warp; ct < nct; ct += MLP_WARPS) {
      FragC acc[MAX_RT];
#pragma unroll
      for (int rt = 0; rt < MAX_RT; ++rt) wmma::fill_fragment(acc[rt], 0.0f);
      const bf16* wrow = w1 + (long long)(f0 + ct * 16) * D;
      for (int k0 = 0; k0 < D; k0 += 16) {
        FragBT wb;   // (W1^T)[d][f] = W1[f][d]
        wmma::load_matrix_sync(wb, wrow + k0, D);
#pragma unroll
        for (int rt = 0; rt < MAX_RT; ++rt) {
          if (rt < RT) {
            FragA xa;
            wmma::load_matrix_sync(xa, Xs + rt * 16 * ldX + k0, ldX);
            wmma::mma_sync(acc[rt], xa, wb, acc[rt]);
          }
        }
      }
#pragma unroll
      for (int rt = 0; rt < MAX_RT; ++rt) {
        if (rt < RT) {
          wmma::store_matrix_sync(scr, acc[rt], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int r = e / 16, c = e % 16;
            const float hpre = scr[e] + b1[f0 + ct * 16 + c];
            Hs[(rt * 16 + r) * LDH + ct * 16 + c] = __float2bfloat16(gelu_erf(hpre));
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    // out tile += h_c W2_c^T: a warp owns 16 output columns, every row tile
    for (int ct = warp; ct < D / 16; ct += MLP_WARPS) {
      FragC acc[MAX_RT];
#pragma unroll
      for (int rt = 0; rt < MAX_RT; ++rt)
        if (rt < RT)
          wmma::load_matrix_sync(acc[rt], Os + rt * 16 * ldO + ct * 16, ldO,
                                 wmma::mem_row_major);
      const bf16* wrow = w2 + (long long)(ct * 16) * F + f0;
      for (int kk = 0; kk < nct; ++kk) {
        FragBT wb;   // (W2^T)[f][d] = W2[d][f]
        wmma::load_matrix_sync(wb, wrow + kk * 16, F);
#pragma unroll
        for (int rt = 0; rt < MAX_RT; ++rt) {
          if (rt < RT) {
            FragA ha;
            wmma::load_matrix_sync(ha, Hs + rt * 16 * LDH + kk * 16, LDH);
            wmma::mma_sync(acc[rt], ha, wb, acc[rt]);
          }
        }
      }
#pragma unroll
      for (int rt = 0; rt < MAX_RT; ++rt)
        if (rt < RT)
          wmma::store_matrix_sync(Os + rt * 16 * ldO + ct * 16, acc[rt], ldO,
                                  wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int i = tid; i < BM * (D / 2); i += MLP_THREADS) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    if (m0 + r < M)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(m0 + r) * D + c) =
          __floats2bfloat162_rn(Os[r * ldO + c], Os[r * ldO + c + 1]);
  }
}

// Workspace of the backward: h and dhpre in bf16, gelu'(hpre) and dhpre in
// fp32, and the split-row partials of the widest sum.
struct BwdBuffers {
  bf16 *h, *dhpre_lp;
  float *hgrad, *dhpre32, *partial, *col_partial;

  void carve(Carver& c, long long M, int D, int F) {
    h = c.take<bf16>(M * F);
    dhpre_lp = c.take<bf16>(M * F);
    hgrad = c.take<float>(M * F);
    dhpre32 = c.take<float>(M * F);
    partial = c.take<float>((long long)chunks_of(M) * D * F);
    col_partial = c.take<float>((long long)chunks_of(M) * F);
  }
};

}  // namespace

// Rows of x one forward block takes at width D (0: D is too wide).
extern "C" int dk_fused_mlp_rows(int D) { return fwd_rows(D); }

// x: [M, D] bf16; w1: [F, D], w2: [D, F] bf16 (nn.Linear layout); b1: [F],
// b2: [D] fp32; out: [M, D] bf16. D and F are multiples of 16. Returns
// cudaGetLastError() after the launch, or -1 for a shape it refuses.
extern "C" int dk_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int M, int D, int F,
                                void* stream) {
  const int BM = fwd_rows(D);
  if (M < 1 || D < 16 || D % 16 || F < 16 || F % 16 || BM == 0) return -1;
  const size_t smem = fwd_smem(BM, D);
  cudaError_t err = cudaFuncSetAttribute(mlp_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_fwd_kernel<<<(M + BM - 1) / BM, MLP_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w1, (const float*)b1, (const bf16*)w2, (const float*)b2,
      (bf16*)out, M, D, F, BM);
  return (int)cudaGetLastError();
}

extern "C" size_t dk_fused_mlp_bwd_workspace(int M, int D, int F) {
  Carver c{nullptr, 0};
  BwdBuffers g;
  g.carve(c, M, D, F);
  return c.off;
}

// x, dy: [M, D] bf16; w1: [F, D], w2: [D, F] bf16; b1: [F] fp32. Writes dx
// [M, D] bf16 and dw1 [F, D], db1 [F], dw2 [D, F], db2 [D] in fp32.
extern "C" int dk_fused_mlp_bwd(const void* x_, const void* w1_, const void* b1_,
                                const void* w2_, const void* dy_, void* dx, void* dw1,
                                void* db1, void* dw2, void* db2, void* work, int M, int D,
                                int F, void* stream) {
  if (M < 1 || D < 1 || F < 1 || !work) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *x = (const bf16*)x_, *w1 = (const bf16*)w1_, *w2 = (const bf16*)w2_,
             *dy = (const bf16*)dy_;
  Carver c{(char*)work, 0};
  BwdBuffers g;
  g.carve(c, M, D, F);

  // recompute h = gelu(hpre) and gelu'(hpre), hpre = x W1^T + b1
  GemmArgs p = linear_args(x, w1, M, F, D);
  p.bias = (const float*)b1_; p.act = ACT_GELU; p.act_grad = g.hgrad;
  p.out_bf16 = g.h;
  gemm(p, 1, st);
  // dhpre = (dy W2) * gelu'(hpre)
  p = grad_input_args(dy, w2, M, F, D);
  p.mul = g.hgrad;
  p.out_f32 = g.dhpre32; p.out_bf16 = g.dhpre_lp;
  gemm(p, 1, st);
  // dx = dhpre W1
  p = grad_input_args(g.dhpre_lp, w1, M, D, F);
  p.out_bf16 = (bf16*)dx;
  gemm(p, 1, st);
  weight_grad(g.dhpre_lp, x, M, F, D, g.partial, (float*)dw1, st);
  weight_grad(dy, g.h, M, D, F, g.partial, (float*)dw2, st);
  col_sum(g.dhpre32, nullptr, M, F, g.col_partial, (float*)db1, st);
  col_sum(dy, nullptr, M, D, g.col_partial, (float*)db2, st);
  return (int)cudaGetLastError();
}
