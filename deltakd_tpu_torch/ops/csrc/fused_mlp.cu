// Fused transformer MLP (fc1 -> erf-GELU -> fc2), forward and recompute
// backward, on Hopper (sm_90a).
//
// Replaces: deltakd_tpu/ops/fused_mlp.py `_mlp_kernel` (called by `fused_mlp`)
// and `_mlp_bwd_kernel` (called by `_fused_mlp_bwd_call`). With x [M, D] and
// nn.Linear weights W1 [F, D], W2 [D, F]:
//
//   forward   h = gelu(x W1^T + b1) rounded to bf16, o = h W2^T + b2
//             (fp32 operands: `dk_fused_mlp_fwd_f32` at the end of this file,
//             the same with 3xTF32 products and h kept fp32)
//   backward  hpre and h recomputed from x; dh = dy W2, dhpre = dh gelu'(hpre),
//             dx = dhpre W1, dW1 = dhpre^T x, dW2 = h^T dy,
//             db1 = colsum(dhpre), db2 = colsum(dy)        (fp32 sums)
//             (fp32 operands: `dk_fused_mlp_bwd_f32`, the same chain with
//             3xTF32 products and nothing rounded to bf16)
//
// What bounds the forward on an H100: the tensor cores, as long as the
// [M, F] hidden never reaches device memory. 4 M D F operations on 2 M D bf16
// of input and output are some 1500 operations a byte at D = 384, far above
// the card's 295; written out and read back, the hidden (four times the
// input, 155.7 MB at M = 50,688, D = 384) would cost more than the products.
// The TPU kernel holds a 256-row tile's whole hidden in VMEM. Here a CTA takes
// 64 rows of x and streams the hidden axis in chunks:
//  * The producer warp loads the x tile once (TMA, 128-byte swizzle), then
//    streams the weights as 64 x 64 tiles through an mbarrier ring, in the
//    order the consumers take them: per chunk of Fc = 64 C hidden units the
//    W1 tiles [64 f, 64 k], then the W2 tiles [64 d, 64 f].
//  * C consumer warpgroups share the rows. Warpgroup c computes the chunk's
//    f-block c, S = X W1_c^T, by wgmma into registers, adds b1, applies
//    erf-GELU, rounds to bf16 and writes the tile into a double-buffered
//    shared H in the swizzle wgmma reads. After one named barrier per chunk
//    each warpgroup adds H W2_c^T for its own DN output columns (wgmma from
//    shared memory, accumulators in registers: DN / 2 a thread).
//  * The b2 epilogue runs from the registers and stores bf16x2, masked at
//    the ragged M edge (rows past M arrive as zeros and are never stored).
//  * Width: the output accumulators of 64 rows are D / 2 registers a thread
//    for one warpgroup, too many above D = 192, so the columns split across
//    the C warpgroups and, above C * DN, into passes that recompute fc1
//    (`mlp_fwd_kernel<C, DN>`: D = 192 one warpgroup of 192 columns, 384 two
//    of 192, 768 two passes of those, 1024 four passes of two of 128). Each
//    pass recomputes fc1, so the operations are 1.5x the MLP's at D = 768
//    and 2.5x at 1024. `dk_fused_mlp_fwd` picks the plan by width.
//  * A model rank's shard of the hidden under tensor parallelism may be an
//    odd multiple of 32 (DeiT-Ti's 768 / 8 = 96). The one-warpgroup plan
//    then ends each pass with a 32-wide tail chunk: its W1 and W2 tiles are
//    the same 64 x 64 TMA boxes, whose rows (W1) and columns (W2) past F
//    arrive as zeros. fc1 is the chunk's usual n = 64 product into S (its
//    columns 32-63 come out zero and go unused): an n = 32 wgmma would need
//    accumulators of its own, since ptxas serialises wgmma of two shapes on
//    one accumulator, and this plan has no registers to spare (with 16 more
//    ptxas spilled and serialised every wgmma of the kernel). The GELU
//    writes 32 columns of H, and fc2 takes K = 32 as two k16 steps. The tail
//    runs after the pass's 64-wide chunks, with no product in flight on
//    either side of it.
//  * The GELU runs between a warpgroup's two products, with its own
//    tensor-core work waiting (the other warpgroup, and at D = 192 a second
//    CTA on the SM, fill that gap), so its cost shows: it uses the TPU
//    kernel's rational erf on the special-function units (gemm_sm90.cuh
//    `gelu_rational`), fewer instructions than erff.
//  * What is left: every product is a 64 x 64 x 16 wgmma with both operands
//    read from shared memory, and every 64-row tile reads both weights again
//    from L2 (2.36 MB a tile at D = 384).
//
// The backward is a chain behind one entry point, every product on the TMA +
// wgmma GEMM of gemm_sm90.cuh, as the block's reverse sweep
// (fused_block_reverse.cuh) runs it: W1 and W2 transposed once per call;
// the recompute's fc1 with GELU and its derivative; dhpre = (dy W2) gelu' in
// bf16 with its 128-row column sums (db1) from the GEMM's epilogue; dx; the
// two weight gradients as fp32 row-range partials; db2 from one row pass over
// dy. What bounds it: the tensor cores for its five products, and the bytes
// of h, gelu' and dhpre that the workspace carries between them (8 bytes an
// element of [M, F]). Every sum over rows is fp32 partials added in a fixed
// order: no atomics, two runs give the same bits.
//
// GELU: the forward uses the TPU kernel's rational erf (Abramowitz and
// Stegun 7.1.26, within 1.5e-7 of erf; `gelu_rational`), the backward's
// recompute of h the GEMM epilogue's erff (`gelu_erf`). So the h that the
// backward's dW2 reads is not always the forward's bit for bit: the two
// GELUs differ by far less than h's bf16 rounding, and each kernel is held
// to the plain version within TOL.

#include "fused_block_reverse.cuh"

using namespace dk;

namespace {

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

constexpr int RT = 64;                // rows of a CTA; every tile is RT x RT bf16
constexpr int TILE = RT * RT;         // elements of a tile (8 KB)
constexpr int MAX_STAGES = 12;
constexpr int MAX_SMEM = 232448;      // 227 KB
// The widest model (ViT-L): its x tile takes 128 KB of shared memory and
// leaves room for every plan's ring. The wrapper states the same rule
// (ops/fused_mlp.py `forward_takes`).
constexpr int MAX_D = 1024;
constexpr int TWO_CTA_SMEM = 110 * 1024;   // two CTAs an SM at one warpgroup

// Ring stages below which a warpgroup could hold back the producer: between
// two of its W2 tiles lie the other warpgroups' (C - 1) DN / 64.
inline int min_stages(int C, int DN) { return (C - 1) * (DN / 64) + 2; }

// x tile, the two H buffers, the ring, then its barriers (and the alignment).
inline size_t fwd_smem(int C, int D, int stages) {
  return 1024 + (size_t)(D / 64 + 2 * C + stages) * TILE * sizeof(bf16) +
         (2 * MAX_STAGES + 1) * sizeof(uint64_t);
}

// Rows of CTA blockIdx.x: [64 blockIdx.x, +64). Warp 4 C is the producer.
template <int C, int DN>
__global__ void __launch_bounds__(C * 128 + 32, C == 1 ? 2 : 1)
mlp_fwd_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w1,
               const __grid_constant__ CUtensorMap tm_w2, const float* __restrict__ b1,
               const float* __restrict__ b2, bf16* __restrict__ out, int M, int D, int F,
               int stages) {
  constexpr int NB = DN / 64;   // 64-column blocks of a warpgroup's output
  extern __shared__ unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(align1024(smem_raw));   // [D / 64][RT][RT]
  bf16* Hs = Xs + D / 64 * TILE;                               // [2][C][RT][RT]
  bf16* Ws = Hs + 2 * C * TILE;                                // [stages][RT][RT]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + stages * TILE);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* xbar = empty + MAX_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * RT;
  // 64 C-wide hidden chunks, then (one warpgroup, F an odd multiple of 32)
  // the 32-wide tail chunk
  const int kblocks = D / 64, chunks = F / (64 * C), passes = D / (C * DN);
  const bool tail = C == 1 && F % 64 != 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // the four warps of the tile's warpgroup
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C) {
    // producer: one thread loads x, then keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(xbar, kblocks * TILE * sizeof(bf16));
      for (int kb = 0; kb < kblocks; ++kb) tma_load_2d(Xs + kb * TILE, &tm_x, kb * 64, m0, xbar);
      int stage = 0;
      uint32_t phase = 0;
      auto load = [&](const CUtensorMap* map, int c0, int c1) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], TILE * sizeof(bf16));
        tma_load_2d(Ws + stage * TILE, map, c0, c1, &full[stage]);
        if (++stage == stages) { stage = 0; phase ^= 1; }
      };
      for (int p = 0; p < passes; ++p)
        for (int j = 0; j < chunks + tail; ++j) {
          const int f0 = j * 64 * C;
          for (int kb = 0; kb < kblocks; ++kb)
            for (int c = 0; c < C; ++c) load(&tm_w1, kb * 64, f0 + 64 * c);
          for (int b = 0; b < C; ++b)
            for (int w = 0; w < C; ++w)
              for (int nb = 0; nb < NB; ++nb) load(&tm_w2, f0 + 64 * b, (p * C + w) * DN + 64 * nb);
        }
    }
    return;
  }

  // consumers: warpgroup c takes f-block c of every chunk and the output
  // columns [(p C + c) DN, +DN) of pass p. Thread (warp, lane) holds rows
  // r = 16 (warp % 4) + lane / 4 and r + 8; of every 8 columns, the two at cq.
  const int c = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4, cq = 2 * (lane % 4);
  float acc[NB][32], s[32];
  int stage = 0, held = -1;
  uint32_t phase = 0;
  auto skip = [&]() {   // a tile of another warpgroup
    if (++stage == stages) { stage = 0; phase ^= 1; }
  };
  // after committing the group that read `stage`: the group before it is
  // done, and its stage goes back to the producer
  auto retire = [&]() {
    wgmma_wait<1>();
    if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
    held = stage;
    skip();
  };
  auto release = [&]() {   // after wgmma_wait<0>
    if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
    held = -1;
  };

  mbar_wait(xbar, 0);
  int chunk_no = 0;
  for (int p = 0; p < passes; ++p) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
    for (int j = 0; j < chunks; ++j, ++chunk_no) {
      const int f0 = j * 64 * C;
      // S = X W1_c^T over the k-blocks of D
      for (int kb = 0; kb < kblocks; ++kb) {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          if (cc != c) {
            skip();
            continue;
          }
          mbar_wait(&full[stage], phase);
          const uint64_t da = sw128_desc(Xs + kb * TILE), db = sw128_desc(Ws + stage * TILE);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) wgmma_ss(s, da + 2 * k, db + 2 * k, kb > 0 || k > 0);
          wgmma_commit();
          retire();
        }
      }
      wgmma_wait<0>();
      fence_regs(s);
      release();

      // H_c = gelu(S + b1) in bf16, into this chunk's buffer in the 128-byte
      // swizzle: element (row, col) at row * 128 + ((col / 8) ^ (row % 8)) * 16
      // + (col % 8) * 2 bytes
      unsigned char* hc =
          reinterpret_cast<unsigned char*>(Hs + ((chunk_no & 1) * C + c) * TILE);
      const float* bias = b1 + f0 + 64 * c + cq;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + 8 * jb));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r + 8 * h;
          const float v0 = s[4 * jb + 2 * h] + bv.x, v1 = s[4 * jb + 2 * h + 1] + bv.y;
          *reinterpret_cast<__nv_bfloat162*>(hc + row * 128 + ((jb ^ (row & 7)) << 4) + 2 * cq) =
              __floats2bfloat162_rn(gelu_rational(v0), gelu_rational(v1));
        }
      }
      // the stores are visible to wgmma (the async proxy), then every
      // warpgroup's f-block is written
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, %0;" ::"n"(C * 128) : "memory");

      // O += H W2^T over the chunk's C f-blocks, this warpgroup's columns
#pragma unroll
      for (int b = 0; b < C; ++b) {
        const uint64_t da = sw128_desc(Hs + ((chunk_no & 1) * C + b) * TILE);
#pragma unroll
        for (int w = 0; w < C; ++w) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            if (w != c) {
              skip();
              continue;
            }
            mbar_wait(&full[stage], phase);
            const uint64_t db = sw128_desc(Ws + stage * TILE);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < 4; ++k) wgmma_ss(acc[nb], da + 2 * k, db + 2 * k, 1);
            wgmma_commit();
            retire();
          }
        }
      }
    }
    if constexpr (C == 1) {
      if (tail) {
        // the 32-wide tail chunk [F - 32, F): every product before it done
        wgmma_wait<0>();
        release();
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&full[stage], phase);
          const uint64_t da = sw128_desc(Xs + kb * TILE), db = sw128_desc(Ws + stage * TILE);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) wgmma_ss(s, da + 2 * k, db + 2 * k, kb > 0 || k > 0);
          wgmma_commit();
          retire();
        }
        wgmma_wait<0>();
        fence_regs(s);
        release();
        unsigned char* hc = reinterpret_cast<unsigned char*>(Hs + (chunk_no & 1) * TILE);
        const float* bias = b1 + F - 32 + cq;
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + 8 * jb));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r + 8 * h;
            const float u0 = s[4 * jb + 2 * h] + bv.x, u1 = s[4 * jb + 2 * h + 1] + bv.y;
            *reinterpret_cast<__nv_bfloat162*>(hc + row * 128 + ((jb ^ (row & 7)) << 4) + 2 * cq) =
                __floats2bfloat162_rn(gelu_rational(u0), gelu_rational(u1));
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 1, 128;" ::: "memory");
        const uint64_t da = sw128_desc(Hs + (chunk_no & 1) * TILE);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          mbar_wait(&full[stage], phase);
          const uint64_t db = sw128_desc(Ws + stage * TILE);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 2; ++k) wgmma_ss(acc[nb], da + 2 * k, db + 2 * k, 1);
          wgmma_commit();
          retire();
        }
        ++chunk_no;
        wgmma_wait<0>();
        release();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    release();

    // out = O + b2, bf16x2 stores, rows past M left out
    const int d0 = (p * C + c) * DN + cq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r + 8 * h;
      if (row >= M) continue;
      bf16* orow = out + (long long)row * D + d0;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int n = 64 * nb + 8 * jb;
          const float2 bv = __ldg(reinterpret_cast<const float2*>(b2 + d0 + n));
          store2(orow + n, acc[nb][4 * jb + 2 * h] + bv.x, acc[nb][4 * jb + 2 * h + 1] + bv.y);
        }
    }
  }
}

template <int C, int DN>
cudaError_t launch_fwd(const bf16* x, const bf16* w1, const float* b1, const bf16* w2,
                       const float* b2, bf16* out, int M, int D, int F, cudaStream_t st) {
  // as many stages as fit (two CTAs an SM at one warpgroup and D <= 192)
  const size_t budget = C == 1 && D <= 192 ? TWO_CTA_SMEM : MAX_SMEM;
  int stages = MAX_STAGES;
  while (stages > min_stages(C, DN) && fwd_smem(C, D, stages) > budget) --stages;
  const size_t smem = fwd_smem(C, D, stages);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  CUtensorMap tx, t1, t2;
  if (!kmajor_map(&tx, x, M, D, RT) || !kmajor_map(&t1, w1, F, D, RT) ||
      !kmajor_map(&t2, w2, D, F, RT))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mlp_fwd_kernel<C, DN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mlp_fwd_kernel<C, DN><<<(M + RT - 1) / RT, C * 128 + 32, smem, st>>>(tx, t1, t2, b1, b2, out,
                                                                      M, D, F, stages);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// partial[chunk][d] = the sum over the chunk's CS_ROWS rows of a[row, d] (a
// of T): the row kernels' column-sum pattern (fused_block_reverse.cuh),
// fixed order.
template <typename T>
__global__ void colsum_kernel(const T* a, int M, int D, float* partial) {
  extern __shared__ float cs_acc[];
  float* acc = cs_warp_slice(cs_acc, 1, D);
  const int r0 = blockIdx.x * CS_ROWS, r1 = min(M, r0 + CS_ROWS);
  for (int row = r0 + threadIdx.x / 32; row < r1; row += ROWS_PER_BLOCK)
    for (int d = threadIdx.x % 32; d < D; d += 32) acc[d] += ld(a + (long long)row * D + d);
  cs_write(cs_acc, 1, D, partial);
}

// Workspace of the backward at operand type T: h and dhpre in T, gelu'(hpre)
// in fp32, the weights transposed (K-major operands of the input
// gradients; fp32: split into TF32 hi and lo by the transpose), the
// row-range partials of the wider weight gradient, the column sums'
// partials (dhpre's per 128-row tile, dy's per CS_ROWS rows), and, in the
// fp32 form, W1 split for the recompute.
template <typename T>
struct MlpBwdBuffers {
  T *h, *dhpre, *w1_t, *w2_t, *w1_split;
  float *hgrad, *partial, *col_partial;

  void carve(Carver& c, int M, int D, int F) {
    h = c.take<T>((long long)M * F);
    dhpre = c.take<T>((long long)M * F);
    hgrad = c.take<float>((long long)M * F);
    w1_t = c.take<T>(weight_operand_len<T>(D, F));
    w2_t = c.take<T>(weight_operand_len<T>(F, D));
    const long long a = weight_grad_partial_len<T>(M, F, D),
                    b = weight_grad_partial_len<T>(M, D, F);
    partial = c.take<float>(a > b ? a : b);
    const long long t = (long long)linear_row_tiles(M) * F, r = (long long)cs_chunks(M) * D;
    col_partial = c.take<float>(t > r ? t : r);
    w1_split = is_f32<T> ? c.take<T>(2LL * F * D) : nullptr;
  }
};

template <typename T>
size_t mlp_bwd_workspace(int M, int D, int F) {
  Carver c{nullptr, 0};
  MlpBwdBuffers<T> g;
  g.carve(c, M, D, F);
  return c.off;
}

// The backward's chain at operand type T (x, dy, dx of T); the entry points
// below are its bf16 and fp32 forms.
template <typename T>
int mlp_bwd(const void* x_, const void* w1_, const void* b1_, const void* w2_, const void* dy_,
            void* dx, void* dw1, void* db1, void* dw2, void* db2, void* work, int M, int D,
            int F, cudaStream_t st) {
  if (M < 1 || D < 8 || F < 8 || D % 8 || F % 8 || !work) return -1;
  const T *x = (const T*)x_, *w1 = (const T*)w1_, *w2 = (const T*)w2_, *dy = (const T*)dy_;
  Carver c{(char*)work, 0};
  MlpBwdBuffers<T> g;
  g.carve(c, M, D, F);
  cudaError_t err;

  // the weights as the K-major operands of the input gradients
  transpose(w1, F, D, g.w1_t, st);
  transpose(w2, D, F, g.w2_t, st);

  // recompute h = gelu(hpre) and gelu'(hpre), hpre = x W1^T + b1
  const T* w1_op = w1;
  if constexpr (is_f32<T>) {
    const long long n = (long long)F * D;
    if ((err = split_weights_tf32(1, &w1, &g.w1_split, &n, st)) != cudaSuccess) return (int)err;
    w1_op = g.w1_split;
  }
  LinearT<T> l = linear_of(x, w1_op, M, F, D);
  l.bias = (const float*)b1_; l.gelu = 1; l.act_grad = g.hgrad;
  l.out_lp = g.h;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return (int)err;
  // dhpre = (dy W2) * gelu'(hpre) in T; db1 from its 128-row column sums
  l = linear_of<T>(dy, g.w2_t, M, F, D);
  l.mul = g.hgrad; l.col_part = g.col_partial;
  l.out_lp = g.dhpre;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return (int)err;
  cs_reduce(g.col_partial, linear_row_tiles(M), F, 0, (float*)db1, st);
  // dx = dhpre W1
  l = linear_of<T>(g.dhpre, g.w1_t, M, D, F);
  l.out_lp = (T*)dx;
  if ((err = linear_sm90(l, st)) != cudaSuccess) return (int)err;
  // dW1 = dhpre^T x, dW2 = dy^T h
  if ((err = weight_grad_sm90(g.dhpre, x, M, F, D, g.partial, (float*)dw1, st)) != cudaSuccess)
    return (int)err;
  if ((err = weight_grad_sm90(dy, g.h, M, D, F, g.partial, (float*)dw2, st)) != cudaSuccess)
    return (int)err;
  // db2 = colsum(dy)
  const int chunks = cs_chunks(M);
  if ((err = cs_opt_in(colsum_kernel<T>, cs_smem(1, D))) != cudaSuccess) return (int)err;
  colsum_kernel<T><<<chunks, ROW_THREADS, cs_smem(1, D), st>>>(dy, M, D, g.col_partial);
  reduce_chunks(g.col_partial, chunks, D, (float*)db2, st);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [M, D] bf16; w1: [F, D], w2: [D, F] bf16 (nn.Linear layout); b1: [F],
// b2: [D] fp32; out: [M, D] bf16; all 16-byte aligned. The plan (C, DN) of
// `mlp_fwd_kernel` by width: with F a multiple of 128, the first of C DN =
// 384, 256, 192 that divides D; with F a multiple of 32 alone (a model
// rank's shard of the hidden under tensor parallelism, such as DeiT-Ti's
// 768 / 4 and 768 / 8), one warpgroup of 192 columns, whose hidden chunks
// are 64 and a 32-wide tail where F is an odd multiple of 32, in D / 192
// passes. Takes D up to MAX_D, a multiple of 192 or 256, and F a multiple of
// 128, or of 32 where D is a multiple of 192. Returns cudaGetLastError()
// after the launch, or -1, without a launch, for a width it does not take.
extern "C" int dk_fused_mlp_fwd(const void* x_, const void* w1_, const void* b1_, const void* w2_,
                                const void* b2_, void* out_, int M, int D, int F, void* stream) {
  if (M < 1 || D < 192 || D > MAX_D || F < 32 || F % 32 || (F % 128 && D % 192) ||
      ((uintptr_t)x_ | (uintptr_t)w1_ | (uintptr_t)w2_) % 16)
    return -1;
  const bf16 *x = (const bf16*)x_, *w1 = (const bf16*)w1_, *w2 = (const bf16*)w2_;
  const float *b1 = (const float*)b1_, *b2 = (const float*)b2_;
  bf16* out = (bf16*)out_;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (F % 128 == 0 && D % 384 == 0) e = launch_fwd<2, 192>(x, w1, b1, w2, b2, out, M, D, F, st);
  else if (F % 128 == 0 && D % 256 == 0)
    e = launch_fwd<2, 128>(x, w1, b1, w2, b2, out, M, D, F, st);
  else if (D % 192 == 0) e = launch_fwd<1, 192>(x, w1, b1, w2, b2, out, M, D, F, st);
  else return -1;
  return e == cudaErrorInvalidValue ? -1 : (int)e;
}

extern "C" size_t dk_fused_mlp_bwd_workspace(int M, int D, int F) {
  return mlp_bwd_workspace<bf16>(M, D, F);
}

// x, dy: [M, D] bf16; w1: [F, D], w2: [D, F] bf16; b1: [F] fp32. Writes dx
// [M, D] bf16 and dw1 [F, D], db1 [F], dw2 [D, F], db2 [D] in fp32. D and F
// are multiples of 8. Returns the first launch error, or -1 for a shape it
// refuses (nothing after it is launched).
extern "C" int dk_fused_mlp_bwd(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* dy, void* dx, void* dw1, void* db1, void* dw2,
                                void* db2, void* work, int M, int D, int F, void* stream) {
  return mlp_bwd<bf16>(x, w1, b1, w2, dy, dx, dw1, db1, dw2, db2, work, M, D, F,
                       (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// Forward, fp32 operands (3xTF32)
// ---------------------------------------------------------------------------

// The fp32 form of the forward, for an fp32 model: every product 3xTF32 on
// the TF32 wgmma with fp32 accumulation (gemm_sm90.cuh), nothing rounded to
// bf16. It is a chain on gemm_sm90.cuh's fp32 linear product, not the fused
// kernel above:
//   0. W1 and W2 split into TF32 hi and lo in the workspace (one launch);
//   1. h = gelu(x W1^T + b1), erf-GELU in the epilogue (`gelu_erf`), stored
//      fp32 in the workspace;
//   2. out = h W2^T + b2, stored fp32.
// What this form gives up: the [M, F] hidden goes through device memory
// (8 bytes an element, written and read back), which the bf16 kernel keeps on
// chip. At fp32 its x tile alone (64 rows x D 384 x 4 bytes) would take 96 KB
// of shared memory, beside the split tiles of 3xTF32, so the fused design
// needs a plan of its own; a simple chain comes first.
// The workspace: h, then W1 and W2 split.
struct MlpFwdF32Buffers {
  float *h, *w1_split, *w2_split;

  void carve(Carver& c, int M, int D, int F) {
    h = c.take<float>((long long)M * F);
    w1_split = c.take<float>(2LL * F * D);
    w2_split = c.take<float>(2LL * D * F);
  }
};

extern "C" size_t dk_fused_mlp_fwd_f32_workspace(int M, int D, int F) {
  Carver c{nullptr, 0};
  MlpFwdF32Buffers b;
  b.carve(c, M, D, F);
  return c.off;
}

// x: [M, D] fp32; w1: [F, D], w2: [D, F] fp32; b1: [F], b2: [D] fp32; out:
// [M, D] fp32; work: dk_fused_mlp_fwd_f32_workspace(M, D, F) bytes. Takes D
// and F multiples of 8 and 16-byte-aligned x, w1 and w2. Returns
// cudaGetLastError() after the launches, or -1, without a launch, for a
// shape it refuses.
extern "C" int dk_fused_mlp_fwd_f32(const void* x_, const void* w1_, const void* b1_,
                                    const void* w2_, const void* b2_, void* out_, void* work,
                                    int M, int D, int F, void* stream) {
  if (M < 1 || D < 8 || F < 8 || D % 8 || F % 8 || !work) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  Carver c{(char*)work, 0};
  MlpFwdF32Buffers b;
  b.carve(c, M, D, F);
  const float* w[2] = {(const float*)w1_, (const float*)w2_};
  float* split[2] = {b.w1_split, b.w2_split};
  const long long n[2] = {(long long)F * D, (long long)D * F};
  cudaError_t err;
  if ((err = split_weights_tf32(2, w, split, n, st)) != cudaSuccess)
    return err == cudaErrorInvalidValue ? -1 : (int)err;
  LinearT<float> f1 = linear_of((const float*)x_, (const float*)b.w1_split, M, F, D);
  f1.bias = (const float*)b1_; f1.gelu = 1;
  f1.out_lp = b.h;
  if ((err = linear_sm90(f1, st)) != cudaSuccess) return err == cudaErrorInvalidValue ? -1 : (int)err;
  LinearT<float> f2 = linear_of((const float*)b.h, (const float*)b.w2_split, M, D, F);
  f2.bias = (const float*)b2_;
  f2.out_f32 = (float*)out_;
  if ((err = linear_sm90(f2, st)) != cudaSuccess) return err == cudaErrorInvalidValue ? -1 : (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, fp32 operands (3xTF32)
// ---------------------------------------------------------------------------

// The fp32 form of the backward (row 6 of an fp32 model): the chain above at
// fp32, every product 3xTF32 on the TF32 wgmma, h, dhpre, dx and the
// transposed weights fp32 and unrounded; its two weight gradients read G and
// X as they lie (gemm_sm90.cuh `weight_grad_f32_kernel`). The same arguments
// and returns as dk_fused_mlp_bwd, with x, dy, w1, w2 and dx fp32.
extern "C" size_t dk_fused_mlp_bwd_f32_workspace(int M, int D, int F) {
  return mlp_bwd_workspace<float>(M, D, F);
}

extern "C" int dk_fused_mlp_bwd_f32(const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* dy, void* dx, void* dw1,
                                    void* db1, void* dw2, void* db2, void* work, int M, int D,
                                    int F, void* stream) {
  return mlp_bwd<float>(x, w1, b1, w2, dy, dx, dw1, db1, dw2, db2, work, M, D, F,
                        (cudaStream_t)stream);
}
