// Attention backward whose scores never leave the chip, on Hopper (sm_90a):
// the attention stage of the fused block's reverse sweep (`reverse_chain`,
// fused_block_reverse.cuh) and the whole of `flash_bwd` (attention.cu). Per
// (batch, head), from q, k, v, the output cotangent dO, the forward's row
// statistic lse and delta = rowsum(dO * O):
//
//   S = q k^T,  P = exp(S scale - lse),  dV = P^T dO,  dP = dO v^T,
//   dS = P * (dP - delta),  dQ = dS k * dq_scale,  dK = dS^T q * scale
//
// This is the math of deltakd_tpu/ops/fused_block.py `_attention_bwd_one`
// (the block) and of deltakd_tpu/ops/attention.py `_bwd_kernel` (flash),
// which folds the softmax normalisation into row scalings of the unnormalised
// e and its row sums; with P normalised through lse the same gradient needs
// only one row statistic, and delta = rowsum(dO * O) stands for its
// c = rowsum(dP * e) / rowsum(e).
//
// The score scale. The block hands over a q already scaled (its forward
// runs with scale 1) and passes scale = 1 and dq_scale = head_dim^-1/2;
// flash_bwd hands over the unscaled q of its caller, so it passes
// scale = dq_scale = 64^-1/2. 64^-1/2 = 2^-3, so applying it to S in the
// exponent and to dQ and dK in fp32 is exact (a power of two), and dS in
// bf16 is the same whether the scale is applied before or after its rounding.
//
// delta. The block passes delta (its chain has dO and O in token-major
// buffers and computes it in a row pass); flash_bwd passes `o` instead, and
// each CTA computes delta of its head's N rows in its prologue (8 threads a
// row, 16 bytes each, a fixed-order sum) into shared memory. That reads dO
// and O of the head once more (2 x N x 64 bf16; 2 x 19.5 MB at [768, 198, 64])
// and saves a launch and a round trip of delta through device memory.
//
// One CTA (one warpgroup, 128 threads) per (batch, head). It walks the key
// tiles of 64 keys; for each it keeps dK and dV of those keys in registers
// and loops over the query tiles of 64 rows:
//   S^T = K Q^T and dP^T = V dO^T: wgmma from shared memory, keys as rows, so
//        that P^T and dS^T land in registers as the A operand of the next two;
//   dV += P^T dO and dK += dS^T Q: wgmma with A from registers, dO and Q
//        as they lie in shared memory (wgmma's transposed B operand);
//   dQ_i = dS K: dS^T goes to shared memory in the 128-byte swizzle and is
//        read as wgmma's transposed A operand, K as its transposed B; the
//        product is added to an fp32 dQ of all N rows in shared memory.
// dQ sums its key tiles in key-tile order inside one CTA: no partials in
// device memory and no atomics, two runs give the same bits. Tiles arrive by
// cp.async in the 128-byte swizzle (attention_fwd.cuh's loader); rows at or
// beyond N arrive as zeros, and P is set to 0 wherever the key or the query
// is at or beyond N, so padding adds nothing.
//
// With `colsum` it also writes each head's column sums of dq, dk and dv
// (fixed order: rows by shuffles and warps, key tiles in order), the
// per-element partials of the qkv bias gradient.
//
// What bounds it on an H100: the five N x N x 64 products of a head against
// q, k, v, dO, dq, dk, dv (7 x N x 64 bf16), some 140 operations a byte at
// N = 198, under the card's ~295: bytes, in
// principle; in practice each CTA's serial chain (two products, the
// exponentials, two more, a barrier, the fifth) and the padding of 198 rows
// to 256. The scores never reach device memory; shared memory holds the five
// 8 KB tiles, delta of all rows and dQ (16 KB per 64 query rows: 64 KB at
// N = 198, two CTAs an SM; N up to 704, 227,072 bytes at 11 tiles).

#pragma once

#include <math.h>

#include "attention_fwd.cuh"

namespace dk {

// q, k, v, dout: [B, H, N, hd] of T (bf16; fp32 for the fp32 form below)
// through (batch, head, row) element strides, the head dim contiguous, rows 16-byte aligned. lse: [B * H, N]
// fp32. delta: [B * H, N] fp32, or null, and then `o` (the forward's output,
// strided like dout) gives it. S is multiplied by `scale` in the exponent and
// dk by `scale`. The bf16 gradients go through (batch, head, row) strides
// g_sb, g_sh, g_sn; dq is multiplied by dq_scale. With `colsum`, the sums over
// the head's N rows of dq, dk, dv (fp32, dq scaled) go to
// colsum[b * cs_b + part * cs_part + h * 64 + d], part 0, 1, 2 for q, k, v
// (the per-element partials of the qkv bias gradient). The gradients are of
// T: "bf16" below reads as T.
template <typename T>
struct AttnBwdArgsT {
  const T *q, *k, *v, *dout;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, d_sb, d_sh, d_sn;
  const float *lse, *delta;
  const T* o;
  long long o_sb, o_sh, o_sn;
  T *dq, *dk, *dv;
  long long g_sb, g_sh, g_sn;
  float* colsum;
  int cs_b, cs_part;
  float scale, dq_scale;
  int B, H, N;
};

using AttnBwdArgs = AttnBwdArgsT<bf16>;

namespace attn_bwd {
constexpr int T = attn::T;             // keys of a key tile, rows of a query tile
constexpr int TILE = T * 64;           // bf16 elements of one tile
constexpr int MAX_TILES = 11;          // dQ in shared memory: N <= 704
// five bf16 tiles, lse of a query tile, delta of all rows, dQ of all rows,
// the column sums of dq, dk, dv and one 64-column partial per warp
inline size_t smem_bytes(int N) {
  const int tiles = (N + T - 1) / T;
  return 5 * TILE * sizeof(bf16) + T * sizeof(float) + (size_t)tiles * T * sizeof(float) +
         (size_t)tiles * T * 64 * sizeof(float) + (3 + 4) * 64 * sizeof(float) + 1024;
}
}  // namespace attn_bwd

// The fp32 dQ accumulator in shared memory: row r, float2 column c2 (of 32),
// swizzled so that the accumulator layout's 4 rows x 4 column pairs of a
// half-warp fall on 16 different 8-byte banks.
__device__ __forceinline__ float2* dq_slot(float* dq, int r, int c2) {
  return reinterpret_cast<float2*>(dq + r * 64) + (c2 ^ ((r & 3) << 2));
}

// Stores one thread's share of a 64 x 64 accumulator (rows of the tile r,
// r + 8 with r = 16 warp + lane / 4; columns 8 jb + 2 (lane % 4) + {0, 1})
// as bf16 into a 128-byte-swizzled tile.
__device__ __forceinline__ void store_tile_sw128(bf16* tile, const float (&d)[32]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
      *reinterpret_cast<uint32_t*>(base + r * 128 + ((jb ^ (r & 7)) << 4) + 4 * (lane % 4)) =
          pack_bf16(d[4 * jb + 2 * h], d[4 * jb + 2 * h + 1]);
  }
}

// Adds the column sums of one 64 x 64 accumulator (all 64 rows; rows past N
// hold zeros) to col[64]: each warp's 16 rows by shuffles, then the four
// warps in order through wpart[4][64]. All 128 threads call it.
__device__ __forceinline__ void add_colsums(const float (&d)[32], float* wpart, float* col) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    float a = d[4 * jb] + d[4 * jb + 2], b = d[4 * jb + 1] + d[4 * jb + 3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane < 4) {
      wpart[warp * 64 + 8 * jb + 2 * lane] = a;
      wpart[warp * 64 + 8 * jb + 2 * lane + 1] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < 64)
    col[threadIdx.x] += wpart[threadIdx.x] + wpart[64 + threadIdx.x] + wpart[128 + threadIdx.x] +
                        wpart[192 + threadIdx.x];
  __syncthreads();
}

// One thread's rows of a 64 x 64 gradient tile (rows r0 + 16 warp + lane / 4
// and + 8 of the head) to `out`, rows at or beyond N left out.
__device__ __forceinline__ void store_grad_rows(const AttnBwdArgs& p, bf16* out, long long head,
                                                int r0, const float (&d)[32]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= p.N) continue;
    const long long off = head + row * p.g_sn + 2 * (lane % 4);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
      store2(out + off + 8 * jb, d[4 * jb + 2 * h], d[4 * jb + 2 * h + 1]);
  }
}

__global__ void __launch_bounds__(attn::THREADS) attention_bwd_kernel(const AttnBwdArgs p) {
  using attn_bwd::T;
  using attn_bwd::TILE;
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;
  bf16* Ds = Qs + TILE;       // dO of the query tile
  bf16* Ss = Ds + TILE;       // dS^T of the (key, query) tile pair
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int N = p.N, tiles = (N + T - 1) / T;
  float* lse_s = reinterpret_cast<float*>(Ss + TILE);   // lse * log2(e) of the query tile
  float* delta_all = lse_s + T;                          // [tiles * T], 0 past N
  float* dq = delta_all + tiles * T;                     // [tiles * T][64] fp32
  const bf16* qh = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kh = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vh = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* dh = p.dout + b * p.d_sb + h * p.d_sh;
  const float* lse = p.lse + (long long)bh * N;
  const long long ghead = b * p.g_sb + h * p.g_sh;
  constexpr float LOG2E = 1.4426950408889634f;
  const float s_log2e = p.scale * LOG2E;   // the block: scale 1, LOG2E itself

  float* col = dq + tiles * T * 64;   // [3][64]: the column sums of dq, dk, dv
  float* wpart = col + 3 * 64;        // [4][64]
  for (int i = threadIdx.x; i < tiles * T * 16; i += attn::THREADS)
    reinterpret_cast<float4*>(dq)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < 3 * 64; i += attn::THREADS) col[i] = 0.f;
  if (p.delta) {
    const float* delta = p.delta + (long long)bh * N;
    for (int r = threadIdx.x; r < tiles * T; r += attn::THREADS)
      delta_all[r] = r < N ? delta[r] : 0.f;
  } else {
    // delta = rowsum(dO * O): 8 threads a row, 8 columns each, summed over
    // the 8 by shuffles in a fixed order; a thread has the loads of 4 rows
    // (16 apart) in flight, and each pass covers one 64-row tile
    const bf16* oh = p.o + b * p.o_sb + h * p.o_sh;
    const int c = 8 * (threadIdx.x % 8);
    for (int r0 = threadIdx.x / 8; r0 < tiles * T; r0 += T) {
      uint4 a[4], o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + 16 * u;
        a[u] = o[u] = make_uint4(0u, 0u, 0u, 0u);
        if (r < N) {
          a[u] = *reinterpret_cast<const uint4*>(dh + (long long)r * p.d_sn + c);
          o[u] = *reinterpret_cast<const uint4*>(oh + (long long)r * p.o_sn + c);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t av[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
        const uint32_t ov[4] = {o[u].x, o[u].y, o[u].z, o[u].w};
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[e]));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ov[e]));
          d += x.x * y.x + x.y * y.y;
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        d += __shfl_xor_sync(0xffffffffu, d, 4);
        if (threadIdx.x % 8 == 0) delta_all[r0 + 16 * u] = d;
      }
    }
  }

  // this thread's rows (keys in S^T, dP^T, dK, dV; queries in dQ) and columns
  const int r_lo = 16 * warp + lane / 4, c_lo = 2 * (lane % 4);

  for (int j = 0; j < tiles; ++j) {
    load_tile_async(Ks, kh, p.k_sn, j * T, N);
    load_tile_async(Vs, vh, p.v_sn, j * T, N);
    cp_async_commit();
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    for (int i = 0; i < tiles; ++i) {
      load_tile_async(Qs, qh, p.q_sn, i * T, N);
      load_tile_async(Ds, dh, p.d_sn, i * T, N);
      cp_async_commit();
      if (threadIdx.x < T) {
        const int row = i * T + threadIdx.x;
        lse_s[threadIdx.x] = row < N ? lse[row] * LOG2E : 0.f;
      }
      const float* delta_s = delta_all + i * T;
      cp_async_wait<0>();
      // this thread's copies are visible to wgmma (the async proxy), then all threads'
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T over the 64 dims of the head
      float s[32], dp[32];
      const uint64_t k_desc = sw128_desc(Ks), v_desc = sw128_desc(Vs);
      const uint64_t q_desc = sw128_desc(Qs), do_desc = sw128_desc(Ds);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_ss(s, k_desc + 2 * k, q_desc + 2 * k, k > 0);
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_ss(dp, v_desc + 2 * k, do_desc + 2 * k, k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta), 0 at padding
      // keys and queries; both as wgmma A fragments (16 queries a k-step)
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        float pv[4], sv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * T + r_lo + 8 * (e >> 1);
          const int col = 8 * jb + c_lo + (e & 1);
          const int idx = 4 * jb + e;
          const bool in = key < N && i * T + col < N;
          pv[e] = in ? exp2f(s[idx] * s_log2e - lse_s[col]) : 0.f;
          sv[e] = pv[e] * (dp[idx] - delta_s[col]);
          s[idx] = sv[e];
        }
        pa[jb / 2][2 * (jb & 1)] = pack_bf16(pv[0], pv[1]);
        pa[jb / 2][2 * (jb & 1) + 1] = pack_bf16(pv[2], pv[3]);
        sa[jb / 2][2 * (jb & 1)] = pack_bf16(sv[0], sv[1]);
        sa[jb / 2][2 * (jb & 1) + 1] = pack_bf16(sv[2], sv[3]);
      }

      // dV += P^T dO and dK += dS^T Q: a k-step of 16 queries is 16 rows
      // of dO and Q, 2048 bytes
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_rs_t(dv, pa[k], do_desc + 128 * k, 1);
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_rs_t(dk, sa[k], q_desc + 128 * k, 1);
      wgmma_commit();

      // dS^T to shared memory, then dQ_i = dS K (dS^T and K both read
      // transposed: 16 keys a k-step)
      store_tile_sw128(Ss, s);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      float dqi[32];
      const uint64_t ds_desc = sw128_desc(Ss);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_ss_tt(dqi, ds_desc + 128 * k, k_desc + 128 * k, k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dqi);

      // dQ of the query tile += this key tile's share (one thread owns each
      // element, key tiles in order)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = i * T + r_lo + 8 * hh;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          float2* slot = dq_slot(dq, r, 4 * jb + c_lo / 2);
          float2 v = *slot;
          v.x += dqi[4 * jb + 2 * hh];
          v.y += dqi[4 * jb + 2 * hh + 1];
          *slot = v;
        }
      }
      __syncthreads();   // the tiles are refilled by the next iteration's copies
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] *= p.scale;
    store_grad_rows(p, p.dk, ghead, j * T, dk);
    store_grad_rows(p, p.dv, ghead, j * T, dv);
    if (p.colsum) {   // key tiles in order
      add_colsums(dk, wpart, col + 64);
      add_colsums(dv, wpart, col + 128);
    }
  }

  __syncthreads();
  // thread t writes column pair t % 32 of rows t / 32, + 4, + 8, ...
  float2 qs = make_float2(0.f, 0.f);
  for (int e = threadIdx.x; e < N * 32; e += attn::THREADS) {
    const int r = e / 32, c2 = e % 32;
    const float2 v = *dq_slot(dq, r, c2);
    const float a = v.x * p.dq_scale, b2 = v.y * p.dq_scale;
    store2(p.dq + ghead + r * p.g_sn + 2 * c2, a, b2);
    qs.x += a;
    qs.y += b2;
  }
  if (p.colsum) {
    wpart[2 * threadIdx.x] = qs.x;        // [4 row classes][32 column pairs]
    wpart[2 * threadIdx.x + 1] = qs.y;
    __syncthreads();
    if (threadIdx.x < 64)
      col[threadIdx.x] = wpart[threadIdx.x] + wpart[64 + threadIdx.x] +
                         wpart[128 + threadIdx.x] + wpart[192 + threadIdx.x];
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * 64; i += attn::THREADS)
      p.colsum[(long long)b * p.cs_b + (i / 64) * p.cs_part + h * 64 + i % 64] = col[i];
  }
}

// Whether the kernel takes head dim hd and sequence length N (dQ and delta
// of all N rows live in shared memory).
inline bool attention_bwd_takes(int hd, int N) {
  return hd == 64 && N >= 1 && (N + attn_bwd::T - 1) / attn_bwd::T <= attn_bwd::MAX_TILES;
}

// Launches the attention backward on `st`; cudaErrorInvalidValue, without a
// launch, for a shape it does not take.
inline cudaError_t attention_bwd(const AttnBwdArgs& p, int hd, cudaStream_t st) {
  if (!attention_bwd_takes(hd, p.N) || p.B < 1 || p.H < 1 || !(p.delta || p.o))
    return cudaErrorInvalidValue;
  const size_t smem = attn_bwd::smem_bytes(p.N);
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attention_bwd_kernel<<<p.B * p.H, attn::THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 form: fp32 operands on TF32 wgmma (m64n64k8) in 3xTF32, fp32
// accumulation
// ---------------------------------------------------------------------------
//
// The math is the bf16 form's, every product in 3xTF32 as attention_fwd.cuh's
// fp32 form computes it (each operand split into hi and lo TF32 parts, three
// wgmmas a product). TF32 wgmma takes no transpose, and three of the five
// products read a tile transposed (dV += P^T dO, dK += dS^T Q and dQ = dS K),
// so the threads write Q^T, dO^T and K^T from registers
// (`load_tile_f32_t`, their columns in tf32_key_slot order, so that P^T,
// dS^T and dS are the A fragments as the accumulators hold them). An fp32
// split tile is 32 KB, and one CTA cannot also hold dQ of all N rows, so
// the backward is two kernels:
//   attention_bwd_dkdv_f32_kernel: one CTA per (batch, head) walks the key
//     tiles, keeps dK and dV of the tile in registers and loops over the
//     query tiles: S^T = K Q^T, dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T Q from registers against dO^T and Q^T. Shared memory: K,
//     V, Q, dO, Q^T, dO^T (split) and delta of all rows, 197 KB at N = 198;
//   attention_bwd_dq_f32_kernel: one CTA per (batch, head) walks the query
//     tiles, keeps dQ of the tile in registers and loops over the key tiles:
//     S = Q K^T, dP = dO V^T, then dQ += dS K against K^T. Shared memory:
//     Q, dO, K, V, K^T (split), 162 KB.
// The second recomputes S and dP (seven products of N x N x 64 where the bf16
// form has five). Each sum runs in a fixed order inside one CTA: no atomics,
// two runs give the same bits, and no shared memory grows with N but delta.
// Nothing is rounded to bf16: P, dS, delta, lse and the gradients are fp32.

namespace attn32 {
// K, V, Q, dO, Q^T, dO^T (split tiles); lse of a query tile, delta of all
// rows, the column sums of dk and dv and one 64-column partial per warp
inline size_t dkdv_smem_bytes(int N) {
  const int tiles = (N + attn::T - 1) / attn::T;
  return 6 * SPLIT * sizeof(float) + attn::T * sizeof(float) +
         (size_t)tiles * attn::T * sizeof(float) + (2 + 4) * 64 * sizeof(float) + 1024;
}
// Q, dO, K, V, K^T (split tiles); lse and delta of the query tile, the
// column sums of dq and one 64-column partial per warp
constexpr size_t DQ_SMEM_BYTES =
    5 * SPLIT * sizeof(float) + 2 * attn::T * sizeof(float) + (1 + 4) * 64 * sizeof(float) + 1024;
}  // namespace attn32

// delta = rowsum(dO * O) of rows [r0, r0 + count) of one head into
// out[0, count), 0 past N: 8 threads a row, 8 columns each, summed over the
// 8 by shuffles in a fixed order. count is a multiple of 16 (a pass of the
// 128 threads), so every lane of a warp takes part in each shuffle.
__device__ __forceinline__ void rows_delta_f32(const AttnBwdArgsT<float>& p, const float* dh,
                                               const float* oh, int r0, int count, float* out) {
  const int c = 8 * (threadIdx.x % 8);
  for (int r = r0 + threadIdx.x / 8; r < r0 + count; r += attn::THREADS / 8) {
    float d = 0.f;
    if (r < p.N) {
      const float4* a = reinterpret_cast<const float4*>(dh + (long long)r * p.d_sn + c);
      const float4* o = reinterpret_cast<const float4*>(oh + (long long)r * p.o_sn + c);
      const float4 a0 = a[0], a1 = a[1], o0 = o[0], o1 = o[1];
      d = a0.x * o0.x + a0.y * o0.y + a0.z * o0.z + a0.w * o0.w + a1.x * o1.x + a1.y * o1.y +
          a1.z * o1.z + a1.w * o1.w;
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if (threadIdx.x % 8 == 0) out[r - r0] = d;
  }
}

// One thread's rows of a 64 x 64 fp32 gradient tile (rows r0 + 16 warp +
// lane / 4 and + 8 of the head) to `out`, rows at or beyond N left out.
__device__ __forceinline__ void store_grad_rows_f32(const AttnBwdArgsT<float>& p, float* out,
                                                    long long head, int r0, const float (&d)[32]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= p.N) continue;
    const long long off = head + row * p.g_sn + 2 * (lane % 4);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      store2(out + off + 8 * jb, d[4 * jb + 2 * h], d[4 * jb + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(attn::THREADS)
attention_bwd_dkdv_f32_kernel(const AttnBwdArgsT<float> p) {
  using attn32::SPLIT;
  constexpr int T = attn::T;
  extern __shared__ unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(align1024(smem_raw));   // split tiles
  float* Vs = Ks + SPLIT;
  float* Qs = Vs + SPLIT;
  float* Ds = Qs + SPLIT;   // dO of the query tile
  float* Qt = Ds + SPLIT;   // Q^T and dO^T of the query tile, queries in tf32_key_slot order
  float* Dt = Qt + SPLIT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int N = p.N, tiles = (N + T - 1) / T;
  float* lse_t = Dt + SPLIT;         // lse * log2(e) of the query tile
  float* delta_all = lse_t + T;      // [tiles * T], 0 past N
  float* col = delta_all + tiles * T;   // [2][64]: the column sums of dk, dv
  float* wpart = col + 2 * 64;          // [4][64]
  const float* qh = p.q + b * p.q_sb + h * p.q_sh;
  const float* kh = p.k + b * p.k_sb + h * p.k_sh;
  const float* vh = p.v + b * p.v_sb + h * p.v_sh;
  const float* dh = p.dout + b * p.d_sb + h * p.d_sh;
  const float* lse = p.lse + (long long)bh * N;
  const long long ghead = b * p.g_sb + h * p.g_sh;
  const float exp_scale = p.scale * 1.4426950408889634f;

  for (int i = threadIdx.x; i < 2 * 64; i += attn::THREADS) col[i] = 0.f;
  if (p.delta) {
    const float* delta = p.delta + (long long)bh * N;
    for (int r = threadIdx.x; r < tiles * T; r += attn::THREADS)
      delta_all[r] = r < N ? delta[r] : 0.f;
  } else {
    rows_delta_f32(p, dh, p.o + b * p.o_sb + h * p.o_sh, 0, tiles * T, delta_all);
  }

  // this thread's rows (keys) and columns (queries) of S^T and dP^T
  const int r_lo = 16 * warp + lane / 4, c_lo = 2 * (lane % 4);

  for (int j = 0; j < tiles; ++j) {
    load_tile_f32_async(Ks, kh, p.k_sn, j * T, N);
    load_tile_f32_async(Vs, vh, p.v_sn, j * T, N);
    cp_async_commit();
    float gk[32], gv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gk[i] = gv[i] = 0.f;

    for (int i = 0; i < tiles; ++i) {
      load_tile_f32_async(Qs, qh, p.q_sn, i * T, N);
      load_tile_f32_async(Ds, dh, p.d_sn, i * T, N);
      cp_async_commit();
      load_tile_f32_t(Qt, qh, p.q_sn, i * T, N);
      load_tile_f32_t(Dt, dh, p.d_sn, i * T, N);
      if (threadIdx.x < T) {
        const int row = i * T + threadIdx.x;
        lse_t[threadIdx.x] = row < N ? lse[row] * 1.4426950408889634f : 0.f;
      }
      cp_async_wait<0>();
      if (i == 0) {
        split_tile_f32(Ks);
        split_tile_f32(Vs);
      }
      split_tile_f32(Qs);
      split_tile_f32(Ds);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T over the 64 dims of the head
      float st[32], dpt[32];
      wgmma_fence();
      mma3_ss(st, Ks, Qs, 0);
      mma3_ss(dpt, Vs, Ds, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(S^T - lse) in place of S^T, 0 where the key or the query
      // is padding; dV += P^T dO from its hi and lo A fragments (8 queries a
      // k-step), B = dO^T
      uint32_t fh[8][4], fl[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int key = j * T + r_lo + 8 * (u >> 1), qc = 8 * kk + c_lo + (u & 1);
          const bool live = key < N && i * T + qc < N;
          st[4 * kk + u] = live ? exp2f(st[4 * kk + u] * exp_scale - lse_t[qc]) : 0.f;
        }
        const float pv[4] = {st[4 * kk], st[4 * kk + 1], st[4 * kk + 2], st[4 * kk + 3]};
        tf32_a_fragments(fh[kk], fl[kk], pv);
      }
      wgmma_fence();
      mma3_rs(gv, fh, fl, Dt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gv);

      // dS^T = P^T (dP^T - delta); dK += dS^T Q, B = Q^T
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          sv[u] = st[4 * kk + u] * (dpt[4 * kk + u] - delta_all[i * T + 8 * kk + c_lo + (u & 1)]);
        tf32_a_fragments(fh[kk], fl[kk], sv);
      }
      wgmma_fence();
      mma3_rs(gk, fh, fl, Qt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gk);
      __syncthreads();   // the query tiles are refilled by the next iteration
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) gk[i] *= p.scale;
    store_grad_rows_f32(p, p.dk, ghead, j * T, gk);
    store_grad_rows_f32(p, p.dv, ghead, j * T, gv);
    if (p.colsum) {   // key tiles in order
      add_colsums(gk, wpart, col);
      add_colsums(gv, wpart, col + 64);
    }
  }
  if (p.colsum) {
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * 64; i += attn::THREADS)
      p.colsum[(long long)b * p.cs_b + (1 + i / 64) * p.cs_part + h * 64 + i % 64] = col[i];
  }
}

__global__ void __launch_bounds__(attn::THREADS)
attention_bwd_dq_f32_kernel(const AttnBwdArgsT<float> p) {
  using attn32::SPLIT;
  constexpr int T = attn::T;
  extern __shared__ unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(align1024(smem_raw));   // split tiles
  float* Ds = Qs + SPLIT;   // dO of the query tile
  float* Ks = Ds + SPLIT;
  float* Vs = Ks + SPLIT;
  float* Kt = Vs + SPLIT;   // K^T of the key tile, keys in tf32_key_slot order
  float* lse_t = Kt + SPLIT;     // lse * log2(e) of the query tile
  float* delta_t = lse_t + T;    // delta of the query tile
  float* col = delta_t + T;      // [64]: the column sums of dq
  float* wpart = col + 64;       // [4][64]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int N = p.N, tiles = (N + T - 1) / T;
  const float* qh = p.q + b * p.q_sb + h * p.q_sh;
  const float* kh = p.k + b * p.k_sb + h * p.k_sh;
  const float* vh = p.v + b * p.v_sb + h * p.v_sh;
  const float* dh = p.dout + b * p.d_sb + h * p.d_sh;
  const float* lse = p.lse + (long long)bh * N;
  const long long ghead = b * p.g_sb + h * p.g_sh;
  const float exp_scale = p.scale * 1.4426950408889634f;
  if (threadIdx.x < 64) col[threadIdx.x] = 0.f;

  // this thread's rows (queries) and columns (keys) of S and dP
  const int r_lo = 16 * warp + lane / 4, c_lo = 2 * (lane % 4);

  for (int i = 0; i < tiles; ++i) {
    load_tile_f32_async(Qs, qh, p.q_sn, i * T, N);
    load_tile_f32_async(Ds, dh, p.d_sn, i * T, N);
    cp_async_commit();
    if (threadIdx.x < T) {
      const int row = i * T + threadIdx.x;
      lse_t[threadIdx.x] = row < N ? lse[row] * 1.4426950408889634f : 0.f;
      if (p.delta) delta_t[threadIdx.x] = row < N ? p.delta[(long long)bh * N + row] : 0.f;
    }
    if (!p.delta) rows_delta_f32(p, dh, p.o + b * p.o_sb + h * p.o_sh, i * T, T, delta_t);
    float gq[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) gq[e] = 0.f;

    for (int j = 0; j < tiles; ++j) {
      load_tile_f32_async(Ks, kh, p.k_sn, j * T, N);
      load_tile_f32_async(Vs, vh, p.v_sn, j * T, N);
      cp_async_commit();
      load_tile_f32_t(Kt, kh, p.k_sn, j * T, N);
      cp_async_wait<0>();
      if (j == 0) {
        split_tile_f32(Qs);
        split_tile_f32(Ds);
      }
      split_tile_f32(Ks);
      split_tile_f32(Vs);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();

      // S = Q K^T and dP = dO V^T over the 64 dims of the head
      float sq[32], dpq[32];
      wgmma_fence();
      mma3_ss(sq, Qs, Ks, 0);
      mma3_ss(dpq, Ds, Vs, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sq);
      fence_regs(dpq);

      // dS = P (dP - delta), 0 where the query or the key is padding; as hi
      // and lo TF32 A fragments, 8 keys a k-step
      uint32_t sf[8][4], sl[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int qr = r_lo + 8 * (u >> 1), key = j * T + 8 * kk + c_lo + (u & 1);
          const bool live = i * T + qr < N && key < N;
          const float pq = live ? exp2f(sq[4 * kk + u] * exp_scale - lse_t[qr]) : 0.f;
          sv[u] = pq * (dpq[4 * kk + u] - delta_t[qr]);
        }
        tf32_a_fragments(sf[kk], sl[kk], sv);
      }

      // dQ += dS K, B = K^T
      wgmma_fence();
      mma3_rs(gq, sf, sl, Kt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gq);
      __syncthreads();   // the key tiles are refilled by the next iteration
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) gq[e] *= p.dq_scale;
    store_grad_rows_f32(p, p.dq, ghead, i * T, gq);
    if (p.colsum) add_colsums(gq, wpart, col);   // query tiles in order
  }
  if (p.colsum) {
    __syncthreads();
    if (threadIdx.x < 64)
      p.colsum[(long long)b * p.cs_b + h * 64 + threadIdx.x] = col[threadIdx.x];
  }
}

// Launches the fp32 attention backward (its two kernels) on `st`;
// cudaErrorInvalidValue, without a launch, for a shape the bf16 form does
// not take either.
inline cudaError_t attention_bwd(const AttnBwdArgsT<float>& p, int hd, cudaStream_t st) {
  if (!attention_bwd_takes(hd, p.N) || p.B < 1 || p.H < 1 || !(p.delta || p.o))
    return cudaErrorInvalidValue;
  const size_t kv_smem = attn32::dkdv_smem_bytes(p.N);
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_dkdv_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attention_bwd_dq_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)attn32::DQ_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  attention_bwd_dkdv_f32_kernel<<<p.B * p.H, attn::THREADS, kv_smem, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attention_bwd_dq_f32_kernel<<<p.B * p.H, attn::THREADS, attn32::DQ_SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
}

}  // namespace dk
