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
// on the short route each CTA computes delta of its head's N rows in its
// prologue (8 threads a row, 16 bytes each, a fixed-order sum) into shared
// memory. That reads dO and O of the head once more (2 x N x 64 bf16; 2 x
// 19.5 MB at [768, 198, 64]) and saves a launch and a round trip of delta
// through device memory. The split route computes it the same way, once per
// head, in a launch of its own.
//
// Two routes compute it, with the same products of each (key tile, query
// tile) pair and every sum in the same order, so that where both take a
// shape they give the same bits.
//
// The short route (`attention_bwd_kernel`, N <= 256 by itself; it takes N up
// to 704): one CTA (one warpgroup, 128 threads) per (batch, head). It walks
// the key tiles of 64 keys; for each it keeps dK and dV of those keys in
// registers and loops over the query tiles of 64 rows:
//   S^T = K Q^T and dP^T = V dO^T: wgmma from shared memory, keys as rows, so
//        that P^T and dS^T land in registers as the A operand of the next two;
//   dV += P^T dO and dK += dS^T Q: wgmma with A from registers, dO and Q
//        as they lie in shared memory (wgmma's transposed B operand);
//   dQ_i = dS K: dS^T goes to shared memory in the 128-byte swizzle and is
//        read as wgmma's transposed A operand, K as its transposed B; the
//        product is added to an fp32 dQ of all N rows in shared memory (11
//        query tiles at most).
// dQ sums its key tiles in key-tile order inside one CTA: no atomics, and
// each element is added to by one thread, so two runs give the same bits.
// Tiles arrive by cp.async in the 128-byte swizzle (attention_fwd.cuh's
// loader); rows at or beyond N arrive as zeros, and P is set to 0 wherever
// the key or the query is at or beyond N, so padding adds nothing.
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
// N = 198, two CTAs an SM; 227,072 bytes at 11 tiles, N = 704).
//
// The split route (N > 256, attn_bwd::SPLIT_TILES; forced at any N by
// attention_bwd's `route`). Above 704 rows dQ of all rows no longer fits a
// CTA, and below it B*H CTAs (96 at B = 32 of 3 heads, for 132 SMs) that
// each walk tiles^2 pairs in series leave the card idle. So the pairs are
// spread over 2 x B*H x tiles CTAs, one warpgroup each, and no N x 64
// partial reaches device memory:
//   attention_bwd_delta_kernel (flash, which passes o): delta of each 64-row
//        tile into the workspace, computed as the short route computes it;
//   attention_bwd_split_kernel, in one launch:
//     split_dkdv, one CTA per (batch, head, key tile): K and V once, then the
//        query tiles in order, each pair's S^T, dP^T, P^T, dS^T, dV += P^T dO
//        and dK += dS^T Q as the short route computes them, while the next
//        query tile's Q and dO (cp.async) and its lse and delta (registers)
//        arrive in a second buffer;
//     split_dq, one CTA per (batch, head, query tile): Q, dO, lse and delta
//        once, then the key tiles in order, the next K and V arriving in a
//        second buffer; per pair S^T and dP^T again, dS^T to shared memory,
//        dQ_i = dS K, added to dQ in registers from zero in key-tile order,
//        as the short route adds it in shared memory; one barrier a pair in
//        split_dkdv, two in split_dq;
//   attention_bwd_colsum_kernel (with `colsum`): each tile's column sums of
//        dq, dk and dv, written by the two halves as partials, added in tile
//        order (dk's and dv's in the short route's order).
// A pair costs seven products instead of five (S^T and dP^T in both halves):
// 1.4 times the bound's operations, against 2,496 CTAs at B*H = 96, N = 786.
// One launch for both halves, so that the dQ CTAs fill the SMs while the
// last wave of dK/dV drains (two launches of 1,248 CTAs at three an SM each
// end on a wave 15% full; measured 0.88 of their time at N = 786). Shared
// memory: 59 KB a CTA (the dQ half's Q, dO, two K, two V and dS^T); the
// registers, held to 168 (the dK/dV half's dK, dV, S^T, dP^T and the two A
// operands), allow three CTAs an SM. What bounds it: its seven products
// (operations) in principle; in practice each CTA's serial chain of a pair,
// which three CTAs an SM overlap only in part (about a quarter of the tensor
// cores' rate at N = 786). The workspace (`attention_bwd_workspace`) holds
// delta [B*H][N64] and the partials [B*H][tiles][3][64] fp32: 1.7 MB at
// B*H = 96, N = 1026.

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
constexpr int MAX_TILES = 11;          // the short route, dQ in shared memory: N <= 704
// the short route's shared memory: five bf16 tiles, lse of a query tile,
// delta and dQ of all rows, the column sums of dq, dk, dv and one 64-column
// partial per warp
inline size_t smem_bytes(int N) {
  const int tiles = (N + T - 1) / T;
  return 5 * TILE * sizeof(bf16) + T * sizeof(float) + (size_t)tiles * T * 65 * sizeof(float) +
         (3 + 4) * 64 * sizeof(float) + 1024;
}
// The split route from 5 query tiles (N > 256) on: at 5 to 11 tiles it takes
// 0.56-0.72 of the short route's time at B*H = 96 and 768, at 4 (N = 198,
// B*H = 768) 1.14 (PERF.md).
constexpr int SPLIT_TILES = 5;
// The CTAs an SM the split route's registers must allow (__launch_bounds__:
// 168 registers and 68 bytes spilled, where the compiler would take 184 and
// fit two; the spill costs nothing measured, PERF.md).
constexpr int SPLIT_CTAS = 3;
// The split route's, the larger of its halves': dK/dV six bf16 tiles (K, V,
// two Q, two dO) and lse and delta of two query tiles; dQ seven (Q, dO, two
// K, two V, dS^T) and lse and delta of one; one 64-column partial per warp.
constexpr size_t SPLIT_SMEM = 7 * TILE * sizeof(bf16) + 4 * T * sizeof(float) +
                              4 * 64 * sizeof(float) + 1024;
}  // namespace attn_bwd

// Whether the bf16 backward takes the split route at N by itself.
inline bool attention_bwd_splits(int N) {
  return (N + attn_bwd::T - 1) / attn_bwd::T >= attn_bwd::SPLIT_TILES;
}

// Bytes of the split route's workspace for B*H heads of N rows: delta
// [B*H][N64] (flash only) and the tiles' column-sum partials [B*H][tiles][3]
// [64], fp32.
inline size_t attention_bwd_split_workspace(int B, int H, int N) {
  const long long tiles = (N + attn_bwd::T - 1) / attn_bwd::T;
  return (size_t)B * H * tiles * (attn_bwd::T + 3 * 64) * sizeof(float);
}

// Bytes of the bf16 attention backward's workspace: none on the short route.
inline size_t attention_bwd_workspace(int B, int H, int N) {
  return attention_bwd_splits(N) ? attention_bwd_split_workspace(B, H, N) : 0;
}

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

// The column sums of one 64 x 64 accumulator (all 64 rows; rows past N hold
// zeros), per warp: each warp's 16 rows by shuffles into wpart[warp][64]. All
// 128 threads call it; wpart is complete when it returns.
__device__ __forceinline__ void warp_colsums(const float (&d)[32], float* wpart) {
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
}

// Adds the column sums of one 64 x 64 accumulator to col[64]: the warps' sums
// (warp_colsums) in warp order. All 128 threads call it.
__device__ __forceinline__ void add_colsums(const float (&d)[32], float* wpart, float* col) {
  warp_colsums(d, wpart);
  if (threadIdx.x < 64)
    col[threadIdx.x] += wpart[threadIdx.x] + wpart[64 + threadIdx.x] + wpart[128 + threadIdx.x] +
                        wpart[192 + threadIdx.x];
  __syncthreads();
}

// The column sums of one 64 x 64 accumulator, as add_colsums adds them, to
// out[64] (device memory). All 128 threads call it.
__device__ __forceinline__ void store_colsums(const float (&d)[32], float* wpart, float* out) {
  warp_colsums(d, wpart);
  if (threadIdx.x < 64)
    out[threadIdx.x] = wpart[threadIdx.x] + wpart[64 + threadIdx.x] + wpart[128 + threadIdx.x] +
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

// delta = rowsum(dO * O) of rows [r0, r0 + 64) of one head into out[0, 64),
// 0 past N: 8 threads a row, 8 columns each, summed over the 8 by shuffles
// in a fixed order; a thread has the loads of 4 rows (16 apart) in flight.
__device__ __forceinline__ void tile_delta(const AttnBwdArgs& p, const bf16* dh, const bf16* oh,
                                           int r0, float* out) {
  const int c = 8 * (threadIdx.x % 8), r1 = threadIdx.x / 8;
  uint4 a[4], o[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + r1 + 16 * u;
    a[u] = o[u] = make_uint4(0u, 0u, 0u, 0u);
    if (r < p.N) {
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
    if (threadIdx.x % 8 == 0) out[r1 + 16 * u] = d;
  }
}

// The short route: one CTA per (batch, head), dQ of all rows in shared memory.
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
  float* col = dq + tiles * T * 64;   // [3][64]: the column sums of dq, dk, dv
  const bf16* qh = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kh = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vh = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* dh = p.dout + b * p.d_sb + h * p.d_sh;
  const float* lse = p.lse + (long long)bh * N;
  const long long ghead = b * p.g_sb + h * p.g_sh;
  constexpr float LOG2E = 1.4426950408889634f;
  const float s_log2e = p.scale * LOG2E;   // the block: scale 1, LOG2E itself

  float* wpart = col + 3 * 64;        // [4][64]
  for (int i = threadIdx.x; i < tiles * T * 16; i += attn::THREADS)
    reinterpret_cast<float4*>(dq)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < 3 * 64; i += attn::THREADS) col[i] = 0.f;
  if (p.delta) {
    const float* delta = p.delta + (long long)bh * N;
    for (int r = threadIdx.x; r < tiles * T; r += attn::THREADS)
      delta_all[r] = r < N ? delta[r] : 0.f;
  } else {
    const bf16* oh = p.o + b * p.o_sb + h * p.o_sh;
    for (int r0 = 0; r0 < tiles * T; r0 += T) tile_delta(p, dh, oh, r0, delta_all + r0);
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

// ---------------------------------------------------------------------------
// The split route: one CTA per (batch, head, key tile) for dK and dV and one
// per (batch, head, query tile) for dQ (the header's note)
// ---------------------------------------------------------------------------

// lse * log2(e) (threads 0-63) or delta (threads 64-127) of row 64 i +
// threadIdx.x % 64 of the head, 0 past N: the row statistics of query tile
// i, one value a thread.
__device__ __forceinline__ float split_row_stat(const float* lse, const float* delta, int i,
                                                int N) {
  constexpr float LOG2E = 1.4426950408889634f;
  const int row = i * attn_bwd::T + threadIdx.x % attn_bwd::T;
  if (row >= N) return 0.f;
  return threadIdx.x < attn_bwd::T ? lse[row] * LOG2E : delta[row];
}

// What both halves of the split route compute of one (key tile, query tile)
// pair, as the short route computes it: S^T = K Q^T and dP^T = V dO^T over
// the 64 dims of the head (the tiles in shared memory), then P^T = exp(S^T -
// lse) and dS^T = P^T (dP^T - delta), 0 at padding keys and queries; key0
// and q0 are the tiles' first rows. dS^T is left in s; with FRAGMENTS, P^T
// and dS^T also go to pa and sa as wgmma A fragments (16 queries a k-step).
template <bool FRAGMENTS>
__device__ __forceinline__ void split_pair_scores(float (&s)[32], uint32_t (&pa)[4][4],
                                                  uint32_t (&sa)[4][4], const bf16* Ks,
                                                  const bf16* Vs, const bf16* Qs, const bf16* Ds,
                                                  const float* lse_s, const float* delta_s,
                                                  int key0, int q0, int N, float s_log2e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_lo = 16 * warp + lane / 4, c_lo = 2 * (lane % 4);
  float dp[32];
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
#pragma unroll
  for (int jb = 0; jb < 8; ++jb) {
    float pv[4], sv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + r_lo + 8 * (e >> 1);
      const int col = 8 * jb + c_lo + (e & 1);
      const int idx = 4 * jb + e;
      const bool in = key < N && q0 + col < N;
      pv[e] = in ? exp2f(s[idx] * s_log2e - lse_s[col]) : 0.f;
      sv[e] = pv[e] * (dp[idx] - delta_s[col]);
      s[idx] = sv[e];
    }
    if constexpr (FRAGMENTS) {
      pa[jb / 2][2 * (jb & 1)] = pack_bf16(pv[0], pv[1]);
      pa[jb / 2][2 * (jb & 1) + 1] = pack_bf16(pv[2], pv[3]);
      sa[jb / 2][2 * (jb & 1)] = pack_bf16(sv[0], sv[1]);
      sa[jb / 2][2 * (jb & 1) + 1] = pack_bf16(sv[2], sv[3]);
    }
  }
}

// Flash's delta (flash passes o, not delta): one CTA per (batch, head, query
// tile), blockIdx.x = bh * tiles + i, into delta_w [B*H][N64].
__global__ void __launch_bounds__(attn::THREADS)
attention_bwd_delta_kernel(const AttnBwdArgs p, float* delta_w) {
  const int tiles = (p.N + attn_bwd::T - 1) / attn_bwd::T;
  const int bh = blockIdx.x / tiles, i = blockIdx.x % tiles, b = bh / p.H, h = bh % p.H;
  tile_delta(p, p.dout + b * p.d_sb + h * p.d_sh, p.o + b * p.o_sb + h * p.o_sh,
             i * attn_bwd::T, delta_w + (long long)blockIdx.x * attn_bwd::T);
}

// dK and dV of key tile j of head bh (the first half of the split grid). K
// and V of the key tile stay in shared memory and dK, dV in registers while
// the query tiles pass in order, two buffers of Q, dO, lse and delta. With
// `colsum`, the key tile's column sums of dk and dv go to col_part
// [B*H][tiles][3][64] at parts 1 and 2.
__device__ __forceinline__ void split_dkdv(const AttnBwdArgs& p, const float* delta_w,
                                           float* col_part, int bh, int j,
                                           unsigned char* smem) {
  using attn_bwd::T;
  using attn_bwd::TILE;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;       // [2][TILE]: this pair's query tile and the next one's
  bf16* Ds = Qs + 2 * TILE;   // [2][TILE]: dO likewise
  float* stat = reinterpret_cast<float*>(Ds + 2 * TILE);   // [2][lse * log2(e), delta][T]
  float* wpart = stat + 4 * T;                              // [4][64]
  const int N = p.N, tiles = (N + T - 1) / T, b = bh / p.H, h = bh % p.H;
  const bf16* qh = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* dh = p.dout + b * p.d_sb + h * p.d_sh;
  const float* lse = p.lse + (long long)bh * N;
  const float* delta = p.delta ? p.delta + (long long)bh * N : delta_w + (long long)bh * tiles * T;
  const float s_log2e = p.scale * 1.4426950408889634f;

  load_tile_async(Ks, p.k + b * p.k_sb + h * p.k_sh, p.k_sn, j * T, N);
  load_tile_async(Vs, p.v + b * p.v_sb + h * p.v_sh, p.v_sn, j * T, N);
  load_tile_async(Qs, qh, p.q_sn, 0, N);
  load_tile_async(Ds, dh, p.d_sn, 0, N);
  cp_async_commit();
  stat[threadIdx.x] = split_row_stat(lse, delta, 0, N);
  float dk[32], dv[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;

  for (int i = 0; i < tiles; ++i) {
    const int cur = i & 1;
    cp_async_wait<0>();   // pair i's copies
    // this thread's copies are visible to wgmma (the async proxy), then all
    // threads'; every thread is past pair i - 1, so its buffers are free
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    float next = 0.f;   // the next query tile's row statistic, stored after this pair
    if (i + 1 < tiles) {
      load_tile_async(Qs + (cur ^ 1) * TILE, qh, p.q_sn, (i + 1) * T, N);
      load_tile_async(Ds + (cur ^ 1) * TILE, dh, p.d_sn, (i + 1) * T, N);
      cp_async_commit();
      next = split_row_stat(lse, delta, i + 1, N);
    }

    const bf16* Qi = Qs + cur * TILE;
    const bf16* Di = Ds + cur * TILE;
    const float* st = stat + 2 * T * cur;
    float s[32];
    uint32_t pa[4][4], sa[4][4];
    split_pair_scores<true>(s, pa, sa, Ks, Vs, Qi, Di, st, st + T, j * T, i * T, N, s_log2e);

    // dV += P^T dO and dK += dS^T Q: a k-step of 16 queries is 16 rows of dO
    // and Q, 2048 bytes
    const uint64_t q_desc = sw128_desc(Qi), do_desc = sw128_desc(Di);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs_t(dv, pa[k], do_desc + 128 * k, 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs_t(dk, sa[k], q_desc + 128 * k, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    stat[2 * T * (cur ^ 1) + threadIdx.x] = next;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) dk[e] *= p.scale;
  const long long ghead = b * p.g_sb + h * p.g_sh;
  store_grad_rows(p, p.dk, ghead, j * T, dk);
  store_grad_rows(p, p.dv, ghead, j * T, dv);
  if (p.colsum) {
    float* col = col_part + ((long long)bh * tiles + j) * 3 * 64;
    store_colsums(dk, wpart, col + 64);
    store_colsums(dv, wpart, col + 128);
  }
}

// dQ of query tile i of head bh (the second half of the split grid). Q, dO,
// lse and delta of the query tile stay in shared memory and dQ in registers
// while the key tiles pass in order, two buffers of K and V. With `colsum`,
// the query tile's column sums of dq go to col_part at part 0.
__device__ __forceinline__ void split_dq(const AttnBwdArgs& p, const float* delta_w,
                                         float* col_part, int bh, int i, unsigned char* smem) {
  using attn_bwd::T;
  using attn_bwd::TILE;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ds = Qs + TILE;       // dO of the query tile
  bf16* Ks = Ds + TILE;       // [2][TILE]: this pair's key tile and the next one's
  bf16* Vs = Ks + 2 * TILE;   // [2][TILE]: V likewise
  bf16* Ss = Vs + 2 * TILE;   // dS^T of the pair
  float* stat = reinterpret_cast<float*>(Ss + TILE);   // [lse * log2(e), delta][T]
  float* wpart = stat + 2 * T;                          // [4][64]
  const int N = p.N, tiles = (N + T - 1) / T, b = bh / p.H, h = bh % p.H;
  const bf16* kh = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vh = p.v + b * p.v_sb + h * p.v_sh;
  const float* delta = p.delta ? p.delta + (long long)bh * N : delta_w + (long long)bh * tiles * T;
  const float s_log2e = p.scale * 1.4426950408889634f;

  load_tile_async(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_sn, i * T, N);
  load_tile_async(Ds, p.dout + b * p.d_sb + h * p.d_sh, p.d_sn, i * T, N);
  load_tile_async(Ks, kh, p.k_sn, 0, N);
  load_tile_async(Vs, vh, p.v_sn, 0, N);
  cp_async_commit();
  stat[threadIdx.x] = split_row_stat(p.lse + (long long)bh * N, delta, i, N);
  float dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    const int cur = j & 1;
    cp_async_wait<0>();   // pair j's copies
    // the copies are visible; every thread is past pair j - 1, so its K and V
    // buffers and dS^T are free
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (j + 1 < tiles) {
      load_tile_async(Ks + (cur ^ 1) * TILE, kh, p.k_sn, (j + 1) * T, N);
      load_tile_async(Vs + (cur ^ 1) * TILE, vh, p.v_sn, (j + 1) * T, N);
      cp_async_commit();
    }

    const bf16* Kj = Ks + cur * TILE;
    float s[32];
    uint32_t pa[4][4], sa[4][4];   // unused: dS^T goes through shared memory
    split_pair_scores<false>(s, pa, sa, Kj, Vs + cur * TILE, Qs, Ds, stat, stat + T, j * T,
                             i * T, N, s_log2e);

    // dS^T to shared memory, then dQ_i = dS K (dS^T and K both read
    // transposed: 16 keys a k-step), added to dQ in key-tile order
    store_tile_sw128(Ss, s);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    float dqi[32];
    const uint64_t ds_desc = sw128_desc(Ss), k_desc = sw128_desc(Kj);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_ss_tt(dqi, ds_desc + 128 * k, k_desc + 128 * k, k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqi);
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] += dqi[e];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) dq[e] *= p.dq_scale;
  store_grad_rows(p, p.dq, b * p.g_sb + h * p.g_sh, i * T, dq);
  if (p.colsum)
    store_colsums(dq, wpart, col_part + ((long long)bh * tiles + i) * 3 * 64);
}

// The split route's grid: 2 x B*H x tiles CTAs, one warpgroup each. The first
// half computes dK and dV (CTA bh * tiles + j: key tile j of head bh), the
// second dQ (bh * tiles + i past the first half: query tile i): one launch,
// so that the dQ CTAs fill the SMs while the last wave of dK/dV drains.
__global__ void __launch_bounds__(attn::THREADS, attn_bwd::SPLIT_CTAS)
attention_bwd_split_kernel(const AttnBwdArgs p, const float* delta_w, float* col_part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int tiles = (p.N + attn_bwd::T - 1) / attn_bwd::T, half = p.B * p.H * tiles;
  if ((int)blockIdx.x < half)
    split_dkdv(p, delta_w, col_part, blockIdx.x / tiles, blockIdx.x % tiles, smem);
  else
    split_dq(p, delta_w, col_part, (blockIdx.x - half) / tiles, (blockIdx.x - half) % tiles,
             smem);
}

// The split route's column sums: one CTA per (batch, head) adds its tiles'
// partials of dq, dk and dv in tile order into colsum.
__global__ void __launch_bounds__(attn::THREADS)
attention_bwd_colsum_kernel(const AttnBwdArgs p, const float* col_part) {
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int tiles = (p.N + attn_bwd::T - 1) / attn_bwd::T;
  const float* part = col_part + (long long)bh * tiles * 3 * 64;
  for (int e = threadIdx.x; e < 3 * 64; e += attn::THREADS) {
    float sum = 0.f;
    for (int t = 0; t < tiles; ++t) sum += part[t * 3 * 64 + e];
    p.colsum[(long long)b * p.cs_b + (e / 64) * p.cs_part + h * 64 + e % 64] = sum;
  }
}

// Whether the bf16 kernels take head dim hd and sequence length N: any N.
// Neither route's shared memory depends on N past 11 tiles, every row and
// head offset is 64-bit, and the split route's workspace is O(B*H*N); what
// bounds N is the grid (attention_bwd refuses 2 B*H*tiles > 2^31 - 1 CTAs).
inline bool attention_bwd_takes(int hd, int N) { return hd == 64 && N >= 1; }

// The routes of the bf16 attention backward: the one attention_bwd_splits
// picks, or either one forced (the short route up to 11 query tiles).
enum class AttnBwdRoute { AUTO = 0, SHORT = 1, SPLIT = 2 };

// Launches the bf16 attention backward on `st`: the short route or the split
// route (`route`, by default as attention_bwd_splits picks), with `work` of
// attention_bwd_split_workspace(B, H, N) bytes on the split route (the short
// route takes none, and `work` may then be null). cudaErrorInvalidValue,
// without a launch, for a shape or route it does not take.
inline cudaError_t attention_bwd(const AttnBwdArgs& p, int hd, float* work, cudaStream_t st,
                                 AttnBwdRoute route = AttnBwdRoute::AUTO) {
  if (!attention_bwd_takes(hd, p.N) || p.B < 1 || p.H < 1 || !(p.delta || p.o))
    return cudaErrorInvalidValue;
  if (route == AttnBwdRoute::AUTO)
    route = attention_bwd_splits(p.N) ? AttnBwdRoute::SPLIT : AttnBwdRoute::SHORT;
  cudaError_t e;
  if (route == AttnBwdRoute::SHORT) {
    if ((p.N + attn_bwd::T - 1) / attn_bwd::T > attn_bwd::MAX_TILES) return cudaErrorInvalidValue;
    const size_t smem = attn_bwd::smem_bytes(p.N);
    e = cudaFuncSetAttribute(attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attention_bwd_kernel<<<p.B * p.H, attn::THREADS, smem, st>>>(p);
    return cudaGetLastError();
  }
  const long long bh = (long long)p.B * p.H, tiles = (p.N + attn_bwd::T - 1) / attn_bwd::T;
  if (!work || 2 * bh * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(bh * tiles);
  float* delta_w = work;                              // [B*H][N64]
  float* col_part = work + bh * tiles * attn_bwd::T;  // [B*H][tiles][3][64]
  if (!p.delta) {
    attention_bwd_delta_kernel<<<grid, attn::THREADS, 0, st>>>(p, delta_w);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute(attention_bwd_split_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)attn_bwd::SPLIT_SMEM);
  if (e != cudaSuccess) return e;
  attention_bwd_split_kernel<<<2 * grid, attn::THREADS, attn_bwd::SPLIT_SMEM, st>>>(p, delta_w,
                                                                                    col_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (p.colsum) attention_bwd_colsum_kernel<<<(unsigned)bh, attn::THREADS, 0, st>>>(p, col_part);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 form: fp32 operands on TF32 wgmma (m64n64k8) in 3xTF32, fp32
// accumulation
// ---------------------------------------------------------------------------
//
// The math is the bf16 form's, every product in 3xTF32 as attention_fwd.cuh's
// fp32 form computes it (each operand split into hi and lo TF32 parts, three
// wgmmas a product). Nothing is rounded to bf16: P, dS, delta, lse and the
// gradients are fp32. TF32 wgmma takes no transpose and its B operand (and a
// shared-memory A) is K-major, so the orientation of each product is chosen
// for the operand it can read as it lies:
//   S = Q K^T and dP = dO V^T     A = the Q and dO tiles, B = K and V, all
//                                 as they lie (query rows in the accumulators);
//   dQ_i = dS K                   A = dS's hi and lo parts read back from
//                                 dS^T (below) as fragments, B = K^T of the
//                                 key tile;
//   dV^T += dO^T P^T, dK^T += Q^T dS^T
//                                 A = dO^T and Q^T from registers, B = P^T
//                                 and dS^T, which the threads store from
//                                 their accumulators into tiles of their own
//                                 (rows keys, columns queries).
// Five products of N x N x 64 a (key tile, query tile) pair, as the bf16 form
// has. Every transposed input tile is made once per head and call: K^T once
// by the CTA that owns the key tile (load_tile_f32_t), Q^T and dO^T of each
// head once, by a prologue kernel, into the workspace ([B*H][64][N padded to
// 64]), from which each pair's A fragments are read as they lie (float2 of
// two neighbouring queries; the columns of a k-step hold its queries in
// tf32_key_slot order, so that they are P^T's and dS^T's columns as the
// threads store them).
// Three kernels:
//   attention_bwd_pack_f32_kernel: Q^T and dO^T of one 64-row tile of one
//     head into the workspace, and (flash, which passes no delta) delta =
//     rowsum(dO * O) of its rows;
//   attention_bwd_f32_kernel: one CTA per (batch, head, key tile), which
//     keeps dK^T and dV^T of its 64 keys in registers and walks the query
//     tiles in order. Its two warpgroups split each pair's products:
//     warpgroup 0 S, P^T, dV^T and dQ_i, warpgroup 1 dP, dS^T and dK^T,
//     handing P^T and dS^T to each other through named barriers, so that
//     one's products run under the other's exponentials and stores. Each
//     pair's dQ_i share goes to the workspace as an fp32 partial of its key
//     tile. The next query tile's Q and dO land by cp.async under the rest
//     of the pair, and each product's A fragments from device memory under
//     the product before. Shared memory: Q, dO, K, V, K^T, P^T, dS^T as
//     split tiles, 7 x 32 KB + alignment = 230,400 bytes: one CTA (256
//     threads) an SM, B*H x N64 / 64 CTAs (3,072 at the main shape);
//   attention_bwd_reduce_f32_kernel: one CTA per (batch, head) adds the dQ
//     partials in key-tile order (times dq_scale) and, with `colsum`, sums dq
//     over the rows and the key tiles' column sums of dk and dv in order.
// Each sum runs in a fixed order: no atomics, two runs give the same bits.
// What bounds it on an H100: the five products, 3xTF32 on the TF32 tensor
// cores (3 x 5 x 2 N^2 64 operations a head against 7 N 64 fp32 values in
// and out, some 200 a byte at N = 198, above the card's ~150 for TF32);
// above that, each warpgroup's serial chain of products (three, two) and
// the padding of N to 64-row tiles.
// Workspace (`attention_bwd_f32_workspace`), fp32: Q^T and dO^T (2 x B*H x
// 64 x N64, N64 = N rounded up to 64), the dQ partials (N64 / 64 x B*H x N x
// 64), the key tiles' column sums of dk and dv (B*H x N64 / 64 x 2 x 64) and
// delta (B*H x N64).

namespace attn32 {
// Q, dO, K, V, K^T, P^T, dS^T (split tiles)
constexpr size_t BWD_SMEM_BYTES = 7 * SPLIT * sizeof(float) + 1024;
}  // namespace attn32

// The fp32 backward's workspace for B*H heads of N rows: its parts' floats
// and their offsets.
struct AttnBwdWork {
  long long bh, tiles, np;   // heads, 64-row tiles, N rounded up to 64
  long long qt_len() const { return bh * 64 * np; }            // Q^T and dO^T each
  long long dq_len(int N) const { return tiles * bh * N * 64; }  // [key tile][bh][N][64]
  long long col_len() const { return bh * tiles * 2 * 64; }     // [bh][key tile][dk, dv][64]
  long long delta_len() const { return bh * np; }                // [bh][np]
};

inline AttnBwdWork attn_bwd_work(int B, int H, int N) {
  const long long tiles = (N + attn::T - 1) / attn::T;
  return AttnBwdWork{(long long)B * H, tiles, tiles * attn::T};
}

// Bytes of the fp32 attention backward's workspace.
inline size_t attention_bwd_f32_workspace(int B, int H, int N) {
  const AttnBwdWork w = attn_bwd_work(B, H, N);
  return (size_t)(2 * w.qt_len() + w.dq_len(N) + w.col_len() + w.delta_len()) * sizeof(float);
}

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

// One warpgroup a (head, query tile), blockIdx.x = bh * tiles + i (a head's
// tiles side by side; B*H may pass gridDim.y's 65,535): Q^T and dO^T of rows
// [64 i, 64 i + 64) of head bh into qt and dt [B*H][64][np] (0 past N)
// through a padded shared tile, and with `delta` rowsum(dO * O) of those
// rows into delta [B*H][np].
__global__ void __launch_bounds__(attn::THREADS)
attention_bwd_pack_f32_kernel(const AttnBwdArgsT<float> p, int np, float* qt, float* dt,
                              float* delta) {
  __shared__ float tq[64][65], td[64][65];
  const int tiles = np / attn::T, bh = blockIdx.x / tiles, i = blockIdx.x % tiles;
  const int b = bh / p.H, h = bh % p.H, r0 = i * attn::T;
  const float* qh = p.q + b * p.q_sb + h * p.q_sh;
  const float* dh = p.dout + b * p.d_sb + h * p.d_sh;
  for (int e = threadIdx.x; e < 64 * 16; e += attn::THREADS) {
    const int r = e / 16, c = 4 * (e % 16), row = r0 + r;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), d = a;
    if (row < p.N) {
      a = *reinterpret_cast<const float4*>(qh + (long long)row * p.q_sn + c);
      d = *reinterpret_cast<const float4*>(dh + (long long)row * p.d_sn + c);
    }
    tq[r][c] = a.x; tq[r][c + 1] = a.y; tq[r][c + 2] = a.z; tq[r][c + 3] = a.w;
    td[r][c] = d.x; td[r][c + 1] = d.y; td[r][c + 2] = d.z; td[r][c + 3] = d.w;
  }
  if (delta)
    rows_delta_f32(p, dh, p.o + b * p.o_sb + h * p.o_sh, r0, attn::T,
                   delta + (long long)bh * np + r0);
  __syncthreads();
  float* qo = qt + (long long)bh * 64 * np + r0;
  float* dout = dt + (long long)bh * 64 * np + r0;
  for (int e = threadIdx.x; e < 64 * 16; e += attn::THREADS) {
    const int d = e / 16, r = 4 * (e % 16);
    *reinterpret_cast<float4*>(qo + (long long)d * np + r) =
        make_float4(tq[r][d], tq[r + 1][d], tq[r + 2][d], tq[r + 3][d]);
    *reinterpret_cast<float4*>(dout + (long long)d * np + r) =
        make_float4(td[r][d], td[r + 1][d], td[r + 2][d], td[r + 3][d]);
  }
}

// Thread `tid` (0-127) of a warpgroup holds rows r = 16 (tid / 32) + (tid %
// 32) / 4 and r + 8 of an accumulator, columns 2 t and 2 t + 1 of each 8
// (t = tid % 4).
__device__ __forceinline__ int acc_row(int tid) { return 16 * (tid / 32) + (tid % 32) / 4; }

// This thread's raw A fragments of a transposed query tile (rows d, columns
// the 64 queries of tile i): per k-step k, the float2 of queries 8 k + 2 t
// and + 1 (columns t and t + 4 in tf32_key_slot order, t = tid % 4) at rows
// d = r and r + 8.
__device__ __forceinline__ void load_t_fragments(float2 (&f)[8][2], const float* src, int np,
                                                 int i, int tid) {
  const int r = acc_row(tid), t = tid % 4;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      f[k][hh] = __ldg(reinterpret_cast<const float2*>(src + (long long)(r + 8 * hh) * np +
                                                       i * attn::T + 8 * k + 2 * t));
}

// The hi and lo A fragments of raw fragments from load_t_fragments:
// (row r, column t), (r + 8, t), (r, t + 4), (r + 8, t + 4) of each k-step.
__device__ __forceinline__ void split_t_fragments(uint32_t (&hi)[8][4], uint32_t (&lo)[8][4],
                                                  const float2 (&f)[8][2]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v[4] = {f[k][0].x, f[k][1].x, f[k][0].y, f[k][1].y};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 x = tf32_split(v[u]);
      hi[k][u] = __float_as_uint(x.x);
      lo[k][u] = __float_as_uint(x.y);
    }
  }
}

// One thread's share of a transposed gradient tile (rows d, columns the 64
// keys from k0) to out[key][d] of the head (rows `sn` apart), keys at or
// beyond N left out. With `col`, also this warp's row sums (the column sums
// of the gradient over its keys) into col[d].
__device__ __forceinline__ void store_t_grad_f32(float* out, long long sn, int k0, int N,
                                                 const float (&d)[32], float* col, int tid) {
  const int r = acc_row(tid), c = 2 * (tid % 4);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int jb = 0; jb < 8; ++jb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * jb + c + (e & 1), row = r + 8 * (e >> 1);
      if (key < N) out[(long long)key * sn + row] = d[4 * jb + e];
      sum[e >> 1] += d[4 * jb + e];
    }
  if (!col) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    if (tid % 4 == 0) col[r + 8 * hh] = sum[hh];
  }
}

// Named barriers of attention_bwd_f32_kernel (0 is __syncthreads): the
// hand-offs of P^T and dS^T between its two warpgroups (all 256 threads:
// one warpgroup arrives, the other waits), and each warpgroup's own.
namespace attn32 {
constexpr int BAR_PT_FULL = 1, BAR_PT_FREE = 2, BAR_ST_FULL = 3, BAR_ST_FREE = 4, BAR_OWN = 5;
}

// Two warpgroups a CTA, one per (batch, head, key tile), each with its own
// share of every (key tile, query tile) pair, the query tiles in order:
//   warpgroup 0: S = Q K^T, P = exp(S - lse) stored as P^T; dV^T += dO^T P^T;
//                dQ_i = dS K, dS read back from dS^T as A fragments;
//   warpgroup 1: dP = dO V^T, dS = P (dP - delta) with P read back from P^T,
//                stored as dS^T; dK^T += Q^T dS^T.
// Warpgroup 0 owns Q, K, K^T and P^T, warpgroup 1 dO, V and dS^T; each loads
// and splits its own tiles (the next query tile's Q or dO by cp.async
// under the rest of the pair), and they meet only at the four hand-off
// barriers. P = hi + lo of P^T's split (within 2^-22 of the stored P).
__global__ void __launch_bounds__(2 * attn::THREADS)
attention_bwd_f32_kernel(const AttnBwdArgsT<float> p, const float* qt, const float* dt,
                         const float* delta_w, float* dq_part, float* col_part) {
  using namespace attn32;
  constexpr int T = attn::T;
  extern __shared__ unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(align1024(smem_raw));   // split tiles
  float* Ds = Qs + SPLIT;   // dO of the query tile
  float* Ks = Ds + SPLIT;
  float* Vs = Ks + SPLIT;
  float* Kt = Vs + SPLIT;   // K^T of the key tile, keys in tf32_key_slot order
  float* Pt = Kt + SPLIT;   // P^T and dS^T of the pair, queries in tf32_key_slot order
  float* St = Pt + SPLIT;
  const int wg = threadIdx.x / attn::THREADS, tid = threadIdx.x % attn::THREADS;
  const int N = p.N, tiles = (N + T - 1) / T, np = tiles * T;
  const int bh = blockIdx.x / tiles, j = blockIdx.x % tiles, b = bh / p.H, h = bh % p.H;
  const long long BH = (long long)p.B * p.H, ghead = b * p.g_sb + h * p.g_sh;
  float* col = p.colsum ? col_part + (bh * tiles + j) * 2 * 64 : nullptr;
  constexpr float LOG2E = 1.4426950408889634f;

  // this thread's rows (queries of S, dP, dQ; dims of dK^T, dV^T) and columns
  const int r_lo = acc_row(tid), c_lo = 2 * (tid % 4);
  // the byte offset in P^T and dS^T of its accumulator element u of k-step
  // 0, (query r_lo + 8 (u >> 1), key c_lo + (u & 1)); key 8 kk + c_lo + (u &
  // 1) lies 1024 kk bytes on
  int pt_off[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int qr = r_lo + 8 * (u >> 1);
    pt_off[u] = f32_tile_offset(c_lo + (u & 1), (qr & ~7) | tf32_key_slot(qr & 7));
  }
  const unsigned char* pt = reinterpret_cast<const unsigned char*>(Pt);
  const unsigned char* stt = reinterpret_cast<const unsigned char*>(St);
  uint32_t fh[8][4], fl[8][4];

  if (wg == 0) {
    const float* qh = p.q + b * p.q_sb + h * p.q_sh;
    const float* kh = p.k + b * p.k_sb + h * p.k_sh;
    const float* lse = p.lse + (long long)bh * N;
    const float* dth = dt + (long long)bh * 64 * np;
    const float exp_scale = p.scale * LOG2E;
    load_tile_f32_async(Ks, kh, p.k_sn, j * T, N, tid);
    load_tile_f32_async(Qs, qh, p.q_sn, 0, N, tid);
    cp_async_commit();
    load_tile_f32_t(Kt, kh, p.k_sn, j * T, N, tid);
    float gv[32];   // dV^T of the key tile: rows d, columns keys
#pragma unroll
    for (int e = 0; e < 32; ++e) gv[e] = 0.f;

    for (int i = 0; i < tiles; ++i) {
      float lse_r[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = i * T + r_lo + 8 * hh;
        lse_r[hh] = row < N ? lse[row] * LOG2E : 0.f;
      }
      float2 fr[8][2];   // dO^T's fragments, loaded under S
      load_t_fragments(fr, dth, np, i, tid);
      cp_async_wait<0>();
      if (i == 0) split_tile_f32(Ks, tid);
      split_tile_f32(Qs, tid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(BAR_OWN + 0, attn::THREADS);

      // S = Q K^T over the 64 dims of the head
      float sq[32];
      wgmma_fence();
      mma3_ss(sq, Qs, Ks, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sq);
      named_sync(BAR_OWN + 0, attn::THREADS);   // every warp's S is done: Q is free
      if (i + 1 < tiles) {
        load_tile_f32_async(Qs, qh, p.q_sn, (i + 1) * T, N, tid);
        cp_async_commit();
      }

      // P = exp(S - lse), 0 where the query or the key is padding, as P^T
      if (i > 0) named_sync(BAR_PT_FREE, 2 * attn::THREADS);   // warpgroup 1 has read the last
      unsigned char* ptw = reinterpret_cast<unsigned char*>(Pt);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int qr = r_lo + 8 * (u >> 1), key = 8 * kk + c_lo + (u & 1);
          const bool live = i * T + qr < N && j * T + key < N;
          const float2 ps =
              tf32_split(live ? exp2f(sq[4 * kk + u] * exp_scale - lse_r[u >> 1]) : 0.f);
          const int off = pt_off[u] + 1024 * kk;
          *reinterpret_cast<float*>(ptw + off) = ps.x;
          *reinterpret_cast<float*>(ptw + TILE * 4 + off) = ps.y;
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_arrive(BAR_PT_FULL, 2 * attn::THREADS);
      named_sync(BAR_OWN + 0, attn::THREADS);

      // dV^T += dO^T P^T
      split_t_fragments(fh, fl, fr);
      wgmma_fence();
      mma3_rs(gv, fh, fl, Pt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gv);

      // dQ_i = dS K: dS's hi and lo parts read from dS^T as A fragments (8
      // keys a k-step; (row r, column t), (r + 8, t), (r, t + 4), (r + 8, t + 4)
      // are elements 0, 2, 1, 3 of the accumulator layout), B = K^T
      named_sync(BAR_ST_FULL, 2 * attn::THREADS);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int at[4] = {0, 2, 1, 3};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int off = pt_off[at[a]] + 1024 * kk;
          fh[kk][a] = *reinterpret_cast<const uint32_t*>(stt + off);
          fl[kk][a] = *reinterpret_cast<const uint32_t*>(stt + TILE * 4 + off);
        }
      }
      if (i + 1 < tiles) named_arrive(BAR_ST_FREE, 2 * attn::THREADS);
      float gq[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) gq[e] = 0.f;
      wgmma_fence();
      mma3_rs(gq, fh, fl, Kt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gq);
      // this key tile's share of dQ_i, a partial for the reduce kernel
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = i * T + r_lo + 8 * hh;
        if (row >= N) continue;
        float* dst = dq_part + ((j * BH + bh) * N + row) * 64 + c_lo;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb)
          store2(dst + 8 * jb, gq[4 * jb + 2 * hh], gq[4 * jb + 2 * hh + 1]);
      }
    }
    store_t_grad_f32(p.dv + ghead, p.g_sn, j * T, N, gv, col ? col + 64 : nullptr, tid);
  } else {
    const float* vh = p.v + b * p.v_sb + h * p.v_sh;
    const float* dh = p.dout + b * p.d_sb + h * p.d_sh;
    const float* delta = p.delta ? p.delta + (long long)bh * N : delta_w + (long long)bh * np;
    const float* qth = qt + (long long)bh * 64 * np;
    load_tile_f32_async(Vs, vh, p.v_sn, j * T, N, tid);
    load_tile_f32_async(Ds, dh, p.d_sn, 0, N, tid);
    cp_async_commit();
    float gk[32];   // dK^T of the key tile: rows d, columns keys
#pragma unroll
    for (int e = 0; e < 32; ++e) gk[e] = 0.f;

    for (int i = 0; i < tiles; ++i) {
      float delta_r[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = i * T + r_lo + 8 * hh;
        delta_r[hh] = row < N ? delta[row] : 0.f;
      }
      float2 fr[8][2];   // Q^T's fragments, loaded under dP
      load_t_fragments(fr, qth, np, i, tid);
      cp_async_wait<0>();
      if (i == 0) split_tile_f32(Vs, tid);
      split_tile_f32(Ds, tid);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(BAR_OWN + 1, attn::THREADS);

      // dP = dO V^T over the 64 dims of the head
      float dpq[32];
      wgmma_fence();
      mma3_ss(dpq, Ds, Vs, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dpq);
      named_sync(BAR_OWN + 1, attn::THREADS);   // every warp's dP is done: dO is free
      if (i + 1 < tiles) {
        load_tile_f32_async(Ds, dh, p.d_sn, (i + 1) * T, N, tid);
        cp_async_commit();
      }

      // dS = P (dP - delta), P from P^T (0 at padding), as dS^T
      named_sync(BAR_PT_FULL, 2 * attn::THREADS);
      if (i > 0) named_sync(BAR_ST_FREE, 2 * attn::THREADS);   // warpgroup 0 has read the last
      unsigned char* stw = reinterpret_cast<unsigned char*>(St);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int off = pt_off[u] + 1024 * kk;
          const float pv = *reinterpret_cast<const float*>(pt + off) +
                           *reinterpret_cast<const float*>(pt + TILE * 4 + off);
          const float2 ss = tf32_split(pv * (dpq[4 * kk + u] - delta_r[u >> 1]));
          *reinterpret_cast<float*>(stw + off) = ss.x;
          *reinterpret_cast<float*>(stw + TILE * 4 + off) = ss.y;
        }
      if (i + 1 < tiles) named_arrive(BAR_PT_FREE, 2 * attn::THREADS);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_arrive(BAR_ST_FULL, 2 * attn::THREADS);
      named_sync(BAR_OWN + 1, attn::THREADS);

      // dK^T += Q^T dS^T
      split_t_fragments(fh, fl, fr);
      wgmma_fence();
      mma3_rs(gk, fh, fl, St);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gk);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) gk[e] *= p.scale;
    store_t_grad_f32(p.dk + ghead, p.g_sn, j * T, N, gk, col, tid);
  }
}

// One CTA per (batch, head): dq = dq_scale x the sum of the key tiles'
// partials in tile order; with `colsum`, the column sums of dq over the
// head's rows (fixed order: each thread its rows, then the four row classes
// in order) and of dk and dv over the key tiles in order.
__global__ void __launch_bounds__(attn::THREADS)
attention_bwd_reduce_f32_kernel(const AttnBwdArgsT<float> p, const float* dq_part,
                                const float* col_part) {
  __shared__ float wpart[4 * 64];
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, N = p.N;
  const int tiles = (N + attn::T - 1) / attn::T;
  const long long BH = (long long)p.B * p.H, ghead = b * p.g_sb + h * p.g_sh;
  // thread t adds column pair t % 32 of rows t / 32, + 4, + 8, ...
  float2 qs = make_float2(0.f, 0.f);
  for (int e = threadIdx.x; e < N * 32; e += attn::THREADS) {
    const int r = e / 32, c2 = e % 32;
    float2 v = make_float2(0.f, 0.f);
    for (int j = 0; j < tiles; ++j) {
      const float2 part =
          *reinterpret_cast<const float2*>(dq_part + ((j * BH + bh) * N + r) * 64 + 2 * c2);
      v.x += part.x;
      v.y += part.y;
    }
    v.x *= p.dq_scale;
    v.y *= p.dq_scale;
    store2(p.dq + ghead + r * p.g_sn + 2 * c2, v.x, v.y);
    qs.x += v.x;
    qs.y += v.y;
  }
  if (!p.colsum) return;
  wpart[2 * threadIdx.x] = qs.x;   // [4 row classes][32 column pairs]
  wpart[2 * threadIdx.x + 1] = qs.y;
  __syncthreads();
  float* out = p.colsum + (long long)b * p.cs_b + h * 64;
  if (threadIdx.x < 64)
    out[threadIdx.x] = wpart[threadIdx.x] + wpart[64 + threadIdx.x] + wpart[128 + threadIdx.x] +
                       wpart[192 + threadIdx.x];
  for (int i = threadIdx.x; i < 2 * 64; i += attn::THREADS) {
    float sum = 0.f;
    for (int j = 0; j < tiles; ++j) sum += col_part[(bh * tiles + j) * 2 * 64 + i];
    out[(1 + i / 64) * p.cs_part + i % 64] = sum;
  }
}

// Whether the fp32 form takes head dim hd and sequence length N: any N (its
// dQ partials and delta live in the workspace).
inline bool attention_bwd_f32_takes(int hd, int N) { return hd == 64 && N >= 1; }

// Launches the fp32 attention backward (its three kernels) on `st`, with
// `work` of attention_bwd_f32_workspace(B, H, N) bytes; cudaErrorInvalidValue,
// without a launch, for a shape it does not take.
inline cudaError_t attention_bwd(const AttnBwdArgsT<float>& p, int hd, float* work,
                                 cudaStream_t st) {
  if (!attention_bwd_f32_takes(hd, p.N) || p.B < 1 || p.H < 1 || !(p.delta || p.o) || !work)
    return cudaErrorInvalidValue;
  const AttnBwdWork w = attn_bwd_work(p.B, p.H, p.N);
  if (w.bh * w.tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* qt = work;
  float* dt = qt + w.qt_len();
  float* dq_part = dt + w.qt_len();
  float* col_part = dq_part + w.dq_len(p.N);
  float* delta = p.delta ? nullptr : col_part + w.col_len();
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)attn32::BWD_SMEM_BYTES);
  if (e != cudaSuccess) return e;
  attention_bwd_pack_f32_kernel<<<(unsigned)(w.bh * w.tiles), attn::THREADS, 0, st>>>(
      p, (int)w.np, qt, dt, delta);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attention_bwd_f32_kernel<<<(unsigned)(w.bh * w.tiles), 2 * attn::THREADS,
                             attn32::BWD_SMEM_BYTES, st>>>(p, qt, dt, delta, dq_part, col_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  attention_bwd_reduce_f32_kernel<<<(unsigned)w.bh, attn::THREADS, 0, st>>>(p, dq_part, col_part);
  return cudaGetLastError();
}

}  // namespace dk
