// Attention forward whose scores never leave the chip, on Hopper (sm_90a).
// Shared by `flash_fwd` (attention.cu) and the attention stage of the fused
// block forward and of the backward's recompute, which keeps its lse
// (`forward_chain`, fused_block_common.cuh). Per (batch, head), with `scale`
// applied to q k^T (1 when q arrives pre-scaled, as the block's packed qkv
// does):
//
//   o = softmax(q k^T scale) v   in bf16,   lse = max + log(sum)   in fp32
//
// with the normalisation applied after the p v product (post-division, as
// deltakd_tpu/ops/fused_block.py:214-247 computes it with post_div=True).
//
// One CTA (one warpgroup, 128 threads) per (batch * head, 64 query rows):
// thousands of CTAs at the main path's shapes, several resident per SM. The
// Q tile is loaded once; K and V stream in chunks of 64 keys through a
// double-buffered cp.async ring (the next chunk's copy runs under this
// chunk's products), each tile stored in the 128-byte swizzle that wgmma
// reads. S = Q K^T is a wgmma from shared memory into registers; an online
// softmax keeps each row's running max and sum in registers; P is rounded to
// bf16 in registers and is the A operand of O += P V (V, key-major in shared
// memory, is wgmma's transposed B operand). The epilogue divides by the row
// sum and stores O in bf16 through (batch, head, row) strides, and lse when
// asked.
//
// What bounds it on an H100: bytes. One head moves q, k, v, o (4 x N x 64
// bf16) for 4 N^2 x 64 operations, some 100 operations a byte at N = 198,
// under the card's ~295. The scores never reach device memory; the copies
// overlap the products; what remains is each CTA's serial chain of two
// wgmma batches and the softmax between them, and the padding of N to
// 64-key chunks (198 keys are computed as 256).
//
// Rounding: P is rounded to bf16 against the running max, not the row's
// final max, and its products are rescaled in fp32 when the max moves; the
// plain versions round softmax(s) (flash_fwd) or exp(s - max) (the block)
// against the final max, so the two differ by bf16 rounding at other points.
// The row sum adds the unrounded fp32 p, as the plain versions do.
// Padding: keys at or beyond N arrive as zero rows (cp.async zero-fill) and
// their scores are set to -inf before the max, so they add nothing to the
// max or the sum; query rows at or beyond N are computed on zeros and never
// stored. No atomics: two runs give the same bits.

#pragma once

#include <math.h>

#include "gemm_sm90.cuh"

namespace dk {

// q, k, v: [B, H, N, hd] bf16 through (batch, head, row) element strides, the
// head dim contiguous, rows 16-byte aligned; o likewise; lse [B * H, N] fp32
// contiguous, or null.
struct AttnArgs {
  const bf16 *q, *k, *v;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn;
  bf16* o;
  long long o_sb, o_sh, o_sn;
  float* lse;
  int B, H, N;
  float scale;
};

namespace attn {
constexpr int T = 64;          // query rows of a CTA, keys of a chunk
constexpr int THREADS = 128;   // one warpgroup
}  // namespace attn

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) of one head (64 bf16 a row, `sn` elements apart) into a
// 128-byte-swizzled tile by cp.async, 16 bytes a thread; rows at or beyond N
// are zero-filled (their source address stays in bounds).
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* src, long long sn, int r0,
                                                int N) {
  const uint32_t base = smem_u32(tile);
#pragma unroll
  for (int i = threadIdx.x; i < attn::T * 8; i += attn::THREADS) {
    const int r = i >> 3, c = i & 7, row = r0 + r;
    const bf16* g = src + (long long)(row < N ? row : N - 1) * sn + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     base + r * 128 + ((c ^ (r & 7)) << 4)),
                 "l"(g), "r"(row < N ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(attn::THREADS) attention_fwd_kernel(const AttnArgs p) {
  static_assert(HD == 64, "a swizzled tile row holds 64 bf16 (128 bytes)");
  using attn::T;
  constexpr int TILE = T * HD;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1024(smem_raw));
  bf16* Ks = Qs + TILE;       // [2][T][HD]
  bf16* Vs = Ks + 2 * TILE;   // [2][T][HD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * T, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int N = p.N, chunks = (N + T - 1) / T;
  const bf16* qh = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kh = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vh = p.v + b * p.v_sb + h * p.v_sh;

  load_tile_async(Qs, qh, p.q_sn, q0, N);
  load_tile_async(Ks, kh, p.k_sn, 0, N);
  load_tile_async(Vs, vh, p.v_sn, 0, N);
  cp_async_commit();

  // Thread (warp, lane) holds rows r = 16 warp + lane / 4 and r + 8 of the
  // tile; of every 8 columns, the two at 2 (lane % 4). m in log2 units.
  float o[HD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  const float scale_log2 = p.scale * 1.4426950408889634f;

  for (int j = 0; j < chunks; ++j) {
    const int buf = j & 1;
    if (j + 1 < chunks) {
      load_tile_async(Ks + (buf ^ 1) * TILE, kh, p.k_sn, (j + 1) * T, N);
      load_tile_async(Vs + (buf ^ 1) * TILE, vh, p.v_sn, (j + 1) * T, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // this thread's copies are visible to wgmma (the async proxy), then all threads'
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    // S = Q K^T over this chunk's 64 keys
    float s[T / 2];
    const uint64_t dq = sw128_desc(Qs), dk = sw128_desc(Ks + buf * TILE);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) wgmma_ss(s, dq + 2 * k, dk + 2 * k, k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax: padding keys out, new running max, rescale
    const int key = j * T + 2 * (lane % 4);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const float v = key + 8 * (i / 4) + (i & 1) < N ? s[i] * scale_log2 : -INFINITY;
      s[i] = v;
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], v);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);   // 0 on the first chunk (m = -inf)
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // P in bf16 as wgmma's A fragments: 16 keys a k-step, 4 registers each
    uint32_t pa[T / 16][4];
#pragma unroll
    for (int jb = 0; jb < T / 8; ++jb) {
      const float p0 = exp2f(s[4 * jb] - m[0]), p1 = exp2f(s[4 * jb + 1] - m[0]);
      const float p2 = exp2f(s[4 * jb + 2] - m[1]), p3 = exp2f(s[4 * jb + 3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[jb / 2][2 * (jb & 1)] = pack_bf16(p0, p1);
      pa[jb / 2][2 * (jb & 1) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) & 1];

    // O += P V; a k-step of 16 keys is 16 rows of V, 2048 bytes
    const uint64_t dv = sw128_desc(Vs + buf * TILE);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < T / 16; ++k) wgmma_rs_t(o, pa[k], dv + 128 * k, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();   // this buffer is refilled by the next iteration's copy
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + lane / 4 + 8 * r;
    if (row >= N) continue;
    const float inv = 1.0f / l[r];
    bf16* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_sn + 2 * (lane % 4);
#pragma unroll
    for (int jb = 0; jb < HD / 8; ++jb)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jb) =
          __floats2bfloat162_rn(o[4 * jb + 2 * r] * inv, o[4 * jb + 2 * r + 1] * inv);
    if (p.lse && lane % 4 == 0)
      p.lse[(long long)bh * N + row] = m[r] * 0.6931471805599453f + logf(l[r]);
  }
}

// The head dims with an instantiation.
inline bool attention_fwd_takes(int hd) { return hd == 64; }

// Launches the attention forward on `st`; cudaErrorInvalidValue, without a
// launch, for a head dim without an instantiation or an empty shape.
inline cudaError_t attention_fwd(const AttnArgs& p, int hd, cudaStream_t st) {
  if (!attention_fwd_takes(hd) || p.B < 1 || p.H < 1 || p.N < 1) return cudaErrorInvalidValue;
  constexpr size_t smem = 5 * attn::T * 64 * sizeof(bf16) + 1024;   // Q, 2 K, 2 V: 41 KB
  const dim3 grid((p.N + attn::T - 1) / attn::T, p.B * p.H);
  attention_fwd_kernel<64><<<grid, attn::THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace dk
