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

// q, k, v: [B, H, N, hd] of T (bf16, or fp32 for attention_fwd_f32_kernel)
// through (batch, head, row) element strides, the head dim contiguous, rows
// 16-byte aligned; o likewise; lse [B * H, N] fp32 contiguous, or null.
template <typename T>
struct AttnArgsT {
  const T *q, *k, *v;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn;
  T* o;
  long long o_sb, o_sh, o_sn;
  float* lse;
  int B, H, N;
  float scale;
};

using AttnArgs = AttnArgsT<bf16>;

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

// ---------------------------------------------------------------------------
// The fp32 form: fp32 operands on TF32 wgmma (m64n64k8) in 3xTF32, fp32
// accumulation
// ---------------------------------------------------------------------------
//
// The math, the grid and the online softmax are the bf16 form's. What
// differs:
//  * 3xTF32. wgmma reads a 32-bit element as TF32 (10 mantissa bits), and a
//    single TF32 rounding of q, k, v and P leaves attention's error at an
//    eighth of the bf16 form's on average but, for one head at N = 578,
//    above a quarter of it (the scores' absolute error becomes P's relative
//    error through the exponent). So every fp32 operand x is held as two
//    TF32 values, hi = tf32(x) and lo = tf32(x - hi), and each product is
//    hi hi + hi lo + lo hi (the lo lo term, 2^-22 relative, is left out):
//    three TF32 wgmmas where the bf16 form issues one, and fp32 accuracy.
//  * A 64 x 64 fp32 tile is two 128-byte swizzle atoms wide, [2][64][32]
//    fp32 (16 KB): k-steps 0-3 of 8 columns in the first, 4-7 in the
//    second; a split tile is the hi tile followed by the lo tile (32 KB).
//  * TF32 wgmma takes no transpose, so O += P V reads V^T (head-dim-major)
//    as its K-major B operand. The threads write V^T from registers, and in
//    each group of 8 keys they permute the columns (tf32_key_slot) so that
//    the accumulator registers of P are the A fragments as they stand: a
//    thread's accumulator holds keys 2t and 2t + 1 of each 8 (t = lane % 4)
//    and a TF32 A fragment wants columns t and t + 4 of a k-step. The
//    attention backward reads K^T the same way, and its Q^T and dO^T A
//    fragments, P^T and dS^T in the same column order.
//  * Q and K arrive by cp.async as the bf16 form's tiles do, and each thread
//    then splits the chunks it copied into hi and lo in place; V^T is split
//    as it is written, P in registers. Nothing is rounded to bf16: the
//    scores, the softmax, lse and o are fp32.
//  * Shared memory: Q, two K and two V^T split tiles, 161 KB (the bf16
//    form: 40 KB), one CTA an SM.
// What bounds it on an H100: as the bf16 form, bytes (now 4 a value, some 50
// operations a byte at N = 198) against products at the TF32 rate, half
// bf16's, three times over; the V^T copy through registers is not
// overlapped with the products of its own chunk, only with the scores of
// the chunk before.

namespace attn32 {
constexpr int HALF = attn::T * 32;   // fp32 elements of one swizzle atom column
constexpr int TILE = 2 * HALF;       // a 64 x 64 fp32 tile
constexpr int SPLIT = 2 * TILE;      // its hi and lo TF32 parts
}  // namespace attn32

// Byte offset of (row r, column c) in a [2][64][32] fp32 tile in the
// 128-byte swizzle (16-byte chunks XOR row % 8, as TMA and wgmma lay it).
__device__ __forceinline__ int f32_tile_offset(int r, int c) {
  return (c >> 5) * attn32::HALF * 4 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// wgmma descriptor of k-step kk (columns 8 kk to 8 kk + 7) of a K-major
// [2][64][32] fp32 tile.
__device__ __forceinline__ uint64_t f32_kstep_desc(const float* tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * attn32::HALF) + 2 * (kk & 3);
}

// tf32_key_slot (gemm_sm90.cuh) is the column of key m (0-7) of a group of
// 8 in a tile whose columns are keys (or queries) and that a TF32 product
// reads against an A operand taken from accumulator registers.

// Rows [r0, r0 + 64) of one head (64 fp32 a row, `sn` elements apart) into
// the hi tile of a split tile by cp.async, 16 bytes a thread; rows at or
// beyond N are zero-filled (their source address stays in bounds). By the
// warpgroup whose thread `tid` (0-127) this is, as the next two.
__device__ __forceinline__ void load_tile_f32_async(float* tile, const float* src, long long sn,
                                                    int r0, int N, int tid = threadIdx.x) {
  const uint32_t base = smem_u32(tile);
#pragma unroll
  for (int i = tid; i < attn::T * 16; i += attn::THREADS) {
    const int r = i >> 4, c = (i & 15) * 4, row = r0 + r;
    const float* g = src + (long long)(row < N ? row : N - 1) * sn + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(base + f32_tile_offset(r, c)),
                 "l"(g), "r"(row < N ? 16 : 0)
                 : "memory");
  }
}

// The chunks that this thread copied into a split tile with
// load_tile_f32_async, split into its hi and lo parts in place once its
// cp.async group has landed.
__device__ __forceinline__ void split_tile_f32(float* tile, int tid = threadIdx.x) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int i = tid; i < attn::T * 16; i += attn::THREADS) {
    const int off = f32_tile_offset(i >> 4, (i & 15) * 4);
    float4* hi = reinterpret_cast<float4*>(base + off);
    const float4 v = *hi;
    const float2 x = tf32_split(v.x), y = tf32_split(v.y), z = tf32_split(v.z),
                 w = tf32_split(v.w);
    *hi = make_float4(x.x, y.x, z.x, w.x);
    *reinterpret_cast<float4*>(base + attn32::TILE * 4 + off) = make_float4(x.y, y.y, z.y, w.y);
  }
}

// Rows [r0, r0 + 64) of one head as the columns of a split tile of
// [2][64 dims][32] (the rows' transpose), the columns of each group of 8 in
// tf32_key_slot order; rows at or beyond N are zeros. A warp takes 32
// consecutive rows of one 4-dim slice: its stores fill 32 banks.
__device__ __forceinline__ void load_tile_f32_t(float* tile, const float* src, long long sn, int r0,
                                                int N, int tid = threadIdx.x) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int i = tid; i < attn::T * 16; i += attn::THREADS) {
    const int r = i & 63, d0 = (i >> 6) * 4, row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < N) v = __ldg(reinterpret_cast<const float4*>(src + (long long)row * sn + d0));
    const int col = (r & ~7) | tf32_key_slot(r & 7);
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int off = f32_tile_offset(d0 + u, col);
      const float2 x = tf32_split(e[u]);
      *reinterpret_cast<float*>(base + off) = x.x;
      *reinterpret_cast<float*>(base + attn32::TILE * 4 + off) = x.y;
    }
  }
}

// The hi and lo A fragments of one k-step from four accumulator values of a
// thread's rows (r, r + 8) and columns (2t, 2t + 1) of a group of 8:
// e = {(r, 2t), (r, 2t + 1), (r + 8, 2t), (r + 8, 2t + 1)} as the
// accumulator holds them; the B operand has its columns in tf32_key_slot
// order.
__device__ __forceinline__ void tf32_a_fragments(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                                 const float (&e)[4]) {
  const int at[4] = {0, 2, 1, 3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = tf32_split(e[at[i]]);
    hi[i] = __float_as_uint(x.x);
    lo[i] = __float_as_uint(x.y);
  }
}

// D (+)= A B^T over the 64 dims of two K-major split tiles in 3xTF32;
// acc = 0 starts the sum at zero.
__device__ __forceinline__ void mma3_ss(float (&d)[32], const float* a, const float* b, int acc) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_ss_tf32(d, f32_kstep_desc(a + attn32::TILE, kk), f32_kstep_desc(b, kk), acc || kk > 0);
    wgmma_ss_tf32(d, f32_kstep_desc(a, kk), f32_kstep_desc(b + attn32::TILE, kk), 1);
    wgmma_ss_tf32(d, f32_kstep_desc(a, kk), f32_kstep_desc(b, kk), 1);
  }
}

// D += A B in 3xTF32, A from registers (the hi and lo fragments of 8
// k-steps), B a K-major split tile.
__device__ __forceinline__ void mma3_rs(float (&d)[32], const uint32_t (&hi)[8][4],
                                        const uint32_t (&lo)[8][4], const float* b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_rs_tf32(d, lo[kk], f32_kstep_desc(b, kk), 1);
    wgmma_rs_tf32(d, hi[kk], f32_kstep_desc(b + attn32::TILE, kk), 1);
    wgmma_rs_tf32(d, hi[kk], f32_kstep_desc(b, kk), 1);
  }
}

__global__ void __launch_bounds__(attn::THREADS) attention_fwd_f32_kernel(const AttnArgsT<float> p) {
  using attn::T;
  using attn32::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(align1024(smem_raw));   // split tiles
  float* Ks = Qs + SPLIT;       // [2][SPLIT]
  float* Vt = Ks + 2 * SPLIT;   // [2][SPLIT]: V^T of the chunk, keys in tf32_key_slot order
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * T, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int N = p.N, chunks = (N + T - 1) / T;
  const float* qh = p.q + b * p.q_sb + h * p.q_sh;
  const float* kh = p.k + b * p.k_sb + h * p.k_sh;
  const float* vh = p.v + b * p.v_sb + h * p.v_sh;

  load_tile_f32_async(Qs, qh, p.q_sn, q0, N);
  load_tile_f32_async(Ks, kh, p.k_sn, 0, N);
  cp_async_commit();
  load_tile_f32_t(Vt, vh, p.v_sn, 0, N);

  // Thread (warp, lane) holds rows 16 warp + lane / 4 and + 8 of the tile;
  // of every 8 columns, the two at 2 (lane % 4). Maxima in log2 units.
  float acc_o[32], row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_o[i] = 0.f;
  const float to_log2 = p.scale * 1.4426950408889634f;

  for (int j = 0; j < chunks; ++j) {
    const int cur = j & 1;
    if (j + 1 < chunks) {
      load_tile_f32_async(Ks + (cur ^ 1) * SPLIT, kh, p.k_sn, (j + 1) * T, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (j == 0) split_tile_f32(Qs);
    split_tile_f32(Ks + cur * SPLIT);
    // this thread's writes are visible to wgmma (the async proxy), then all threads'
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    // S = Q K^T over this chunk's 64 keys, 8 k-steps of 8 dims
    float sc[32];
    wgmma_fence();
    mma3_ss(sc, Qs, Ks + cur * SPLIT, 0);
    wgmma_commit();
    // the next chunk's V^T is written while the scores are computed (its
    // buffer's last reader, the chunk before's P V, has finished)
    if (j + 1 < chunks) load_tile_f32_t(Vt + (cur ^ 1) * SPLIT, vh, p.v_sn, (j + 1) * T, N);
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax: keys at or beyond N out, the new running max, rescale
    const int key0 = j * T + 2 * (lane % 4);
    float mnew[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = key0 + 8 * (i / 4) + (i & 1) < N ? sc[i] * to_log2 : -INFINITY;
      mnew[(i / 2) & 1] = fmaxf(mnew[(i / 2) & 1], sc[i]);
    }
    float rescale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mnew[r] = fmaxf(mnew[r], __shfl_xor_sync(0xffffffffu, mnew[r], 1));
      mnew[r] = fmaxf(mnew[r], __shfl_xor_sync(0xffffffffu, mnew[r], 2));
      rescale[r] = exp2f(row_max[r] - mnew[r]);   // 0 on the first chunk
      row_max[r] = mnew[r];
      row_sum[r] *= rescale[r];
    }
    // P as hi and lo TF32 A fragments, 8 keys a k-step; the row sums add fp32 p
    uint32_t pa[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float e[4] = {exp2f(sc[4 * kk] - row_max[0]), exp2f(sc[4 * kk + 1] - row_max[0]),
                          exp2f(sc[4 * kk + 2] - row_max[1]), exp2f(sc[4 * kk + 3] - row_max[1])};
      row_sum[0] += e[0] + e[1];
      row_sum[1] += e[2] + e[3];
      tf32_a_fragments(pa[kk], pl[kk], e);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_o[i] *= rescale[(i / 2) & 1];

    // O += P V, B = V^T of the chunk
    wgmma_fence();
    mma3_rs(acc_o, pa, pl, Vt + cur * SPLIT);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    __syncthreads();   // K of this chunk is refilled by the next iteration's copy
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    const int row = q0 + warp * 16 + lane / 4 + 8 * r;
    if (row >= N) continue;
    const float inv = 1.0f / row_sum[r];
    float* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_sn + 2 * (lane % 4);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      store2(orow + 8 * jb, acc_o[4 * jb + 2 * r] * inv, acc_o[4 * jb + 2 * r + 1] * inv);
    }
    if (p.lse && lane % 4 == 0)
      p.lse[(long long)bh * N + row] = row_max[r] * 0.6931471805599453f + logf(row_sum[r]);
  }
}

// Launches the fp32 attention forward on `st`; cudaErrorInvalidValue,
// without a launch, for a head dim without an instantiation or an empty shape.
inline cudaError_t attention_fwd(const AttnArgsT<float>& p, int hd, cudaStream_t st) {
  if (!attention_fwd_takes(hd) || p.B < 1 || p.H < 1 || p.N < 1) return cudaErrorInvalidValue;
  constexpr size_t smem = 5 * attn32::SPLIT * sizeof(float) + 1024;   // Q, 2 K, 2 V^T: 161 KB
  const cudaError_t e = cudaFuncSetAttribute(attention_fwd_f32_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.N + attn::T - 1) / attn::T, p.B * p.H);
  attention_fwd_f32_kernel<<<grid, attn::THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace dk
