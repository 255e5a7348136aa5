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
// The bf16 form (the fp32 form, warp-specialised, is at the end of this
// file): one CTA (one warpgroup, 128 threads) per (batch * head, 64 query rows),
// a 1-D grid with a head's query tiles side by side (any B*H: gridDim.y would
// stop at 65,535): thousands of CTAs at the main path's shapes, several
// resident per SM. The
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
  // blockIdx.x = bh * chunks + query tile: a head's query tiles side by side
  // (their K and V reads meet in L2), and B*H past gridDim.y's 65,535
  const int N = p.N, chunks = (N + T - 1) / T;
  const int bh = blockIdx.x / chunks, q0 = blockIdx.x % chunks * T, b = bh / p.H, h = bh % p.H;
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
  const long long ctas = (long long)p.B * p.H * ((p.N + attn::T - 1) / attn::T);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  attention_fwd_kernel<64><<<(unsigned)ctas, attn::THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 form: fp32 operands on TF32 wgmma in 3xTF32, fp32 accumulation,
// one producer and two consumer warpgroups
// ---------------------------------------------------------------------------
//
// The math and the online softmax are the bf16 form's. What differs:
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
//    as its K-major B operand, written with the columns of each group of 8
//    keys permuted (tf32_key_slot) so that the accumulator registers of P
//    are the A fragments as they stand: a thread's accumulator holds keys
//    2t and 2t + 1 of each 8 (t = lane % 4) and a TF32 A fragment wants
//    columns t and t + 4 of a k-step. The attention backward reads K^T the
//    same way, and its Q^T and dO^T A fragments, P^T and dS^T in the same
//    column order.
//  * Warp specialisation (attention_fwd_f32_ws_kernel). One CTA of three
//    warpgroups per (batch * head, 128 query rows); the CTAs of a head's
//    row halves are neighbours in blockIdx, so their reads of K and V meet
//    in L2, and each chunk of K and V is split twice a head at N = 198
//    where 64-row CTAs split it four times.
//    - The producer (warpgroup 0, its registers lowered by setmaxnreg)
//      copies each 64-key chunk of K and of V from device memory as it lies
//      into a raw staging tile (cp.async, the next chunk's copies in flight
//      while it works on this one), splits it into TF32 hi and lo and
//      writes K's split tile and V^T's into a ring of two K slots and two
//      V^T slots, then fences (its stores are generic-proxy, wgmma reads
//      through the async proxy) and arrives on the slot's full mbarrier. K
//      and V^T have barriers of their own: a chunk's K is free once its
//      scores are done, its V^T only after its P V product, a batch later.
//    - Two consumers (warpgroups 1 and 2, registers raised) own 64 query
//      rows each and split their Q once into a split tile of their own.
//      Per chunk j a consumer waits on the full barriers, issues S_j = Q
//      K_j^T and O += P_{j-1} V_{j-1} as one batch of wgmmas, gives the two
//      slots back (one arrival a warp), and runs the softmax of S_j while
//      the other consumer's batch holds the tensor cores. Two named
//      barriers make the consumers take turns at issuing a batch (FA3's
//      ordering), so that their batches alternate.
//  * The tail chunk is cut to its groups of 8 keys: with r keys left in the
//    last chunk, S runs at n = 8 ceil(r / 8) (the n = 8..64 TF32 forms) and
//    P V over as many k-steps. At N = 198 (and 197) the keys computed fall
//    from 256 to 200 a row. Keys at or beyond N inside the last group are
//    zeros in K and V^T and -inf in S before the max.
//  * Nothing is rounded to bf16: the scores, the softmax, lse and o are
//    fp32. Each row's sums run in chunk order, whatever the timing of the
//    warpgroups: two runs give the same bits, and so do the block forward
//    and its recompute in the backward.
//  * Shared memory: two Q, two K and two V^T split tiles, the producer's
//    two raw tiles and eight mbarriers, 230,464 bytes: one CTA (384
//    threads) an SM.
// What bounds it on an H100: the products at the TF32 rate. One head moves
// q, k, v, o (4 x N x 64 fp32) for 4 N^2 x 64 operations, some 150 a byte
// at N = 198, the TF32 ridge of the card; 3xTF32 triples the operations, so
// the tensor cores bound it (about 0.12 ms for the teacher's 1,536 heads
// at 256 query and 200 key rows a head, above the 0.093 ms of its bytes).
// On the card it takes about 2.6 times that; what it loses is not
// measured apart: each CTA's prologue (Q, then K of chunk 0) and epilogue,
// exposed at one CTA an SM, the softmax between a consumer's batches that
// the other consumer's batch covers only in part, the shared-memory reads
// of the products (Q and K both from shared memory: 4 KB a wgmma), and the
// query rows padded to 64.

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
// warpgroup whose thread `tid` (0-127) this is, as the next two (the
// attention backward's tiles; this one also the forward producer's raw K).
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

// D (+)= A B^T over the 64 dims of two K-major split tiles in 3xTF32, D's
// columns the first G groups of 8 rows of B (wgmma_ss_tf32_n); acc = 0
// starts the sum at zero.
template <int G>
__device__ __forceinline__ void mma3_ss_n(float (&d)[32], const float* a, const float* b, int acc) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_ss_tf32_n<G>(d, f32_kstep_desc(a + attn32::TILE, kk), f32_kstep_desc(b, kk), acc || kk > 0);
    wgmma_ss_tf32_n<G>(d, f32_kstep_desc(a, kk), f32_kstep_desc(b + attn32::TILE, kk), 1);
    wgmma_ss_tf32_n<G>(d, f32_kstep_desc(a, kk), f32_kstep_desc(b, kk), 1);
  }
}

__device__ __forceinline__ void mma3_ss(float (&d)[32], const float* a, const float* b, int acc) {
  mma3_ss_n<8>(d, a, b, acc);
}

// D += A B in 3xTF32 over the first G k-steps, A from registers (the hi and
// lo fragments of 8 k-steps), B a K-major split tile.
template <int G>
__device__ __forceinline__ void mma3_rs_n(float (&d)[32], const uint32_t (&hi)[8][4],
                                          const uint32_t (&lo)[8][4], const float* b) {
#pragma unroll
  for (int kk = 0; kk < G; ++kk) {
    wgmma_rs_tf32(d, lo[kk], f32_kstep_desc(b, kk), 1);
    wgmma_rs_tf32(d, hi[kk], f32_kstep_desc(b + attn32::TILE, kk), 1);
    wgmma_rs_tf32(d, hi[kk], f32_kstep_desc(b, kk), 1);
  }
}

__device__ __forceinline__ void mma3_rs(float (&d)[32], const uint32_t (&hi)[8][4],
                                        const uint32_t (&lo)[8][4], const float* b) {
  mma3_rs_n<8>(d, hi, lo, b);
}

// The warp-specialised forward's plan.
namespace fwd32 {
constexpr int ROWS = 2 * attn::T;            // query rows of a CTA, 64 a consumer
constexpr int THREADS = 3 * attn::THREADS;   // the producer, consumers 0 and 1
constexpr int SLOTS = 2;                     // ring slots of K, and of V^T
// 120 x 128 + 192 x 256 = 168 x 384 (the registers a thread at entry); a
// producer of 72 spilled and ran the teacher's forward a fifth slower
// (PERF.md)
constexpr int PRODUCER_REGS = 120, CONSUMER_REGS = 192;
constexpr int BAR_Q = 1;      // + c: consumer c's own barrier (its Q split tile is written)
constexpr int BAR_TURN = 3;   // + c: consumer c's turn to issue a batch
constexpr bool TAKE_TURNS = true;   // a few percent faster than none (PERF.md)
// Q of both consumers, the K and V^T slots (split tiles), the producer's
// raw K and V tiles, 4 SLOTS mbarriers: 230,464 bytes
constexpr size_t SMEM_BYTES = (2 + 2 * SLOTS) * attn32::SPLIT * sizeof(float) +
                              2 * attn32::TILE * sizeof(float) + 4 * SLOTS * sizeof(uint64_t) +
                              1024;
}  // namespace fwd32

// Rows [r0, r0 + 64) of one head (64 fp32 a row, `sn` elements apart), the
// share of warpgroup thread `tid`: v[u] = row r0 + (tid >> 4) + 8u, columns
// 4 (tid & 15) to + 3, a warp's loads two whole rows; zeros at or beyond N.
__device__ __forceinline__ void load_rows_f32(float4 (&v)[8], const float* src, long long sn,
                                              int r0, int N, int tid) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int row = r0 + (tid >> 4) + 8 * u;
    v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < N)
      v[u] = __ldg(reinterpret_cast<const float4*>(src + (long long)row * sn + 4 * (tid & 15)));
  }
}

// Rows held that way (load_rows_f32, read_rows_raw) split into TF32 hi and
// lo: a K-major split tile's rows below `rows` (a multiple of 8).
__device__ __forceinline__ void store_rows_split(float* tile, const float4 (&v)[8], int rows,
                                                 int tid) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = (tid >> 4) + 8 * u;
    if (r >= rows) continue;
    const int off = f32_tile_offset(r, 4 * (tid & 15));
    const float2 x = tf32_split(v[u].x), y = tf32_split(v[u].y), z = tf32_split(v[u].z),
                 w = tf32_split(v[u].w);
    *reinterpret_cast<float4*>(base + off) = make_float4(x.x, y.x, z.x, w.x);
    *reinterpret_cast<float4*>(base + attn32::TILE * 4 + off) = make_float4(x.y, y.y, z.y, w.y);
  }
}

// The producer's raw tiles. Rows [r0, r0 + 64) of one head into a [2][64][32]
// staging tile by cp.async, the share of warpgroup thread `tid` being the
// 16-byte chunks that it reads back (cp.async lands a thread's own copies
// in its own order): for K, row (tid >> 4) + 8u, columns 4 (tid & 15) to +
// 3 (load_tile_f32_async's share, read back by read_rows_raw); for V, key
// r0 + (tid & 63), dims 4 ((tid >> 6) + 2u) to + 3 (load_keys_f32_async,
// read_keys_raw), so that its V^T stores fill the banks. Rows at or beyond N
// are zero-filled.
__device__ __forceinline__ void load_keys_f32_async(float* tile, const float* src, long long sn,
                                                    int r0, int N, int tid) {
  const uint32_t base = smem_u32(tile);
  const int r = tid & 63, row = r0 + r;
  const float* g = src + (long long)(row < N ? row : N - 1) * sn;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int c = 4 * ((tid >> 6) + 2 * u);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(base + f32_tile_offset(r, c)),
                 "l"(g + c), "r"(row < N ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void read_rows_raw(float4 (&v)[8], const float* tile, int tid) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
#pragma unroll
  for (int u = 0; u < 8; ++u)
    v[u] = *reinterpret_cast<const float4*>(base + f32_tile_offset((tid >> 4) + 8 * u, 4 * (tid & 15)));
}

__device__ __forceinline__ void read_keys_raw(float4 (&v)[8], const float* tile, int tid) {
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tile);
#pragma unroll
  for (int u = 0; u < 8; ++u)
    v[u] = *reinterpret_cast<const float4*>(
        base + f32_tile_offset(tid & 63, 4 * ((tid >> 6) + 2 * u)));
}

// Those keys split into TF32 hi and lo as the columns of a split tile of
// [2][64 dims][32] (V^T), each at its tf32_key_slot column of its group of
// 8. A warp's stores of one dim are 32 keys: the 32 banks once.
__device__ __forceinline__ void store_keys_split_t(float* tile, const float4 (&v)[8], int tid) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  const int key = tid & 63, slot = (key & ~7) | tf32_key_slot(key & 7);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int d0 = 4 * ((tid >> 6) + 2 * u);
    const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = f32_tile_offset(d0 + i, slot);
      const float2 x = tf32_split(e[i]);
      *reinterpret_cast<float*>(base + off) = x.x;
      *reinterpret_cast<float*>(base + attn32::TILE * 4 + off) = x.y;
    }
  }
}

// The online softmax of one chunk's scores: keys at or beyond `valid` (the
// chunk's keys below N) out, the new running max, o rescaled, and P as the
// hi and lo TF32 A fragments of the P V product, 8 keys a k-step. The row
// sums add fp32 p. Thread (warp, lane) holds rows 16 warp + lane / 4 and + 8
// of the tile; of every 8 columns, the two at 2 (lane % 4). Maxima in log2
// units.
__device__ __forceinline__ void softmax_chunk(float (&sc)[32], int valid, float to_log2,
                                              float (&row_max)[2], float (&row_sum)[2],
                                              float (&acc_o)[32], uint32_t (&pa)[8][4],
                                              uint32_t (&pl)[8][4]) {
  const int key0 = 2 * (threadIdx.x % 4);
  float mnew[2] = {row_max[0], row_max[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = valid >= attn::T || key0 + 8 * (i / 4) + (i & 1) < valid ? sc[i] * to_log2 : -INFINITY;
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
}

// Consumer c's turn to issue a batch of wgmmas, and its handing the turn to
// the other consumer (consumer 1 hands none after its last batch, so that
// the barriers end even).
__device__ __forceinline__ void take_turn(bool turns, int c) {
  if (turns) named_sync(fwd32::BAR_TURN + c, 2 * attn::THREADS);
}
__device__ __forceinline__ void pass_turn(bool turns, int c, bool last) {
  if (turns && !(last && c == 1)) named_arrive(fwd32::BAR_TURN + (c ^ 1), 2 * attn::THREADS);
}

// What a consumer warpgroup reads of its CTA.
struct Fwd32Consumer {
  const float *qs, *Ks, *Vt;   // its Q split tile, the K and V^T slots
  uint64_t *k_full, *k_empty, *v_full, *v_empty;
  int N, chunks, c, lane;
  bool turns;
  float to_log2;
};

// K and V^T of chunk j, once their full barriers have completed.
__device__ __forceinline__ const float* k_ready(const Fwd32Consumer& x, int j) {
  mbar_wait(&x.k_full[j % fwd32::SLOTS], (j / fwd32::SLOTS) & 1);
  return x.Ks + j % fwd32::SLOTS * attn32::SPLIT;
}
__device__ __forceinline__ const float* v_ready(const Fwd32Consumer& x, int j) {
  mbar_wait(&x.v_full[j % fwd32::SLOTS], (j / fwd32::SLOTS) & 1);
  return x.Vt + j % fwd32::SLOTS * attn32::SPLIT;
}

// After the batch that holds S of chunk j (in s): the turn passed, the
// batch waited for, its slots back to the producer (K's, and V^T's of chunk
// j - 1), then the softmax of the chunk's `valid` keys.
__device__ __forceinline__ void softmax_after(const Fwd32Consumer& x, int j, float (&s)[32],
                                              int valid, float (&acc_o)[32], float (&row_max)[2],
                                              float (&row_sum)[2], uint32_t (&pa)[8][4],
                                              uint32_t (&pl)[8][4]) {
  pass_turn(x.turns, x.c, false);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(acc_o);
  if (x.lane == 0) {
    mbar_arrive(&x.k_empty[j % fwd32::SLOTS]);
    if (j > 0) mbar_arrive(&x.v_empty[(j - 1) % fwd32::SLOTS]);
  }
  softmax_chunk(s, valid, x.to_log2, row_max, row_sum, acc_o, pa, pl);
}

// A consumer's walk over the chunks, the last one holding G groups of 8
// keys (a single chunk with ONE_CHUNK): batch j issues P V of chunk j - 1
// and S of chunk j, the last chunk's S at n = 8G into accumulators of its
// own (st: no accumulator register takes part in wgmmas of two widths),
// then P V of the last chunk over G k-steps. Every branch on the shape is
// taken outside the wgmma batches and everything is inlined, so that the
// compiler keeps each batch in flight until its wait.
template <int G, bool ONE_CHUNK>
__device__ __forceinline__ void consume_chunks(const Fwd32Consumer& x, float (&acc_o)[32],
                                               float (&row_max)[2], float (&row_sum)[2]) {
  using attn::T;
  float sc[32], st[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = st[i] = 0.f;
  uint32_t pa[8][4], pl[8][4];   // P of the chunk before, hi and lo A fragments
  const int last = x.chunks - 1, last_keys = x.N - last * T;

  if constexpr (ONE_CHUNK) {
    const float* ks = k_ready(x, 0);
    take_turn(x.turns, x.c);
    wgmma_fence();
    mma3_ss_n<G>(st, x.qs, ks, 0);
    wgmma_commit();
    softmax_after(x, 0, st, last_keys, acc_o, row_max, row_sum, pa, pl);
  } else {
    const float* ks = k_ready(x, 0);
    take_turn(x.turns, x.c);
    wgmma_fence();
    mma3_ss(sc, x.qs, ks, 0);
    wgmma_commit();
    softmax_after(x, 0, sc, T, acc_o, row_max, row_sum, pa, pl);
    for (int j = 1; j < last; ++j) {
      ks = k_ready(x, j);
      const float* vt = v_ready(x, j - 1);
      take_turn(x.turns, x.c);
      wgmma_fence();
      mma3_rs(acc_o, pa, pl, vt);
      mma3_ss(sc, x.qs, ks, 0);
      wgmma_commit();
      softmax_after(x, j, sc, T, acc_o, row_max, row_sum, pa, pl);
    }
    ks = k_ready(x, last);
    const float* vt = v_ready(x, last - 1);
    take_turn(x.turns, x.c);
    wgmma_fence();
    mma3_rs(acc_o, pa, pl, vt);
    mma3_ss_n<G>(st, x.qs, ks, 0);
    wgmma_commit();
    softmax_after(x, last, st, last_keys, acc_o, row_max, row_sum, pa, pl);
  }

  // P V of the last chunk, over its G groups of 8 keys (its slots are not
  // refilled)
  const float* vt = v_ready(x, last);
  take_turn(x.turns, x.c);
  wgmma_fence();
  mma3_rs_n<G>(acc_o, pa, pl, vt);
  wgmma_commit();
  pass_turn(x.turns, x.c, true);
  wgmma_wait<0>();
  fence_regs(acc_o);
}

template <int G>
__device__ __forceinline__ void consume(const Fwd32Consumer& x, float (&acc_o)[32],
                                        float (&row_max)[2], float (&row_sum)[2]) {
  if (x.chunks == 1)
    consume_chunks<G, true>(x, acc_o, row_max, row_sum);
  else
    consume_chunks<G, false>(x, acc_o, row_max, row_sum);
}

__global__ void __launch_bounds__(fwd32::THREADS, 1)
attention_fwd_f32_ws_kernel(const AttnArgsT<float> p) {
  using namespace fwd32;
  using attn::T;
  using attn32::SPLIT;
  extern __shared__ unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(align1024(smem_raw));   // [2][SPLIT]: consumer c's Q
  float* Ks = Qs + 2 * SPLIT;       // [SLOTS][SPLIT]
  float* Vt = Ks + SLOTS * SPLIT;   // [SLOTS][SPLIT]: V^T, keys in tf32_key_slot order
  float* raw_k = Vt + SLOTS * SPLIT;   // the producer's staging tiles
  float* raw_v = raw_k + attn32::TILE;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(raw_v + attn32::TILE);
  uint64_t* k_empty = k_full + SLOTS;
  uint64_t* v_full = k_empty + SLOTS;
  uint64_t* v_empty = v_full + SLOTS;
  const int N = p.N, q_tiles = (N + ROWS - 1) / ROWS, chunks = (N + T - 1) / T;
  const int bh = blockIdx.x / q_tiles, q0 = blockIdx.x % q_tiles * ROWS, b = bh / p.H, h = bh % p.H;
  const int tail = (N - (chunks - 1) * T + 7) / 8;   // groups of 8 keys in the last chunk
  const int consumers = N - q0 > T ? 2 : 1;
  const int wg = threadIdx.x / attn::THREADS, tid = threadIdx.x % attn::THREADS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&k_full[s], attn::THREADS);
      mbar_init(&v_full[s], attn::THREADS);
      mbar_init(&k_empty[s], 4 * consumers);
      mbar_init(&v_empty[s], 4 * consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: chunk j of K, then of V^T, split into slot j % SLOTS
    // once the consumers have given it back, the next chunk's raw tile then
    // copied in (two cp.async groups in flight: K and V of the chunk ahead)
    setmaxnreg_dec<PRODUCER_REGS>();
    const float* kh = p.k + b * p.k_sb + h * p.k_sh;
    const float* vh = p.v + b * p.v_sb + h * p.v_sh;
    load_tile_f32_async(raw_k, kh, p.k_sn, 0, N, tid);
    cp_async_commit();
    load_keys_f32_async(raw_v, vh, p.v_sn, 0, N, tid);
    cp_async_commit();
    float4 v[8];
    for (int j = 0; j < chunks; ++j) {
      const int s = j % SLOTS, rows = j + 1 < chunks ? T : 8 * tail;
      const uint32_t freed = ((j / SLOTS) & 1) ^ 1;
      cp_async_wait<1>();   // K of chunk j
      read_rows_raw(v, raw_k, tid);
      mbar_wait(&k_empty[s], freed);
      store_rows_split(Ks + s * SPLIT, v, rows, tid);
      fence_proxy_async();
      mbar_arrive(&k_full[s]);
      if (j + 1 < chunks) load_tile_f32_async(raw_k, kh, p.k_sn, (j + 1) * T, N, tid);
      cp_async_commit();
      cp_async_wait<1>();   // V of chunk j
      read_keys_raw(v, raw_v, tid);
      mbar_wait(&v_empty[s], freed);
      store_keys_split_t(Vt + s * SPLIT, v, tid);
      fence_proxy_async();
      mbar_arrive(&v_full[s]);
      if (j + 1 < chunks) load_keys_f32_async(raw_v, vh, p.v_sn, (j + 1) * T, N, tid);
      cp_async_commit();
    }
    return;
  }

  // consumer c: query rows [r0, r0 + 64)
  const int c = wg - 1, r0 = q0 + c * T;
  if (c >= consumers) return;
  setmaxnreg_inc<CONSUMER_REGS>();
  const int warp = tid / 32, lane = tid % 32;
  float* qs = Qs + c * SPLIT;
  {
    const float* qh = p.q + b * p.q_sb + h * p.q_sh;
    float4 v[8];
    load_rows_f32(v, qh, p.q_sn, r0, N, tid);
    store_rows_split(qs, v, T, tid);
  }
  fence_proxy_async();
  named_sync(BAR_Q + c, attn::THREADS);
  const bool turns = TAKE_TURNS && consumers == 2;
  if (turns && c == 1) named_arrive(BAR_TURN + 0, 2 * attn::THREADS);   // consumer 0 goes first

  float acc_o[32], row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_o[i] = 0.f;
  const Fwd32Consumer x = {qs, Ks, Vt, k_full, k_empty, v_full, v_empty, N, chunks, c, lane,
                           turns, p.scale * 1.4426950408889634f};
  switch (tail) {
    case 1: consume<1>(x, acc_o, row_max, row_sum); break;
    case 2: consume<2>(x, acc_o, row_max, row_sum); break;
    case 3: consume<3>(x, acc_o, row_max, row_sum); break;
    case 4: consume<4>(x, acc_o, row_max, row_sum); break;
    case 5: consume<5>(x, acc_o, row_max, row_sum); break;
    case 6: consume<6>(x, acc_o, row_max, row_sum); break;
    case 7: consume<7>(x, acc_o, row_max, row_sum); break;
    default: consume<8>(x, acc_o, row_max, row_sum); break;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    const int row = r0 + warp * 16 + lane / 4 + 8 * r;
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
  const cudaError_t e = cudaFuncSetAttribute(attention_fwd_f32_ws_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)fwd32::SMEM_BYTES);
  if (e != cudaSuccess) return e;
  // the CTAs of one head's row halves are neighbours
  const long long ctas = (long long)p.B * p.H * ((p.N + fwd32::ROWS - 1) / fwd32::ROWS);
  attention_fwd_f32_ws_kernel<<<(unsigned)ctas, fwd32::THREADS, fwd32::SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
}

}  // namespace dk
