// Fused attention for ViT-length sequences, forward and backward.
//
// Replaces: deltakd_tpu/ops/attention.py `_fwd_kernel` (called by `_flash_fwd`)
// and `_bwd_kernel` (called by `_flash_bwd`). Per (batch, head), head dim 64:
//
//   forward   s = q k^T * scale (fp32), p = softmax(s) with p in bf16 for
//             its product, o = p v (fp32 accumulate) in bf16,
//             lse = max + log(sum) in fp32
//   backward  p = exp(s - lse), dv = p^T dO, dp = dO v^T,
//             delta = rowsum(dO * o), ds = p (dp - delta) scale,
//             dq = ds k, dk = ds^T q
//
// What bounds it on an H100: bytes. One head's q, k, v, o move 4 x N x 64 bf16
// and the products are 4 N^2 x 64 operations, some 100 operations a byte at
// N = 198, under the card's 295; the [N, N] scores must therefore never reach
// device memory. The TPU kernel keeps one head's whole problem, fp32 scores
// included, in VMEM. A thread block here has 227 KB, so:
//
// * forward: attention_fwd.cuh, shared with the fused block's forward: a CTA
//   of one warpgroup per (batch * head, 64 query rows), K and V streamed in
//   64-key chunks through a double-buffered cp.async ring, both products on
//   wgmma with the scores and P in registers, and an online softmax; see
//   that header for its rounding and padding. What keeps it above its byte
//   bound: each CTA's chain of two wgmma batches with the softmax between
//   them (no overlap inside a CTA; several CTAs per SM overlap each other),
//   198 keys padded to 256, and K and V read once per 64-row query tile.
// * backward: dq sums over keys, dk and dv over queries. A block owns one
//   range of at most 208 keys of one (batch, head), keeps that range of K, V
//   and its fp32 dk, dv accumulators in shared memory and loops over 32-row
//   query tiles; each accumulator tile belongs to one warp, so the sum over
//   queries runs in a fixed order without atomics. Given the saved lse,
//   p = exp(s - lse) needs no other keys. With one range (N <= 208) dq is
//   written directly; with more, each range writes an fp32 partial and a
//   second kernel sums the partials in range order.
//
// In the backward p and ds are rounded to bf16 before their products (the
// tensor cores take bf16); q, k, v, dO arrive in bf16. Inputs are addressed
// through (batch, head, row) strides with a contiguous head dim, so the
// [B, N, 3, H, 64] views of a packed qkv projection are read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_fwd.cuh"

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;            // head dim
constexpr int LDK = HD + 8;       // bf16 row stride of K, V, Q, dO tiles
constexpr int LDO = HD + 4;       // fp32 row stride of [*, 64] staging tiles
constexpr int MAX_SMEM = 232448;  // 227 KB
constexpr int BWD_THREADS = 256, BWD_WARPS = 8;
constexpr int BQ = 32;            // backward query tile
constexpr int KC_MAX = 208;       // backward key range
static_assert((BQ / 16) * (HD / 16) == BWD_WARPS, "one dq tile a warp");

// [B, H, N, 64] through element strides; the head dim is contiguous.
struct Strided {
  const bf16* p;
  long long sb, sh, sn;
  __device__ const bf16* head(int b, int h) const { return p + b * sb + h * sh; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [r0, r0 + rows) of one head into dst[rows][LDK], 16 bytes a thread;
// rows at or beyond N are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long sn, int r0,
                                          int rows, int N, int tid, int nthreads) {
  for (int i = tid; i < rows * (HD / 8); i += nthreads) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N) v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * sn + c);
    *reinterpret_cast<uint4*>(dst + r * LDK + c) = v;
  }
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

inline int round16(int n) { return (n + 15) / 16 * 16; }

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

struct BwdPlan {
  int splits, Kc;
  size_t smem;
};

inline BwdPlan bwd_plan(int N) {
  BwdPlan p;
  p.splits = (N + KC_MAX - 1) / KC_MAX;
  p.Kc = round16((N + p.splits - 1) / p.splits);
  p.smem = (size_t)2 * p.Kc * LDK * sizeof(bf16)          // K, V
           + (size_t)2 * p.Kc * LDO * sizeof(float)       // dk, dv accumulators
           + (size_t)2 * BQ * LDK * sizeof(bf16)          // Q, dO tiles
           + (size_t)2 * BQ * (p.Kc + 8) * sizeof(bf16)   // p, ds
           + (size_t)BWD_WARPS * 512 * sizeof(float)      // per-warp scratch / dq staging
           + (size_t)2 * BQ * sizeof(float);              // lse, delta
  return p;
}

__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_kernel(Strided q, Strided k, Strided v, Strided dO, const bf16* o, const float* lse,
                 bf16* dq, float* dq_part, bf16* dk, bf16* dv, int H, int BH, int N, int Kc,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int key0 = split * Kc, nkt = Kc / 16, ldP = Kc + 8;

  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Kc * LDK;
  float* dKs = reinterpret_cast<float*>(Vs + Kc * LDK);
  float* dVs = dKs + Kc * LDO;
  bf16* Qs = reinterpret_cast<bf16*>(dVs + Kc * LDO);
  bf16* dOs = Qs + BQ * LDK;
  bf16* Ps = dOs + BQ * LDK;
  bf16* dSs = Ps + BQ * ldP;
  float* scr = reinterpret_cast<float*>(dSs + BQ * ldP);
  float* lse_s = scr + BWD_WARPS * 512;
  float* delta_s = lse_s + BQ;
  float* dQs = scr;   // [BQ][LDO] staging, used after the score phase is over

  load_rows(Ks, k.head(b, h), k.sn, key0, Kc, N, tid, BWD_THREADS);
  load_rows(Vs, v.head(b, h), v.sn, key0, Kc, N, tid, BWD_THREADS);
  for (int i = tid; i < 2 * Kc * LDO; i += BWD_THREADS) dKs[i] = 0.f;
  __syncthreads();

  const bf16* qh = q.head(b, h);
  const bf16* doh = dO.head(b, h);
  for (int q0 = 0; q0 < N; q0 += BQ) {
    load_rows(Qs, qh, q.sn, q0, BQ, N, tid, BWD_THREADS);
    load_rows(dOs, doh, dO.sn, q0, BQ, N, tid, BWD_THREADS);
    __syncthreads();
    // delta = rowsum(dO * o) with the saved o; lse of the tile's rows
    for (int r = warp; r < BQ; r += BWD_WARPS) {
      const int row = q0 + r;
      float d = 0.f;
      if (row < N) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dOs + r * LDK + 2 * lane));
        const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            o + ((long long)bh * N + row) * HD + 2 * lane));
        d = a.x * c.x + a.y * c.y;
      }
      d = warp_sum(d);
      if (lane == 0) {
        delta_s[r] = d;
        lse_s[r] = row < N ? lse[(long long)bh * N + row] : 0.f;
      }
    }
    __syncthreads();

    // p = exp(s - lse) and ds = p (dp - delta) scale, 16 x 16 tiles
    for (int t = warp; t < (BQ / 16) * nkt; t += BWD_WARPS) {
      const int i = t / nkt, j = t % nkt;
      FragC s_acc, dp_acc;
      wmma::fill_fragment(s_acc, 0.0f);
      wmma::fill_fragment(dp_acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        FragA a;
        FragBT bt;
        wmma::load_matrix_sync(a, Qs + i * 16 * LDK + kk * 16, LDK);
        wmma::load_matrix_sync(bt, Ks + j * 16 * LDK + kk * 16, LDK);
        wmma::mma_sync(s_acc, a, bt, s_acc);
        wmma::load_matrix_sync(a, dOs + i * 16 * LDK + kk * 16, LDK);
        wmma::load_matrix_sync(bt, Vs + j * 16 * LDK + kk * 16, LDK);
        wmma::mma_sync(dp_acc, a, bt, dp_acc);
      }
      float* sc = scr + warp * 512;
      wmma::store_matrix_sync(sc, s_acc, 16, wmma::mem_row_major);
      wmma::store_matrix_sync(sc + 256, dp_acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = i * 16 + e / 16, c = j * 16 + e % 16;
        float p = 0.f, ds = 0.f;
        if (q0 + r < N && key0 + c < N) {
          p = __expf(sc[e] * scale - lse_s[r]);
          ds = p * (sc[256 + e] - delta_s[r]) * scale;
        }
        Ps[r * ldP + c] = __float2bfloat16(p);
        dSs[r * ldP + c] = __float2bfloat16(ds);
      }
      __syncwarp();
    }
    __syncthreads();

    // dv += p^T dO, dk += ds^T q: each [16 keys, 16 dims] tile has one owner
    for (int t = warp; t < 2 * nkt * (HD / 16); t += BWD_WARPS) {
      const int which = t / (nkt * (HD / 16)), tt = t % (nkt * (HD / 16));
      const int kt = tt / (HD / 16), n = tt % (HD / 16);
      const bf16* A = which ? dSs : Ps;
      const bf16* Bm = which ? Qs : dOs;
      float* C = (which ? dKs : dVs) + kt * 16 * LDO + n * 16;
      FragC acc;
      wmma::load_matrix_sync(acc, C, LDO, wmma::mem_row_major);
#pragma unroll
      for (int qq = 0; qq < BQ / 16; ++qq) {
        FragAT at;   // (p^T)[key][row] = Ps[row][key]
        FragB bm;
        wmma::load_matrix_sync(at, A + qq * 16 * ldP + kt * 16, ldP);
        wmma::load_matrix_sync(bm, Bm + qq * 16 * LDK + n * 16, LDK);
        wmma::mma_sync(acc, at, bm, acc);
      }
      wmma::store_matrix_sync(C, acc, LDO, wmma::mem_row_major);
    }
    // dq tile = ds k over this block's keys: BQ/16 x 4 = 8 tiles, one a warp
    {
      const int i = warp / (HD / 16), n = warp % (HD / 16);
      FragC acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kt = 0; kt < nkt; ++kt) {
        FragA a;
        FragB bm;
        wmma::load_matrix_sync(a, dSs + i * 16 * ldP + kt * 16, ldP);
        wmma::load_matrix_sync(bm, Ks + kt * 16 * LDK + n * 16, LDK);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(dQs + i * 16 * LDO + n * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < BQ * (HD / 2); i += BWD_THREADS) {
      const int r = i / (HD / 2), c = (i % (HD / 2)) * 2;
      if (q0 + r >= N) continue;
      const float x0 = dQs[r * LDO + c], x1 = dQs[r * LDO + c + 1];
      const long long at = ((long long)bh * N + q0 + r) * HD + c;
      if (dq_part) {
        float* dst = dq_part + (long long)split * BH * N * HD + at;
        dst[0] = x0;
        dst[1] = x1;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dq + at) = __floats2bfloat162_rn(x0, x1);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < Kc * (HD / 2); i += BWD_THREADS) {
    const int r = i / (HD / 2), c = (i % (HD / 2)) * 2;
    if (key0 + r >= N) continue;
    const long long at = ((long long)bh * N + key0 + r) * HD + c;
    *reinterpret_cast<__nv_bfloat162*>(dk + at) =
        __floats2bfloat162_rn(dKs[r * LDO + c], dKs[r * LDO + c + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dv + at) =
        __floats2bfloat162_rn(dVs[r * LDO + c], dVs[r * LDO + c + 1]);
  }
}

// dq = sum over key ranges of the fp32 partials, in range order.
__global__ void dq_reduce_kernel(const float* part, int splits, long long len, bf16* dq) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int c = 0; c < splits; ++c) s += part[c * len + i];
  dq[i] = __float2bfloat16(s);
}

}  // namespace

// The longest sequence flash_attention takes: 656 keys, the limit of the
// forward when it kept all of K and V in shared memory. The streaming forward
// takes any N; the backward is held to its plain version up to this length.
extern "C" int dk_flash_max_n() { return 656; }

// q, k, v: [B, H, N, 64] bf16 through strides (batch, head, row), in
// elements; o: [B, H, N, 64] bf16 and lse: [B, H, N] fp32, both contiguous.
// Returns cudaGetLastError() after the launch, or -1 for a shape it refuses.
extern "C" int dk_flash_fwd(const void* q, const void* k, const void* v, long long q_sb,
                            long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                            long long k_sn, long long v_sb, long long v_sh, long long v_sn,
                            void* o, void* lse, int B, int H, int N, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > dk_flash_max_n()) return -1;
  dk::AttnArgs a = {};
  a.q = (const bf16*)q; a.q_sb = q_sb; a.q_sh = q_sh; a.q_sn = q_sn;
  a.k = (const bf16*)k; a.k_sb = k_sb; a.k_sh = k_sh; a.k_sn = k_sn;
  a.v = (const bf16*)v; a.v_sb = v_sb; a.v_sh = v_sh; a.v_sn = v_sn;
  a.o = (bf16*)o; a.o_sb = (long long)H * N * HD; a.o_sh = (long long)N * HD; a.o_sn = HD;
  a.lse = (float*)lse;
  a.B = B; a.H = H; a.N = N;
  a.scale = 1.0f / sqrtf((float)HD);
  return (int)dk::attention_fwd(a, HD, (cudaStream_t)stream);
}

// Bytes of fp32 dq partials the backward needs (0 when one key range covers N).
extern "C" size_t dk_flash_bwd_workspace(int B, int H, int N) {
  const BwdPlan p = bwd_plan(N);
  return p.splits > 1 ? (size_t)p.splits * B * H * N * HD * sizeof(float) : 0;
}

// q, k, v, dO strided as in the forward; o, lse the forward's outputs; dq, dk,
// dv: [B, H, N, 64] bf16 contiguous; work: dk_flash_bwd_workspace bytes.
extern "C" int dk_flash_bwd(const void* q, const void* k, const void* v, const void* dO,
                            long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                            long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                            long long v_sn, long long g_sb, long long g_sh, long long g_sn,
                            const void* o, const void* lse, void* dq, void* dk, void* dv,
                            void* work, int B, int H, int N, void* stream) {
  if (B < 1 || H < 1 || N < 1) return -1;
  const BwdPlan p = bwd_plan(N);
  if (p.smem > (size_t)MAX_SMEM || (p.splits > 1 && !work)) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const Strided qs{(const bf16*)q, q_sb, q_sh, q_sn};
  const Strided ks{(const bf16*)k, k_sb, k_sh, k_sn};
  const Strided vs{(const bf16*)v, v_sb, v_sh, v_sn};
  const Strided gs{(const bf16*)dO, g_sb, g_sh, g_sn};
  float* part = p.splits > 1 ? (float*)work : nullptr;
  flash_bwd_kernel<<<dim3(p.splits, B * H), BWD_THREADS, p.smem, st>>>(
      qs, ks, vs, gs, (const bf16*)o, (const float*)lse, (bf16*)dq, part, (bf16*)dk, (bf16*)dv,
      H, B * H, N, p.Kc, 1.0f / sqrtf((float)HD));
  if (part) {
    const long long len = (long long)B * H * N * HD;
    dq_reduce_kernel<<<(unsigned)((len + 255) / 256), 256, 0, st>>>(part, p.splits, len,
                                                                     (bf16*)dq);
  }
  return (int)cudaGetLastError();
}
