// Fused attention for ViT-length sequences, forward and backward.
//
// Replaces: deltakd_tpu/ops/attention.py `_fwd_kernel` (called by `_flash_fwd`)
// and `_bwd_kernel` (called by `_flash_bwd`). Per (batch, head), head dim 64:
//
//   forward   s = q k^T * scale (fp32), p = softmax(s) rounded to bf16,
//             o = p v (fp32 accumulate) in bf16, lse = max + log(sum) in fp32
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
// * forward: one block per (batch, head) keeps all of K and V in shared memory
//   and each warp walks 16-row query tiles. With every key present a row's
//   maximum and sum are exact in one pass (no online rescaling); the fp32
//   score rows of the warp's tile live in shared memory and are overwritten in
//   place by the bf16 probabilities. Padding keys (N is ragged against the
//   16-wide tiles) are zero rows of K and V, their columns are left out of
//   the maximum and the sum and get probability 0; padding query rows are
//   computed on zeros and never stored, so no -inf and no NaN arises.
// * backward: dq sums over keys, dk and dv over queries. A block owns one
//   range of at most 208 keys of one (batch, head), keeps that range of K, V
//   and its fp32 dk, dv accumulators in shared memory and loops over 32-row
//   query tiles; each accumulator tile belongs to one warp, so the sum over
//   queries runs in a fixed order without atomics. Given the saved lse,
//   p = exp(s - lse) needs no other keys. With one range (N <= 208) dq is
//   written directly; with more, each range writes an fp32 partial and a
//   second kernel sums the partials in range order.
//
// p and ds are rounded to bf16 before their products (the tensor cores take
// bf16); q, k, v, dO arrive in bf16. Inputs are addressed through (batch,
// head, row) strides with a contiguous head dim, so the [B, N, 3, H, 64] views
// of a packed qkv projection are read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;            // head dim
constexpr int LDK = HD + 8;       // bf16 row stride of K, V, Q, dO tiles
constexpr int LDO = HD + 4;       // fp32 row stride of [*, 64] staging tiles
constexpr int MAX_SMEM = 232448;  // 227 KB
constexpr int FWD_MAX_WARPS = 8;
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

inline int round16(int n) { return (n + 15) / 16 * 16; }

// Bytes of one warp's work area: 16 fp32 score rows of Np + 8, and never less
// than the 16 x 64 fp32 output staging tile that reuses it.
inline size_t fwd_warp_bytes(int Np) {
  const size_t s = (size_t)16 * (Np + 8) * sizeof(float);
  const size_t o = (size_t)16 * LDO * sizeof(float);
  return s > o ? s : o;
}

__host__ __device__ inline size_t fwd_kv_bytes(int Np) { return (size_t)2 * Np * LDK * sizeof(bf16); }

__global__ void flash_fwd_kernel(Strided q, Strided k, Strided v, bf16* o, float* lse, int H,
                                 int N, int Np, int warp_bytes, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = blockDim.x / 32;
  const int ldS = Np + 8, ldP = 2 * ldS, ntiles = Np / 16;

  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Np * LDK;
  float* S = reinterpret_cast<float*>(smem + fwd_kv_bytes(Np) + (size_t)warp * warp_bytes);
  bf16* P = reinterpret_cast<bf16*>(S);      // probabilities, in place over the scores
  bf16* Qs = reinterpret_cast<bf16*>(S);     // query tile staging, before the scores
  float* Os = S;                             // output staging, after the p v product

  load_rows(Ks, k.head(b, h), k.sn, 0, Np, N, tid, blockDim.x);
  load_rows(Vs, v.head(b, h), v.sn, 0, Np, N, tid, blockDim.x);
  __syncthreads();

  const bf16* qh = q.head(b, h);
  for (int t = warp; t < ntiles; t += nwarps) {
    const int r0 = t * 16;
    load_rows(Qs, qh, q.sn, r0, 16, N, lane, 32);
    __syncwarp();
    FragA qa[HD / 16];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wmma::load_matrix_sync(qa[kk], Qs + kk * 16, LDK);
    __syncwarp();

    // scores of the 16 rows against every key
    for (int j = 0; j < ntiles; ++j) {
      FragC acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        FragBT kb;   // (k^T)[d][key] = Ks[key][d]
        wmma::load_matrix_sync(kb, Ks + j * 16 * LDK + kk * 16, LDK);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(S + j * 16, acc, ldS, wmma::mem_row_major);
    }
    __syncwarp();

    // row softmax over the N real keys; p in bf16 over the row's own scores
    for (int r = 0; r < 16; ++r) {
      float* srow = S + r * ldS;
      bf16* prow = P + r * ldP;
      float m = -3.402823466e38f;
      for (int j = lane; j < N; j += 32) m = fmaxf(m, srow[j] * scale);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = __expf(srow[j] * scale - m);
        srow[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0 && r0 + r < N) lse[(long long)bh * N + r0 + r] = m + logf(sum);
      // bf16 element j lies inside fp32 elements <= j of the same row, all of
      // which this or an earlier round has already read
      for (int j0 = 0; j0 < Np; j0 += 32) {
        const int j = j0 + lane;
        const float e = (j < N) ? srow[j] : 0.f;
        __syncwarp();
        if (j < Np) prow[j] = __float2bfloat16(e / sum);
        __syncwarp();
      }
    }
    __syncwarp();

    // o = p v
    FragC oacc[HD / 16];
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(oacc[n], 0.0f);
    for (int kt = 0; kt < ntiles; ++kt) {
      FragA pa;
      wmma::load_matrix_sync(pa, P + kt * 16, ldP);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        FragB vb;
        wmma::load_matrix_sync(vb, Vs + kt * 16 * LDK + n * 16, LDK);
        wmma::mma_sync(oacc[n], pa, vb, oacc[n]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < HD / 16; ++n)
      wmma::store_matrix_sync(Os + n * 16, oacc[n], LDO, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * (HD / 2); i += 32) {
      const int r = i / (HD / 2), c = (i % (HD / 2)) * 2;
      if (r0 + r < N)
        *reinterpret_cast<__nv_bfloat162*>(o + ((long long)bh * N + r0 + r) * HD + c) =
            __floats2bfloat162_rn(Os[r * LDO + c], Os[r * LDO + c + 1]);
    }
    __syncwarp();
  }
}

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

// The longest sequence the forward kernel takes: K, V and one warp's score
// rows must fit one block's shared memory.
extern "C" int dk_flash_max_n() {
  int n = 16;
  while (fwd_kv_bytes(n + 16) + fwd_warp_bytes(n + 16) <= (size_t)MAX_SMEM) n += 16;
  return n;
}

// q, k, v: [B, H, N, 64] bf16 through strides (batch, head, row), in
// elements; o: [B, H, N, 64] bf16 and lse: [B, H, N] fp32, both contiguous.
// Returns cudaGetLastError() after the launch, or -1 for a shape it refuses.
extern "C" int dk_flash_fwd(const void* q, const void* k, const void* v, long long q_sb,
                            long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                            long long k_sn, long long v_sb, long long v_sh, long long v_sn,
                            void* o, void* lse, int B, int H, int N, void* stream) {
  if (B < 1 || H < 1 || N < 1 || N > dk_flash_max_n()) return -1;
  const int Np = round16(N);
  const size_t warp_bytes = fwd_warp_bytes(Np);
  int nwarps = (int)(((size_t)MAX_SMEM - fwd_kv_bytes(Np)) / warp_bytes);
  if (nwarps > FWD_MAX_WARPS) nwarps = FWD_MAX_WARPS;
  if (nwarps > Np / 16) nwarps = Np / 16;
  const size_t smem = fwd_kv_bytes(Np) + (size_t)nwarps * warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strided qs{(const bf16*)q, q_sb, q_sh, q_sn};
  const Strided ks{(const bf16*)k, k_sb, k_sh, k_sn};
  const Strided vs{(const bf16*)v, v_sb, v_sh, v_sn};
  flash_fwd_kernel<<<B * H, 32 * nwarps, smem, (cudaStream_t)stream>>>(
      qs, ks, vs, (bf16*)o, (float*)lse, H, N, Np, (int)warp_bytes, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
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
