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
// included, in VMEM. A thread block here has 227 KB, so both directions run
// the fused block's Hopper attention cores, with the score scale passed in:
//
// * forward: attention_fwd.cuh: a CTA of one warpgroup per (batch * head, 64
//   query rows), K and V streamed in 64-key chunks through a double-buffered
//   cp.async ring, both products on wgmma with the scores and P in
//   registers, and an online softmax; see that header for its rounding and
//   padding. What keeps it above its byte bound: each CTA's chain of two
//   wgmma batches with the softmax between them, 198 keys padded to 256, and
//   K and V read once per 64-row query tile.
// * backward: attention_bwd.cuh, the five products on wgmma, P^T and dS^T
//   in registers, every sum in a fixed order (no atomics). Up to N = 256 one
//   warpgroup per (batch, head) keeps dK and dV in registers per 64-key tile
//   and dQ of all rows in shared memory (one launch). Above it the split
//   route: one warpgroup per (batch, head, key tile) for dK and dV and one
//   per (batch, head, query tile) for dQ, in one launch after one that
//   computes rowsum(dO * o) into a small device workspace
//   (`dk_flash_bwd_workspace`).
//   Here it gets the unscaled q, so the scale goes on S in the exponent and
//   on dQ and dK (64^-1/2 = 2^-3: exact), and no delta, so it computes
//   rowsum(dO * o) of each head itself. Any N and any B*H: neither route's
//   shared memory grows past 11 tiles and every grid is 1-D.
//
// In the backward p and ds are rounded to bf16 before their products (the
// tensor cores take bf16); q, k, v, dO arrive in bf16. The fp32 forms
// (`dk_flash_fwd_f32`, `dk_flash_bwd_f32`, for fp32 tensors, as the TPU
// kernels run at their inputs' dtype) run every product on TF32 wgmma in
// 3xTF32 (each operand as a high and a low TF32 part, three products) and
// round nothing to bf16: o, lse, dq, dk, dv fp32 (the fp32 forms in
// attention_fwd.cuh and attention_bwd.cuh). The fp32 forward is one
// warp-specialised kernel per (batch * head, 128 query rows): a producer
// warpgroup splits each 64-key chunk of K and V^T into TF32 hi and lo in a
// two-slot ring, two consumer warpgroups of 64 rows take turns at the
// tensor cores, and the last chunk runs only over its groups of 8 keys;
// what bounds it is its products at the TF32 rate, three times over. The
// fp32 backward is three kernels, with a workspace the caller passes.
// Inputs are addressed through (batch, head, row) strides with a contiguous
// head dim, so the [B, N, 3, H, 64] views of a packed qkv projection are
// read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_bwd.cuh"
#include "attention_fwd.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;   // head dim

}  // namespace

// q, k, v: [B, H, N, 64] bf16 through strides (batch, head, row), in
// elements; o: [B, H, N, 64] bf16 and lse: [B, H, N] fp32, both contiguous.
// Returns cudaGetLastError() after the launch, or -1 for a shape it refuses.
extern "C" int dk_flash_fwd(const void* q, const void* k, const void* v, long long q_sb,
                            long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                            long long k_sn, long long v_sb, long long v_sh, long long v_sn,
                            void* o, void* lse, int B, int H, int N, void* stream) {
  if (B < 1 || H < 1 || N < 1) return -1;
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

// Bytes of dk_flash_bwd's workspace (attention_bwd.cuh
// `attention_bwd_workspace`): 0 up to N = 256, above it the split route's
// delta and column-sum partials.
extern "C" size_t dk_flash_bwd_workspace(int B, int H, int N) {
  return dk::attention_bwd_workspace(B, H, N);
}

namespace {

int flash_bwd(const void* q, const void* k, const void* v, const void* dO, long long q_sb,
              long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
              long long v_sb, long long v_sh, long long v_sn, long long g_sb, long long g_sh,
              long long g_sn, const void* o, const void* lse, void* dq, void* dk, void* dv, int B,
              int H, int N, void* work, void* stream, dk::AttnBwdRoute route) {
  if (B < 1 || H < 1 || N < 1) return -1;
  const long long sb = (long long)H * N * HD, sh = (long long)N * HD;
  dk::AttnBwdArgs a = {};
  a.q = (const bf16*)q; a.q_sb = q_sb; a.q_sh = q_sh; a.q_sn = q_sn;
  a.k = (const bf16*)k; a.k_sb = k_sb; a.k_sh = k_sh; a.k_sn = k_sn;
  a.v = (const bf16*)v; a.v_sb = v_sb; a.v_sh = v_sh; a.v_sn = v_sn;
  a.dout = (const bf16*)dO; a.d_sb = g_sb; a.d_sh = g_sh; a.d_sn = g_sn;
  a.lse = (const float*)lse;
  a.delta = nullptr;   // the kernel computes it from o and dO
  a.o = (const bf16*)o; a.o_sb = sb; a.o_sh = sh; a.o_sn = HD;
  a.dq = (bf16*)dq; a.dk = (bf16*)dk; a.dv = (bf16*)dv;
  a.g_sb = sb; a.g_sh = sh; a.g_sn = HD;
  a.colsum = nullptr;
  a.scale = a.dq_scale = 1.0f / sqrtf((float)HD);   // 2^-3
  a.B = B; a.H = H; a.N = N;
  return (int)dk::attention_bwd(a, HD, (float*)work, (cudaStream_t)stream, route);
}

}  // namespace

// q, k, v, dO strided as in the forward; o, lse the forward's outputs
// (contiguous); dq, dk, dv: [B, H, N, 64] bf16 contiguous; the workspace, of
// the bytes above (null when they are 0), before the stream. Returns
// cudaGetLastError() after the launch, or -1 for a shape it refuses.
extern "C" int dk_flash_bwd(const void* q, const void* k, const void* v, const void* dO,
                            long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                            long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                            long long v_sn, long long g_sb, long long g_sh, long long g_sn,
                            const void* o, const void* lse, void* dq, void* dk, void* dv, int B,
                            int H, int N, void* work, void* stream) {
  return flash_bwd(q, k, v, dO, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, g_sb, g_sh,
                   g_sn, o, lse, dq, dk, dv, B, H, N, work, stream, dk::AttnBwdRoute::AUTO);
}

// dk_flash_bwd on a route forced (1 the short route, N <= 704; 2 the split
// route, any N), where the kernel would take the other by itself: the same
// arguments and the route last, with a workspace of
// dk_flash_bwd_route_workspace bytes. For holding the two routes to the same
// bits and timing them beside each other; no model path calls it.
extern "C" size_t dk_flash_bwd_route_workspace(int B, int H, int N, int route) {
  return route == (int)dk::AttnBwdRoute::SPLIT ? dk::attention_bwd_split_workspace(B, H, N) : 0;
}

extern "C" int dk_flash_bwd_route(const void* q, const void* k, const void* v, const void* dO,
                                  long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                                  long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                                  long long v_sn, long long g_sb, long long g_sh, long long g_sn,
                                  const void* o, const void* lse, void* dq, void* dk, void* dv,
                                  int B, int H, int N, void* work, void* stream, int route) {
  if (route != (int)dk::AttnBwdRoute::SHORT && route != (int)dk::AttnBwdRoute::SPLIT) return -1;
  return flash_bwd(q, k, v, dO, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, g_sb, g_sh,
                   g_sn, o, lse, dq, dk, dv, B, H, N, work, stream, (dk::AttnBwdRoute)route);
}

// The fp32 forms of dk_flash_fwd and dk_flash_bwd: the same arguments, every
// tensor fp32 (lse fp32 as before).
extern "C" int dk_flash_fwd_f32(const void* q, const void* k, const void* v, long long q_sb,
                                long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                                long long k_sn, long long v_sb, long long v_sh, long long v_sn,
                                void* o, void* lse, int B, int H, int N, void* stream) {
  if (B < 1 || H < 1 || N < 1) return -1;
  dk::AttnArgsT<float> a = {};
  a.q = (const float*)q; a.q_sb = q_sb; a.q_sh = q_sh; a.q_sn = q_sn;
  a.k = (const float*)k; a.k_sb = k_sb; a.k_sh = k_sh; a.k_sn = k_sn;
  a.v = (const float*)v; a.v_sb = v_sb; a.v_sh = v_sh; a.v_sn = v_sn;
  a.o = (float*)o; a.o_sb = (long long)H * N * HD; a.o_sh = (long long)N * HD; a.o_sn = HD;
  a.lse = (float*)lse;
  a.B = B; a.H = H; a.N = N;
  a.scale = 1.0f / sqrtf((float)HD);
  return (int)dk::attention_fwd(a, HD, (cudaStream_t)stream);
}

// Bytes of dk_flash_bwd_f32's workspace (attention_bwd.cuh
// `attention_bwd_f32_workspace`).
extern "C" size_t dk_flash_bwd_f32_workspace(int B, int H, int N) {
  return dk::attention_bwd_f32_workspace(B, H, N);
}

// The fp32 backward takes its workspace, of the bytes above, before the
// stream.
extern "C" int dk_flash_bwd_f32(const void* q, const void* k, const void* v, const void* dO,
                                long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                                long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                                long long v_sn, long long g_sb, long long g_sh, long long g_sn,
                                const void* o, const void* lse, void* dq, void* dk, void* dv,
                                int B, int H, int N, void* work, void* stream) {
  if (B < 1 || H < 1 || N < 1) return -1;
  const long long sb = (long long)H * N * HD, sh = (long long)N * HD;
  dk::AttnBwdArgsT<float> a = {};
  a.q = (const float*)q; a.q_sb = q_sb; a.q_sh = q_sh; a.q_sn = q_sn;
  a.k = (const float*)k; a.k_sb = k_sb; a.k_sh = k_sh; a.k_sn = k_sn;
  a.v = (const float*)v; a.v_sb = v_sb; a.v_sh = v_sh; a.v_sn = v_sn;
  a.dout = (const float*)dO; a.d_sb = g_sb; a.d_sh = g_sh; a.d_sn = g_sn;
  a.lse = (const float*)lse;
  a.delta = nullptr;   // each CTA computes it from o and dO
  a.o = (const float*)o; a.o_sb = sb; a.o_sh = sh; a.o_sn = HD;
  a.dq = (float*)dq; a.dk = (float*)dk; a.dv = (float*)dv;
  a.g_sb = sb; a.g_sh = sh; a.g_sn = HD;
  a.colsum = nullptr;
  a.scale = a.dq_scale = 1.0f / sqrtf((float)HD);   // 2^-3
  a.B = B; a.H = H; a.N = N;
  return (int)dk::attention_bwd(a, HD, (float*)work, (cudaStream_t)stream);
}
