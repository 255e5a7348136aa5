// Two consecutive fused pre-norm ViT blocks behind one entry point, forward
// and backward.
//
// Replaces: deltakd_tpu/ops/fused_block.py `_pair_fwd_kernel` (called by
// `_pair_fwd_call`) and `_pair_bwd_kernel` (called by `_pair_bwd_call`). For
// x [B, N, D] bf16 (or fp32 with fp32 weights: the `_f32` entry points, as
// the TPU kernels run at their input's dtype), four per-sample drop-path
// scales [B] fp32 and two weight sets:
//   mid, feat1 = block(x,   w1, s_attn1, s_mlp1)
//   out, feat2 = block(mid, w2, s_attn2, s_mlp2)
// What the pair does that two single-block launches do not: `mid` never
// leaves fp32 (a single block rounds its output to bf16 at the kernel
// boundary), and in the backward neither does the cotangent `dmid` between
// the two reverse sweeps; the backward saves one tensor (x) per pair and
// recomputes both blocks, block 1 including its fc2 (one [M, 4D] x [4D, D]
// product more than two single backwards) to get `mid`.
//
// The TPU kernel holds one element's two blocks in VMEM. Here one block
// already exceeds a thread block's 227 KB of shared memory, so a block is the
// chain of kernels of fused_block_common.cuh over a global workspace, and the
// pair is block 1's chain then block 2's chain over one workspace:
//   forward:  one set of forward buffers, reused by block 2, plus `mid`;
//   backward: two stashes alive at once (block 1's must survive until block
//             2's sweep has produced `dmid`), `mid`, `dmid`, and one set of
//             backward buffers that the two sweeps share.
// What bounds it on an H100: as for the single kernels, the tensor cores
// (twice the forward's operations; twice the backward's plus one fc2)
// against 4ND bytes of input and output per element, and above that floor
// the activations the chains carry through the workspace. Every product of
// both chains runs on the TMA + wgmma GEMM (gemm_sm90.cuh), and the
// attention keeps its [N, N] scores on chip in both directions
// (attention_fwd.cuh, attention_bwd.cuh), so a stash is per-token
// activations and one [B*H, N] row statistic. Each of the 24 weight
// gradients is a fixed-order sum of row-range partials; no atomics, so two
// runs give the same bits.

#include "fused_block_reverse.cuh"

using namespace dk;

namespace {

// Pointer-table slots shared by both entry points: x, the four scales
// (s_attn1, s_mlp1, s_attn2, s_mlp2), 12 weights of block 1, 12 of block 2.
constexpr int P_X = 0, P_SCALES = 1, P_W1 = 5, P_W2 = 17, P_REST = 29;

// The backward's workspace at operand type T: both blocks' stashes, mid and
// dmid (fp32 in both forms), and the sweeps' shared buffers.
template <typename T>
struct PairBwdBuffers {
  FwdBuffersT<T> f1, f2;
  float *mid, *dmid;
  BwdBuffersT<T> g;

  void carve(Carver& c, const Shape& sh) {
    f1.carve(c, sh, true);
    f2.carve(c, sh, true);
    mid = c.take<float>(sh.M() * sh.D);
    dmid = c.take<float>(sh.M() * sh.D);
    g.carve(c, sh);
  }
};

template <typename T>
size_t pair_fwd_workspace(const Shape& sh) {
  Carver c{nullptr, 0};
  FwdBuffersT<T> f;
  f.carve(c, sh, false);
  c.take<float>(sh.M() * sh.D);
  return c.off;
}

// The forward at operand type T: x, out, feat1 and feat2 of T. Block 2's
// output is rounded to bf16 at the kernel boundary in the bf16 form and
// written unrounded in the fp32 form.
template <typename T>
int pair_fwd(void* const* ptr, const Shape& sh, float eps, cudaStream_t st) {
  const float* const* s = (const float* const*)(ptr + P_SCALES);
  Carver c{(char*)ptr[P_REST + 3], 0};
  FwdBuffersT<T> f;
  f.carve(c, sh, false);
  float* mid = c.take<float>(sh.M() * sh.D);
  const cudaError_t err =
      forward_chain((const T*)ptr[P_X], s[0], s[1], unpack_weights<T>(ptr + P_W1), sh, eps, f,
                    false, nullptr, mid, (T*)ptr[P_REST + 1], st);
  if (err != cudaSuccess) return (int)err;
  T* out = is_f32<T> ? nullptr : (T*)ptr[P_REST];
  float* out32 = is_f32<T> ? (float*)ptr[P_REST] : nullptr;
  return (int)forward_chain((const float*)mid, s[2], s[3], unpack_weights<T>(ptr + P_W2), sh,
                            eps, f, false, out, out32, (T*)ptr[P_REST + 2], st);
}

template <typename T>
size_t pair_bwd_workspace(const Shape& sh) {
  Carver c{nullptr, 0};
  PairBwdBuffers<T> b;
  b.carve(c, sh);
  return c.off;
}

// The backward at operand type T: x, g_out, g_feat1, g_feat2 and dx of T.
template <typename T>
int pair_bwd(void* const* ptr, const Shape& sh, float eps, cudaStream_t st) {
  if (!(is_f32<T> ? attention_bwd_f32_takes(sh.hd(), sh.N) : attention_bwd_takes(sh.hd(), sh.N)))
    return (int)cudaErrorInvalidValue;
  const float* const* s = (const float* const*)(ptr + P_SCALES);
  const BlockWeightsT<T> w1 = unpack_weights<T>(ptr + P_W1), w2 = unpack_weights<T>(ptr + P_W2);
  const T* g_out = (const T*)ptr[P_REST];
  const T* g_feat1 = (const T*)ptr[P_REST + 1];
  const T* g_feat2 = (const T*)ptr[P_REST + 2];
  // dx: rounded as a product operand in the bf16 form, unrounded in the fp32
  T* dx = is_f32<T> ? nullptr : (T*)ptr[P_REST + 3];
  float* dx32 = is_f32<T> ? (float*)ptr[P_REST + 3] : nullptr;
  float* const* dW1 = (float* const*)(ptr + P_REST + 4);
  float* const* dW2 = dW1 + 12;

  Carver c{(char*)ptr[P_REST + 4 + 24], 0};
  PairBwdBuffers<T> b;
  b.carve(c, sh);

  // recompute block 1 with its stash and its unrounded output, then block 2's
  // stash from it (block 2 stops at the GELU)
  cudaError_t err = forward_chain((const T*)ptr[P_X], s[0], s[1], w1, sh, eps, b.f1, true,
                                  nullptr, b.mid, nullptr, st);
  if (err == cudaSuccess)
    err = forward_chain((const float*)b.mid, s[2], s[3], w2, sh, eps, b.f2, true, nullptr,
                        nullptr, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  // block 2's sweep leaves dmid in fp32; block 1's sweep reads it as its g_out
  err = reverse_chain(g_out, g_feat2, s[2], s[3], w2, sh, b.f2, b.g, dW2, b.dmid, nullptr, st);
  if (err != cudaSuccess) return (int)err;
  return (int)reverse_chain((const float*)b.dmid, g_feat1, s[0], s[1], w1, sh, b.f1, b.g, dW1,
                            dx32, dx, st);
}

}  // namespace

extern "C" size_t dk_fused_pair_fwd_workspace(int B, int N, int D, int H, int F) {
  return pair_fwd_workspace<bf16>(Shape{B, N, D, H, F});
}

// ptr: x, s_attn1, s_mlp1, s_attn2, s_mlp2, 12 weights of block 1, 12 of
// block 2, out, feat1|null, feat2|null, workspace. Returns
// cudaGetLastError() after the launches.
extern "C" int dk_fused_pair_fwd(void* const* ptr, int B, int N, int D, int H, int F,
                                 float eps, void* stream) {
  return pair_fwd<bf16>(ptr, Shape{B, N, D, H, F}, eps, (cudaStream_t)stream);
}

extern "C" size_t dk_fused_pair_bwd_workspace(int B, int N, int D, int H, int F) {
  return pair_bwd_workspace<bf16>(Shape{B, N, D, H, F});
}

// ptr: x, s_attn1, s_mlp1, s_attn2, s_mlp2, 12 weights of block 1, 12 of
// block 2, g_out, g_feat1|null, g_feat2|null, dx, the 12 fp32 weight
// gradients of block 1, the 12 of block 2 (each in its weights' order), then
// the workspace. Returns the first launch error, or cudaErrorInvalidValue,
// before any launch, for a shape the attention kernels do not take.
extern "C" int dk_fused_pair_bwd(void* const* ptr, int B, int N, int D, int H, int F,
                                 float eps, void* stream) {
  return pair_bwd<bf16>(ptr, Shape{B, N, D, H, F}, eps, (cudaStream_t)stream);
}

// The fp32 forms (rows 7 and 8 of an fp32 model): x, out, the features,
// the cotangents and dx fp32, the 24 weights fp32, every product 3xTF32 on
// TF32 wgmma, nothing rounded to bf16 (so the pair gives the bits of two
// fp32 single blocks chained, whose output between them is fp32 too). The
// same pointer tables and returns as the bf16 entry points.
extern "C" size_t dk_fused_pair_fwd_f32_workspace(int B, int N, int D, int H, int F) {
  return pair_fwd_workspace<float>(Shape{B, N, D, H, F});
}

extern "C" int dk_fused_pair_fwd_f32(void* const* ptr, int B, int N, int D, int H, int F,
                                     float eps, void* stream) {
  return pair_fwd<float>(ptr, Shape{B, N, D, H, F}, eps, (cudaStream_t)stream);
}

extern "C" size_t dk_fused_pair_bwd_f32_workspace(int B, int N, int D, int H, int F) {
  return pair_bwd_workspace<float>(Shape{B, N, D, H, F});
}

extern "C" int dk_fused_pair_bwd_f32(void* const* ptr, int B, int N, int D, int H, int F,
                                     float eps, void* stream) {
  return pair_bwd<float>(ptr, Shape{B, N, D, H, F}, eps, (cudaStream_t)stream);
}
