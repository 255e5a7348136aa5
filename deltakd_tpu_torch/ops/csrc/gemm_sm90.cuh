// A pipelined TMA + wgmma GEMM for Hopper (sm_90a), in two forms, and the
// Hopper primitives (mbarriers, TMA, wgmma and its shared-memory descriptors)
// that attention_fwd.cuh, attention_bwd.cuh and the fused-MLP forward
// (fused_mlp.cu) build on. The fused-MLP backward runs its five products on
// the two forms below, as the block's reverse sweep does.
//
//   linear_kernel:       C[M, N] = A[M, K] W[N, K]^T, then a fused epilogue
//                        (`Linear` below). The block forward's four products
//                        (qkv, proj, fc1, fc2 in `forward_chain`) and the
//                        backward's four input gradients (dX = G W, with W
//                        copied once per call into a K-major W^T; fc2's times
//                        GELU's derivative, with the column sums of each
//                        128-row tile for the fc1 bias gradient).
//   weight_grad_kernel:  P[s][O, I] = sum over rows m of split s of
//                        G[m, O]^T X[m, I], the backward's weight gradients,
//                        summed over the splits in a fixed order afterwards.
//
// linear_kernel reads A (row-major activations) and W (an nn.Linear weight)
// K-major, as wgmma reads them with no transpose. weight_grad_kernel reads G
// and X as they lie in memory, rows of the batch along the product's depth:
// both operands MN-major, which wgmma reads with its transpose bits set.
// bf16 operands, fp32 accumulation.
//
// What bounds them on an H100: the tensor cores. At the main path's shapes
// (M = 50,688 rows, K = D or 4D, D = 192/384) a product does 2MNK operations
// on (M + N) K + M N elements, hundreds of operations a byte, above the
// card's ~295 FLOP/byte ridge. But K is short (3-24 blocks of 64), so each
// output tile's epilogue (bias, GELU, residual, 2-8 bytes an element out) is
// a large share of its time, and the design is built to hide it:
//  * A persistent grid walks 128 x 64 output tiles in row order, so that
//    neighbouring CTAs share A's rows in L2. Two CTAs run on each SM (the
//    occupancy query says how many fit; 97 KB of shared memory and at most
//    113 registers a thread each), so that one CTA's epilogue runs under the
//    other's products.
//  * One producer warp issues TMA loads of 128 x 64 A tiles and 64 x 64 W
//    tiles into a ring of STAGES stages. Each stage has a "full" mbarrier
//    (completed by the TMA's byte count) and an "empty" one (one arrival per
//    consumer warp). The tensor maps use the 128-byte swizzle, the layout
//    wgmma's descriptors read; rows past M or N arrive as zeros.
//  * Two consumer warpgroups, 64 rows each, issue wgmma.mma_async m64n64k16
//    from shared memory, keep the fp32 accumulators in registers, and keep
//    one k-block's products in flight while they release the stage before.
//    The producer runs on into the next tile's loads during the epilogue.
//  * The epilogue runs straight from the registers: each thread owns two
//    neighbouring columns of two rows per 8-column block and stores them as
//    float2 / bf16x2, masked at the ragged M and N edges. Its inputs (bias,
//    residual, multiplier) are loaded a group of blocks ahead of the group's
//    stores.
// Tiles 64 wide and two CTAs per SM were the fastest of the layouts tried on
// the four forward products (tiles 64 to 256 wide, one CTA per SM with 4 or
// 5 stages); chip_smoke.py's [gemm] lines give this design's rates.
// A weight gradient has a short output (O x I = 36,864 to 147,456 elements
// at D = 192, 6 to 24 tiles) and a long depth (M = 50,688 rows), so
// weight_grad_kernel splits the depth into row ranges, as many as fill the
// card's CTA slots with (tile, range) items, and writes one fp32 partial per
// range; the caller sums them in range order. Each output element is summed
// by one warpgroup in a fixed k order and the partials in a fixed order: no
// atomics, two runs give the same bits.
//
// Both forms have fp32 counterparts (the operand type T, `Operand<T>`):
// an fp32 product is 3xTF32 on the TF32 wgmma (m64n64k8.f32.tf32.tf32, 495
// TFLOP/s dense) with fp32 accumulation. A 128-byte swizzle row holds 32
// fp32, so a k-block is 32 deep and a stage holds the bf16 ring's bytes; a
// k-step of 8 is 32 bytes, as bf16's of 16 is. TF32 wgmma takes no
// transpose: both shared-memory operands are K-major.
// 3xTF32: one TF32 product (10 mantissa bits, an eighth of bf16's rounding)
// held the fp32 forms' error to 0.25 of the bf16 forms' with no margin (one
// input draw in 64 read 0.249 for a block's dx), so every fp32 product is
// a_hi b_hi + a_hi b_lo + a_lo b_hi, with hi = TF32(v) rounded to nearest and
// lo = TF32(v - hi): about 21 bits of each operand. The operands are stored
// fp32 and unrounded (`to_lp<float>` is the identity).
// The fp32 linear product is a kernel of its own, `linear_f32_kernel`: its
// weight arrives split, once per call, into TF32 hi and lo ([2][N][K], each
// k-step's 8 columns in tf32_key_slot order: `split_weights_tf32_kernel`,
// or fused_block_common.cuh's transpose for an input gradient), and each
// thread splits its A fragments in registers; nothing is split in shared
// memory. See its comment.
// The fp32 weight gradient's depth m is the strided dimension of G and X, so
// it is a kernel of its own, `weight_grad_f32_kernel`: it lands G and X as
// they lie, as the bf16 form does, and makes the K-major operands on chip in
// the pass that splits them (G^T as the A operand from registers, X^T as
// K-major hi and lo tiles of each warpgroup's own); see its comment.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dk {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool is_f32 = std::is_same<T, float>::value;

// x rounded to nearest TF32 (10 explicit mantissa bits; ties away from zero),
// as an fp32 bit pattern whose low 13 bits are zero.
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The column of k-step position m (0..7) of a K-major TF32 operand whose A
// fragments come from registers: a thread with lane % 4 = t holds columns t
// and t + 4, which this order makes the neighbouring m = 2t and 2t + 1 (one
// float2 read). Column c holds m = 2 (c % 4) + c / 4.
__host__ __device__ __forceinline__ int tf32_key_slot(int m) { return (m >> 1) | ((m & 1) << 2); }

// x as hi = tf32(x) and lo = tf32(x - hi), the two TF32 parts of 3xTF32.
__device__ __forceinline__ float2 tf32_split(float x) {
  const float hi = tf32_rna(x);
  return make_float2(hi, tf32_rna(x - hi));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_erf_grad(float x) {
  float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  return cdf + x * __expf(-0.5f * x * x) * 0.3989422804014327f;
}

// The second GELU, of the fused-MLP forward alone (fused_mlp.cu), where the
// GELU runs between two products of one warpgroup and its instruction count
// shows: x Phi(x) with the rational erf of Abramowitz and Stegun 7.1.26
// (absolute error 1.5e-7), the TPU kernel's own `_erf`, on the approximate
// reciprocal and exp2 of the special-function units (a few ulp more). The
// epilogue above, and so the MLP backward's recompute of the hidden, uses
// gelu_erf: the two differ by far less than h's bf16 rounding.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// q = (1 - erf(|x| / sqrt 2)) / 2 = a poly(t) exp(-x^2 / 2) with t = 1 / (1 +
// p |x| / sqrt 2) (the coefficients halved); gelu = x (1 - q) for x >= 0, x q
// below.
__device__ __forceinline__ float gelu_rational(float x) {
  const float z = fabsf(x) * 0.70710678118654752f;
  const float t = rcp_approx(fmaf(0.3275911f, z, 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 0.5307027145f, -0.7265760135f), 0.7107068705f),
                       -0.142248368f),
               0.127414796f);
  const float q = poly * ex2_approx(x * x * -0.72134752044448170f);
  return x * (x >= 0.f ? 1.0f - q : q);
}

// ---------------------------------------------------------------------------
// Hopper primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte-aligned address at or after `raw` in shared memory (the
// 128-byte swizzle is a function of the address bits, so its tiles start on
// 1024-byte boundaries).
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barriers (0 is __syncthreads): `threads` of the CTA meet at `id`;
// bar.arrive counts this thread's warp without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The registers of each thread of this warpgroup lowered or raised to R
// (a multiple of 8): a warp-specialised kernel moves registers from its
// producer to its consumers. The kernel's launch bounds fix the registers
// at entry, and the CTA's total may not grow.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// One 2-D TMA box of `map` at (c0 = column, c1 = row) into `dst`; the bytes
// are counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins the registers of an accumulator here, so that the compiler moves no
// read of them above the wgmma wait that precedes this call.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a tile in the 128-byte swizzle: rows of 64 bf16 (128
// bytes), groups of 8 rows 1024 bytes apart. Both byte offsets are 1024:
// for a K-major operand the leading one is unused, for an MN-major one
// (64 columns wide, one swizzle atom) only the stride between 8-row groups
// along K is read. Adding b >> 4 to the descriptor moves its start b bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFF) >> 4) | (64ull << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma.mma_async with bf16 operands and fp32 accumulators; acc = 0 starts
// the sum at zero.
// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B MN-major in shared memory
// (both transposed: A's rows and B's columns contiguous, 16 k-rows of 128
// bytes a k-step).
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (bf16 pairs),
// B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 64] (+)= A[64 x 8] B[8 x 64] with TF32 operands read from fp32 bit
// patterns, A and B K-major in shared memory (TF32 takes no transpose).
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] += A[64 x 8] B[8 x 64], A from registers (one TF32 value each:
// of the warp's 16 rows, a[0] at (lane / 4, lane % 4), a[1] 8 rows down,
// a[2] and a[3] 4 columns right of those), B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// D[64 x 8G] (+)= A[64 x 8] B[8G x 8]^T with TF32 operands, A and B K-major
// in shared memory: the n = 8G forms of wgmma_ss_tf32 (G = 1..8), for a
// product over the first G groups of 8 rows of B. d holds the first 4G
// accumulators of the n = 64 form's layout; the rest are left as they are.
template <int G>
__device__ __forceinline__ void wgmma_ss_tf32_n(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  static_assert(G == 8, "n = 8G for G = 1..8");
  wgmma_ss_tf32(d, da, db, acc);
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32_n<1>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32_n<2>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32_n<3>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32_n<4>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32_n<5>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32_n<6>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss_tf32_n<7>(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
      "}, %28, %29, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(da), "l"(db), "r"(acc));
}

// The operand type of a product: bf16 (wgmma k = 16) or fp32 read as TF32
// (k = 8). A 128-byte swizzle row holds BK elements of either, and a k-step
// is 32 bytes of it, so a K-major tile's descriptor moves by 2 (32 >> 4) a
// step in both; `mma` is one k-step with A and B K-major in shared memory.
template <typename T>
struct Operand;

template <>
struct Operand<bf16> {
  static constexpr int BK = 64, KSTEP = 16;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    wgmma_ss(d, da, db, acc);
  }
};

// fp32: one k-step is three TF32 products of the hi and lo parts
// (linear_f32_kernel, weight_grad_f32_kernel).
template <>
struct Operand<float> {
  static constexpr int BK = 32, KSTEP = 8;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

// v as a product operand of type T: bf16 rounded to nearest, or fp32 as it
// is (the fp32 products split their operands into TF32 hi and lo parts).
template <typename T>
__device__ __forceinline__ T to_lp(float v);
template <>
__device__ __forceinline__ bf16 to_lp<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float to_lp<float>(float v) { return v; }

// Writes of the generic proxy to shared memory, made visible to the async
// proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// The fp32 weight operand, split once per call
// ---------------------------------------------------------------------------

// Up to four weights [R, C] (C % 8 == 0, 16-byte aligned) split in one
// launch: out[0] = hi = TF32(w) rounded to nearest, out[1] = lo = TF32(w -
// hi), each [R, C] with the 8 columns of every k-step in tf32_key_slot
// order: the K-major B operand of linear_f32_kernel (`LinearT<float>::w`).
struct Tf32Splits {
  const float* w[4];
  float* out[4];     // [2][R][C]
  long long n[4];    // R * C
  int count;
};

// One thread takes the 8 values of one k-step of one row of weight
// blockIdx.y (two float4 in, two of hi and two of lo out).
__global__ void split_weights_tf32_kernel(const Tf32Splits s) {
  const int j = blockIdx.y;
  const long long steps = s.n[j] / 8;
  const float4* w = reinterpret_cast<const float4*>(s.w[j]);
  float4* hi = reinterpret_cast<float4*>(s.out[j]);
  float4* lo = hi + s.n[j] / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < steps;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 a = w[2 * i], b = w[2 * i + 1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float h[8], l[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float2 x = tf32_split(v[m]);
      const int c = tf32_key_slot(m);
      h[c] = x.x;
      l[c] = x.y;
    }
    hi[2 * i] = make_float4(h[0], h[1], h[2], h[3]);
    hi[2 * i + 1] = make_float4(h[4], h[5], h[6], h[7]);
    lo[2 * i] = make_float4(l[0], l[1], l[2], l[3]);
    lo[2 * i + 1] = make_float4(l[4], l[5], l[6], l[7]);
  }
}

// Splits `count` (1 to 4) weights w[j] of n[j] fp32 values (a multiple of 8,
// 16-byte aligned) into out[j] (2 n[j] values: hi, then lo) in one launch on
// `st`; cudaErrorInvalidValue, without a launch, for anything else.
inline cudaError_t split_weights_tf32(int count, const float* const* w, float* const* out,
                                      const long long* n, cudaStream_t st) {
  if (count < 1 || count > 4) return cudaErrorInvalidValue;
  Tf32Splits s = {};
  s.count = count;
  long long most = 0;
  for (int j = 0; j < count; ++j) {
    if (n[j] < 8 || n[j] % 8 || ((uintptr_t)w[j] | (uintptr_t)out[j]) % 16)
      return cudaErrorInvalidValue;
    s.w[j] = w[j];
    s.out[j] = out[j];
    s.n[j] = n[j];
    most = n[j] > most ? n[j] : most;
  }
  const long long blocks = (most / 8 + 255) / 256;
  split_weights_tf32_kernel<<<dim3((unsigned)(blocks < 1024 ? blocks : 1024), count), 256, 0,
                              st>>>(s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The linear product and its epilogue
// ---------------------------------------------------------------------------

// C = a w^T with a [M, K] row-major and w [N, K] (nn.Linear), operands of
// type T (bf16, or fp32 on TF32), then, in this order, on v = C[m, n]
// (outputs [M, N] row-major):
template <typename T>
struct LinearT {
  int M, N, K;
  const T* a;
  const T* w;               // bf16: w [N, K]; fp32: w split into TF32 parts,
                            // [2][N][K], hi then lo, each k-step's 8 columns in
                            // tf32_key_slot order (split_weights_tf32)
  const float* bias;        // v += bias[n]
  int scale_cols;           // v *= col_scale for n < scale_cols
  float col_scale;
  const float* mul;         // v *= mul[m, n] (fp32, C's layout; not with a residual)
  float* col_part;          // with mul: col_part[m / 128, n] = the 128-row tile's
                            // column sums of v here (fp32, rows past M left out)
  int gelu;                 // v = gelu(v); gelu'(v) -> act_grad (fp32)
  float* act_grad;
  T* pre_lp;                // pre_lp = v (before the residual), as a product operand
  const float* res_f32;     // v = res + res_scale[m / rows_per_sample] * v
  const bf16* res_bf16;
  const float* res_scale;
  int rows_per_sample;
  float* out_f32;           // out = v
  T* out_lp;                // out = v, as a product operand (to_lp)
};

using Linear = LinearT<bf16>;

template <typename T>
inline LinearT<T> linear_of(const T* a, const T* w, int M, int N, int K) {
  LinearT<T> p = {};
  p.M = M; p.N = N; p.K = K;
  p.a = a; p.w = w;
  p.col_scale = 1.0f;
  p.rows_per_sample = 1;
  return p;
}

namespace sm90 {
constexpr int BM = 128, BN = 64, STAGES = 4, CONSUMER_WARPS = 8, EPI_J = 4;
constexpr int ROW_BYTES = 128;   // a k-block of one operand row: Operand<T>::BK elements
constexpr int THREADS = (CONSUMER_WARPS + 1) * 32;
constexpr int CTAS_PER_SM = 2;
// the ring, the barriers, and the column sums of one tile per consumer warp
constexpr size_t SMEM_BYTES = (size_t)STAGES * (BM + BN) * ROW_BYTES +
                              2 * STAGES * sizeof(uint64_t) + CONSUMER_WARPS * BN * sizeof(float) +
                              1024;
}  // namespace sm90

// Row tiles of a linear product of M rows (the rows of `Linear::col_part`).
inline int linear_row_tiles(int M) { return (M + sm90::BM - 1) / sm90::BM; }

// Barrier 1 among the consumer warps alone (the producer warp runs ahead).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(sm90::CONSUMER_WARPS * 32) : "memory");
}

// Two neighbouring outputs as one float2 / bf16x2 store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// ... as product operands (to_lp): bf16 as above, fp32 as it is
__device__ __forceinline__ void store2_lp(bf16* p, float a, float b) { store2(p, a, b); }
__device__ __forceinline__ void store2_lp(float* p, float a, float b) { store2(p, a, b); }

// The epilogue of columns n, n + 1 of row m, given their bias b, residual r,
// multiplier mu (read only with MUL) and the row's residual scale rs (each
// read by the caller). Returns v after the multiplier.
template <typename T, bool MUL>
__device__ __forceinline__ float2 linear_epilogue(const LinearT<T>& p, int m, int n, float v0,
                                                  float v1, float2 b, float2 r, float2 mu,
                                                  float rs) {
  const long long c = (long long)m * p.N + n;
  v0 += b.x;
  v1 += b.y;
  if (n < p.scale_cols) {
    v0 *= p.col_scale;
    v1 *= p.col_scale;
  }
  if (MUL) {
    v0 *= mu.x;
    v1 *= mu.y;
  }
  const float2 after_mul = make_float2(v0, v1);
  if (p.gelu) {
    if (p.act_grad) store2(p.act_grad + c, gelu_erf_grad(v0), gelu_erf_grad(v1));
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  }
  if (p.pre_lp) store2_lp(p.pre_lp + c, v0, v1);
  if (!MUL && p.res_scale) {
    v0 = r.x + rs * v0;
    v1 = r.y + rs * v1;
  }
  if (p.out_f32) store2(p.out_f32 + c, v0, v1);
  if (p.out_lp) store2_lp(p.out_lp + c, v0, v1);
  return after_mul;
}

template <typename T>
__device__ __forceinline__ float2 load_residual(const LinearT<T>& p, long long c) {
  if (p.res_f32) return __ldg(reinterpret_cast<const float2*>(p.res_f32 + c));
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p.res_bf16 + c)));
}

// The epilogue of one 64-column block (n0, n0 + 64) of the 128-row output
// tile at m0, from a consumer thread's accumulators of its wgmma rows quad
// and quad + 8 (quad = lane / 4), which hold the output rows `row` and
// row + 8, columns n0 + 2 (lane % 4) + 8 j. EPI_J 8-column blocks at a time:
// first every input of the group (bias, residual, multiplier), then the
// stores, so that the loads overlap instead of each waiting behind the
// stores before it. With `col_part`, every consumer thread takes part (two
// barriers of the consumer warps).
template <typename T, bool MUL>
__device__ __forceinline__ void store_linear_tile(const LinearT<T>& p, const float (&acc)[32],
                                                  int m0, int n0, int row, float* cs) {
  using namespace sm90;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = n0 + 2 * (lane % 4);
  const bool row_ok[2] = {row < p.M, row + 8 < p.M};
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (p.res_scale && row_ok[h]) rs[h] = __ldg(p.res_scale + (row + 8 * h) / p.rows_per_sample);
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
    float2 b[EPI_J], r[MUL ? 1 : EPI_J][2], mu[MUL ? EPI_J : 1][2];
#pragma unroll
    for (int jj = 0; jj < EPI_J; ++jj) {
      const int n = col + 8 * (j0 + jj);   // N % 8 == 0: n, n + 1 both in or both out
      b[jj] = p.bias && n < p.N ? __ldg(reinterpret_cast<const float2*>(p.bias + n))
                                : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (MUL)   // in place of the residual, which a MUL launch never has
          mu[MUL ? jj : 0][h] =
              n < p.N && row_ok[h]
                  ? __ldg(reinterpret_cast<const float2*>(p.mul + (long long)(row + 8 * h) * p.N + n))
                  : make_float2(1.f, 1.f);
        else
          r[MUL ? 0 : jj][h] = p.res_scale && n < p.N && row_ok[h]
                                   ? load_residual(p, (long long)(row + 8 * h) * p.N + n)
                                   : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int jj = 0; jj < EPI_J; ++jj) {
      const int n = col + 8 * (j0 + jj), j = j0 + jj;
      if (n >= p.N) continue;   // the same for the whole warp (N % 8 == 0)
      float2 csum = make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row_ok[h]) {
          const float2 v = linear_epilogue<T, MUL>(
              p, row + 8 * h, n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], b[jj],
              MUL ? make_float2(0.f, 0.f) : r[MUL ? 0 : jj][h],
              MUL ? mu[MUL ? jj : 0][h] : make_float2(1.f, 1.f), rs[h]);
          csum.x += v.x;
          csum.y += v.y;
        }
      if (MUL && p.col_part) {
        // the warp's 16 rows: lanes with the same lane % 4 hold the same columns
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          csum.x += __shfl_xor_sync(0xffffffffu, csum.x, o);
          csum.y += __shfl_xor_sync(0xffffffffu, csum.y, o);
        }
        if (lane < 4) {
          cs[warp * BN + 8 * j + 2 * lane] = csum.x;
          cs[warp * BN + 8 * j + 2 * lane + 1] = csum.y;
        }
      }
    }
  }
  if (MUL && p.col_part) {
    // the tile's 128 rows: the consumer warps' sums in warp order
    consumer_sync();
    if (threadIdx.x < BN && n0 + threadIdx.x < p.N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMER_WARPS; ++w) sum += cs[w * BN + threadIdx.x];
      p.col_part[(long long)(m0 / BM) * p.N + n0 + threadIdx.x] = sum;
    }
    consumer_sync();
  }
}

// MUL: the epilogue reads `mul` and may write `col_part` (an instantiation of
// its own, so that the forward's products keep the registers of the one
// without it). bf16 operands; the fp32 form is linear_f32_kernel below.
template <typename T, bool MUL>
static __global__ void __launch_bounds__(sm90::THREADS, sm90::CTAS_PER_SM)
linear_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
              const LinearT<T> p) {
  static_assert(!is_f32<T>, "the bf16 linear product");
  using namespace sm90;
  constexpr int BK = Operand<T>::BK;
  extern __shared__ unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(align1024(smem_raw));         // [STAGES][BM][BK]
  T* Bs = As + STAGES * BM * BK;                               // [STAGES][BN][BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * BN * BK);
  uint64_t* empty = full + STAGES;
  float* cs = reinterpret_cast<float*>(empty + STAGES);     // [CONSUMER_WARPS][BN]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = (p.M + BM - 1) / BM * n_tiles;
  const int k_blocks = (p.K + BK - 1) / BK;

  if (warp == CONSUMER_WARPS) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], (BM + BN) * BK * sizeof(T));
          tma_load_2d(As + stage * BM * BK, &tm_a, kb * BK, m0, &full[stage]);
          tma_load_2d(Bs + stage * BN * BK, &tm_w, kb * BK, n0, &full[stage]);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wg = warp / 4;
  float acc[BN / 2];
  int stage = 0, held = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
    for (int kb = 0; kb < k_blocks; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint64_t da = sw128_desc(As + stage * BM * BK + wg * 64 * BK);
      const uint64_t db = sw128_desc(Bs + stage * BN * BK);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / Operand<T>::KSTEP; ++k)
        Operand<T>::mma(acc, da + 2 * k, db + 2 * k, kb > 0 || k > 0);
      wgmma_commit();
      // the k-block before this one is done: its stage goes back to the producer
      wgmma_wait<1>();
      if (kb > 0 && lane == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[held]);
    store_linear_tile<T, MUL>(p, acc, m0, n0, m0 + wg * 64 + (warp % 4) * 16 + lane / 4, cs);
  }
}

// ---------------------------------------------------------------------------
// The fp32 linear product: the weight split once per call, A in registers
// ---------------------------------------------------------------------------
//
// linear_kernel's persistent tiles, producer and epilogue, with fp32
// operands in 3xTF32: a k-step of 8 is a_lo b_hi + a_hi b_lo + a_hi b_hi, the
// small terms first.
//  * B is the weight split once per call (`LinearT<float>::w`: hi, then lo,
//    each k-step's columns in tf32_key_slot order), so the CTAs of the
//    M / 128 row tiles do not split the same tiles again. TMA lands A
//    (128 x 32) and W's hi and lo boxes (TN x 32) in each stage.
//  * A is the operand from registers. A thread reads its fragments of a
//    k-step from the landed, swizzled A box as two float2: k = 2t and 2t + 1
//    (t = lane % 4; columns t and t + 4 of the k-step, the order of B's
//    columns) of its rows r and r + 8. It splits them into TF32 hi and lo in
//    registers. The warp's 16 wgmma rows hold its tile rows in the order 0,
//    2, 4, 6, 1, 3, 5, 7 (and those + 8; row q holds tf32_key_slot's m =
//    2 (q % 4) + q / 4): the four rows of a half-warp then lie in swizzle
//    phases two apart and its 16 float2 fall on the 32 banks once. The
//    epilogue stores each row where it belongs.
//  * The consumers write nothing to shared memory, so there is no proxy
//    fence, and the two warpgroups share nothing but the ring: no barrier
//    across them. A k-step's three products are one wgmma group; each
//    warpgroup keeps one group in flight while it splits the next k-step
//    into the other of two register sets (its float2 read one k-step
//    ahead), and gives a stage back to the producer once the last group
//    that reads its B is done (one k-step into the next k-block).
// Two tile plans (TN output columns, STAGES stages of A, B_hi and B_lo,
// (BM + 2 TN) x 32 fp32 each, the barriers and the column sums): TN = 64
// at three stages, 101,424 bytes, two CTAs an SM, so that one CTA's
// epilogue runs under the other's products; TN = 128 (two wgmma blocks of
// 64 on the same A fragments) at four stages, one CTA an SM, which reads
// a third less A and B from L2 for the same work. The launch takes TN = 128
// where N is a multiple of 128 and K at least 384 (`linear_f32_wide`): on
// an H100 it ran the block's products at D = 384 faster, TN = 64 every
// product at D = 192 (PERF.md has both plans' times).
namespace lf32 {
constexpr int BK = Operand<float>::BK;
__host__ __device__ constexpr int stages(int tn) { return tn == 64 ? 3 : 4; }
__host__ __device__ constexpr int ctas_per_sm(int tn) { return tn == 64 ? 2 : 1; }
__host__ __device__ constexpr size_t smem_bytes(int tn) {
  return (size_t)stages(tn) * (sm90::BM + 2 * tn) * BK * sizeof(float) +
         2 * stages(tn) * sizeof(uint64_t) + sm90::CONSUMER_WARPS * sm90::BN * sizeof(float) + 1024;
}
}  // namespace lf32

inline bool linear_f32_wide(int N, int K) { return N % 128 == 0 && K >= 384; }

template <bool MUL, int TN>
static __global__ void __launch_bounds__(sm90::THREADS, lf32::ctas_per_sm(TN))
linear_f32_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_hi,
                  const __grid_constant__ CUtensorMap tm_lo, const LinearT<float> p) {
  using namespace sm90;
  using lf32::BK;
  constexpr int NB = TN / 64, STAGES = lf32::stages(TN);
  extern __shared__ unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(align1024(smem_raw));   // [STAGES][BM][BK]
  float* Bs = As + STAGES * BM * BK;                            // [STAGES][hi, lo][TN][BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * 2 * TN * BK);
  uint64_t* empty = full + STAGES;
  float* cs = reinterpret_cast<float*>(empty + STAGES);       // [CONSUMER_WARPS][64]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (p.N + TN - 1) / TN;
  const int tiles = (p.M + BM - 1) / BM * n_tiles;
  const int k_blocks = (p.K + BK - 1) / BK;

  if (warp == CONSUMER_WARPS) {
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * BM, n0 = t % n_tiles * TN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], (BM + 2 * TN) * BK * sizeof(float));
          tma_load_2d(As + stage * BM * BK, &tm_a, kb * BK, m0, &full[stage]);
          tma_load_2d(Bs + 2 * stage * TN * BK, &tm_hi, kb * BK, n0, &full[stage]);
          tma_load_2d(Bs + (2 * stage + 1) * TN * BK, &tm_lo, kb * BK, n0, &full[stage]);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile; this
  // thread's wgmma rows quad and quad + 8 of its warp hold tile rows r, r + 8
  const int wg = warp / 4, quad = lane / 4, t4 = lane % 4;
  const int r = wg * 64 + (warp % 4) * 16 + 2 * (quad & 3) + (quad >> 2);
  // byte offset in an A box of this thread's float2 of k-step 0 at row r
  // (k = 2 t4): k-step s is at a_off ^ (s << 5) (16-byte chunk 2 s + t4 / 2,
  // swizzled), row r + 8 1024 bytes on (the same swizzle phase)
  const int a_off = r * 128 + (((t4 >> 1) ^ (r & 7)) << 4) + (t4 & 1) * 8;
  float acc[NB][32];
  uint32_t a_hi[2][4], a_lo[2][4];   // two register sets of A fragments
  int stage = 0, held = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / n_tiles * BM, n0 = t % n_tiles * TN;
    for (int kb = 0; kb < k_blocks; ++kb) {
      mbar_wait(&full[stage], phase);
      const unsigned char* a_box = reinterpret_cast<const unsigned char*>(As + stage * BM * BK);
      float2 v[2][2];   // the A values of this k-step and of the next, as read
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[0][h] = *reinterpret_cast<const float2*>(a_box + a_off + 1024 * h);
      const uint64_t d_hi = sw128_desc(Bs + 2 * stage * TN * BK);
      const uint64_t d_lo = sw128_desc(Bs + (2 * stage + 1) * TN * BK);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (s < 3)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            v[(s + 1) & 1][h] =
                *reinterpret_cast<const float2*>(a_box + (a_off ^ ((s + 1) << 5)) + 1024 * h);
        // the group two k-steps back, the last reader of this register set, is done
        wgmma_wait<1>();
        if (s == 1) {
          // ... and so is every group of the k-block before: its stage goes back
          if (kb > 0 && lane == 0) mbar_arrive(&empty[held]);
          held = stage;
        }
        const int f = s & 1;
        // the A fragments: rows quad, quad + 8 of column t4, then of column t4 + 4
        const float x[4] = {v[f][0].x, v[f][1].x, v[f][0].y, v[f][1].y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 hl = tf32_split(x[i]);
          a_hi[f][i] = __float_as_uint(hl.x);
          a_lo[f][i] = __float_as_uint(hl.y);
        }
        wgmma_fence();
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          // block nb of B: 64 rows of 128 bytes, 8192 bytes on
          const uint64_t hi = d_hi + 2 * s + 512 * nb, lo = d_lo + 2 * s + 512 * nb;
          wgmma_rs_tf32(acc[nb], a_lo[f], hi, kb > 0 || s > 0);
          wgmma_rs_tf32(acc[nb], a_hi[f], lo, 1);
          wgmma_rs_tf32(acc[nb], a_hi[f], hi, 1);
        }
        wgmma_commit();
      }
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
    if (lane == 0) mbar_arrive(&empty[held]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      store_linear_tile<float, MUL>(p, acc[nb], m0, n0 + 64 * nb, m0 + r, cs);
  }
}

// ---------------------------------------------------------------------------
// The weight gradient: partials of G^T X over row ranges
// ---------------------------------------------------------------------------

// partial[s][o, i] = sum over the rows m of range s of g[m, o] x[m, i], with g
// [M, O] and x [M, I] row-major (the output cotangent and the input of an
// nn.Linear, whose weight gradient is the sum of the partials over s). Range
// s covers k-blocks [s kb_per_split, (s + 1) kb_per_split) of 64 rows.
struct WeightGrad {
  int M, O, I;
  int splits, kb_per_split;
  float* partial;           // [splits][O][I] fp32
};

// A (o, i) output tile of 128 x 64 over one row range is one work item.
// Each stage holds G's rows of the k-block as two [64 m][64 o] boxes (one per
// consumer warpgroup) and X's as one [64 m][64 i] box, each in the 128-byte
// swizzle; a box is MN-major for wgmma (its 64 columns are the product's o or
// i), so a k-step of 16 rows is 2048 bytes on. Where the tile's upper 64
// columns of o lie past O (O = 192 is three halves), that half is not loaded
// and its warpgroup only keeps the ring in step. bf16 operands; the fp32
// form is weight_grad_f32_kernel below.
template <typename T>
static __global__ void __launch_bounds__(sm90::THREADS, sm90::CTAS_PER_SM)
weight_grad_kernel(const __grid_constant__ CUtensorMap tm_g, const __grid_constant__ CUtensorMap tm_x,
                   const WeightGrad p) {
  using namespace sm90;
  constexpr int BK = Operand<T>::BK;
  extern __shared__ unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(align1024(smem_raw));         // [STAGES][2][BK][64]
  T* Bs = As + STAGES * BM * BK;                               // [STAGES][BK][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + STAGES * BN * BK);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int i_tiles = (p.I + BN - 1) / BN;
  const int tiles = (p.O + BM - 1) / BM * i_tiles;
  const int items = tiles * p.splits;
  const int k_total = (p.M + BK - 1) / BK;

  if (warp == CONSUMER_WARPS) {
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int s = t / tiles, tile = t % tiles;
        const int o0 = tile / i_tiles * BM, i0 = tile % i_tiles * BN;
        const int halves = o0 + 64 < p.O ? 2 : 1;
        const int kb0 = s * p.kb_per_split, kb1 = min(k_total, kb0 + p.kb_per_split);
        for (int kb = kb0; kb < kb1; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], (halves * 64 + BN) * BK * sizeof(T));
          for (int h = 0; h < halves; ++h)
            tma_load_2d(As + stage * BM * BK + h * 64 * BK, &tm_g, o0 + 64 * h, kb * BK,
                        &full[stage]);
          tma_load_2d(Bs + stage * BN * BK, &tm_x, i0, kb * BK, &full[stage]);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns columns [o0 + 64 wg, o0 + 64 wg + 64) of o
  const int wg = warp / 4;
  float acc[BN / 2];
  int stage = 0, held = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int s = t / tiles, tile = t % tiles;
    const int o0 = tile / i_tiles * BM, i0 = tile % i_tiles * BN;
    const bool active = o0 + 64 * wg < p.O;
    const int kb0 = s * p.kb_per_split, kb1 = min(k_total, kb0 + p.kb_per_split);
    for (int kb = kb0; kb < kb1; ++kb) {
      mbar_wait(&full[stage], phase);
      if (active) {
        const uint64_t da = sw128_desc(As + (stage * BM + wg * 64) * BK);
        const uint64_t db = sw128_desc(Bs + stage * BN * BK);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / Operand<T>::KSTEP; ++k)
          wgmma_ss_tt(acc, da + 128 * k, db + 128 * k, kb > kb0 || k > 0);
        wgmma_commit();
        // the k-block before this one is done: its stage goes back to the producer
        wgmma_wait<1>();
      }
      if (kb > kb0 && lane == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    if (active) {
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (lane == 0) mbar_arrive(&empty[held]);
    if (!active) continue;

    const int row = o0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int col = i0 + 2 * (lane % 4);
    float* out = p.partial + (long long)s * p.O * p.I;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = col + 8 * j;   // I % 8 == 0: n, n + 1 both in or both out
      if (n >= p.I) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row + 8 * h < p.O)
          store2(out + (long long)(row + 8 * h) * p.I + n, acc[4 * j + 2 * h],
                 acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The fp32 weight gradient: G and X as they lie, the K-major operands made on
// chip
// ---------------------------------------------------------------------------
//
// The same work items, row ranges and partials as weight_grad_kernel, with
// fp32 operands in 3xTF32. TF32 wgmma reads its shared-memory operands
// K-major only, and the depth m of a weight gradient is the strided
// dimension of G [M, O] and X [M, I]; the kernel makes the K-major TF32 hi
// and lo operands on chip, in the one pass that touches every landed
// element, so nothing is transposed through device memory:
//  * TMA lands G and X as they lie, in [32 m][32 columns] boxes (128 bytes a
//    row, the 128-byte swizzle): four of G (the tile's 128 o) and two of X
//    (its 64 i) a stage, 24 KB. Boxes that start past O or I are not loaded;
//    only outputs that are never stored read them.
//  * G^T is the A operand from registers. Each thread reads its fragments of
//    its warp's 16 o straight from the G boxes, as float2 (two neighbouring
//    o at one m), and splits them into TF32 hi and lo in registers. For that
//    the warp's 16 wgmma rows hold its o in the order 0, 2, ..., 14, 1, 3,
//    ..., 15 (row r holds o = 2 (r % 8) + r / 8; the epilogue stores them
//    there), and the 8 columns of a k-step hold its 8 rows m in
//    tf32_key_slot order (column c holds m = 2 (c % 4) + c / 4): the four
//    lanes of a quad then read rows m in four different swizzle phases, and
//    a half-warp's 16 float2 fall on the 32 banks once.
//  * X^T is the B operand: K-major [64 i][32 m] hi and lo tiles in the
//    128-byte swizzle, the k-step's columns in the same order. Each
//    warpgroup writes its own from the X boxes: a lane reads its column i at
//    the four m of one 16-byte chunk of the k-step (a warp reads one 128-byte
//    row: no conflict) and writes them as one float4 of hi and one of lo (a
//    quarter-warp writes its 8 rows of i into 8 different chunks).
//  * A warpgroup holds a landed stage in registers and in its X^T tiles
//    before its products start, and releases it to the producer then. The
//    two warpgroups share nothing but the ring; a k-block costs each two
//    named barriers of its own 128 threads (its X^T is free: its products of
//    the k-block before are done; its X^T is written), besides the ring's
//    full and empty barriers. Each thread's products of a k-block are
//    waited for before its next loads (its A fragments are registers).
// Shared memory: a ring of 3 stages of 24 KB, two 16 KB X^T tiles, the
// barriers and the alignment, 107,568 bytes a CTA: two CTAs an SM, as the
// bf16 form.
namespace wg32 {
constexpr int BK = Operand<float>::BK;                      // rows m of a k-block
constexpr int STAGES = 3;
constexpr int BOX = 32 * BK;                                // fp32 elements of one [32 m][32] box
constexpr int G_BOXES = sm90::BM / 32, X_BOXES = sm90::BN / 32;
constexpr int STAGE_ELEMS = (G_BOXES + X_BOXES) * BOX;      // 24 KB
constexpr int XT_ELEMS = 2 * sm90::BN * BK;                 // a warpgroup's X^T, hi then lo: 16 KB
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE_ELEMS * sizeof(float) +
                              2 * XT_ELEMS * sizeof(float) + 2 * STAGES * sizeof(uint64_t) + 1024;
}  // namespace wg32

// Byte offset of (row r, column c) in a [32][32] fp32 box in the 128-byte
// swizzle (16-byte chunks XOR row % 8, as TMA lays it).
__device__ __forceinline__ int box32_offset(int r, int c) {
  return r * 128 + ((((c >> 2) ^ (r & 7))) << 4) + (c & 3) * 4;
}

// Named barrier 2 + wg among the 128 threads of consumer warpgroup wg.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
}

// T is float (a template, so that only the sources that launch it build it).
template <typename T>
static __global__ void __launch_bounds__(sm90::THREADS, sm90::CTAS_PER_SM)
weight_grad_f32_kernel(const __grid_constant__ CUtensorMap tm_g,
                       const __grid_constant__ CUtensorMap tm_x, const WeightGrad p) {
  static_assert(is_f32<T>, "the fp32 weight gradient");
  using namespace sm90;
  using wg32::BK;
  using wg32::BOX;
  extern __shared__ unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(align1024(smem_raw));   // [STAGES][4 G, 2 X boxes]
  float* xt = ring + wg32::STAGES * wg32::STAGE_ELEMS;          // [2 warpgroups][hi, lo][BN][BK]
  uint64_t* full = reinterpret_cast<uint64_t*>(xt + 2 * wg32::XT_ELEMS);
  uint64_t* empty = full + wg32::STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < wg32::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int i_tiles = (p.I + BN - 1) / BN;
  const int tiles = (p.O + BM - 1) / BM * i_tiles;
  const int items = tiles * p.splits;
  const int k_total = (p.M + BK - 1) / BK;

  if (warp == CONSUMER_WARPS) {
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int s = t / tiles, tile = t % tiles;
        const int o0 = tile / i_tiles * BM, i0 = tile % i_tiles * BN;
        const int gb = min(wg32::G_BOXES, (p.O - o0 + 31) / 32);
        const int xb = min(wg32::X_BOXES, (p.I - i0 + 31) / 32);
        const int kb0 = s * p.kb_per_split, kb1 = min(k_total, kb0 + p.kb_per_split);
        for (int kb = kb0; kb < kb1; ++kb) {
          float* st = ring + stage * wg32::STAGE_ELEMS;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], (gb + xb) * BOX * sizeof(float));
          for (int b = 0; b < gb; ++b)
            tma_load_2d(st + b * BOX, &tm_g, o0 + 32 * b, kb * BK, &full[stage]);
          for (int b = 0; b < xb; ++b)
            tma_load_2d(st + (wg32::G_BOXES + b) * BOX, &tm_x, i0 + 32 * b, kb * BK,
                        &full[stage]);
          if (++stage == wg32::STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns o0 + 64 wg + [0, 64), its warp wq 16 of them
  const int wg = warp / 4, wq = warp % 4, quad = lane / 4, c = lane % 4;
  unsigned char* xt_hi = reinterpret_cast<unsigned char*>(xt + wg * wg32::XT_ELEMS);
  unsigned char* xt_lo = xt_hi + BN * BK * sizeof(float);
  const uint64_t d_hi = sw128_desc(xt_hi), d_lo = sw128_desc(xt_lo);
  float acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < items; t += gridDim.x) {
    const int s = t / tiles, tile = t % tiles;
    const int o0 = tile / i_tiles * BM, i0 = tile % i_tiles * BN;
    const bool active = o0 + 64 * wg < p.O;
    const int kb0 = s * p.kb_per_split, kb1 = min(k_total, kb0 + p.kb_per_split);
    for (int kb = kb0; kb < kb1; ++kb) {
      mbar_wait(&full[stage], phase);
      uint32_t a_hi[4][4], a_lo[4][4];
      if (active) {
        const unsigned char* st =
            reinterpret_cast<const unsigned char*>(ring + stage * wg32::STAGE_ELEMS);
        // G^T fragments: this warp's o pair (2 quad, + 1) at m = 8 k + 2 c
        // (column c of k-step k) and m = 8 k + 2 c + 1 (column c + 4)
        const unsigned char* gbox = st + (2 * wg + wq / 2) * BOX * sizeof(float);
        const int go = 16 * (wq % 2) + 2 * quad;
        float2 g[4][2];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            g[k][e] = *reinterpret_cast<const float2*>(gbox + box32_offset(8 * k + 2 * c + e, go));
        // X^T: four (i, chunk) tasks of this lane, each the four m of one
        // 16-byte chunk of a k-step (columns 4 h + u hold m = 8 k + 2 u + h)
        float x[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int task = 4 * wq + n, b = task >> 3, k = (task >> 1) & 3, h = task & 1;
          const unsigned char* xbox = st + (wg32::G_BOXES + b) * BOX * sizeof(float);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            x[n][u] = *reinterpret_cast<const float*>(xbox + box32_offset(8 * k + 2 * u + h, lane));
        }
        warpgroup_sync(wg);   // this warpgroup's products of the k-block before are done
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int task = 4 * wq + n, b = task >> 3, k = (task >> 1) & 3, h = task & 1;
          const int i = 32 * b + lane, chunk = 2 * k + h;
          const int off = i * 128 + ((chunk ^ (i & 7)) << 4);
          float hi[4], lo[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            hi[u] = tf32_rna(x[n][u]);
            lo[u] = tf32_rna(x[n][u] - hi[u]);
          }
          *reinterpret_cast<float4*>(xt_hi + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<float4*>(xt_lo + off) = make_float4(lo[0], lo[1], lo[2], lo[3]);
        }
        // the A fragments: (row quad, column c), (quad + 8, c), (quad, c + 4), (quad + 8, c + 4)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float v[4] = {g[k][0].x, g[k][0].y, g[k][1].x, g[k][1].y};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float hv = tf32_rna(v[r]);
            a_hi[k][r] = __float_as_uint(hv);
            a_lo[k][r] = __float_as_uint(tf32_rna(v[r] - hv));
          }
        }
      }
      // the stage is in registers and in X^T: it goes back to the producer
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (active) {
        fence_proxy_async();
        warpgroup_sync(wg);   // X^T is written
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_rs_tf32(acc, a_lo[k], d_hi + 2 * k, kb > kb0 || k > 0);
          wgmma_rs_tf32(acc, a_hi[k], d_lo + 2 * k, 1);
          wgmma_rs_tf32(acc, a_hi[k], d_hi + 2 * k, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if (++stage == wg32::STAGES) { stage = 0; phase ^= 1; }
    }
    if (!active) continue;

    // row r of the warp's 16 holds o = 2 (r % 8) + r / 8: this thread's rows
    // quad and quad + 8 are the neighbouring o = 2 quad and 2 quad + 1
    const int row = o0 + wg * 64 + wq * 16 + 2 * quad;
    const int col = i0 + 2 * c;
    float* out = p.partial + (long long)s * p.O * p.I;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = col + 8 * j;   // I % 8 == 0: n, n + 1 both in or both out
      if (n >= p.I) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row + h < p.O)
          store2(out + (long long)(row + h) * p.I + n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and the launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)f;
  }
  return fn;
}

// Tensor map of a row-major [rows, K] matrix of T (rows `ld` elements apart,
// ld = K when 0), read in boxes of [box_rows, Operand<T>::BK] (128 bytes) in
// the 128-byte swizzle; out-of-range elements read as 0.
template <typename T>
inline bool kmajor_map(CUtensorMap* map, const T* ptr, int rows, int K, int box_rows,
                       int ld = 0) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld ? ld : K) * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Operand<T>::BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, Operand<T>::MAP, 2, (void*)ptr, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Per device and instantiation, the number of CTAs that fit the card at once,
// known once the kernel has its shared-memory opt-in there. Internal
// linkage on purpose: every library that includes this header has its own
// copy of the kernel to opt in (a static local of an inline function would be
// one object for the whole process, and a second library would launch without
// its opt-in).
constexpr int kMaxDevices = 64;
static int linear_grid[2][kMaxDevices];              // [MUL][device]
static int linear_f32_grid[2][2][kMaxDevices];       // [TN == 128][MUL][device]

// Sets `kernel`'s opt-in to `smem` bytes of shared memory on device `dev`
// and its CTA slots there (SMs times the CTAs that fit one) into *slots,
// unless *slots is known already.
template <typename K>
inline cudaError_t cta_slots(K kernel, size_t smem, int dev, int* slots) {
  if (*slots) return cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, sm90::THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  return cudaSuccess;
}

// Launches C = a w^T + epilogue on `st`: bf16 on linear_kernel, fp32 (w
// split, see LinearT) on linear_f32_kernel. Takes N and K multiples of 8
// (TMA strides are multiples of 16 bytes), 16-byte-aligned a and w, and
// `mul` or a residual but not both; returns cudaErrorInvalidValue for
// anything else, without a launch.
template <typename T>
inline cudaError_t linear_sm90(const LinearT<T>& p, cudaStream_t st) {
  if (p.M < 1 || p.N < 8 || p.K < 8 || p.N % 8 || p.K % 8 ||
      ((uintptr_t)p.a | (uintptr_t)p.w) % 16 || (p.mul && p.res_scale))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int* slots = &linear_grid[p.mul != nullptr][dev];
  const long long row_tiles = linear_row_tiles(p.M);
  CUtensorMap ta, tw;
  if constexpr (is_f32<T>) {
    const bool wide = linear_f32_wide(p.N, p.K);
    const int tn = wide ? 128 : 64;
    CUtensorMap tl;
    if (!kmajor_map(&ta, p.a, p.M, p.K, sm90::BM) || !kmajor_map(&tw, p.w, p.N, p.K, tn) ||
        !kmajor_map(&tl, p.w + (long long)p.N * p.K, p.N, p.K, tn))
      return cudaErrorInvalidValue;
    const auto kernel =
        wide ? (p.mul ? linear_f32_kernel<true, 128> : linear_f32_kernel<false, 128>)
             : (p.mul ? linear_f32_kernel<true, 64> : linear_f32_kernel<false, 64>);
    const size_t smem = lf32::smem_bytes(tn);
    slots = &linear_f32_grid[wide][p.mul != nullptr][dev];
    if ((e = cta_slots(kernel, smem, dev, slots)) != cudaSuccess) return e;
    const long long tiles = row_tiles * ((p.N + tn - 1) / tn);
    kernel<<<(int)(tiles < *slots ? tiles : *slots), sm90::THREADS, smem, st>>>(ta, tw, tl, p);
  } else {
    if (!kmajor_map(&ta, p.a, p.M, p.K, sm90::BM) || !kmajor_map(&tw, p.w, p.N, p.K, sm90::BN))
      return cudaErrorInvalidValue;
    const auto kernel = p.mul ? linear_kernel<T, true> : linear_kernel<T, false>;
    if ((e = cta_slots(kernel, sm90::SMEM_BYTES, dev, slots)) != cudaSuccess) return e;
    const long long tiles = row_tiles * ((p.N + sm90::BN - 1) / sm90::BN);
    kernel<<<(int)(tiles < *slots ? tiles : *slots), sm90::THREADS, sm90::SMEM_BYTES, st>>>(
        ta, tw, p);
  }
  return cudaGetLastError();
}

// The split of a weight gradient's M rows into row ranges: as many ranges
// as fill kWgradSlots CTA slots (two CTAs on each of an H100's 132 SMs) with
// (tile, range) items, each range a whole number of k-blocks (64 rows of
// bf16, 32 of fp32) and none empty. fp32: that many times the smallest
// whole number that keeps a range within kWgradF32Depth k-blocks (1,536
// rows). The tensor cores' fp32 accumulator loses more low bits the longer
// one sum runs (on the card, a 12,672-row range at D = 384 read 0.036 of the
// bf16 form's error, 4,608 rows at D = 192 0.014; the limit is 0.02); the
// ranges' partials are added in fp32 by reduce_partials_kernel. A function
// of the shape alone, so the workspace can be sized before a launch and the
// sum order is the same on every run.
constexpr int kWgradSlots = 2 * 132;
constexpr int kWgradF32Depth = 48;

template <typename T = bf16>
inline void weight_grad_plan(int M, int O, int I, int* splits, int* kb_per_split) {
  const int tiles = (O + sm90::BM - 1) / sm90::BM * ((I + sm90::BN - 1) / sm90::BN);
  const int k_total = (M + Operand<T>::BK - 1) / Operand<T>::BK;
  int s = (kWgradSlots + tiles - 1) / tiles;
  if (is_f32<T>) s *= (k_total + s * kWgradF32Depth - 1) / (s * kWgradF32Depth);
  s = s < 1 ? 1 : (s > k_total ? k_total : s);
  const int per = (k_total + s - 1) / s;
  *kb_per_split = per;
  *splits = (k_total + per - 1) / per;
}

// fp32 elements of the partials of one weight gradient.
template <typename T = bf16>
inline long long weight_grad_partial_len(int M, int O, int I) {
  int splits, per;
  weight_grad_plan<T>(M, O, I, &splits, &per);
  return (long long)splits * O * I;
}

static int wgrad_grid[2][kMaxDevices];   // [fp32][device]

// Launches the partials of dW[O, I] = g^T x into `partial`
// (weight_grad_partial_len<T> floats) on `st` and returns the number of
// partials through `splits`: g [M, O] and x [M, I] row-major, bf16 or fp32
// (weight_grad_f32_kernel). Takes O and I multiples of 8 and 16-byte-aligned
// g and x; cudaErrorInvalidValue, without a launch, for anything else.
template <typename T>
inline cudaError_t weight_grad_partials_sm90(const T* g, const T* x, int M, int O, int I,
                                             float* partial, int* splits, cudaStream_t st) {
  if (M < 1 || O < 8 || I < 8 || O % 8 || I % 8 || ((uintptr_t)g | (uintptr_t)x) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tg, tx;
  if (!kmajor_map(&tg, g, M, O, Operand<T>::BK) || !kmajor_map(&tx, x, M, I, Operand<T>::BK))
    return cudaErrorInvalidValue;
  void (*kernel)(CUtensorMap, CUtensorMap, WeightGrad);
  size_t smem;
  if constexpr (is_f32<T>) {
    kernel = weight_grad_f32_kernel<T>;
    smem = wg32::SMEM_BYTES;
  } else {
    kernel = weight_grad_kernel<T>;
    smem = sm90::SMEM_BYTES;
  }
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& slots = wgrad_grid[is_f32<T>][dev];
  if ((e = cta_slots(kernel, smem, dev, &slots)) != cudaSuccess) return e;
  WeightGrad p;
  p.M = M; p.O = O; p.I = I;
  weight_grad_plan<T>(M, O, I, &p.splits, &p.kb_per_split);
  p.partial = partial;
  const long long items = (long long)((O + sm90::BM - 1) / sm90::BM) *
                          ((I + sm90::BN - 1) / sm90::BN) * p.splits;
  const int grid = (int)(items < slots ? items : slots);
  kernel<<<grid, sm90::THREADS, smem, st>>>(tg, tx, p);
  *splits = p.splits;
  return cudaGetLastError();
}

}  // namespace dk
