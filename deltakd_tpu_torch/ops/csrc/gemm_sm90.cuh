// A pipelined TMA + wgmma GEMM for Hopper (sm_90a): the four linear products
// of the ViT block forward (qkv, proj, fc1, fc2 in `forward_chain`,
// fused_block_common.cuh), and the Hopper primitives (mbarriers, TMA, wgmma
// and its shared-memory descriptors) that attention_fwd.cuh builds on.
//
//   C[M, N] = A[M, K] W[N, K]^T,  then a fused epilogue (`Linear` below)
//
// A is row-major activations and W an nn.Linear weight, both bf16 and
// K-major, which is what wgmma reads with no transpose; fp32 accumulation.
//
// What bounds it on an H100: the tensor cores. At the main path's shapes
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
//    residual) are loaded a group of blocks ahead of the group's stores.
// Tiles 64 wide and two CTAs per SM were the fastest of the layouts tried on
// the four products (tiles 64 to 256 wide, one CTA per SM with 4 or 5
// stages); chip_smoke.py's [gemm] lines give this design's rates.
// Each output element is summed by one warpgroup in a fixed k order: no
// atomics, two runs give the same bits.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dk {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_erf_grad(float x) {
  float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  return cdf + x * __expf(-0.5f * x * x) * 0.3989422804014327f;
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

// ---------------------------------------------------------------------------
// The linear product and its epilogue
// ---------------------------------------------------------------------------

// C = a w^T with a [M, K] row-major and w [N, K] (nn.Linear), then, in this
// order, on v = C[m, n] (outputs [M, N] row-major):
struct Linear {
  int M, N, K;
  const bf16* a;
  const bf16* w;
  const float* bias;        // v += bias[n]
  int scale_cols;           // v *= col_scale for n < scale_cols
  float col_scale;
  int gelu;                 // v = gelu(v); gelu'(v) -> act_grad (fp32)
  float* act_grad;
  bf16* pre_bf16;           // pre_bf16 = v (before the residual)
  const float* res_f32;     // v = res + res_scale[m / rows_per_sample] * v
  const bf16* res_bf16;
  const float* res_scale;
  int rows_per_sample;
  float* out_f32;           // out = v
  bf16* out_bf16;
};

inline Linear linear_of(const bf16* a, const bf16* w, int M, int N, int K) {
  Linear p = {};
  p.M = M; p.N = N; p.K = K;
  p.a = a; p.w = w;
  p.col_scale = 1.0f;
  p.rows_per_sample = 1;
  return p;
}

namespace sm90 {
constexpr int BM = 128, BN = 64, BK = 64, STAGES = 4, CONSUMER_WARPS = 8, EPI_J = 4;
constexpr int THREADS = (CONSUMER_WARPS + 1) * 32;
constexpr int CTAS_PER_SM = 2;
constexpr size_t SMEM_BYTES =
    (size_t)STAGES * (BM + BN) * BK * sizeof(bf16) + 2 * STAGES * sizeof(uint64_t) + 1024;
}  // namespace sm90

// Two neighbouring outputs as one float2 / bf16x2 store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The epilogue of columns n, n + 1 of row m, given their bias b, residual r
// and the row's residual scale rs (each read by the caller).
__device__ __forceinline__ void linear_epilogue(const Linear& p, int m, int n, float v0,
                                                float v1, float2 b, float2 r, float rs) {
  const long long c = (long long)m * p.N + n;
  v0 += b.x;
  v1 += b.y;
  if (n < p.scale_cols) {
    v0 *= p.col_scale;
    v1 *= p.col_scale;
  }
  if (p.gelu) {
    if (p.act_grad) store2(p.act_grad + c, gelu_erf_grad(v0), gelu_erf_grad(v1));
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  }
  if (p.pre_bf16) store2(p.pre_bf16 + c, v0, v1);
  if (p.res_scale) {
    v0 = r.x + rs * v0;
    v1 = r.y + rs * v1;
  }
  if (p.out_f32) store2(p.out_f32 + c, v0, v1);
  if (p.out_bf16) store2(p.out_bf16 + c, v0, v1);
}

__device__ __forceinline__ float2 load_residual(const Linear& p, long long c) {
  if (p.res_f32) return __ldg(reinterpret_cast<const float2*>(p.res_f32 + c));
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p.res_bf16 + c)));
}

static __global__ void __launch_bounds__(sm90::THREADS, sm90::CTAS_PER_SM)
linear_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
              const Linear p) {
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(align1024(smem_raw));   // [STAGES][BM][BK]
  bf16* Bs = As + STAGES * BM * BK;                            // [STAGES][BN][BK]
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
          mbar_expect_tx(&full[stage], (BM + BN) * BK * sizeof(bf16));
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
      for (int k = 0; k < BK / 16; ++k) wgmma_ss(acc, da + 2 * k, db + 2 * k, kb > 0 || k > 0);
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

    // Epilogue, EPI_J 8-column blocks at a time: first every input of the
    // group (bias, residual), then the stores, so that the loads overlap
    // instead of each waiting behind the stores before it.
    const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int col = n0 + 2 * (lane % 4);
    const bool row_ok[2] = {row < p.M, row + 8 < p.M};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (p.res_scale && row_ok[h]) rs[h] = __ldg(p.res_scale + (row + 8 * h) / p.rows_per_sample);
#pragma unroll
    for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
      float2 b[EPI_J], r[EPI_J][2];
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj) {
        const int n = col + 8 * (j0 + jj);   // N % 8 == 0: n, n + 1 both in or both out
        b[jj] = p.bias && n < p.N ? __ldg(reinterpret_cast<const float2*>(p.bias + n))
                                  : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          r[jj][h] = p.res_scale && n < p.N && row_ok[h]
                         ? load_residual(p, (long long)(row + 8 * h) * p.N + n)
                         : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int jj = 0; jj < EPI_J; ++jj) {
        const int n = col + 8 * (j0 + jj), j = j0 + jj;
        if (n >= p.N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row_ok[h])
            linear_epilogue(p, row + 8 * h, n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], b[jj],
                            r[jj][h], rs[h]);
      }
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

// Tensor map of a row-major [rows, K] bf16 matrix, read in boxes of
// [box_rows, 64] in the 128-byte swizzle; out-of-range elements read as 0.
inline bool kmajor_map(CUtensorMap* map, const bf16* ptr, int rows, int K, int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, (void*)ptr, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Per device, the number of CTAs that fit the card at once, known once
// linear_kernel has its shared-memory opt-in there. Internal linkage on
// purpose: every library that includes this header has its own copy of the
// kernel to opt in (a static local of an inline function would be one object
// for the whole process, and a second library would launch without its
// opt-in).
constexpr int kMaxDevices = 64;
static int linear_grid[kMaxDevices];

// Launches C = a w^T + epilogue on `st`. Takes N and K multiples of 8 (TMA
// strides are multiples of 16 bytes) and 16-byte-aligned a and w; returns
// cudaErrorInvalidValue for anything else, without a launch.
inline cudaError_t linear_sm90(const Linear& p, cudaStream_t st) {
  if (p.M < 1 || p.N < 8 || p.K < 8 || p.N % 8 || p.K % 8 ||
      ((uintptr_t)p.a | (uintptr_t)p.w) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  if (!kmajor_map(&ta, p.a, p.M, p.K, sm90::BM) || !kmajor_map(&tw, p.w, p.N, p.K, sm90::BN))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!linear_grid[dev]) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm90::SMEM_BYTES);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, linear_kernel, sm90::THREADS,
                                                        sm90::SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    linear_grid[dev] = sms * per_sm;
  }
  const long long tiles =
      (long long)((p.M + sm90::BM - 1) / sm90::BM) * ((p.N + sm90::BN - 1) / sm90::BN);
  const int grid = (int)(tiles < linear_grid[dev] ? tiles : linear_grid[dev]);
  linear_kernel<<<grid, sm90::THREADS, sm90::SMEM_BYTES, st>>>(ta, tw, p);
  return cudaGetLastError();
}

}  // namespace dk
