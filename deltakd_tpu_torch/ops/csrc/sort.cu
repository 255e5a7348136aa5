// Bitonic sorting-network kernels along the token axis of a [B, n, d] tensor:
// the value sort, and the forward and backward of
//   sorted_l1(s, t) = mean |sort(s, axis=1) - sort(t, axis=1)|
// (the WassKD-l1 building block), with the gradient going to s only.
//
// Replaces, in deltakd_tpu/ops/sort.py: `_sort_kernel` (called by
// `bitonic_sort_pallas`), `_sl1_fwd_kernel` (`_sl1_fwd_call`) and
// `_sl1_bwd_kernel` (`_sl1_bwd_call`).
//
// Layout. Every column (b, :, j) is an independent sort of n values. A thread
// block takes one batch element b and a tile of C neighbouring columns, loads
// [n, C] with reads coalesced along d, pads rows n..n_pad-1 (n_pad the next
// power of two) with +inf, runs the log2(n_pad)(log2(n_pad)+1)/2
// compare-exchange stages in shared memory with one barrier per stage, and
// writes back coalesced. C is 32 columns up to n_pad = 512 and 16 at
// n_pad = 1024, so the largest block (fp32 keys, two key arrays, the row index
// and the sign buffer) takes 11 bytes x 1024 x 16 = 176 KB of the 227 KB a
// block may have. Column edges are masked, so any d works.
//
// Ties. The s-sort compares (key, row index) lexicographically. All pairs are
// then distinct, the network's result is exactly the stable ascending order,
// and row indices agree element for element with a stable library sort.
// Padding rows carry an index >= n and so sort behind a real +inf.
//
// The forward writes (a) one fp32 loss partial per block, summed inside the
// block in a fixed order (no atomics: the loss is bit-reproducible), and (b)
// the residual for the backward: sign(s_sorted - t_sorted) in {-1, 0, +1},
// already scattered back to the row the s value came from. The scatter
// happens in shared memory, where it costs no uncoalesced traffic, so the
// residual is one int8 per element of s in row order. What is left for the
// backward kernel is one pass: g = sign * (ct / numel) in fp32, cast to the
// dtype of s.
//
// What bounds them on an H100: bytes. The forward must read s and t and write
// the int8 residual (5 bytes an element in bf16), the backward reads 1 byte
// and writes one element, the value sort reads and writes one element each;
// against that stand about n_pad/2 * 36 compare-exchanges a column at
// n_pad = 256, all in shared memory. This first design spends its time there
// (one barrier a stage, two to four shared-memory accesses a
// compare-exchange); keeping the small-stride stages in registers is the
// lever for a later pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxN = 1024;

inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

inline int col_tile(int n_pad) { return n_pad <= 512 ? 32 : 16; }

template <typename T>
struct Key;

template <>
struct Key<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
};

template <>
struct Key<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 inf() {
    return __ushort_as_bfloat16((unsigned short)0x7f80);
  }
};

// Rows [0, n) and columns [col0, col0 + C) of element b into a [n_pad, C]
// shared tile; everything outside the tensor is +inf.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, T* tile, int b, int n,
                                          int n_pad, int d, int col0) {
  const int C = blockDim.x;
  const int col = col0 + threadIdx.x;
  for (int r = threadIdx.y; r < n_pad; r += blockDim.y) {
    T v = Key<T>::inf();
    if (r < n && col < d) v = x[((size_t)b * n + r) * d + col];
    tile[r * C + threadIdx.x] = v;
  }
}

// The low row of compare-exchange pair q at stride j (a power of two).
__device__ __forceinline__ int pair_low(int q, int j) {
  return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

// One stage on values alone: ascending blocks keep the smaller key low.
template <typename T>
__device__ __forceinline__ void exchange_values(T* tile, int lo, int hi, bool asc) {
  const T a = tile[lo], b = tile[hi];
  const float fa = Key<T>::f(a), fb = Key<T>::f(b);
  if (asc ? (fa > fb) : (fa < fb)) {
    tile[lo] = b;
    tile[hi] = a;
  }
}

// One stage on (key, row index) pairs, ordered lexicographically.
template <typename T>
__device__ __forceinline__ void exchange_indexed(T* tile, uint16_t* idx, int lo, int hi,
                                                 bool asc) {
  const T a = tile[lo], b = tile[hi];
  const uint16_t ia = idx[lo], ib = idx[hi];
  const float fa = Key<T>::f(a), fb = Key<T>::f(b);
  const bool lo_after_hi = (fa > fb) || (fa == fb && ia > ib);
  if (lo_after_hi == asc) {
    tile[lo] = b;
    tile[hi] = a;
    idx[lo] = ib;
    idx[hi] = ia;
  }
}

template <typename T>
__global__ void bitonic_sort_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                                    int n_pad, int d, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int C = blockDim.x;
  const int b = blockIdx.x / tiles;
  const int col0 = (blockIdx.x % tiles) * C;
  load_tile(x, tile, b, n, n_pad, d, col0);
  __syncthreads();
  const int half = n_pad >> 1;
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int q = threadIdx.y; q < half; q += blockDim.y) {
        const int lo = pair_low(q, j);
        exchange_values(tile, lo * C + threadIdx.x, (lo + j) * C + threadIdx.x,
                        (lo & k) == 0);
      }
      __syncthreads();
    }
  }
  const int col = col0 + threadIdx.x;
  if (col < d)
    for (int r = threadIdx.y; r < n; r += blockDim.y)
      out[((size_t)b * n + r) * d + col] = tile[r * C + threadIdx.x];
}

template <typename T>
__global__ void sl1_fwd_kernel(const T* __restrict__ s, const T* __restrict__ t,
                               float* __restrict__ partials, int8_t* __restrict__ sign,
                               int n, int n_pad, int d, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = blockDim.x;
  const int cells = n_pad * C;
  const int threads = blockDim.x * blockDim.y;
  float* red = reinterpret_cast<float*>(smem);              // [threads]
  T* ks = reinterpret_cast<T*>(red + threads);              // [n_pad, C] keys of s
  T* kt = ks + cells;                                       // [n_pad, C] keys of t
  uint16_t* is = reinterpret_cast<uint16_t*>(kt + cells);   // [n_pad, C] row index
  int8_t* sg = reinterpret_cast<int8_t*>(is + cells);       // [n_pad, C] sign by row
  const int b = blockIdx.x / tiles;
  const int col0 = (blockIdx.x % tiles) * C;
  const int tx = threadIdx.x;
  load_tile(s, ks, b, n, n_pad, d, col0);
  load_tile(t, kt, b, n, n_pad, d, col0);
  for (int r = threadIdx.y; r < n_pad; r += blockDim.y) is[r * C + tx] = (uint16_t)r;
  __syncthreads();

  // both sorts walk the same network, so they share its barriers
  const int half = n_pad >> 1;
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int q = threadIdx.y; q < half; q += blockDim.y) {
        const int lo = pair_low(q, j);
        const bool asc = (lo & k) == 0;
        const int a = lo * C + tx, c = (lo + j) * C + tx;
        exchange_indexed(ks, is, a, c, asc);
        exchange_values(kt, a, c, asc);
      }
      __syncthreads();
    }
  }

  // |difference| summed per thread; the sign goes to the row s came from.
  // Within one column the first n indices are a permutation of 0..n-1.
  float acc = 0.f;
  if (col0 + tx < d) {
    for (int r = threadIdx.y; r < n; r += blockDim.y) {
      const float diff = Key<T>::f(ks[r * C + tx]) - Key<T>::f(kt[r * C + tx]);
      acc += fabsf(diff);
      sg[(int)is[r * C + tx] * C + tx] = (int8_t)((diff > 0.f) - (diff < 0.f));
    }
  }
  const int tid = threadIdx.y * blockDim.x + tx;
  red[tid] = acc;
  __syncthreads();
  for (int w = threads >> 1; w > 0; w >>= 1) {   // threads is a power of two
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.x] = red[0];
  if (col0 + tx < d)
    for (int r = threadIdx.y; r < n; r += blockDim.y)
      sign[((size_t)b * n + r) * d + col0 + tx] = sg[r * C + tx];
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float e) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float e) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, e);
  uint2 v;
  v.x = *reinterpret_cast<unsigned int*>(&lo);
  v.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// g = sign * scale, four elements a thread; `sign` and `g` are 16-byte aligned.
template <typename T>
__global__ void sl1_bwd_kernel(const int8_t* __restrict__ sign, const float* __restrict__ scale,
                               T* __restrict__ g, long long numel) {
  const float sc = *scale;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i + 3 < numel) {
    const char4 v = *reinterpret_cast<const char4*>(sign + i);
    store4(g + i, (float)v.x * sc, (float)v.y * sc, (float)v.z * sc, (float)v.w * sc);
  } else {
    for (long long e = i; e < numel; ++e) store1(g + e, (float)sign[e] * sc);
  }
}

struct Launch {
  int n_pad, C, tiles;
  dim3 block;
};

inline Launch plan(int n, int d) {
  Launch l;
  l.n_pad = next_pow2(n);
  l.C = col_tile(l.n_pad);
  l.tiles = (d + l.C - 1) / l.C;
  int rows = l.n_pad / 2;
  if (rows < 1) rows = 1;
  if (rows > kMaxThreads / l.C) rows = kMaxThreads / l.C;
  l.block = dim3(l.C, rows);
  return l;
}

inline bool bad_shape(int B, int n, int d) {
  return B < 1 || d < 1 || n < 2 || n > kMaxN || (long long)B * ((d + 15) / 16) > 0x7fffffffLL;
}

template <typename T>
int run_sort(const void* x, void* out, int B, int n, int d, cudaStream_t st) {
  const Launch l = plan(n, d);
  const size_t bytes = (size_t)l.n_pad * l.C * sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(bitonic_sort_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  bitonic_sort_kernel<T><<<B * l.tiles, l.block, bytes, st>>>(
      (const T*)x, (T*)out, n, l.n_pad, d, l.tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int run_sl1_fwd(const void* s, const void* t, float* partials, int8_t* sign, int B, int n,
                int d, cudaStream_t st) {
  const Launch l = plan(n, d);
  const size_t cells = (size_t)l.n_pad * l.C;
  const size_t bytes = (size_t)l.block.x * l.block.y * sizeof(float)
                       + cells * (2 * sizeof(T) + sizeof(uint16_t) + sizeof(int8_t));
  cudaError_t e = cudaFuncSetAttribute(sl1_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  sl1_fwd_kernel<T><<<B * l.tiles, l.block, bytes, st>>>(
      (const T*)s, (const T*)t, partials, sign, n, l.n_pad, d, l.tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int run_sl1_bwd(const int8_t* sign, const float* scale, void* g, long long numel,
                cudaStream_t st) {
  const int threads = 256;
  const long long blocks = (numel + 4LL * threads - 1) / (4LL * threads);
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sl1_bwd_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(sign, scale, (T*)g, numel);
  return (int)cudaGetLastError();
}

}  // namespace

// Column tiles per batch element: the forward writes B * tiles loss partials.
extern "C" int dk_sort_tiles(int n, int d) {
  if (bad_shape(1, n, d)) return -1;
  return plan(n, d).tiles;
}

// x, out: [B, n, d] contiguous, bf16 (is_bf16 = 1) or fp32. Returns a CUDA
// error code (0 = launched).
extern "C" int dk_sort_bitonic(const void* x, void* out, int B, int n, int d, int is_bf16,
                               void* stream) {
  if (bad_shape(B, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? run_sort<__nv_bfloat16>(x, out, B, n, d, st)
                 : run_sort<float>(x, out, B, n, d, st);
}

// s, t: [B, n, d] contiguous, one dtype; partials: fp32 [B * dk_sort_tiles(n, d)];
// sign: int8 [B, n, d], sign(s_sorted - t_sorted) at the row each s came from.
extern "C" int dk_sort_sl1_fwd(const void* s, const void* t, void* partials, void* sign,
                               int B, int n, int d, int is_bf16, void* stream) {
  if (bad_shape(B, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? run_sl1_fwd<__nv_bfloat16>(s, t, (float*)partials, (int8_t*)sign, B, n, d, st)
                 : run_sl1_fwd<float>(s, t, (float*)partials, (int8_t*)sign, B, n, d, st);
}

// sign: int8 [numel]; scale: one fp32 on the device (ct / numel); g: [numel]
// bf16 or fp32, g = sign * scale.
extern "C" int dk_sort_sl1_bwd(const void* sign, const void* scale, void* g, long long numel,
                               int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? run_sl1_bwd<__nv_bfloat16>((const int8_t*)sign, (const float*)scale, g, numel, st)
                 : run_sl1_bwd<float>((const int8_t*)sign, (const float*)scale, g, numel, st);
}
