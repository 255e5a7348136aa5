// Sorting-network kernels along the token axis of a [B, n, d] tensor: the
// value sort, and the forward and backward of
//   sorted_l1(s, t) = mean |sort(s, axis=1) - sort(t, axis=1)|
// (the WassKD-l1 building block), with the gradient going to s only.
//
// Replaces, in deltakd_tpu/ops/sort.py: `_sort_kernel` (called by
// `bitonic_sort_pallas`), `_sl1_fwd_kernel` (`_sl1_fwd_call`) and
// `_sl1_bwd_kernel` (`_sl1_bwd_call`).
//
// Every column (b, :, j) is an independent sort of n values. A thread block
// takes one batch element b and a tile of C neighbouring columns (32 up to
// n_pad = 512, 16 at n_pad = 1024; column edges are masked, so any d works)
// and loads [n, C] with reads coalesced along d.
//
// The sorted_l1 forward: a bitonic network in registers and warp shuffles.
// The block (8 warps) turns the [n, C] tile into columns in shared memory
// as it is (5 bytes a cell in bf16 with the signs, 41 KB at n_pad = 256,
// where 64 registers a thread let four blocks share an SM); each warp then
// takes one column at a time, forms its keys, with
// n_pad / 32 = R keys a lane (n_pad the next power of two of n, at least 32)
// and sorts s and t side by side. A key's network position is lane * R + r,
// so the stages of stride below R exchange two registers of one lane and
// those of stride R..n_pad/2 exchange register r with lane ^ (stride / R)
// by __shfl_xor_sync: at n_pad = 256, 21 register stages and 15 shuffle
// stages, and no barrier in the network. (A key's first position is free:
// the network sorts whatever it is given, so lane l takes rows l, l + 32, ...
// of its column, which reads shared memory without bank conflicts.)
//   s keys carry their row: (image(s) << 16) | row in 32 bits for bf16,
// (image(s) << 32) | row in 64 bits for fp32, where image() is the
// order-preserving unsigned image of the float (sign bit set: all bits
// flipped; clear: sign bit set). All keys are then distinct and their
// unsigned order is the lexicographic (value, row) order, so an exchange is
// one unsigned min or max (two shuffles for 64 bits) and the result is
// exactly the stable ascending order: the row indices agree element for
// element with torch.sort(stable=True). -0.0 is folded onto +0.0 before the
// image (their bit images differ, but they are equal as floats and tie by
// row). Padding rows and the columns past d carry the largest image and a
// row >= n, so they sort behind every real key, a real +inf or NaN included.
// t keys are images alone; in bf16 two share a word (positions r and
// r + R/2 of a lane, from R = 2 on), so that one shuffle moves two and
// min.u16x2 / max.u16x2 exchange two pairs at once. In each phase of the
// network the keys of its descending blocks are held complemented (~key
// reverses the unsigned order), so every exchange keeps the smaller key low:
// a register stage is one min and one max a pair, a shuffle stage one
// shuffle and one min or max a word, and entering a phase one XOR a word.
//   NaN: every NaN takes the largest image (after +inf, as torch.sort puts
// NaN last, ties by row); its value decodes to a NaN, so the loss is NaN and
// its sign is 0. No check feeds NaN.
//   The epilogue decodes both keys, adds |s - t| of the first n positions to
// a per-lane sum (columns and positions in a fixed order, then shuffles and
// the 8 warps in order: one fp32 partial per block, bit-reproducible, no
// atomics), and writes sign(s - t) in {-1, 0, +1} to the row the s key
// carries, in a [C][n_pad] byte buffer of shared memory, which is then
// written out coalesced as one int8 per element of s in row order. What is
// left for the backward kernel is one pass: g = sign * (ct / numel) in fp32,
// cast to the dtype of s.
//
// The value sort (no model path calls it) still runs the first design: the
// log2(n_pad)(log2(n_pad)+1)/2 compare-exchange stages on a [n_pad, C] tile
// in shared memory with one barrier per stage.
//
// What bounds them on an H100: bytes. The forward must read s and t and write
// the int8 residual (5 bytes an element in bf16, 96.3 MB at [256, 196, 384]),
// the backward reads 1 byte and writes one element, the value sort reads and
// writes one element each. Against that stand n_pad/2 * 36 compare-exchanges
// a column at n_pad = 256 for each of s and t. In the forward, 15 of the 36
// stages take one shuffle a word: 8 words of s and 4 of t a lane, about
// 17.7 M warp shuffles at the main shape, near 0.08 ms at one warp shuffle a
// clock an SM, above the 0.029 ms of its bytes; the min/max instructions
// (about 1.5x as many) share the SM's instruction slots with them.

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

// ---------------------------------------------------------------------------
// sorted_l1 forward: the network in registers and shuffles
// ---------------------------------------------------------------------------

constexpr int kSl1Warps = 8;
constexpr int kSl1Threads = 32 * kSl1Warps;

// The order-preserving unsigned image of a key, -0.0 folded onto +0.0 and
// every NaN onto the largest image; and back (the largest image decodes to a
// NaN).
__device__ __forceinline__ uint32_t key_image(__nv_bfloat16 x) {
  uint32_t u = __bfloat16_as_ushort(x);
  if ((u & 0x7fffu) > 0x7f80u) u = 0x7fffu;   // NaN
  if (u == 0x8000u) u = 0u;                   // -0.0
  return (u & 0x8000u) ? (~u & 0xffffu) : (u | 0x8000u);
}

__device__ __forceinline__ uint32_t key_image(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) u = 0x7fffffffu;
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <typename T>
struct SortKey;

// s keys: (image << 16) | row; t keys: the image
template <>
struct SortKey<__nv_bfloat16> {
  using S = uint32_t;
  static constexpr uint32_t kPad = 0xffffu;   // the largest image
  static __device__ __forceinline__ S pack(uint32_t image, int row) {
    return (image << 16) | (uint32_t)row;
  }
  static __device__ __forceinline__ int row(S key) { return (int)(key & 0xffffu); }
  static __device__ __forceinline__ float value(uint32_t image) {
    const uint32_t u = (image & 0x8000u) ? (image ^ 0x8000u) : (~image & 0xffffu);
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)u));
  }
  static __device__ __forceinline__ float s_value(S key) { return value(key >> 16); }
};

// s keys: (image << 32) | row
template <>
struct SortKey<float> {
  using S = unsigned long long;
  static constexpr uint32_t kPad = 0xffffffffu;
  static __device__ __forceinline__ S pack(uint32_t image, int row) {
    return ((S)image << 32) | (uint32_t)row;
  }
  static __device__ __forceinline__ int row(S key) { return (int)(uint32_t)key; }
  static __device__ __forceinline__ float value(uint32_t image) {
    return __uint_as_float((image & 0x80000000u) ? (image ^ 0x80000000u) : ~image);
  }
  static __device__ __forceinline__ float s_value(S key) { return value((uint32_t)(key >> 32)); }
};

template <typename K>
__device__ __forceinline__ K kmin(K a, K b) { return a < b ? a : b; }
template <typename K>
__device__ __forceinline__ K kmax(K a, K b) { return a < b ? b : a; }

// Two 16-bit keys a word: halfwise unsigned min and max.
__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Whether position lane * R + r lies in a descending block of the phase with
// block size Kb (none before the first phase, Kb = 1).
template <int R, int Kb>
__device__ __forceinline__ bool descending(int lane, int r) {
  if constexpr (Kb < 2) return false;
  else if constexpr (Kb < R) return (r & Kb) != 0;
  else return ((lane * R) & Kb) != 0;
}

// Whether the block of position lane * R + r changes direction entering the
// phase with block size Kb.
template <int R, int Kb>
__device__ __forceinline__ bool turns(int lane, int r) {
  return descending<R, Kb / 2>(lane, r) != descending<R, Kb>(lane, r);
}

// The network on R keys a lane, one key a word; a key's position is
// lane * R + r. In each phase the keys of its descending blocks are held
// complemented (~key reverses the unsigned order), so every exchange keeps
// the smaller key low; entering a phase, each key whose block turns is
// complemented.
template <int R, int J, typename K>
__device__ __forceinline__ void stage(K (&v)[R], int lane) {
  if constexpr (J >= R) {
    // partner: register r of lane ^ (J / R); the lower lane keeps the minimum
    const bool low = ((lane * R) & J) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const K o = __shfl_xor_sync(0xffffffffu, v[r], J / R);
      v[r] = low ? kmin(v[r], o) : kmax(v[r], o);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & J) continue;   // r is the pair's low register, r | J its high one
      const K a = v[r], b = v[r | J];
      v[r] = kmin(a, b);
      v[r | J] = kmax(a, b);
    }
  }
}

template <int R, int J, typename K>
__device__ __forceinline__ void merge(K (&v)[R], int lane) {
  stage<R, J>(v, lane);
  if constexpr (J > 1) merge<R, J / 2>(v, lane);
}

// Block sizes Kb = 2 .. 32 R; in the last phase no block is descending, so
// the keys leave ascending and uncomplemented.
template <int R, int Kb = 2, typename K>
__device__ __forceinline__ void network(K (&v)[R], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] ^= K(0) - K(turns<R, Kb>(lane, r));
  merge<R, Kb / 2>(v, lane);
  if constexpr (Kb < 32 * R) network<R, 2 * Kb>(v, lane);
}

// The same network on 16-bit keys two to a word: word i holds positions
// lane * R + i (low half) and lane * R + i + R / 2 (high half), so a shuffle
// moves two keys and a register stage is one min2 and one max2 for four.
template <int R, int J>
__device__ __forceinline__ void stage_pairs(uint32_t (&w)[R / 2], int lane) {
  constexpr int H = R / 2;
  if constexpr (J >= R) {
    const bool low = ((lane * R) & J) == 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const uint32_t o = __shfl_xor_sync(0xffffffffu, w[i], J / R);
      w[i] = low ? min2(w[i], o) : max2(w[i], o);
    }
  } else if constexpr (J == H) {
    // the two halves of a word: the minimum to the low half
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const uint32_t x = __byte_perm(w[i], 0, 0x1032);   // halves swapped
      w[i] = __byte_perm(min2(w[i], x), max2(w[i], x), 0x7610);
    }
  } else {
#pragma unroll
    for (int i = 0; i < H; ++i) {
      if (i & J) continue;
      const uint32_t a = w[i], b = w[i | J];
      w[i] = min2(a, b);
      w[i | J] = max2(a, b);
    }
  }
}

template <int R, int J>
__device__ __forceinline__ void merge_pairs(uint32_t (&w)[R / 2], int lane) {
  stage_pairs<R, J>(w, lane);
  if constexpr (J > 1) merge_pairs<R, J / 2>(w, lane);
}

template <int R, int Kb = 2>
__device__ __forceinline__ void network_pairs(uint32_t (&w)[R / 2], int lane) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i)
    w[i] ^= (turns<R, Kb>(lane, i) ? 0xffffu : 0u) | (turns<R, Kb>(lane, i + R / 2) ? 0xffff0000u : 0u);
  merge_pairs<R, Kb / 2>(w, lane);
  if constexpr (Kb < 32 * R) network_pairs<R, 2 * Kb>(w, lane);
}

// Rows 0 .. n - 1 of columns col0 .. col0 + C - 1 of element b of s and t,
// as they are, into the columns xs[c][row], xt[c][row] (row stride LD);
// columns at or past d are left out. VEC elements a load: 16 bytes when d
// allows it, else one; four passes of loads in flight.
template <typename T, int R, int C, int LD, int VEC>
__device__ __forceinline__ void load_columns(const T* __restrict__ s, const T* __restrict__ t,
                                             T* xs, T* xt, int b, int n, int d, int col0) {
  constexpr int NP = 32 * R, PER_ROW = C / VEC, ROWS = kSl1Threads / PER_ROW;
  constexpr int PASSES = (NP + ROWS - 1) / ROWS, BATCH = PASSES < 4 ? PASSES : 4;
  static_assert(PASSES % BATCH == 0, "whole batches of passes");
  struct alignas(sizeof(T) * VEC) Vec { T x[VEC]; };
  const int c0 = (threadIdx.x % PER_ROW) * VEC, r0 = threadIdx.x / PER_ROW;
  if (col0 + c0 >= d) return;   // VEC > 1: d % VEC == 0, the whole vector
#pragma unroll 1
  for (int p0 = 0; p0 < PASSES; p0 += BATCH) {
    Vec sv[BATCH], tv[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = r0 + (p0 + u) * ROWS;
      if (r < n) {
        const size_t at = ((size_t)b * n + r) * d + col0 + c0;
        sv[u] = *reinterpret_cast<const Vec*>(s + at);
        tv[u] = *reinterpret_cast<const Vec*>(t + at);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = r0 + (p0 + u) * ROWS;
      if (r >= n) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        xs[(c0 + e) * LD + r] = sv[u].x[e];
        xt[(c0 + e) * LD + r] = tv[u].x[e];
      }
    }
  }
}

// One block: element b, columns col0 .. col0 + C - 1. partials[blockIdx.x]
// gets the block's sum of |s_sorted - t_sorted|; sign (int8, [B, n, d])
// gets sign(s_sorted - t_sorted) at the row each s key came from.
template <typename T, int R>
__global__ void __launch_bounds__(kSl1Threads, R <= 8 ? 4 : 1)   // R <= 8: 64 registers
sl1_fwd_kernel(const T* __restrict__ s, const T* __restrict__ t, float* __restrict__ partials,
               int8_t* __restrict__ sign, int n, int d, int tiles, int vec) {
  using K = SortKey<T>;
  using S = typename K::S;
  constexpr int NP = 32 * R;
  constexpr int C = NP <= 512 ? 32 : 16;             // col_tile(n_pad)
  constexpr int LD = NP + 4 / (int)sizeof(T);        // conflict-free column writes
  constexpr int LDS = NP + 4;                        // signs: conflict-free row reads
  constexpr int VEC = 16 / sizeof(T);
  // t keys of bf16 two to a word (positions r and r + R / 2), from R = 2 on
  constexpr bool kPairs = sizeof(T) == 2 && R >= 2;
  constexpr int TW = kPairs ? R / 2 : R;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                // [C][LD] s by column
  T* xt = xs + C * LD;                               // [C][LD] t by column
  int8_t* sg = reinterpret_cast<int8_t*>(xt + C * LD);   // [C][LDS] signs by row
  __shared__ float red[kSl1Warps];
  const int b = blockIdx.x / tiles, col0 = (blockIdx.x % tiles) * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (vec)
    load_columns<T, R, C, LD, VEC>(s, t, xs, xt, b, n, d, col0);
  else
    load_columns<T, R, C, LD, 1>(s, t, xs, xt, b, n, d, col0);
  __syncthreads();

  float acc = 0.f;
  for (int c = warp; c < C && col0 + c < d; c += kSl1Warps) {
    // the keys: lane l takes rows l, l + 32, ...; rows at or past n pad
    S v[R];
    uint32_t w[TW];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = 32 * r + lane;
      const bool in = row < n;
      v[r] = K::pack(in ? key_image(xs[c * LD + row]) : K::kPad, row);
      const uint32_t ti = in ? key_image(xt[c * LD + row]) : K::kPad;
      if (!kPairs || r < TW)
        w[r % TW] = ti;
      else
        w[r % TW] |= ti << 16;
    }
    network<R>(v, lane);
    if constexpr (kPairs)
      network_pairs<R>(w, lane);
    else
      network<R>(w, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane * R + r >= n) continue;
      const uint32_t t_image = kPairs ? (w[r % TW] >> (16 * (r / TW))) & 0xffffu : w[r % TW];
      const float diff = K::s_value(v[r]) - K::value(t_image);
      acc += fabsf(diff);
      sg[c * LDS + K::row(v[r])] = (int8_t)((diff > 0.f) - (diff < 0.f));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kSl1Warps; ++i) total += red[i];
    partials[blockIdx.x] = total;
  }
  for (int i = threadIdx.x; i < n * C; i += kSl1Threads) {
    const int r = i / C, c = i % C;
    if (col0 + c < d) sign[((size_t)b * n + r) * d + col0 + c] = sg[c * LDS + r];
  }
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

template <typename T, int R>
int launch_sl1_fwd(const T* s, const T* t, float* partials, int8_t* sign, int B, int n, int d,
                   cudaStream_t st) {
  constexpr int NP = 32 * R, C = NP <= 512 ? 32 : 16;
  const size_t bytes = (size_t)C * (NP + 4 / sizeof(T)) * 2 * sizeof(T) + (size_t)C * (NP + 4);
  cudaError_t e = cudaFuncSetAttribute(sl1_fwd_kernel<T, R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (d + C - 1) / C;
  // 16-byte loads when every row segment of a column tile is 16-byte aligned
  const int vec = d % (16 / (int)sizeof(T)) == 0 && (uintptr_t)s % 16 == 0 &&
                  (uintptr_t)t % 16 == 0;
  sl1_fwd_kernel<T, R><<<B * tiles, kSl1Threads, bytes, st>>>(s, t, partials, sign, n, d, tiles,
                                                               vec);
  return (int)cudaGetLastError();
}

template <typename T>
int run_sl1_fwd(const void* s, const void* t, float* partials, int8_t* sign, int B, int n,
                int d, cudaStream_t st) {
  const T* sp = (const T*)s;
  const T* tp = (const T*)t;
  const int n_pad = next_pow2(n);
  if (n_pad <= 32) return launch_sl1_fwd<T, 1>(sp, tp, partials, sign, B, n, d, st);
  if (n_pad == 64) return launch_sl1_fwd<T, 2>(sp, tp, partials, sign, B, n, d, st);
  if (n_pad == 128) return launch_sl1_fwd<T, 4>(sp, tp, partials, sign, B, n, d, st);
  if (n_pad == 256) return launch_sl1_fwd<T, 8>(sp, tp, partials, sign, B, n, d, st);
  if (n_pad == 512) return launch_sl1_fwd<T, 16>(sp, tp, partials, sign, B, n, d, st);
  return launch_sl1_fwd<T, 32>(sp, tp, partials, sign, B, n, d, st);
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
