// Sorting-network kernels along the token axis of a [B, n, d] tensor: the
// value sort, and the forward and backward of
//   sorted_l1(s, t) = mean |sort(s, axis=1) - sort(t, axis=1)|
// (the WassKD-l1 building block), with the gradient going to s only.
//
// Replaces, in deltakd_tpu/ops/sort.py: `_sort_kernel` (called by
// `bitonic_sort_pallas`), `_sl1_fwd_kernel` (`_sl1_fwd_call`) and
// `_sl1_bwd_kernel` (`_sl1_bwd_call`).
//
// Every column (b, :, j) is an independent sort of its n values. Up to n =
// 4096 the value sort and the sorted_l1 forward run one design (longer
// columns: the long route at the end of this comment). A thread block (8
// warps) takes one batch element b and a tile of C neighbouring columns (32
// up to n_pad = 512, 16 at n_pad = 1024; columns past d are skipped, so any d
// works), loads [n, C] with reads coalesced along d (16 bytes a load when d
// allows it) and keeps it in shared memory as columns, values as they are.
// Each warp then takes one column at a time and sorts it with a bitonic
// network in registers and warp shuffles, n_pad / 32 = R keys a lane (n_pad
// the next power of two of n, at least 32). A key's network position is
// lane * R + r, so the stages of stride below R exchange two registers of one
// lane and those of stride R..n_pad/2 exchange register r with
// lane ^ (stride / R) by __shfl_xor_sync: at n_pad = 256, 21 register stages
// and 15 shuffle stages, and no barrier in the network. (A key's first
// position is free: the network sorts whatever it is given, so lane l takes
// rows l, l + 32, ... of its column, which reads shared memory without bank
// conflicts.)
//   A key is an unsigned image whose order is the order to sort by. A
// float's (bf16, fp16, fp32): every NaN takes the largest image (all ones);
// otherwise sign bit set: all bits flipped; clear: sign bit set. An int32's:
// x ^ 0x80000000. Rows past n take the largest image, so padding sorts
// behind every real key, a NaN included. In each phase of the network the
// keys of its descending blocks are held complemented (~key reverses the
// unsigned order), so every exchange keeps the smaller key low: a register
// stage is one min and one max a pair, a shuffle stage one shuffle and one
// min or max a word, and entering a phase one XOR a word. 16-bit keys go two
// to a word (positions r and r + R/2 of a lane, from R = 2 on), so that one
// shuffle moves two and min.u16x2 / max.u16x2 exchange two pairs at once.
//
// The value sort (bf16, fp16, fp32, int32): the keys are the images of the
// values, decoded back to values after the network. -0.0's image lies just
// below +0.0's, so every -0.0 comes out as a -0.0, ahead of the +0.0s:
// equal as floats to torch.sort's result. A column with k NaNs ends in k
// NaNs (the dtype's NaN with every other bit set), as torch.sort puts NaN
// last. Each lane writes its sorted values back into its column at
// positions lane * R + r, through a column layout that skips one 32-bit word
// after every 128 bytes, so that these writes meet no bank conflict either;
// then the block stores the [n, C] tile coalesced along d.
//
// The sorted_l1 forward (bf16, fp32) sorts s and t side by side. s keys
// carry their row: (image(s) << 16) | row in 32 bits for bf16,
// (image(s) << 32) | row in 64 bits for fp32, with -0.0 folded onto +0.0
// before the image (equal as floats, they tie by row). All keys are then
// distinct and their unsigned order is the lexicographic (value, row) order,
// so an exchange is one unsigned min or max (two shuffles for 64 bits) and
// the result is exactly the stable ascending order: the row indices agree
// element for element with torch.sort(stable=True). Padding rows carry a row
// >= n. t keys are images alone (bf16 t two to a word). A NaN's value
// decodes to a NaN, so the loss is NaN and its sign is 0. The raw values
// take 5 bytes a cell in bf16 with the signs (41 KB at n_pad = 256, where 64
// registers a thread let four blocks share an SM).
//   The epilogue decodes both keys, adds |s - t| of the first n positions to
// a per-lane sum (columns and positions in a fixed order, then shuffles and
// the 8 warps in order: one fp32 partial per block, bit-reproducible, no
// atomics), and writes sign(s - t) in {-1, 0, +1} to the row the s key
// carries, in a [C][n_pad] byte buffer of shared memory, which is then
// written out coalesced as one int8 per element of s in row order. What is
// left for the backward kernel is one pass: g = sign * (ct / numel) in fp32,
// cast to the dtype of s.
//
// What bounds them on an H100: bytes, and then the network's shuffles. The
// value sort reads and writes one element each (77 MB at [256, 196, 384]
// bf16, 0.023 ms at the memory rate); the forward reads s and t and writes
// the int8 residual (96.3 MB); the backward reads 1 byte and writes one
// element. Against that stand the 15 shuffle stages at n_pad = 256: a lane
// shuffles one word a stage for each word of keys it holds, 4 for a bf16
// column (5.9 M warp shuffles for the value sort at the main shape), 8 for
// fp32, and 8 + 4 for the forward's s and t (17.7 M), at one warp shuffle a
// clock an SM; the min/max instructions share the SM's issue slots with them.
//
// Columns longer than 1024 (n_pad = 2048 and 4096: RUNS = n_pad / 1024 runs
// of 1024 keys). A column is taken by RUNS neighbouring warps of the block,
// warp k holding run k (rows 1024 k + 32 r + lane) as 32 keys a lane at
// positions 1024 k + 32 lane + r; the block holds 16384 / n_pad columns (8
// at 2048, 4 at 4096) and its 8 warps take them 8 / RUNS at a time, in two
// rounds. Each warp sorts its run ascending with the network above. The
// merge phases of block size Kb = 2048 .. n_pad then use the network's other
// form, which needs no descending blocks: a phase's first stage compares
// position p with its mirror p ^ (Kb - 1), its next ones p with p ^ J (J =
// Kb / 4 .. 1), the lower position keeping the smaller key. The stages whose
// partner lies in another run (the mirror stage and J >= 1024) go through an
// exchange buffer in shared memory between two barriers (one skipped slot
// after every 32 keys: no bank conflict); those of J <= 512 run within the
// warp as above (`merge`). 16-bit keys leave their words for the exchange
// and go back two to a word for the in-warp stages. The sorted_l1 forward's
// s keys keep their row in 16 bits (bf16) or 32 (fp32): rows below 4096
// leave them distinct. Two barriers a cross stage, 1 stage at 2048 and 3 at
// 4096; the rest of the kernel, loads, keys, decode, stores and the loss's
// sum, is the short columns'. n <= 1024 runs the code above unchanged.
//
// The long route: columns longer than 4096 (n_pad = 8192 and up, any
// power of two up to 2^30; the JAX package's network takes any n). One
// block holds 4096 keys a column (a group of four warps, 32 a lane), and a
// column's keys live in a workspace in device memory, [B * d][n_pad] by
// column (`dk_sort_long_*`; the caller drives the passes, ops/sort.py
// `long_schedule`):
//   1. runs: block (b, 4 columns, run q) loads rows 4096 q .. 4096 q + 4095
//      of its columns coalesced along d, keys them (rows past n take the
//      largest image, as above), and each group sorts a column's run
//      ascending with the in-block design above (the network, then the
//      merge phases 2048 and 4096 through a shared exchange buffer, its
//      barriers the group's own named barrier), and writes it to the
//      workspace through that buffer, coalesced;
//   2. for each merge phase Kb = 8192 .. n_pad: its stages of stride 4096
//      and up, one launch a stage, one thread a compare-exchange in device
//      memory (the mirror stage p ^ (Kb - 1) first, then p ^ J, J = Kb / 4
//      .. 4096); then the finish, one group a 4096-key chunk: the stages of
//      stride 2048 .. 1, in the block as above. At the last phase the finish
//      ends the sort: the value sort decodes its keys into the output; the
//      sorted_l1 forward's block takes one chunk of s and the same chunk of
//      t (a group each), and the s group forms |s - t| and the signs as
//      above, one fp32 partial a block (columns, then chunks, in order;
//      the caller sums them in a fixed order) and each sign written to the
//      row its key carries.
// The long route's s keys are 64 bits for bf16 as for fp32, (image << 32)
// | row, since rows pass 65535; t keys and the value sort's keys are 32-bit
// words, one key a word. Bytes: each pass reads and writes every key once
// (12 bytes an element for sorted_l1, 4 for the value sort), log2(n_pad /
// 4096) (log2(n_pad / 4096) + 1) / 2 stage passes and as many finishes as
// phases: a column of 8192 takes one stage and one finish.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxN = 4096;
constexpr int kRun = 1024;   // keys a warp sorts in registers and shuffles
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

inline int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Columns a block takes: 32 up to n_pad = 512, 16 at 1024; above, as many as
// fill two rounds of the 8 warps at n_pad / 1024 warps a column.
__host__ __device__ constexpr int col_tile(int n_pad) {
  return n_pad <= 512 ? 32 : n_pad <= kRun ? 16 : 2 * kWarps * kRun / n_pad;
}

// A dtype's bits, as its key image needs them.
template <typename T>
struct Bits;

template <>
struct Bits<__nv_bfloat16> {
  static constexpr bool kFloat = true;
  static constexpr uint32_t kSign = 0x8000u, kMask = 0xffffu, kInf = 0x7f80u;
  static __device__ __forceinline__ uint32_t of(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }
  static __device__ __forceinline__ __nv_bfloat16 from(uint32_t u) {
    return __ushort_as_bfloat16((unsigned short)u);
  }
};

template <>
struct Bits<__half> {
  static constexpr bool kFloat = true;
  static constexpr uint32_t kSign = 0x8000u, kMask = 0xffffu, kInf = 0x7c00u;
  static __device__ __forceinline__ uint32_t of(__half x) { return __half_as_ushort(x); }
  static __device__ __forceinline__ __half from(uint32_t u) { return __ushort_as_half((unsigned short)u); }
};

template <>
struct Bits<float> {
  static constexpr bool kFloat = true;
  static constexpr uint32_t kSign = 0x80000000u, kMask = 0xffffffffu, kInf = 0x7f800000u;
  static __device__ __forceinline__ uint32_t of(float x) { return __float_as_uint(x); }
  static __device__ __forceinline__ float from(uint32_t u) { return __uint_as_float(u); }
};

template <>
struct Bits<int32_t> {
  static constexpr bool kFloat = false;
  static constexpr uint32_t kSign = 0x80000000u, kMask = 0xffffffffu;
  static __device__ __forceinline__ uint32_t of(int32_t x) { return (uint32_t)x; }
  static __device__ __forceinline__ int32_t from(uint32_t u) { return (int32_t)u; }
};

// The order-preserving unsigned image of a value, every NaN onto the largest
// image; FoldZero: -0.0 onto +0.0 first.
template <bool FoldZero = false, typename T>
__device__ __forceinline__ uint32_t key_image(T x) {
  using B = Bits<T>;
  uint32_t u = B::of(x);
  if constexpr (!B::kFloat) {
    return u ^ B::kSign;
  } else {
    if ((u & (B::kSign - 1u)) > B::kInf) return B::kMask;   // NaN
    if (FoldZero && u == B::kSign) u = 0u;
    return (u & B::kSign) ? (~u & B::kMask) : (u | B::kSign);
  }
}

// The value of an image: the inverse of key_image (the largest image decodes
// to a NaN with every bit but the sign set, or to INT32_MAX).
template <typename T>
__device__ __forceinline__ T key_value(uint32_t image) {
  using B = Bits<T>;
  if constexpr (!B::kFloat)
    return B::from(image ^ B::kSign);
  else
    return B::from((image & B::kSign) ? (image ^ B::kSign) : (~image & B::kMask));
}

template <typename T>
struct SortKey;

// sorted_l1's s keys: (image << 16) | row; t keys: the image
template <>
struct SortKey<__nv_bfloat16> {
  using S = uint32_t;
  static constexpr uint32_t kPad = 0xffffu;   // the largest image
  static __device__ __forceinline__ S pack(uint32_t image, int row) {
    return (image << 16) | (uint32_t)row;
  }
  static __device__ __forceinline__ int row(S key) { return (int)(key & 0xffffu); }
  static __device__ __forceinline__ float value(uint32_t image) {
    return __bfloat162float(key_value<__nv_bfloat16>(image));
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
  static __device__ __forceinline__ float value(uint32_t image) { return key_value<float>(image); }
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

// Where row p of a column lies in shared memory: at p, or (Padded) with one
// 32-bit word skipped after every 128 bytes, so that lanes which each write
// R consecutive rows of one column meet no bank conflict.
template <typename T, bool Padded>
__device__ __forceinline__ int slot(int p) {
  constexpr int EW = 4 / (int)sizeof(T);   // elements a word
  return Padded ? p + EW * (p / (32 * EW)) : p;
}

// The value sort's column stride in elements: room for the padded slots, and
// LD = 1 word (mod 32 words), so that the load's column writes and the
// store's column reads meet no bank conflict.
template <typename T, int NP>
__host__ __device__ constexpr int value_sort_ld() {
  return NP <= kRun ? NP + 33 * (4 / (int)sizeof(T)) : NP + NP / 32 + 33 * (4 / (int)sizeof(T));
}

// ---------------------------------------------------------------------------
// The merge across runs (columns longer than 1024)
// ---------------------------------------------------------------------------

// Where position p of a column lies in the exchange buffer: one slot skipped
// after every 32 keys.
__device__ __forceinline__ int xslot(int p) { return p + (p >> 5); }

// One stage whose partners lie in other runs: position p (1024 run + 32 lane
// + r) meets p ^ mask, and keeps the larger key if p & half, else the
// smaller. `buf` holds the column's keys (n_pad + n_pad / 32 slots); every
// thread of the block calls it, the barriers being __syncthreads.
template <typename K>
__device__ __forceinline__ void exchange(K (&v)[32], K* buf, int run, int lane, int mask,
                                         int half) {
  const int p0 = kRun * run + 32 * lane;
#pragma unroll
  for (int r = 0; r < 32; ++r) buf[xslot(p0 + r)] = v[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int p = p0 + r;
    const K o = buf[xslot(p ^ mask)];
    v[r] = (p & half) ? kmax(v[r], o) : kmin(v[r], o);
  }
  __syncthreads();   // the buffer is written again by the next stage
}

// The merge phases Kb = 2048 .. 1024 RUNS on runs that each leave the
// network ascending (32 keys a lane, one a word). The in-warp stages keep
// the smaller key low without complements: no block descends.
template <int RUNS, typename K>
__device__ __forceinline__ void merge_runs(K (&v)[32], K* buf, int run, int lane) {
#pragma unroll 1
  for (int Kb = 2 * kRun; Kb <= kRun * RUNS; Kb *= 2) {
    exchange(v, buf, run, lane, Kb - 1, Kb / 2);
#pragma unroll 1
    for (int J = Kb / 4; J >= kRun; J /= 2) exchange(v, buf, run, lane, J, J);
    merge<32, kRun / 2>(v, lane);
  }
}

// The same for 16-bit keys two to a word (positions r and r + 16 of a lane):
// one key a word for the exchanges, two for the in-warp stages.
template <int RUNS>
__device__ __forceinline__ void merge_runs_pairs(uint32_t (&w)[16], uint32_t* buf, int run,
                                                 int lane) {
#pragma unroll 1
  for (int Kb = 2 * kRun; Kb <= kRun * RUNS; Kb *= 2) {
    uint32_t v[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = w[i] & 0xffffu;
      v[i + 16] = w[i] >> 16;
    }
    exchange(v, buf, run, lane, Kb - 1, Kb / 2);
#pragma unroll 1
    for (int J = Kb / 4; J >= kRun; J /= 2) exchange(v, buf, run, lane, J, J);
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = v[i] | (v[i + 16] << 16);
    merge_pairs<32, kRun / 2>(w, lane);
  }
}

// Rows 0 .. n - 1 of columns col0 .. col0 + C - 1 of element b of x (and, if
// Twin, of y), as they are, into the columns xs[c * LD + slot(row)] (and ys);
// columns at or past d are left out. VEC elements a load: 16 bytes when d
// allows it, else one; four passes of loads in flight.
template <typename T, int R, int C, int LD, int VEC, bool Padded, bool Twin>
__device__ __forceinline__ void load_columns(const T* __restrict__ x, const T* __restrict__ y,
                                             T* xs, T* ys, int b, int n, int d, int col0) {
  constexpr int NP = 32 * R, PER_ROW = C / VEC, ROWS = kThreads / PER_ROW;
  constexpr int PASSES = (NP + ROWS - 1) / ROWS, BATCH = PASSES < 4 ? PASSES : 4;
  static_assert(PASSES % BATCH == 0, "whole batches of passes");
  struct alignas(sizeof(T) * VEC) Vec { T x[VEC]; };
  const int c0 = (threadIdx.x % PER_ROW) * VEC, r0 = threadIdx.x / PER_ROW;
  if (col0 + c0 >= d) return;   // VEC > 1: d % VEC == 0, the whole vector
#pragma unroll 1
  for (int p0 = 0; p0 < PASSES; p0 += BATCH) {
    Vec xv[BATCH], yv[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = r0 + (p0 + u) * ROWS;
      if (r < n) {
        const size_t at = ((size_t)b * n + r) * d + col0 + c0;
        xv[u] = *reinterpret_cast<const Vec*>(x + at);
        if constexpr (Twin) yv[u] = *reinterpret_cast<const Vec*>(y + at);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = r0 + (p0 + u) * ROWS;
      if (r >= n) continue;
      const int at = slot<T, Padded>(r);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        xs[(c0 + e) * LD + at] = xv[u].x[e];
        if constexpr (Twin) ys[(c0 + e) * LD + at] = yv[u].x[e];
      }
    }
  }
}

// The way back for one tensor of padded columns: rows 0 .. n - 1 of
// xs[c * LD + slot(row)] into columns col0 .. col0 + C - 1 of element b of
// out, stores coalesced along d, VEC elements a store.
template <typename T, int R, int C, int LD, int VEC>
__device__ __forceinline__ void store_columns(const T* xs, T* __restrict__ out, int b, int n,
                                              int d, int col0) {
  constexpr int NP = 32 * R, PER_ROW = C / VEC, ROWS = kThreads / PER_ROW;
  constexpr int PASSES = (NP + ROWS - 1) / ROWS;
  struct alignas(sizeof(T) * VEC) Vec { T x[VEC]; };
  const int c0 = (threadIdx.x % PER_ROW) * VEC, r0 = threadIdx.x / PER_ROW;
  if (col0 + c0 >= d) return;
#pragma unroll 4
  for (int p = 0; p < PASSES; ++p) {
    const int r = r0 + p * ROWS;
    if (r >= n) break;
    const int at = slot<T, true>(r);
    Vec v;
#pragma unroll
    for (int e = 0; e < VEC; ++e) v.x[e] = xs[(c0 + e) * LD + at];
    *reinterpret_cast<Vec*>(out + ((size_t)b * n + r) * d + col0 + c0) = v;
  }
}

// ---------------------------------------------------------------------------
// The value sort
// ---------------------------------------------------------------------------

// One block: element b, columns col0 .. col0 + C - 1 of x, sorted into out.
// RUNS > 1: columns of n_pad = 1024 RUNS (R = 32), RUNS warps a column.
template <typename T, int R, int RUNS = 1>
__global__ void __launch_bounds__(kThreads)
value_sort_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int d, int tiles, int vec) {
  constexpr int NP = 32 * R * RUNS, C = col_tile(NP), LD = value_sort_ld<T, NP>();
  constexpr int VEC = 16 / (int)sizeof(T) < C ? 16 / (int)sizeof(T) : C;
  // 16-bit keys two to a word (positions r and r + R / 2), from R = 2 on
  constexpr bool kPairs = sizeof(T) == 2 && R >= 2;
  constexpr int W = kPairs ? R / 2 : R;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);   // [C][LD] by column, rows at slot(row)
  const int b = blockIdx.x / tiles, col0 = (blockIdx.x % tiles) * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (vec)
    load_columns<T, R * RUNS, C, LD, VEC, true, false>(x, nullptr, xs, nullptr, b, n, d, col0);
  else
    load_columns<T, R * RUNS, C, LD, 1, true, false>(x, nullptr, xs, nullptr, b, n, d, col0);
  __syncthreads();

  if constexpr (RUNS > 1) {
    // warp w takes run w % RUNS of columns w / RUNS, + 8 / RUNS (every warp
    // runs both rounds: the exchanges' barriers are the block's)
    constexpr int G = kWarps / RUNS;
    const int run = warp % RUNS;
    uint32_t* buf = reinterpret_cast<uint32_t*>(smem + C * LD * sizeof(T)) +
                    (warp / RUNS) * (NP + NP / 32);
#pragma unroll 1
    for (int c = warp / RUNS; c < C; c += G) {
      const bool live = col0 + c < d;
      T* col = xs + c * LD;
      uint32_t w[W];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int row = kRun * run + 32 * r + lane;
        const uint32_t k = live && row < n ? key_image(col[slot<T, true>(row)]) : Bits<T>::kMask;
        if (!kPairs || r < W)
          w[r % W] = k;
        else
          w[r % W] |= k << 16;
      }
      if constexpr (kPairs) {
        network_pairs<32>(w, lane);
        merge_runs_pairs<RUNS>(w, buf, run, lane);
      } else {
        network<32>(w, lane);
        merge_runs<RUNS>(w, buf, run, lane);
      }
      // every warp of the column has read its rows (the exchanges' barriers)
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int p = kRun * run + 32 * lane + r;
        if (!live || p >= n) break;
        const uint32_t k = kPairs ? (w[r % W] >> (16 * (r / W))) & 0xffffu : w[r % W];
        col[slot<T, true>(p)] = key_value<T>(k);
      }
    }
  }
  for (int c = warp; RUNS == 1 && c < C && col0 + c < d; c += kWarps) {
    T* col = xs + c * LD;
    // the keys: lane l takes rows l, l + 32, ...; rows at or past n pad
    uint32_t w[W];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = 32 * r + lane;
      const uint32_t k = row < n ? key_image(col[slot<T, true>(row)]) : Bits<T>::kMask;
      if (!kPairs || r < W)
        w[r % W] = k;
      else
        w[r % W] |= k << 16;
    }
    if constexpr (kPairs)
      network_pairs<R>(w, lane);
    else
      network<R>(w, lane);
    __syncwarp();   // every lane has read its rows before any is overwritten
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = lane * R + r;
      if (p >= n) break;
      const uint32_t k = kPairs ? (w[r % W] >> (16 * (r / W))) & 0xffffu : w[r % W];
      col[slot<T, true>(p)] = key_value<T>(k);
    }
  }
  __syncthreads();
  if (vec)
    store_columns<T, R * RUNS, C, LD, VEC>(xs, out, b, n, d, col0);
  else
    store_columns<T, R * RUNS, C, LD, 1>(xs, out, b, n, d, col0);
}

// ---------------------------------------------------------------------------
// sorted_l1 forward
// ---------------------------------------------------------------------------

// One block: element b, columns col0 .. col0 + C - 1. partials[blockIdx.x]
// gets the block's sum of |s_sorted - t_sorted|; sign (int8, [B, n, d])
// gets sign(s_sorted - t_sorted) at the row each s key came from. RUNS > 1:
// columns of n_pad = 1024 RUNS (R = 32), RUNS warps a column.
template <typename T, int R, int RUNS = 1>
__global__ void __launch_bounds__(kThreads, R <= 8 ? 4 : 1)   // R <= 8: 64 registers
sl1_fwd_kernel(const T* __restrict__ s, const T* __restrict__ t, float* __restrict__ partials,
               int8_t* __restrict__ sign, int n, int d, int tiles, int vec) {
  using K = SortKey<T>;
  using S = typename K::S;
  constexpr int NP = 32 * R * RUNS;
  constexpr int C = col_tile(NP);
  constexpr int LD = NP + 4 / (int)sizeof(T);        // conflict-free column writes
  constexpr int LDS = NP + 4;                        // signs: conflict-free row reads
  constexpr int VEC = 16 / (int)sizeof(T) < C ? 16 / (int)sizeof(T) : C;
  // t keys of bf16 two to a word (positions r and r + R / 2), from R = 2 on
  constexpr bool kPairs = sizeof(T) == 2 && R >= 2;
  constexpr int TW = kPairs ? R / 2 : R;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                // [C][LD] s by column
  T* xt = xs + C * LD;                               // [C][LD] t by column
  int8_t* sg = reinterpret_cast<int8_t*>(xt + C * LD);   // [C][LDS] signs by row
  __shared__ float red[kWarps];
  const int b = blockIdx.x / tiles, col0 = (blockIdx.x % tiles) * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (vec)
    load_columns<T, R * RUNS, C, LD, VEC, false, true>(s, t, xs, xt, b, n, d, col0);
  else
    load_columns<T, R * RUNS, C, LD, 1, false, true>(s, t, xs, xt, b, n, d, col0);
  __syncthreads();

  float acc = 0.f;
  if constexpr (RUNS > 1) {
    // as in the value sort: warp w on run w % RUNS of columns w / RUNS, +
    // 8 / RUNS; s keys, then t keys, through one exchange buffer
    constexpr int G = kWarps / RUNS;
    const int run = warp % RUNS;
    unsigned char* xb = reinterpret_cast<unsigned char*>(sg + C * LDS);
    S* sbuf = reinterpret_cast<S*>(xb) + (warp / RUNS) * (NP + NP / 32);
    uint32_t* tbuf = reinterpret_cast<uint32_t*>(xb) + (warp / RUNS) * (NP + NP / 32);
#pragma unroll 1
    for (int c = warp / RUNS; c < C; c += G) {
      const bool live = col0 + c < d;
      S v[32];
      uint32_t w[TW];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int row = kRun * run + 32 * r + lane;
        const bool in = live && row < n;
        v[r] = K::pack(in ? key_image<true>(xs[c * LD + row]) : K::kPad, row);
        const uint32_t ti = in ? key_image<true>(xt[c * LD + row]) : K::kPad;
        if (!kPairs || r < TW)
          w[r % TW] = ti;
        else
          w[r % TW] |= ti << 16;
      }
      network<32>(v, lane);
      merge_runs<RUNS>(v, sbuf, run, lane);
      if constexpr (kPairs) {
        network_pairs<32>(w, lane);
        merge_runs_pairs<RUNS>(w, tbuf, run, lane);
      } else {
        network<32>(w, lane);
        merge_runs<RUNS>(w, tbuf, run, lane);
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int p = kRun * run + 32 * lane + r;
        if (!live || p >= n) break;
        const uint32_t t_image = kPairs ? (w[r % TW] >> (16 * (r / TW))) & 0xffffu : w[r % TW];
        const float diff = K::s_value(v[r]) - K::value(t_image);
        acc += fabsf(diff);
        sg[c * LDS + K::row(v[r])] = (int8_t)((diff > 0.f) - (diff < 0.f));
      }
    }
  }
  for (int c = warp; RUNS == 1 && c < C && col0 + c < d; c += kWarps) {
    // the keys: lane l takes rows l, l + 32, ...; rows at or past n pad
    S v[R];
    uint32_t w[TW];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = 32 * r + lane;
      const bool in = row < n;
      v[r] = K::pack(in ? key_image<true>(xs[c * LD + row]) : K::kPad, row);
      const uint32_t ti = in ? key_image<true>(xt[c * LD + row]) : K::kPad;
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
    for (int i = 0; i < kWarps; ++i) total += red[i];
    partials[blockIdx.x] = total;
  }
  for (int i = threadIdx.x; i < n * C; i += kThreads) {
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

// ---------------------------------------------------------------------------
// The long route (columns longer than 4096)
// ---------------------------------------------------------------------------

constexpr int kChunk = 4 * kRun;         // keys of a group of four warps, 32 a lane
constexpr int kLongCols = 4;             // columns a runs block loads
constexpr int kGroupThreads = 4 * 32;
constexpr int kChunkSlots = kChunk + kChunk / 32;   // a group's exchange buffer (xslot)
constexpr int kLongMaxN = 1 << 30;       // n_pad, positions and rows in 32-bit ints

// The barrier of warp group g (warps 4g .. 4g + 3): named barrier 1 + g.
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(kGroupThreads) : "memory");
}

// `exchange` within a group: position p = 1024 w + 32 lane + r of its 4096
// keys meets p ^ mask and keeps the larger key if p & half, else the smaller.
template <typename K>
__device__ __forceinline__ void group_exchange(K (&v)[32], K* buf, int w, int lane, int g,
                                               int mask, int half) {
  const int p0 = kRun * w + 32 * lane;
#pragma unroll
  for (int r = 0; r < 32; ++r) buf[xslot(p0 + r)] = v[r];
  group_sync(g);
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int p = p0 + r;
    const K o = buf[xslot(p ^ mask)];
    v[r] = (p & half) ? kmax(v[r], o) : kmin(v[r], o);
  }
  group_sync(g);   // the buffer is written again by the next stage
}

// A group's 4096 keys sorted ascending: each warp's 1024 by the network,
// then the merge phases 2048 and 4096 (merge_runs<4> on the group).
template <typename K>
__device__ __forceinline__ void group_sort(K (&v)[32], K* buf, int w, int lane, int g) {
  network<32>(v, lane);
#pragma unroll 1
  for (int kb = 2 * kRun; kb <= kChunk; kb *= 2) {
    group_exchange(v, buf, w, lane, g, kb - 1, kb / 2);
#pragma unroll 1
    for (int j = kb / 4; j >= kRun; j /= 2) group_exchange(v, buf, w, lane, g, j, j);
    merge<32, kRun / 2>(v, lane);
  }
}

// The stages of stride 2048 .. 1 of a merge phase on a group's 4096 keys.
template <typename K>
__device__ __forceinline__ void group_finish(K (&v)[32], K* buf, int w, int lane, int g) {
  group_exchange(v, buf, w, lane, g, kChunk / 2, kChunk / 2);
  group_exchange(v, buf, w, lane, g, kRun, kRun);
  merge<32, kRun / 2>(v, lane);
}

// v (position 1024 w + 32 lane + r) into the buffer in position order.
template <typename K>
__device__ __forceinline__ void group_stage(const K (&v)[32], K* buf, int w, int lane, int g) {
  const int p0 = kRun * w + 32 * lane;
#pragma unroll
  for (int r = 0; r < 32; ++r) buf[xslot(p0 + r)] = v[r];
  group_sync(g);
}

// 4096 keys of device memory into v by way of the buffer (coalesced reads).
template <typename K>
__device__ __forceinline__ void group_load(K (&v)[32], const K* __restrict__ src, K* buf, int w,
                                           int lane, int g) {
  for (int i = 32 * w + lane; i < kChunk; i += kGroupThreads) buf[xslot(i)] = src[i];
  group_sync(g);
  const int p0 = kRun * w + 32 * lane;
#pragma unroll
  for (int r = 0; r < 32; ++r) v[r] = buf[xslot(p0 + r)];
  group_sync(g);
}

// v back to device memory by way of the buffer (coalesced writes).
template <typename K>
__device__ __forceinline__ void group_store(const K (&v)[32], K* __restrict__ dst, K* buf, int w,
                                            int lane, int g) {
  group_stage(v, buf, w, lane, g);
  for (int i = 32 * w + lane; i < kChunk; i += kGroupThreads) dst[i] = buf[xslot(i)];
  group_sync(g);
}

// The long route's s keys: (image << 32) | row, for bf16 as for fp32.
__device__ __forceinline__ unsigned long long long_key(uint32_t image, int row) {
  return ((unsigned long long)image << 32) | (uint32_t)row;
}

// Bytes of a runs block's staged values, before its two exchange buffers.
template <typename T, bool SL1>
__host__ __device__ constexpr size_t long_values_bytes() {
  return ((SL1 ? 2 : 1) * kLongCols * (size_t)(kChunk + 4 / sizeof(T)) * sizeof(T) + 15) / 16 * 16;
}

// Pass 1: block (b, columns col0 .. col0 + 3, run q) sorts rows [4096 q,
// 4096 q + 4096) of its columns into the workspace, [B * d][n_pad] by
// column; groups take columns g and g + 2. The value sort (!SL1): x's key
// images into k32. sorted_l1: s keys (image << 32 | row, -0.0 folded onto
// +0.0) into k64, t's images into k32. Rows past n (the whole run when 4096
// q >= n) are padding: the largest image.
template <typename T, bool SL1>
__global__ void __launch_bounds__(kThreads, 1)
long_runs_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 unsigned long long* __restrict__ k64, uint32_t* __restrict__ k32, int n, int d,
                 int n_pad, int tiles, int vec) {
  constexpr int C = kLongCols, LD = kChunk + 4 / (int)sizeof(T);
  constexpr int VEC = 16 / (int)sizeof(T) < C ? 16 / (int)sizeof(T) : C;
  using K = typename std::conditional<SL1, unsigned long long, uint32_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);   // [C][LD] x (s) by column
  T* ys = xs + C * LD;                  // [C][LD] t by column (SL1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = warp / 4, w = warp % 4;
  K* buf = reinterpret_cast<K*>(smem + long_values_bytes<T, SL1>()) + g * kChunkSlots;
  const int runs = n_pad / kChunk, q = blockIdx.x % runs, bt = blockIdx.x / runs;
  const int b = bt / tiles, col0 = (bt % tiles) * C;
  const int r0 = q * kChunk, rows = n - r0 < kChunk ? n - r0 : kChunk;   // <= 0: all padding

  if (rows > 0) {
    const size_t at = ((size_t)b * n + r0) * d;
    if (vec)
      load_columns<T, kChunk / 32, C, LD, VEC, false, SL1>(x + at, SL1 ? y + at : nullptr, xs, ys,
                                                            0, rows, d, col0);
    else
      load_columns<T, kChunk / 32, C, LD, 1, false, SL1>(x + at, SL1 ? y + at : nullptr, xs, ys,
                                                          0, rows, d, col0);
  }
  __syncthreads();

#pragma unroll 1
  for (int c = g; c < C; c += 2) {
    const bool live = col0 + c < d;
    const size_t at = ((size_t)b * d + col0 + c) * n_pad + r0;
    uint32_t u[32];
    if constexpr (SL1) {
      unsigned long long v[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int row = kRun * w + 32 * r + lane;
        const bool in = live && row < rows;
        v[r] = long_key(in ? key_image<true>(xs[c * LD + row]) : Bits<T>::kMask, r0 + row);
      }
      group_sort(v, buf, w, lane, g);
      if (live) group_store(v, k64 + at, buf, w, lane, g);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int row = kRun * w + 32 * r + lane;
        u[r] = live && row < rows ? key_image<true>(ys[c * LD + row]) : Bits<T>::kMask;
      }
      uint32_t* buf32 = reinterpret_cast<uint32_t*>(buf);
      group_sort(u, buf32, w, lane, g);
      if (live) group_store(u, k32 + at, buf32, w, lane, g);
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int row = kRun * w + 32 * r + lane;
        u[r] = live && row < rows ? key_image(xs[c * LD + row]) : Bits<T>::kMask;
      }
      group_sort(u, buf, w, lane, g);
      if (live) group_store(u, k32 + at, buf, w, lane, g);
    }
  }
}

// Pass 2: one merge stage of stride >= 4096 on every column of the
// workspace, one thread a compare-exchange: position p, whose bit `half` is
// clear, against p | half, or (mirror) against p ^ (2 half - 1); the smaller
// key goes to p. A column holds 2^log_pairs pairs (n_pad / 2).
template <typename K>
__global__ void __launch_bounds__(256)
long_stage_kernel(K* __restrict__ keys, long long pairs, int log_pairs, int half, int mirror) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= pairs) return;
  const int k = (int)(i & ((1LL << log_pairs) - 1));
  const int p = ((k & ~(half - 1)) << 1) | (k & (half - 1));
  const int o = mirror ? p ^ (2 * half - 1) : p | half;
  K* col = keys + ((i >> log_pairs) << (log_pairs + 1));
  const K a = col[p], e = col[o];
  col[p] = kmin(a, e);
  col[o] = kmax(a, e);
}

// Pass 3, the value sort: the stages of stride 2048 .. 1 of a merge phase on
// each 4096-key chunk, two chunks a block (a group each); at the last phase
// the keys are decoded into out at their positions below n.
template <typename T>
__global__ void __launch_bounds__(kThreads)
long_finish_value_kernel(uint32_t* __restrict__ keys, T* __restrict__ out, int n, int d,
                         int n_pad, int last) {
  __shared__ uint32_t bufs[2][kChunkSlots];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = warp / 4, w = warp % 4;
  const int runs = n_pad / kChunk;
  const long long chunk = 2LL * blockIdx.x + g, col = chunk / runs;
  const int q = (int)(chunk % runs);
  uint32_t* src = keys + col * n_pad + (long long)q * kChunk;
  uint32_t v[32];
  group_load(v, src, bufs[g], w, lane, g);
  group_finish(v, bufs[g], w, lane, g);
  if (!last) {
    group_store(v, src, bufs[g], w, lane, g);
    return;
  }
  group_stage(v, bufs[g], w, lane, g);
  const long long b = col / d, j = col % d;
  for (int i = 32 * w + lane; i < kChunk && q * kChunk + i < n; i += kGroupThreads)
    out[(b * n + q * kChunk + i) * d + j] = key_value<T>(bufs[g][xslot(i)]);
}

// Bytes of the sorted_l1 finish's buffers: a chunk of s keys and one of t.
constexpr size_t kFinishSl1Bytes = kChunkSlots * (sizeof(unsigned long long) + sizeof(uint32_t));

// Pass 3, sorted_l1: one chunk a block, its s keys by group 0 and its t keys
// by group 1, each through the stages of stride 2048 .. 1. At the last
// phase group 1 leaves the t images in its buffer in position order and
// group 0 forms, at each position below n, |s - t| into the block's fp32
// partial (partials[blockIdx.x]: lanes, then warps in order) and sign(s - t)
// at the row its s key carries.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
long_finish_sl1_kernel(unsigned long long* __restrict__ k64, uint32_t* __restrict__ k32,
                       float* __restrict__ partials, int8_t* __restrict__ sign, int n, int d,
                       int n_pad, int last) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* sbuf = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* tbuf = reinterpret_cast<uint32_t*>(sbuf + kChunkSlots);
  __shared__ float red[4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = warp / 4, w = warp % 4;
  const int runs = n_pad / kChunk, q = blockIdx.x % runs;
  const long long col = blockIdx.x / runs, at = col * n_pad + (long long)q * kChunk;
  unsigned long long v[32];
  if (g == 0) {
    group_load(v, k64 + at, sbuf, w, lane, g);
    group_finish(v, sbuf, w, lane, g);
    if (!last) group_store(v, k64 + at, sbuf, w, lane, g);
  } else {
    uint32_t u[32];
    group_load(u, k32 + at, tbuf, w, lane, g);
    group_finish(u, tbuf, w, lane, g);
    if (!last)
      group_store(u, k32 + at, tbuf, w, lane, g);
    else
      group_stage(u, tbuf, w, lane, g);
  }
  if (!last) return;
  __syncthreads();   // the t images are in tbuf
  float acc = 0.f;
  if (g == 0) {
    const long long b = col / d, j = col % d;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int p = kRun * w + 32 * lane + r;
      if (q * kChunk + p >= n) break;
      const float diff = SortKey<T>::value((uint32_t)(v[r] >> 32)) - SortKey<T>::value(tbuf[xslot(p)]);
      acc += fabsf(diff);
      sign[(b * n + (uint32_t)v[r]) * d + j] = (int8_t)((diff > 0.f) - (diff < 0.f));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) red[w] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) partials[blockIdx.x] = red[0] + red[1] + red[2] + red[3];
}

inline bool bad_shape(int B, int n, int d) {
  if (B < 1 || d < 1 || n < 2 || n > kMaxN) return true;
  const int C = col_tile(next_pow2(n));
  return (long long)B * ((d + C - 1) / C) > 0x7fffffffLL;
}

// The long route's shapes: n from 4097 to 2^30 and every grid within its
// limit (the runs, B * ceil(d / 4) * n_pad / 4096 blocks; the stages, B * d *
// n_pad / 2 threads; the sorted_l1 finish, B * d * n_pad / 4096 blocks).
inline bool bad_long_shape(long long B, int n, int d) {
  if (B < 1 || d < 1 || n <= kMaxN || n > kLongMaxN) return true;
  const long long n_pad = next_pow2(n), runs = n_pad / kChunk, cols = B * d;
  return B * ((d + kLongCols - 1) / kLongCols) * runs > 0x7fffffffLL ||
         cols * n_pad / 2 / 256 > 0x7fffffffLL || cols * runs > 0x7fffffffLL;
}

// f(integral_constant<int, R>(), integral_constant<int, RUNS>()) for the keys
// a lane, R = min(n_pad, 1024) / 32, and the runs a column, n_pad / 1024 from
// 2048 on (else 1).
template <typename F>
int by_keys_a_lane(int n, F f) {
  using std::integral_constant;
  const int n_pad = next_pow2(n);
  const integral_constant<int, 1> one;
  if (n_pad <= 32) return f(integral_constant<int, 1>(), one);
  if (n_pad == 64) return f(integral_constant<int, 2>(), one);
  if (n_pad == 128) return f(integral_constant<int, 4>(), one);
  if (n_pad == 256) return f(integral_constant<int, 8>(), one);
  if (n_pad == 512) return f(integral_constant<int, 16>(), one);
  if (n_pad == 1024) return f(integral_constant<int, 32>(), one);
  if (n_pad == 2048) return f(integral_constant<int, 32>(), integral_constant<int, 2>());
  return f(integral_constant<int, 32>(), integral_constant<int, 4>());
}

// Bytes of the exchange buffer of a block whose columns have RUNS runs.
template <typename K, int RUNS>
constexpr size_t exchange_bytes() {
  return RUNS > 1 ? (size_t)(kWarps / RUNS) * (kRun * RUNS + kRun * RUNS / 32) * sizeof(K) : 0;
}

// 16-byte loads and stores when every row segment of a column tile is 16-byte
// aligned in each tensor.
template <typename T>
int vectorised(int d, const void* a, const void* b) {
  return d % (16 / (int)sizeof(T)) == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
}

template <typename T, int R, int RUNS>
int launch_sort(const T* x, T* out, int B, int n, int d, cudaStream_t st) {
  constexpr int NP = 32 * R * RUNS, C = col_tile(NP);
  const size_t bytes =
      (size_t)C * value_sort_ld<T, NP>() * sizeof(T) + exchange_bytes<uint32_t, RUNS>();
  cudaError_t e = cudaFuncSetAttribute(value_sort_kernel<T, R, RUNS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (d + C - 1) / C;
  value_sort_kernel<T, R, RUNS><<<B * tiles, kThreads, bytes, st>>>(x, out, n, d, tiles,
                                                                    vectorised<T>(d, x, out));
  return (int)cudaGetLastError();
}

template <typename T>
int run_sort(const void* x, void* out, int B, int n, int d, cudaStream_t st) {
  return by_keys_a_lane(n, [&](auto r, auto runs) {
    return launch_sort<T, decltype(r)::value, decltype(runs)::value>((const T*)x, (T*)out, B, n,
                                                                     d, st);
  });
}

template <typename T, int R, int RUNS>
int launch_sl1_fwd(const T* s, const T* t, float* partials, int8_t* sign, int B, int n, int d,
                   cudaStream_t st) {
  constexpr int NP = 32 * R * RUNS, C = col_tile(NP);
  const size_t bytes = (size_t)C * (NP + 4 / sizeof(T)) * 2 * sizeof(T) + (size_t)C * (NP + 4) +
                       exchange_bytes<typename SortKey<T>::S, RUNS>();
  cudaError_t e = cudaFuncSetAttribute(sl1_fwd_kernel<T, R, RUNS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (d + C - 1) / C;
  sl1_fwd_kernel<T, R, RUNS><<<B * tiles, kThreads, bytes, st>>>(s, t, partials, sign, n, d,
                                                                 tiles, vectorised<T>(d, s, t));
  return (int)cudaGetLastError();
}

template <typename T>
int run_sl1_fwd(const void* s, const void* t, float* partials, int8_t* sign, int B, int n,
                int d, cudaStream_t st) {
  return by_keys_a_lane(n, [&](auto r, auto runs) {
    return launch_sl1_fwd<T, decltype(r)::value, decltype(runs)::value>(
        (const T*)s, (const T*)t, partials, sign, B, n, d, st);
  });
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

template <typename T, bool SL1>
int launch_long_runs(const void* x, const void* y, void* k64, void* k32, int B, int n, int d,
                     cudaStream_t st) {
  const int n_pad = next_pow2(n), tiles = (d + kLongCols - 1) / kLongCols;
  const size_t bytes = long_values_bytes<T, SL1>() +
                       2 * (size_t)kChunkSlots * (SL1 ? sizeof(unsigned long long) : sizeof(uint32_t));
  cudaError_t e = cudaFuncSetAttribute(long_runs_kernel<T, SL1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  long_runs_kernel<T, SL1><<<B * tiles * (n_pad / kChunk), kThreads, bytes, st>>>(
      (const T*)x, (const T*)y, (unsigned long long*)k64, (uint32_t*)k32, n, d, n_pad, tiles,
      vectorised<T>(d, x, SL1 ? y : x));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_long_finish_value(void* keys, void* out, int B, int n, int d, int last,
                             cudaStream_t st) {
  const long long n_pad = next_pow2(n), blocks = (long long)B * d * (n_pad / kChunk) / 2;
  long_finish_value_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>((uint32_t*)keys, (T*)out, n,
                                                                     d, (int)n_pad, last);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_long_finish_sl1(void* k64, void* k32, void* partials, void* sign, int B, int n, int d,
                           int last, cudaStream_t st) {
  const long long n_pad = next_pow2(n), blocks = (long long)B * d * (n_pad / kChunk);
  cudaError_t e = cudaFuncSetAttribute(long_finish_sl1_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kFinishSl1Bytes);
  if (e != cudaSuccess) return (int)e;
  long_finish_sl1_kernel<T><<<(unsigned)blocks, kThreads, kFinishSl1Bytes, st>>>(
      (unsigned long long*)k64, (uint32_t*)k32, (float*)partials, (int8_t*)sign, n, d,
      (int)n_pad, last);
  return (int)cudaGetLastError();
}

}  // namespace

// Loss partials per batch element of the sorted_l1 forward: its column tiles
// up to n = 4096; on the long route one per column and 4096-row chunk.
extern "C" int dk_sort_tiles(int n, int d) {
  if (n > kMaxN) return bad_long_shape(1, n, d) ? -1 : d * (next_pow2(n) / kChunk);
  if (bad_shape(1, n, d)) return -1;
  const int C = col_tile(next_pow2(n));
  return (d + C - 1) / C;
}

// x, out: [B, n, d] contiguous, n <= 4096, of the dtype that `dtype` names:
// 0 fp32, 1 bf16, 2 fp16, 3 int32. Returns a CUDA error code (0 = launched).
extern "C" int dk_sort_bitonic(const void* x, void* out, int B, int n, int d, int dtype,
                               void* stream) {
  if (bad_shape(B, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return run_sort<float>(x, out, B, n, d, st);
    case 1: return run_sort<__nv_bfloat16>(x, out, B, n, d, st);
    case 2: return run_sort<__half>(x, out, B, n, d, st);
    case 3: return run_sort<int32_t>(x, out, B, n, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// s, t: [B, n, d] contiguous, n <= 4096, one dtype; partials: fp32 [B *
// dk_sort_tiles(n, d)];
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

// The long route (4096 < n <= 2^30), its passes in the order ops/sort.py
// `long_schedule` gives; every call returns a CUDA error code (0 =
// launched). The workspace: k32, [B * d][n_pad] uint32 (the value sort's
// keys, or sorted_l1's t keys), and for sorted_l1 k64, [B * d][n_pad]
// uint64 (its s keys).
//
// Pass 1. x: [B, n, d] contiguous; y: null for the value sort (x of the dtype
// `dtype` names, as dk_sort_bitonic), else sorted_l1's t beside s = x (dtype 0
// fp32 or 1 bf16).
extern "C" int dk_sort_long_runs(const void* x, const void* y, void* k64, void* k32, int B, int n,
                                 int d, int dtype, void* stream) {
  if (bad_long_shape(B, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (y) {
    switch (dtype) {
      case 0: return launch_long_runs<float, true>(x, y, k64, k32, B, n, d, st);
      case 1: return launch_long_runs<__nv_bfloat16, true>(x, y, k64, k32, B, n, d, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (dtype) {
    case 0: return launch_long_runs<float, false>(x, y, k64, k32, B, n, d, st);
    case 1: return launch_long_runs<__nv_bfloat16, false>(x, y, k64, k32, B, n, d, st);
    case 2: return launch_long_runs<__half, false>(x, y, k64, k32, B, n, d, st);
    case 3: return launch_long_runs<int32_t, false>(x, y, k64, k32, B, n, d, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Pass 2, one stage on `keys` ([cols][n_pad] of key_bytes 4 or 8 each): the
// pairs (p, p | half), or with `mirror` (p, p ^ (2 half - 1)), over the
// positions p whose bit `half` is clear; 4096 <= half < n_pad.
extern "C" int dk_sort_long_stage(void* keys, int key_bytes, long long cols, int n_pad, int half,
                                  int mirror, void* stream) {
  if (cols < 1 || n_pad <= kChunk || n_pad > kLongMaxN || (n_pad & (n_pad - 1)) ||
      half < kChunk || half >= n_pad || (half & (half - 1)))
    return (int)cudaErrorInvalidValue;
  int log_pairs = 0;
  while ((2 << log_pairs) < n_pad) ++log_pairs;
  const long long pairs = cols * (n_pad / 2), blocks = (pairs + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (key_bytes == 8)
    long_stage_kernel<unsigned long long><<<(unsigned)blocks, 256, 0, st>>>(
        (unsigned long long*)keys, pairs, log_pairs, half, mirror);
  else if (key_bytes == 4)
    long_stage_kernel<uint32_t><<<(unsigned)blocks, 256, 0, st>>>((uint32_t*)keys, pairs,
                                                                  log_pairs, half, mirror);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Pass 3 of the value sort: the finish of a merge phase on k32; with `last`
// (the phase of block size n_pad) the sorted values into out, [B, n, d]
// contiguous of x's dtype.
extern "C" int dk_sort_long_finish_value(void* k32, void* out, int B, int n, int d, int dtype,
                                         int last, void* stream) {
  if (bad_long_shape(B, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_long_finish_value<float>(k32, out, B, n, d, last, st);
    case 1: return launch_long_finish_value<__nv_bfloat16>(k32, out, B, n, d, last, st);
    case 2: return launch_long_finish_value<__half>(k32, out, B, n, d, last, st);
    case 3: return launch_long_finish_value<int32_t>(k32, out, B, n, d, last, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Pass 3 of the sorted_l1 forward: the finish on k64 and k32; with `last` the
// loss partials (fp32 [B * dk_sort_tiles(n, d)]) and the signs (int8 [B, n,
// d], at the row each s came from), as dk_sort_sl1_fwd writes them.
extern "C" int dk_sort_long_finish_sl1(void* k64, void* k32, void* partials, void* sign, int B,
                                       int n, int d, int is_bf16, int last, void* stream) {
  if (bad_long_shape(B, n, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_long_finish_sl1<__nv_bfloat16>(k64, k32, partials, sign, B, n, d, last, st)
                 : launch_long_finish_sl1<float>(k64, k32, partials, sign, B, n, d, last, st);
}
