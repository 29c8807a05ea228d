// Lanes flags of the GC-content, homopolymer and no-ambiguous filters for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes these flags with XLA
// element-wise ops (genome_kmers_tpu/ops/filters.py, *_lanes_flags*). It
// takes the place of the plain versions in ops/filters.py
// (gc_lanes_flags4, noamb_lanes_flags4, homopoly_lanes_flags4,
// gc_lanes_flags2, homopoly_lanes_flags2), which it equals bit for bit:
// each row's survivor flag and raise conditions from the row's sorted key
// words, its position and (2-bit lanes) its cap.
//
// Why it was added: the plain versions widen every int32 word to int64 and
// run the SWAR steps as separate element-wise ops, 245-310 launches that
// each read and write full-length int64 tensors: 354-452 ms a filter at
// 2.49e8 rows on an H100, some 180-260 times the bound.
//
// What bounds it: device memory. A row reads only the words that the
// filter's k_f reaches (4 B each on int32 lanes, 8 B on int64 lanes), its
// int64 position where the filter has an overflow condition, its int64 cap
// on 2-bit lanes that carry one, and writes one byte for the survivor flag
// and one for each raise condition: at k_f = 31 on 4-bit lanes 18 B a row
// (GC) or 26-27 B (homopolymer, no-ambiguous).
//
// Design:
// * One kernel, templated on the filter and width (Kind), on the number of
//   words the filter's k_f reaches (NW, so the word loop unrolls) and on
//   the element type of the word lanes (W: int32 bit patterns, or int64
//   lanes holding uint32 values, whose low half is read).
// * A persistent grid of as many blocks as the SMs hold at once; each
//   thread walks quads of 4 consecutive rows in grid-stride order. Every
//   lane is its own 1-D array, so neighbouring threads load neighbouring
//   16-byte pieces of one lane: a quad's 4 words of an int32 lane in one
//   16-byte load, of an int64 lane (positions, caps, 2-bit words) in two.
//   Where some input lane is not 16-byte aligned (a slice at an odd
//   offset) every quad loads row by row instead; a ragged last quad does
//   too. The outputs are fresh allocations: a quad's 4 flags of one output
//   leave in one 32-bit store (byte stores for the ragged last quad).
// * All arithmetic is 32-bit in registers. Nibble (4-bit) and field (2-bit)
//   tests keep one bit a field at the field's lowest bit; the words' bits
//   are OR-ed into one register at distinct offsets so that one __popc
//   counts the G/C bases (or the kept nonzero nibbles) of all the words.
// * The flags that need no word (a homopolymer filter whose k_f is below
//   max_h: every row passes; an impossible GC range: no row passes) skip
//   the word loads; such a call still launches once.

#include <cstdint>
#include <cuda_runtime.h>

// The kernel's arguments; kernels/lanes_flags.py::_Args mirrors them field
// for field. Outside the unnamed namespace, so that the C entry point that
// takes them keeps external linkage.
struct LanesFlagsArgs {
  const void* words[8];  // the word lanes, W elements each
  const int64_t* pos;    // positions; null where the filter reads none
  const int64_t* cap;    // 2-bit cap lane; null: every row's cap is cap_const
  uint8_t* out[3];       // survivor flag, then the raise conditions
  int64_t n;             // rows
  int64_t thr;           // overflow threshold: position >= thr raises
  int64_t cap_const;
  int64_t k;             // k_f
  int64_t lo, hi;        // GC: the allowed G/C count range
  int64_t max_h;         // homopolymer: the longest allowed run
  uint32_t keep[8];      // per word: the bits of the fields below k_f
  int32_t mode;          // kRows, or kConstant (no word is read)
  int32_t aligned;       // every input lane is 16-byte aligned
  int32_t n_out;         // outputs written (2 or 3)
};

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kLsb4 = 0x11111111u;  // the lowest bit of every nibble
constexpr uint32_t kLsb2 = 0x55555555u;  // the lowest bit of every 2-bit field

enum Kind : int { kGc4 = 0, kNoamb4 = 1, kHomopoly4 = 2, kGc2 = 3, kHomopoly2 = 4 };
enum Mode : int { kRows = 0, kConstant = 1 };


__device__ __forceinline__ bool needs_pos(int kind) { return kind != kGc4 && kind != kGc2; }
__device__ __forceinline__ bool two_bit(int kind) { return kind == kGc2 || kind == kHomopoly2; }

// Bits 0..7 = bits 0, 4, ..., 28 of z (z has no other bits set): each 16-bit
// half through one multiply, whose 16 partial products land on distinct bits
// (4s + 3t, s, t in 0..3), so nothing carries; bit 9 + s holds bit 4s.
__device__ __forceinline__ uint32_t compress_nibble_bits(uint32_t z) {
  const uint32_t lo = ((z & 0x1111u) * 0x249u >> 9) & 0xFu;
  const uint32_t hi = (((z >> 16) & 0x1111u) * 0x249u >> 9) & 0xFu;
  return lo | (hi << 4);
}

// Bits 0..15 = the even bits 0, 2, ..., 30 of x (the odd bits must be 0).
__device__ __forceinline__ uint32_t compress_even_bits(uint32_t x) {
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// 0xFFFFFFFF << s, s clamped to [0, 31] (the plain versions' clamp).
__device__ __forceinline__ uint32_t ones_shl(int64_t s) {
  const int t = s < 0 ? 0 : s > 31 ? 31 : static_cast<int>(s);
  return 0xFFFFFFFFu << t;
}

// The shift-AND run fold of the plain versions, step for step (doubling
// steps capped at cap_t): nonzero iff `run` consecutive bits are set.
template <typename T, int kSteps>
__device__ __forceinline__ bool run_fold(T x, int64_t run) {
  constexpr int kCaps[7] = {1, 2, 4, 8, 16, 16, 16};
  int64_t rem = run - 1;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t t = kCaps[s] < rem ? kCaps[s] : rem;
    if (t <= 0) break;
    x &= x >> t;
    rem -= t;
  }
  return x != 0;
}

// The 64-bit eq stream (flag of base j at bit 63 - j) kept to bases j < m.
__device__ __forceinline__ uint64_t stream_keep64(int64_t m) {
  const uint64_t hi = ones_shl(32 - m);
  const uint64_t lo = m > 32 ? ones_shl(64 - m) : 0u;
  return (hi << 32) | lo;
}

// One row's flags: bit 0 survives, bit 1 + c raise condition c.
template <int kKind, int kNW>
__device__ __forceinline__ uint32_t row_flags(const uint32_t (&w)[kNW], int64_t pos, int64_t cap,
                                              const LanesFlagsArgs& a) {
  if constexpr (kKind == kGc4 || kKind == kNoamb4) {
    uint32_t zero = 0, acc0 = 0, acc1 = 0;
#pragma unroll
    for (int i = 0; i < kNW; ++i) {
      const uint32_t x = w[i], s1 = x >> 1, s2 = x >> 2, s3 = x >> 3;
      const uint32_t kept = a.keep[i] & kLsb4;
      zero |= ~(x | s1 | s2 | s3) & kept;  // a zero nibble among the kept: the cap
      uint32_t hit;
      if constexpr (kKind == kGc4) {
        hit = ~s3 & x & (s1 ^ s2);  // the nibble is C (0011) or G (0101)
      } else {
        // the nibble is neither 0 ('$', past the cap) nor A 0001, C 0011,
        // G 0101, T 1100: ambiguous
        const uint32_t ok = (~s3 & ((~s2 & ~s1 & ~x) | (x & ~(s1 & s2)))) | (s3 & s2 & ~s1 & ~x);
        hit = ~ok;
      }
      hit &= kept;
      if (i < 4) acc0 |= hit << i; else acc1 |= hit << (i - 4);
    }
    const bool trunc = zero != 0;
    if constexpr (kKind == kGc4) {
      const int64_t gc = __popc(acc0) + (kNW > 4 ? __popc(acc1) : 0);
      const bool under = gc <= a.hi;
      return (!trunc && gc >= a.lo && under) | ((trunc && under) << 1);
    } else {
      const bool amb = (acc0 | acc1) != 0;
      // an ambiguous base found before the '$' fails without raising
      return (!trunc && !amb) | ((pos >= a.thr) << 1) | ((trunc && !amb) << 2);
    }
  } else if constexpr (kKind == kHomopoly4) {
    uint32_t zero = 0, kept_nonzero = 0, e = 0;
#pragma unroll
    for (int i = 0; i < kNW; ++i) {
      const uint32_t x = w[i];
      const uint32_t kept = a.keep[i] & kLsb4;
      const uint32_t nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & kLsb4;
      zero |= ~nz & kept;
      kept_nonzero |= (nz & kept) << i;
      const uint32_t y = x ^ (x >> 4);  // nibble slot s: field 7-s against the field before it
      const uint32_t eq = ~(y | (y >> 1) | (y >> 2) | (y >> 3)) & kLsb4;
      uint32_t c = compress_nibble_bits(eq) & 0x7Fu;  // bit 7 - j: base j equals base j - 1
      if (i > 0) c |= static_cast<uint32_t>((w[i - 1] & 0xFu) == (x >> 28)) << 7;
      e |= c << (24 - 8 * i);
    }
    const int64_t capv = __popc(kept_nonzero);
    const bool run_bad = run_fold<uint32_t, 5>(e & ones_shl(32 - a.k), a.max_h);
    // raise preemption: only the flags below the row's truncation point
    const bool run_bad_cap = run_fold<uint32_t, 5>(e & ones_shl(32 - capv), a.max_h);
    return !run_bad | (((pos >= a.thr) || (zero != 0 && !run_bad_cap)) << 1);
  } else if constexpr (kKind == kGc2) {
    uint32_t acc = 0;
    int64_t gc = 0;
#pragma unroll
    for (int i = 0; i < kNW; ++i) {
      const uint32_t x = w[i] & a.keep[i];
      // per 2-bit field, b1 ^ b0 == 1 exactly for C (01) and G (10)
      const uint32_t hit = ((x >> 1) ^ x) & kLsb2;
      if (i % 2 == 0) {
        acc = hit;
      } else {
        gc += __popc(acc | (hit << 1));
        acc = 0;
      }
    }
    if constexpr (kNW % 2 != 0) gc += __popc(acc);
    const bool trunc = cap < a.k;
    const bool under = gc <= a.hi;
    return (!trunc && gc >= a.lo && under) | ((trunc && under) << 1);
  } else {  // kHomopoly2
    uint64_t e = 0;
#pragma unroll
    for (int i = 0; i < kNW; ++i) {
      const uint32_t x = w[i];
      const uint32_t same = ~(x ^ (x >> 2));
      uint32_t c = compress_even_bits(same & (same >> 1) & kLsb2) & 0x7FFFu;  // bit 15 - j
      if (i > 0) c |= static_cast<uint32_t>((w[i - 1] & 3u) == (x >> 30)) << 15;
      e |= static_cast<uint64_t>(c) << (48 - 16 * i);
    }
    const int64_t m = cap < a.k ? cap : a.k;
    const bool run_bad = run_fold<uint64_t, 7>(e & stream_keep64(a.k), a.max_h);
    const bool run_bad_cap = run_fold<uint64_t, 7>(e & stream_keep64(m), a.max_h);
    return !run_bad | (((pos >= a.thr) || (cap < a.k && !run_bad_cap)) << 1);
  }
}

// A quad's 4 values of one lane: one 16-byte load per 4 (int32) or 2
// (int64) rows where `vec`, else row by row, rows at and past n read 0.
template <typename W>
__device__ __forceinline__ void load_quad(const void* lane, int64_t q, int64_t n, bool vec,
                                          uint32_t (&v)[4]) {
  if (vec) {
    if constexpr (sizeof(W) == 4) {
      const uint4 t = __ldcs(reinterpret_cast<const uint4*>(lane) + q);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const ulonglong2 t0 = __ldcs(reinterpret_cast<const ulonglong2*>(lane) + 2 * q);
      const ulonglong2 t1 = __ldcs(reinterpret_cast<const ulonglong2*>(lane) + 2 * q + 1);
      v[0] = static_cast<uint32_t>(t0.x); v[1] = static_cast<uint32_t>(t0.y);
      v[2] = static_cast<uint32_t>(t1.x); v[3] = static_cast<uint32_t>(t1.y);
    }
  } else {
    const W* p = static_cast<const W*>(lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = 4 * q + j;
      v[j] = r < n ? static_cast<uint32_t>(p[r]) : 0u;
    }
  }
}

__device__ __forceinline__ void load_quad64(const int64_t* lane, int64_t q, int64_t n, bool vec,
                                            int64_t (&v)[4]) {
  if (vec) {
    const longlong2 t0 = __ldcs(reinterpret_cast<const longlong2*>(lane) + 2 * q);
    const longlong2 t1 = __ldcs(reinterpret_cast<const longlong2*>(lane) + 2 * q + 1);
    v[0] = t0.x; v[1] = t0.y; v[2] = t1.x; v[3] = t1.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = 4 * q + j;
      v[j] = r < n ? lane[r] : 0;
    }
  }
}

template <int kKind, int kNW, typename W>
__global__ void __launch_bounds__(kThreads) lanes_flags_kernel(const LanesFlagsArgs a) {
  const int64_t n_quads = (a.n + 3) / 4;
  const int64_t full = a.n / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; q < n_quads;
       q += stride) {
    const bool whole = q < full;
    const bool vec = whole && a.aligned;
    int64_t pos[4] = {0, 0, 0, 0};
    int64_t cap[4] = {a.cap_const, a.cap_const, a.cap_const, a.cap_const};
    if (needs_pos(kKind)) load_quad64(a.pos, q, a.n, vec, pos);
    uint32_t flags[4];
    if (a.mode == kConstant) {
      // GC over an impossible range: nothing passes or raises; homopolymer
      // with k_f below max_h: every row passes, only the overflow raises
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        flags[j] = kKind == kGc4 || kKind == kGc2 ? 0u : 1u | ((pos[j] >= a.thr) << 1);
      }
    } else {
      if (two_bit(kKind) && a.cap != nullptr) load_quad64(a.cap, q, a.n, vec, cap);
      uint32_t words[kNW][4];
#pragma unroll
      for (int i = 0; i < kNW; ++i) load_quad<W>(a.words[i], q, a.n, vec, words[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w[kNW];
#pragma unroll
        for (int i = 0; i < kNW; ++i) w[i] = words[i][j];
        flags[j] = row_flags<kKind, kNW>(w, pos[j], cap[j], a);
      }
    }
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      if (o >= a.n_out) break;
      if (whole) {
        uint32_t packed = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) packed |= ((flags[j] >> o) & 1u) << (8 * j);
        reinterpret_cast<uint32_t*>(a.out[o])[q] = packed;
      } else {
        for (int j = 0; j < 4 && 4 * q + j < a.n; ++j) {
          a.out[o][4 * q + j] = static_cast<uint8_t>((flags[j] >> o) & 1u);
        }
      }
    }
  }
}

using KernelFn = void (*)(LanesFlagsArgs);

template <int kKind, typename W>
KernelFn pick(int n_words) {
  switch (n_words) {
    case 1: return lanes_flags_kernel<kKind, 1, W>;
    case 2: return lanes_flags_kernel<kKind, 2, W>;
    case 3: return lanes_flags_kernel<kKind, 3, W>;
    case 4: return lanes_flags_kernel<kKind, 4, W>;
    default: break;
  }
  if constexpr (kKind == kGc4 || kKind == kNoamb4) {
    switch (n_words) {
      case 5: return lanes_flags_kernel<kKind, 5, W>;
      case 6: return lanes_flags_kernel<kKind, 6, W>;
      case 7: return lanes_flags_kernel<kKind, 7, W>;
      case 8: return lanes_flags_kernel<kKind, 8, W>;
      default: break;
    }
  }
  return nullptr;
}

KernelFn pick_kernel(int kind, int n_words, int word_bytes) {
  if (word_bytes == 4) {
    switch (kind) {
      case kGc4: return pick<kGc4, uint32_t>(n_words);
      case kNoamb4: return pick<kNoamb4, uint32_t>(n_words);
      case kHomopoly4: return pick<kHomopoly4, uint32_t>(n_words);
      case kGc2: return pick<kGc2, uint32_t>(n_words);
      case kHomopoly2: return pick<kHomopoly2, uint32_t>(n_words);
      default: return nullptr;
    }
  }
  if (word_bytes == 8) {
    switch (kind) {
      case kGc2: return pick<kGc2, uint64_t>(n_words);
      case kHomopoly2: return pick<kHomopoly2, uint64_t>(n_words);
      default: return nullptr;
    }
  }
  return nullptr;
}

}  // namespace

// The flags of `args->n` rows (see LanesFlagsArgs) for filter `kind` over
// `n_words` word lanes of `word_bytes`-byte elements, on `stream`. Returns
// cudaErrorInvalidValue for a combination without a kernel, else the first
// CUDA error of the launch (cudaGetLastError()), 0 on success.
extern "C" int gkt_lanes_flags(int kind, int n_words, int word_bytes,
                               const LanesFlagsArgs* args, void* stream) {
  if (args->n <= 0) return 0;
  const KernelFn kernel = pick_kernel(kind, n_words, word_bytes);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t n_quads = (args->n + 3) / 4;
  const int64_t needed = (n_quads + kThreads - 1) / kThreads;
  const int64_t blocks = needed < resident ? needed : resident;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}
