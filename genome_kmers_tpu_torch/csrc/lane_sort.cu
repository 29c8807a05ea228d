// Multi-lane bitonic sort for Hopper (sm_90a).
//
// Replaces the TPU kernel genome_kmers_tpu/ops/pallas_sort.py::
// bitonic_sort_tile and widens its contract from one on-chip tile to any
// power-of-two length. A row is one element from each of 1..8 uint32 lanes;
// rows are sorted ascending, lexicographically over ALL lanes, most
// significant lane first, compared as unsigned, and the lanes of a row move
// together. The network is the classic bitonic one: at stage L and distance
// d, row i meets row i XOR d, ascending iff (i & L) == 0 with i the GLOBAL
// row index. It is not stable; the caller makes the last lane unique (the
// position), so the order is total and the result is the one a stable
// lexicographic sort gives. Its plain version is ops/sort.py::sort_lanes.
//
// What bounds it: device memory. The least the card could do is read and
// write every lane once (2 * 4 * lanes * n bytes); the network needs
// log2(n) * (log2(n) + 1) / 2 compare-exchange steps, and a step taken in
// global memory reads and writes all of it again.
//
// Design: one kernel, `tile_pass`, does every pass. A block of 512 threads
// takes a tile of 4096 rows; each thread holds 8 rows of every lane in
// registers and runs as many steps as the tile allows before the rows go
// back to global memory:
//   * a step whose distance lies inside the thread's 8 rows (spacing h, so
//     distances h, 2h, 4h) is a compare-exchange between registers;
//   * a step at distance < 32 is a warp shuffle (the thread's rows are then
//     32 apart, so lane t of a warp holds row t of eight 32-row runs);
//   * between those, the rows are regrouped through shared memory (struct
//     of arrays, two block barriers) to a spacing of 512, 64 or 32; every
//     spacing keeps neighbouring threads on neighbouring words, so shared
//     memory sees no bank conflict and global memory whole 128-byte lines.
// The tile is a rectangle of the row index space: R runs of C consecutive
// rows, the runs `stride` rows apart (R * C = 4096, C >= 32). With C = 4096
// it is one contiguous piece: the first pass sorts every piece (stages
// L = 2..4096), and each later stage ends with one such pass for its
// distances 2048..1. With the runs d rows apart a pass takes the log2(R)
// distances d * R / 2 .. d of a stage (at most 7, and all >= 4096) that a
// contiguous tile cannot reach. At n = 2^27 that is 1 + 15 contiguous and
// 24 strided passes over the data for the 378 steps.
// Row indices are 64-bit: n * 4 bytes may pass 2^31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 8;
constexpr int kThreads = 512;
constexpr int kRowsPerThread = 8;
constexpr int kTile = kThreads * kRowsPerThread;  // rows a block holds
constexpr int kLog2Tile = 12;
constexpr int kMaxStepsPerPass = 7;  // runs of at least 32 rows: 128 runs

struct Lanes {
  uint32_t* p[kMaxLanes];
};

// Where a tile lies in the row index space: tile index t is global row
// base + (t >> log2c << log2_stride) + (t & (C - 1)), C = 1 << log2c.
struct Tile {
  long long base;
  int log2c;
  int log2_stride;
  __device__ __forceinline__ long long row(int t) const {
    return base + (static_cast<long long>(t >> log2c) << log2_stride) + (t & ((1 << log2c) - 1));
  }
};

// Compares rows a and b lexicographically over the lanes, unsigned: gt is
// a > b, eq is a == b. The lanes after the first are looked at only while
// some thread of the warp still has a tie (a vote, so every thread of the
// warp must call this together): on k-mer keys nearly every pair is decided
// by its first word or two, and the integer units bound this kernel.
template <int NL>
__device__ __forceinline__ void lex_compare(const uint32_t (&a)[NL], const uint32_t (&b)[NL],
                                            bool& gt, bool& eq) {
  gt = a[0] > b[0];
  eq = a[0] == b[0];
#pragma unroll
  for (int l = 1; l < NL; ++l) {
    if (!__any_sync(0xFFFFFFFFu, eq)) break;
    gt = gt || (eq && a[l] > b[l]);
    eq = eq && a[l] == b[l];
  }
}

// Whether tile index t sorts ascending at stage L: bit L of its global row
// index. From stage kTile on, every row of a tile has the bit of the tile's
// base; below it (first pass, contiguous tiles) the bit of t itself.
struct Direction {
  bool within_tile;
  int stage;
  bool of_tile;
  __device__ __forceinline__ Direction(long long base, long long L)
      : within_tile(L < kTile), stage(static_cast<int>(L)), of_tile((base & L) == 0) {}
  __device__ __forceinline__ bool ascending(int t) const {
    return within_tile ? (t & stage) == 0 : of_tile;
  }
};

// Tile index of a thread's first row when its 8 rows are h apart: the
// threads of a group of h take neighbouring rows, the groups follow each
// other 8 * h rows apart.
__device__ __forceinline__ int first_row(int h) {
  const int q = threadIdx.x;
  return ((q & ~(h - 1)) << 3) | (q & (h - 1));
}

// The thread's rows (spacing h) out to shared memory and back in at
// another spacing. The second barrier keeps the next regrouping's writes
// behind this one's reads.
template <int NL>
__device__ __forceinline__ void regroup(uint32_t (&v)[kRowsPerThread][NL], uint32_t* shared,
                                        int h_from, int h_to) {
  const int from = first_row(h_from);
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
    for (int l = 0; l < NL; ++l) shared[l * kTile + from + a * h_from] = v[a][l];
  __syncthreads();
  const int to = first_row(h_to);
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a)
#pragma unroll
    for (int l = 0; l < NL; ++l) v[a][l] = shared[l * kTile + to + a * h_to];
  __syncthreads();
}

// One step between the thread's own rows: row a meets row a | (1 << S),
// which is h << S rows away.
template <int NL, int S>
__device__ __forceinline__ void exchange_in_thread(uint32_t (&v)[kRowsPerThread][NL], int h,
                                                   const Direction& dir) {
  const int i0 = first_row(h);
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    if ((a & (1 << S)) != 0) continue;
    uint32_t(&lo)[NL] = v[a];
    uint32_t(&hi)[NL] = v[a | (1 << S)];
    bool gt, eq;
    lex_compare<NL>(lo, hi, gt, eq);
    if (gt == dir.ascending(i0 + a * h)) {  // swapping equal rows changes nothing
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const uint32_t t = lo[l];
        lo[l] = hi[l];
        hi[l] = t;
      }
    }
  }
}

// One step at distance d < 32 with the thread's rows 32 apart: the partner
// of each row is held by lane (t XOR d) of the same warp. The lower of the
// two keeps the smaller row when ascending, the upper the larger.
template <int NL>
__device__ __forceinline__ void exchange_in_warp(uint32_t (&v)[kRowsPerThread][NL], int d,
                                                 const Direction& dir) {
  const int i0 = first_row(32);
  const bool lower = (threadIdx.x & d) == 0;
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    uint32_t other[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) other[l] = __shfl_xor_sync(0xFFFFFFFFu, v[a][l], d);
    bool gt, eq;
    lex_compare<NL>(v[a], other, gt, eq);
    const bool keep_smaller = lower == dir.ascending(i0 + a * 32);
    if (keep_smaller ? gt : !(gt || eq)) {
#pragma unroll
      for (int l = 0; l < NL; ++l) v[a][l] = other[l];
    }
  }
}

// The spacing at which a step of tile distance d >= 32 lies between a
// thread's own rows, coming from another spacing.
__device__ __forceinline__ int spacing_for(int d) { return d >= 512 ? 512 : d >= 64 ? 64 : 32; }

// Stages stage_lo..stage_hi of the network on one tile; within a stage the
// steps of tile distance min(L / 2, 2048) down to d_to. (2, 4096) on
// contiguous tiles sorts each; (L, L) with d_to = 1 finishes stage L > 4096
// on them; (L, L) with d_to = C on a strided tile of runs of C rows takes
// the distances that lie between the runs.
template <int NL>
__global__ void __launch_bounds__(kThreads, 1)
tile_pass(Lanes lanes, int log2c, int log2_stride, long long stage_lo, long long stage_hi, int d_to) {
  extern __shared__ uint32_t shared[];  // shared[l * kTile + t]
  Tile tile;
  {
    // block b takes run group (b >> log2_mids) and, inside it, column
    // (b & (mids - 1)): mids columns of C rows fill one stride
    const int log2_mids = log2_stride - log2c;
    const long long b = blockIdx.x;
    tile.base = ((b >> log2_mids) << (log2_stride + kLog2Tile - log2c)) +
                ((b & ((1LL << log2_mids) - 1)) << log2c);
    tile.log2c = log2c;
    tile.log2_stride = log2_stride;
  }

  const long long half_lo = stage_lo >> 1;
  const int d_first = half_lo < kTile / 2 ? static_cast<int>(half_lo) : kTile / 2;
  int h = spacing_for(d_first);
  uint32_t v[kRowsPerThread][NL];
  {
    const int i0 = first_row(h);
#pragma unroll
    for (int a = 0; a < kRowsPerThread; ++a) {
      const long long g = tile.row(i0 + a * h);
#pragma unroll
      for (int l = 0; l < NL; ++l) v[a][l] = lanes.p[l][g];
    }
  }

  for (long long L = stage_lo; L <= stage_hi; L <<= 1) {
    const long long half = L >> 1;
    const Direction dir(tile.base, L);
    for (int d = half < kTile / 2 ? static_cast<int>(half) : kTile / 2; d >= d_to; d >>= 1) {
      if (d < 32) {
        if (h != 32) {
          regroup<NL>(v, shared, h, 32);
          h = 32;
        }
        exchange_in_warp<NL>(v, d, dir);
        continue;
      }
      if (d != h && d != 2 * h && d != 4 * h) {
        const int h_new = spacing_for(d);
        regroup<NL>(v, shared, h, h_new);
        h = h_new;
      }
      if (d == h) {
        exchange_in_thread<NL, 0>(v, h, dir);
      } else if (d == 2 * h) {
        exchange_in_thread<NL, 1>(v, h, dir);
      } else {
        exchange_in_thread<NL, 2>(v, h, dir);
      }
    }
  }

  const int i0 = first_row(h);
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const long long g = tile.row(i0 + a * h);
#pragma unroll
    for (int l = 0; l < NL; ++l) lanes.p[l][g] = v[a][l];
  }
}

inline int log2_of(long long x) {
  int r = 0;
  while ((1LL << r) < x) ++r;
  return r;
}

// The whole schedule for n rows (a power of two >= kTile) of NL lanes on
// `stream`. Returns the first CUDA error met, 0 on success.
template <int NL>
int sort_lanes(const Lanes& lanes, long long n, cudaStream_t stream) {
  const size_t bytes = sizeof(uint32_t) * NL * kTile;
  cudaError_t err = cudaFuncSetAttribute(
      tile_pass<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int tiles = static_cast<unsigned int>(n / kTile);

  tile_pass<NL><<<tiles, kThreads, bytes, stream>>>(lanes, kLog2Tile, kLog2Tile, 2, kTile, 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  for (long long L = 2LL * kTile; L <= n; L <<= 1) {
    // the distances L / 2 .. kTile lie between contiguous tiles: strided
    // passes of near-equal depth, at most kMaxStepsPerPass steps each
    int steps = log2_of(L >> 1) - kLog2Tile + 1;
    int passes = (steps + kMaxStepsPerPass - 1) / kMaxStepsPerPass;
    long long d_hi = L >> 1;
    for (; passes > 0; --passes) {
      const int s = (steps + passes - 1) / passes;
      const long long d_lo = d_hi >> (s - 1);  // the runs of the tile are d_lo apart
      const int log2c = kLog2Tile - s;         // 2^s runs of C = 2^log2c rows
      tile_pass<NL><<<tiles, kThreads, bytes, stream>>>(lanes, log2c, log2_of(d_lo), L, L, 1 << log2c);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      d_hi = d_lo >> 1;
      steps -= s;
    }
    tile_pass<NL><<<tiles, kThreads, bytes, stream>>>(lanes, kLog2Tile, kLog2Tile, L, L, 1);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Rows a block holds; the row count must be a multiple of it.
extern "C" int gkt_lane_sort_tile_rows() { return kTile; }

// Sorts, in place, the n rows of the n_lanes uint32 lanes whose device
// pointers stand in the host array `lane_ptrs` (most significant lane first).
// n must be a power of two >= gkt_lane_sort_tile_rows(). Launches on
// `stream`, does not synchronise. Returns 0, a CUDA error code, or
// cudaErrorInvalidValue for bad arguments.
extern "C" int gkt_lane_sort(void* const* lane_ptrs, int n_lanes, long long n, void* stream) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || n < kTile || (n & (n - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Lanes lanes{};
  for (int l = 0; l < n_lanes; ++l) lanes.p[l] = static_cast<uint32_t*>(lane_ptrs[l]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_lanes) {
    case 1: return sort_lanes<1>(lanes, n, s);
    case 2: return sort_lanes<2>(lanes, n, s);
    case 3: return sort_lanes<3>(lanes, n, s);
    case 4: return sort_lanes<4>(lanes, n, s);
    case 5: return sort_lanes<5>(lanes, n, s);
    case 6: return sort_lanes<6>(lanes, n, s);
    case 7: return sort_lanes<7>(lanes, n, s);
    default: return sort_lanes<8>(lanes, n, s);
  }
}
