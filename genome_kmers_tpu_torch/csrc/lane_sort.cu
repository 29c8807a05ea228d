// Multi-lane sort for Hopper (sm_90a): a sort of on-chip tiles, then
// merge-path merges of the sorted runs.
//
// Replaces the TPU kernel genome_kmers_tpu/ops/pallas_sort.py::
// bitonic_sort_tile and widens its contract from one on-chip tile to any
// length. A row is one element from each of 1..8 uint32 lanes; rows are
// sorted ascending, lexicographically over ALL lanes, most significant lane
// first, compared as unsigned, and the lanes of a row move together. The
// caller makes the rows distinct (the position: one lane, or two lanes hi
// and lo for 64-bit positions), so the order is total and the result is
// the one a stable lexicographic sort gives. Its plain
// version is ops/sort.py::sort_lanes.
//
// What bounds it: device memory. The least the card could do is read and
// write every lane once (2 * 4 * lanes * n bytes). A comparison sort above
// one on-chip tile needs log2(n / tile) more passes over the data, so the
// design keeps the passes few and each pass close to the memory rate.
//
// Design, three kernels; all of them sort or merge SOURCE INDICES (16 bits
// a row) in shared memory and leave the lanes where the loads put them, so
// no thread ever holds 8 rows of every lane in registers, the register
// count allows two or more blocks an SM (one block's loads overlap
// another's compares), and every global store is a whole 128-byte line:
//   * `block_sort` (1 pass, out of place) sorts one tile of 4096 rows, which
//     is what the TPU kernel computes. It copies the tile of every lane into
//     shared memory (rows at index >= n are taken as all-ones: they sort
//     last and the caller cuts them off; the row count is rounded up to a
//     whole tile only), sorts 8 rows a thread with a 19-step network, then
//     doubles the sorted runs nine times by merge path: a thread finds the
//     split of its 8 consecutive outputs by binary search and merges them
//     serially, comparing lane by lane up to the first lane that decides.
//     A compare-exchange network over the whole tile (the TPU kernel's
//     schedule) is bound by the integer units at 78 steps of up to 6 words.
//   * `merge_partition` + `merge_tiles` (one pass per doubling of the run
//     width) merge neighbouring sorted runs pairwise from one scratch buffer
//     into the other. Work is cut by OUTPUT tile, so every block moves the
//     same number of rows whatever the data: the partition kernel finds, by
//     binary search along the diagonal, how many rows of the left run (A)
//     come before each output-tile boundary ("take from A on equal"); a
//     merge block copies its A part and B part of every lane into shared
//     memory with asynchronous 4-byte copies (the parts start at any row, so
//     no wider alignment holds) and merges them as above.
//   * every kernel ends the same way: out[l][o] = tile[l][source[o]] with o
//     along the threads.
//   A run without a partner is merged with an empty run (a copy).
// Row indices are 64-bit: n * 4 bytes may pass 2^31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 8;
constexpr int kRowsPerThread = 8;
constexpr int kSortThreads = 512;
constexpr int kTile = kSortThreads * kRowsPerThread;  // rows a block sorts
constexpr uint32_t kPadWord = 0xFFFFFFFFu;
// Lanes of the two rows under comparison that a merging thread keeps in
// registers; the lanes behind them are read from shared memory only when
// these tie.
constexpr int kCachedLanes = 2;
// What the blocks of one SM can opt into together, and what the runtime
// keeps of it for each block.
constexpr size_t kSharedBytesPerSm = 232448;
constexpr size_t kSharedBytesReservedPerBlock = 1024;

// Threads of a block (its tile is 8 rows a thread) and the blocks an SM
// should hold, by lane count: the tile of every lane plus the source
// indices, times the blocks, must fit an SM.
template <int NL, int THREADS, int BLOCKS>
struct Config {
  static constexpr int kThreads = THREADS;
  static constexpr int kBlocksPerSm = BLOCKS;
  static constexpr int kTile = kThreads * kRowsPerThread;
  static constexpr size_t kSharedBytes = sizeof(uint32_t) * NL * kTile + sizeof(uint16_t) * kTile;
  static_assert(kTile <= (1 << 16), "source indices are 16 bits");
  static_assert(kBlocksPerSm * kThreads <= 2048, "threads an SM holds");
  static_assert(kBlocksPerSm * (kSharedBytes + kSharedBytesReservedPerBlock) <= kSharedBytesPerSm,
                "the blocks do not fit the shared memory of an SM");
};
// Up to 6 lanes two blocks of 4096 rows fit an SM; the merge takes tiles of
// 2048 rows, three blocks an SM, at 7 and 8 lanes.
template <int NL>
using SortConfig = Config<NL, kSortThreads, (NL <= 6 ? 2 : 1)>;
template <int NL>
using MergeConfig = Config<NL, (NL <= 6 ? 512 : 256), (NL <= 6 ? 2 : 3)>;

struct Lanes {
  uint32_t* p[kMaxLanes];
};

struct ConstLanes {
  const uint32_t* p[kMaxLanes];
};

// --------------------------------------------------------------------------
// shared by the kernels: compare, merge 8 outputs, move the lanes
// --------------------------------------------------------------------------

// row ia <= row ib, lexicographic and unsigned; lanes[l][i] is at
// lanes[l * stride + i] in shared memory.
template <int NL>
__device__ __forceinline__ bool row_le(const uint32_t* lanes, int stride, int ia, int ib) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const uint32_t x = lanes[l * stride + ia], y = lanes[l * stride + ib];
    if (x != y) return x < y;
  }
  return true;
}

template <int NL>
__device__ __forceinline__ bool row_le(const ConstLanes& lanes, long long ia, long long ib) {
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const uint32_t x = lanes.p[l][ia], y = lanes.p[l][ib];
    if (x != y) return x < y;
  }
  return true;
}

// The row at the head of a run: its place in the tile and its first lanes.
template <int NL>
struct Head {
  static constexpr int kCached = NL < kCachedLanes ? NL : kCachedLanes;
  int row;
  uint32_t word[kCached];
  __device__ __forceinline__ Head(const uint32_t* tile, int stride, int at) : row(at) {
#pragma unroll
    for (int l = 0; l < kCached; ++l) word[l] = tile[l * stride + at];
  }
  __device__ __forceinline__ bool le(const Head& other, const uint32_t* tile, int stride) const {
#pragma unroll
    for (int l = 0; l < kCached; ++l) {
      if (word[l] != other.word[l]) return word[l] < other.word[l];
    }
#pragma unroll
    for (int l = kCached; l < NL; ++l) {
      const uint32_t x = tile[l * stride + row], y = tile[l * stride + other.row];
      if (x != y) return x < y;
    }
    return true;
  }
};

// Where the rows of a run lie in the tile: one after the other from
// `first` on (never past `last`), or as a list of source indices names them.
struct Consecutive {
  int first, last;
  __device__ __forceinline__ int operator()(int i) const {
    return first + i < last ? first + i : last;
  }
};

struct Listed {
  const uint16_t* source;
  __device__ __forceinline__ int operator()(int i) const { return source[i]; }
};

__device__ __forceinline__ int clamp_index(int i, int len) {
  return i < len ? (i > 0 ? i : 0) : (len > 0 ? len - 1 : 0);
}

// The 8 outputs from diagonal `diag` on of the merge of run A (len_a rows,
// the i-th at tile row row_a(i)) with run B: a binary search along the
// diagonal for the split (the least i with A[i] > B[diag - 1 - i], so A goes
// first on equal), then a serial merge. Returns the 8 tile rows, 16 bits
// each, first output lowest.
template <int NL, class RowA, class RowB>
__device__ __forceinline__ uint4 merge_eight(const uint32_t* tile, int stride, RowA row_a,
                                             int len_a, RowB row_b, int len_b, int diag) {
  int lo = diag > len_b ? diag - len_b : 0;
  int hi = diag < len_a ? diag : len_a;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row_le<NL>(tile, stride, row_a(mid), row_b(diag - 1 - mid))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, j = diag - lo;
  // a head past the end of its run holds some row of the tile and is never taken
  Head<NL> a(tile, stride, row_a(clamp_index(i, len_a)));
  Head<NL> b(tile, stride, row_b(clamp_index(j, len_b)));
  uint32_t packed[kRowsPerThread / 2];
#pragma unroll
  for (int s = 0; s < kRowsPerThread; ++s) {
    const bool take_a = j >= len_b || (i < len_a && a.le(b, tile, stride));
    const uint32_t taken = take_a ? a.row : b.row;
    if (s & 1) {
      packed[s >> 1] |= taken << 16;
    } else {
      packed[s >> 1] = taken;
    }
    i += take_a ? 1 : 0;
    j += take_a ? 0 : 1;
    const Head<NL> next(tile, stride,
                        take_a ? row_a(clamp_index(i, len_a)) : row_b(clamp_index(j, len_b)));
    if (take_a) {
      a = next;
    } else {
      b = next;
    }
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

__device__ __forceinline__ void copy_word_async(uint32_t* to_shared, const uint32_t* from_global) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(to_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to), "l"(from_global) : "memory");
}

__device__ __forceinline__ void wait_for_async_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// out[l][row + o] = tile[l][source[o]] for the block's whole tile.
template <int NL, int THREADS>
__device__ __forceinline__ void store_rows(const uint32_t* tile, const uint16_t* source,
                                           const Lanes& out, long long row) {
  constexpr int TM = THREADS * kRowsPerThread;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int o = r * THREADS + threadIdx.x;
    const int s = source[o];
#pragma unroll
    for (int l = 0; l < NL; ++l) out.p[l][row + o] = tile[l * TM + s];
  }
}

// --------------------------------------------------------------------------
// block sort
// --------------------------------------------------------------------------

// Sorts tile blockIdx.x of `in` (rows at index >= n taken as all-ones) into
// the same rows of `out`.
template <int NL>
__global__ void __launch_bounds__(SortConfig<NL>::kThreads, SortConfig<NL>::kBlocksPerSm)
block_sort(ConstLanes in, Lanes out, long long n) {
  constexpr int THREADS = SortConfig<NL>::kThreads;
  extern __shared__ __align__(16) uint32_t shared[];
  uint32_t* tile = shared;  // tile[l * kTile + x]
  uint16_t* source = reinterpret_cast<uint16_t*>(shared + NL * kTile);  // source[o], o < kTile
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int x = r * THREADS + tid;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (base + x < n) {
        copy_word_async(tile + l * kTile + x, in.p[l] + base + x);
      } else {
        tile[l * kTile + x] = kPadWord;
      }
    }
  }
  wait_for_async_copies();
  __syncthreads();

  uint4 sorted;
  {
    // the thread's first run: rows tid, tid + THREADS, ... (a warp's reads
    // fall into 32 different banks whatever the data), by the 19
    // compare-exchanges of an odd-even merge network
    uint32_t v[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) v[k] = k * THREADS + tid;
#define GKT_EXCHANGE(i, j)                    \
  if (!row_le<NL>(tile, kTile, v[i], v[j])) { \
    const uint32_t t = v[i];                  \
    v[i] = v[j];                              \
    v[j] = t;                                 \
  }
    GKT_EXCHANGE(0, 1) GKT_EXCHANGE(2, 3) GKT_EXCHANGE(4, 5) GKT_EXCHANGE(6, 7)
    GKT_EXCHANGE(0, 2) GKT_EXCHANGE(1, 3) GKT_EXCHANGE(4, 6) GKT_EXCHANGE(5, 7)
    GKT_EXCHANGE(1, 2) GKT_EXCHANGE(5, 6)
    GKT_EXCHANGE(0, 4) GKT_EXCHANGE(1, 5) GKT_EXCHANGE(2, 6) GKT_EXCHANGE(3, 7)
    GKT_EXCHANGE(2, 4) GKT_EXCHANGE(3, 5)
    GKT_EXCHANGE(1, 2) GKT_EXCHANGE(3, 4) GKT_EXCHANGE(5, 6)
#undef GKT_EXCHANGE
    sorted = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16, v[6] | v[7] << 16);
  }
  reinterpret_cast<uint4*>(source)[tid] = sorted;
  __syncthreads();

  // source[] holds sorted runs of `width` rows; each round merges them in pairs
  for (int width = kRowsPerThread; width < kTile; width <<= 1) {
    const int o = tid * kRowsPerThread;
    const int pair = o & ~(2 * width - 1);
    sorted = merge_eight<NL>(tile, kTile, Listed{source + pair}, width,
                             Listed{source + pair + width}, width, o - pair);
    __syncthreads();  // every thread has read its runs
    reinterpret_cast<uint4*>(source)[tid] = sorted;
    __syncthreads();
  }

  store_rows<NL, THREADS>(tile, source, out, base);
}

// --------------------------------------------------------------------------
// merge passes
// --------------------------------------------------------------------------

// The pair of neighbouring runs that output row `row` belongs to in a pass
// that merges runs of `width` rows: run A is rows [base, base + len_a), run
// B rows [base + width, base + width + len_b); `diag` is the row's place in
// the pair's output. The last pair of the buffer may have a short or empty B.
struct Pair {
  long long base, len_a, len_b, diag;
  __device__ __forceinline__ Pair(long long row, long long n_rows, long long width) {
    base = row / (2 * width) * (2 * width);
    const long long left = n_rows - base;
    len_a = left < width ? left : width;
    len_b = left - len_a < width ? left - len_a : width;
    diag = row - base;
  }
};

// splits[t] = how many rows of run A come before output row t * tile of its
// pair: the least i on the diagonal i + j = diag with A[i] > B[j - 1], found
// by binary search ("take from A on equal": A[i] goes first iff
// A[i] <= B[diag - 1 - i]). One thread a boundary.
template <int NL>
__global__ void merge_partition(ConstLanes src, long long n_rows, long long width, int tile,
                                long long n_tiles, long long* __restrict__ splits) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  const Pair pair(t * tile, n_rows, width);
  long long lo = pair.diag > pair.len_b ? pair.diag - pair.len_b : 0;
  long long hi = pair.diag < pair.len_a ? pair.diag : pair.len_a;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (row_le<NL>(src, pair.base + mid, pair.base + width + pair.diag - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  splits[t] = lo;
}

// Merges output tile blockIdx.x (TM rows) of a pass over runs of `width`
// rows from `src` into `dst`.
template <int NL, int THREADS, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
merge_tiles(ConstLanes src, Lanes dst, long long n_rows, long long width,
            const long long* __restrict__ splits) {
  constexpr int TM = THREADS * kRowsPerThread;
  extern __shared__ __align__(16) uint32_t shared[];
  uint32_t* tile = shared;  // tile[l * TM + x]: A part at x < na, B part from na on
  uint16_t* source = reinterpret_cast<uint16_t*>(shared + NL * TM);  // source[o], o < TM
  const int tid = threadIdx.x;

  const long long row = static_cast<long long>(blockIdx.x) * TM;
  const Pair pair(row, n_rows, width);
  const long long a0 = splits[blockIdx.x];
  const long long a1 =
      pair.diag + TM == pair.len_a + pair.len_b ? pair.len_a : splits[blockIdx.x + 1];
  const int na = static_cast<int>(a1 - a0);
  const long long from_a = pair.base + a0;                            // of tile row 0
  const long long from_b = pair.base + width + (pair.diag - a0) - na;  // of tile row 0, B part

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int x = r * THREADS + tid;
    const long long g = (x < na ? from_a : from_b) + x;
#pragma unroll
    for (int l = 0; l < NL; ++l) copy_word_async(tile + l * TM + x, src.p[l] + g);
  }
  wait_for_async_copies();
  __syncthreads();

  const uint4 merged = merge_eight<NL>(tile, TM, Consecutive{0, TM - 1}, na,
                                       Consecutive{na, TM - 1}, TM - na, tid * kRowsPerThread);
  reinterpret_cast<uint4*>(source)[tid] = merged;
  __syncthreads();

  store_rows<NL, THREADS>(tile, source, dst, row);
}

inline ConstLanes as_const(const Lanes& lanes) {
  ConstLanes c{};
  for (int l = 0; l < kMaxLanes; ++l) c.p[l] = lanes.p[l];
  return c;
}

#define GKT_CHECK(call)                                           \
  do {                                                            \
    const cudaError_t err_ = (call);                              \
    if (err_ != cudaSuccess) return static_cast<int>(err_);       \
  } while (0)

// The whole schedule for n rows of NL lanes on `stream`: the block sort
// from `in` into `a`, then merges a -> b -> a ... until one run is left.
// Adds one to *passes for every launch that reads and writes all lanes.
// Returns the first CUDA error met, 0 on success.
template <int NL>
int sort_lanes(const ConstLanes& in, const Lanes& a, const Lanes& b, long long n,
               long long* splits, cudaStream_t stream, int* passes) {
  using Sort = SortConfig<NL>;
  using Merge = MergeConfig<NL>;
  auto merge = merge_tiles<NL, Merge::kThreads, Merge::kBlocksPerSm>;
  GKT_CHECK(cudaFuncSetAttribute(block_sort<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Sort::kSharedBytes)));
  GKT_CHECK(cudaFuncSetAttribute(block_sort<NL>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared));
  GKT_CHECK(cudaFuncSetAttribute(merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(Merge::kSharedBytes)));
  GKT_CHECK(cudaFuncSetAttribute(merge, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared));

  const long long n_rows = (n + kTile - 1) / kTile * kTile;
  block_sort<NL><<<static_cast<unsigned>(n_rows / kTile), Sort::kThreads, Sort::kSharedBytes, stream>>>(
      in, a, n);
  GKT_CHECK(cudaGetLastError());
  ++*passes;

  const long long n_tiles = n_rows / Merge::kTile;
  const Lanes* from = &a;
  const Lanes* to = &b;
  for (long long width = kTile; width < n_rows; width *= 2) {
    merge_partition<NL><<<static_cast<unsigned>((n_tiles + 255) / 256), 256, 0, stream>>>(
        as_const(*from), n_rows, width, Merge::kTile, n_tiles, splits);
    GKT_CHECK(cudaGetLastError());
    merge<<<static_cast<unsigned>(n_tiles), Merge::kThreads, Merge::kSharedBytes, stream>>>(
        as_const(*from), *to, n_rows, width, splits);
    GKT_CHECK(cudaGetLastError());
    ++*passes;
    const Lanes* t = from;
    from = to;
    to = t;
  }
  return 0;
}

// Blocks of `kernel` an SM of the current device holds, as the runtime
// computes them from its registers and shared memory, or -1.
template <class Kernel>
int blocks_resident(Kernel kernel, int threads, size_t shared_bytes) {
  int blocks = -1;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(shared_bytes)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, shared_bytes) !=
          cudaSuccess) {
    return -1;
  }
  return blocks;
}

template <int NL>
int blocks_resident(int* sort_blocks, int* merge_blocks) {
  using Sort = SortConfig<NL>;
  using Merge = MergeConfig<NL>;
  *sort_blocks = blocks_resident(block_sort<NL>, Sort::kThreads, Sort::kSharedBytes);
  *merge_blocks = blocks_resident(merge_tiles<NL, Merge::kThreads, Merge::kBlocksPerSm>,
                                  Merge::kThreads, Merge::kSharedBytes);
  return *sort_blocks < 0 || *merge_blocks < 0 ? -1 : 0;
}

// Returns `expr`, evaluated with the constant NL that equals n_lanes.
#define GKT_BY_LANES(n_lanes, expr) \
  switch (n_lanes) {                \
    case 1: { constexpr int NL = 1; return expr; } \
    case 2: { constexpr int NL = 2; return expr; } \
    case 3: { constexpr int NL = 3; return expr; } \
    case 4: { constexpr int NL = 4; return expr; } \
    case 5: { constexpr int NL = 5; return expr; } \
    case 6: { constexpr int NL = 6; return expr; } \
    case 7: { constexpr int NL = 7; return expr; } \
    case 8: { constexpr int NL = 8; return expr; } \
    default: return -1;             \
  }

}  // namespace

// Rows the block sort takes at a time; the scratch buffers hold the row
// count rounded up to a multiple of it.
extern "C" int gkt_lane_sort_tile_rows() { return kTile; }

// Rows of an output tile of the merge passes at n_lanes lanes (the `splits`
// scratch needs one entry per such tile), or -1.
extern "C" int gkt_lane_sort_merge_tile_rows(int n_lanes) {
  GKT_BY_LANES(n_lanes, MergeConfig<NL>::kTile)
}

// The block-sort blocks and the merge blocks an SM of the current device
// does hold at n_lanes lanes (the occupancy the runtime computes from
// registers and shared memory). Returns 0, or -1 on failure.
extern "C" int gkt_lane_sort_blocks_resident(int n_lanes, int* sort_blocks, int* merge_blocks) {
  GKT_BY_LANES(n_lanes, blocks_resident<NL>(sort_blocks, merge_blocks))
}

// Sorts the n rows of the n_lanes uint32 lanes whose device pointers stand
// in the host array `in_ptrs` (most significant lane first; not modified).
// `a_ptrs` and `b_ptrs` name two scratch buffers of n_lanes lanes, each lane
// n rounded up to a multiple of gkt_lane_sort_tile_rows() rows (b is not
// touched when that is one tile); `splits` is device scratch of one int64
// per merge output tile. The sorted rows end in the first n rows of a when
// the number of merge passes is even, else of b; the rows behind them are
// all-ones. *passes receives the number of launches that read and write all
// lanes (the block sort and each merge). Launches on `stream`, does not
// synchronise. Returns 0, a CUDA error code, or cudaErrorInvalidValue for
// bad arguments.
extern "C" int gkt_lane_sort(const void* const* in_ptrs, void* const* a_ptrs, void* const* b_ptrs,
                             int n_lanes, long long n, long long* splits, void* stream,
                             int* passes) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || n < 1 || passes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConstLanes in{};
  Lanes a{}, b{};
  for (int l = 0; l < n_lanes; ++l) {
    in.p[l] = static_cast<const uint32_t*>(in_ptrs[l]);
    a.p[l] = static_cast<uint32_t*>(a_ptrs[l]);
    b.p[l] = static_cast<uint32_t*>(b_ptrs[l]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *passes = 0;
  GKT_BY_LANES(n_lanes, sort_lanes<NL>(in, a, b, n, splits, s, passes))
}
