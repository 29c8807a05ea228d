// Group-size histogram for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's clipped_counts
// (genome_kmers_tpu/ops/groups.py:66) is an XLA compare or scatter-add. It
// takes the place of kernels/group_hist.py::group_size_hist, its plain
// version (a clamp, the qualifying select and PyTorch's histogram op),
// which it equals bit for bit:
//     counts[s] = #{i : qualifies[i] and min(size[i], max_counts_bin) == s},
// counts int64, max_counts_bin + 1 bins, zeroed by the caller. A negative
// size, which the plain version refuses, is not counted.
//
// Why it was added: most k-mers of a genome are unique, so nearly every
// qualifying row falls into one bin (size 1; with max_counts_bin = 1 the top
// bin). PyTorch's global-memory histogram issues one atomicAdd a row on
// that bin's word, and atomics on one address serialise in L2 at about one
// a clock: 63 ms for 1e8 rows on an H100, some 230 times the bound.
//
// What bounds it: device memory. Each row reads 8 bytes of size and 1 byte
// of mask, and the answer is written once: 9 n + 8 (max_counts_bin + 1)
// bytes, 0.27 ms for 1e8 rows at 3.35 TB/s.
//
// Design:
// * A persistent grid of as many blocks as the SMs hold at once. Each warp
//   walks tiles of 32 x kUnroll row pairs in a grid-stride loop; a lane
//   reads two sizes with one 16-byte load and their two mask bytes with one
//   2-byte load, neighbouring lanes on neighbouring addresses, and issues
//   all kUnroll loads of a tile before it counts. One head row aligns the
//   sizes to 16 bytes; where the mask is then odd-aligned its bytes are
//   read one at a time; a ragged last row is counted alone.
// * Bins 0 to kRegBins - 1 are counted in registers by every thread, so
//   whichever of them is hot costs no atomic until the end, where a warp
//   adds each sum with one shared atomic.
// * Bins kRegBins to S - 1, S = min(max_counts_bin + 1, kSharedBins), go to
//   the block's histogram of 32-bit counters in shared memory. Equal bins
//   of a warp are merged first (__match_any_sync): one leader adds the
//   popcount of its peers, so any hot bin costs at most one shared atomic a
//   warp a row.
// * Bins from S up (only where max_counts_bin >= kSharedBins) take a 64-bit
//   global atomicAdd each. A group of size s >= S has s rows and one of
//   them qualifies, so over group sizes at most n / S rows go this way.
// * At the end each block adds its non-zero shared bins to the counts.
// The counters of a block cannot wrap: a block counts at most n / (number
// of blocks) rows, and n is bounded by device memory at 9 bytes a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // row pairs a lane loads before it counts them
constexpr int kTilePairs = 32 * kUnroll;
constexpr int kRegBins = 4;
constexpr int kSharedBins = 4096;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;

// Counts one row: in a register, in shared memory after the warp's merge,
// or in global memory. Every lane of the warp calls it together.
__device__ __forceinline__ void count_row(int64_t size, bool qualifies, int64_t max_bin,
                                          uint32_t span, uint32_t (&reg)[kRegBins],
                                          uint32_t* sh, unsigned long long* counts) {
  uint32_t key = kNone;
  if (qualifies && size >= 0) {
    const int64_t bin = size < max_bin ? size : max_bin;
    if (bin < span) {
      key = static_cast<uint32_t>(bin);
    } else {
      atomicAdd(counts + bin, 1ull);
    }
  }
#pragma unroll
  for (int j = 0; j < kRegBins; ++j) reg[j] += key == static_cast<uint32_t>(j);
  const bool shared_bin = key >= kRegBins && key != kNone;
  if (__any_sync(kFull, shared_bin)) {
    const unsigned peers = __match_any_sync(kFull, shared_bin ? key : kNone);
    if (shared_bin && __ffs(peers) - 1 == static_cast<int>(threadIdx.x & 31)) {
      atomicAdd(sh + key, static_cast<uint32_t>(__popc(peers)));
    }
  }
}

__device__ __forceinline__ void count_alone(const int64_t* size, const uint8_t* qualifies,
                                            int64_t i, int64_t max_bin,
                                            unsigned long long* counts) {
  const int64_t s = size[i];
  if (qualifies[i] && s >= 0) atomicAdd(counts + (s < max_bin ? s : max_bin), 1ull);
}

// Rows head + 2p and head + 2p + 1 form pair p, p < n_pairs; the sizes of
// pair 0 start on a 16-byte boundary. kMaskPairs: the mask of pair 0 starts
// on a 2-byte boundary.
template <bool kMaskPairs>
__global__ void __launch_bounds__(kThreads)
group_hist_kernel(const int64_t* __restrict__ size, const uint8_t* __restrict__ qualifies,
                  int64_t n, int64_t head, int64_t n_pairs, int64_t max_bin, uint32_t span,
                  unsigned long long* __restrict__ counts) {
  extern __shared__ uint32_t sh[];
  for (uint32_t i = threadIdx.x; i < span; i += kThreads) sh[i] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (head) count_alone(size, qualifies, 0, max_bin, counts);
    if (head + 2 * n_pairs < n) count_alone(size, qualifies, n - 1, max_bin, counts);
  }
  __syncthreads();

  const longlong2* size2 = reinterpret_cast<const longlong2*>(size + head);
  const uint8_t* mask = qualifies + head;
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps * kTilePairs;
  uint32_t reg[kRegBins] = {};
  for (int64_t tile = warp * kTilePairs; tile < n_pairs; tile += stride) {
    longlong2 s[kUnroll];
    uint32_t m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = tile + u * 32 + lane;
      if (p < n_pairs) {
        s[u] = __ldg(size2 + p);
        if (kMaskPairs) {
          m[u] = __ldg(reinterpret_cast<const uint16_t*>(mask) + p);
        } else {
          m[u] = __ldg(mask + 2 * p) | (static_cast<uint32_t>(__ldg(mask + 2 * p + 1)) << 8);
        }
      } else {
        s[u] = make_longlong2(0, 0);
        m[u] = 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      count_row(s[u].x, (m[u] & 0xff) != 0, max_bin, span, reg, sh, counts);
      count_row(s[u].y, (m[u] >> 8) != 0, max_bin, span, reg, sh, counts);
    }
  }

#pragma unroll
  for (int j = 0; j < kRegBins; ++j) {
    const uint32_t v = __reduce_add_sync(kFull, reg[j]);
    if (lane == 0 && v != 0) atomicAdd(sh + j, v);  // v != 0 only for a bin below span
  }
  __syncthreads();
  for (uint32_t i = threadIdx.x; i < span; i += kThreads) {
    const uint32_t v = sh[i];
    if (v != 0) atomicAdd(counts + i, static_cast<unsigned long long>(v));
  }
}

}  // namespace

// Adds the histogram of n rows (`size` int64, 8-byte aligned; `qualifies`
// one byte a row, 0 or 1; both device pointers) into max_bin + 1 zeroed
// int64 `counts` on `stream`. Returns the first CUDA error of the launch
// (cudaGetLastError()), 0 on success.
extern "C" int gkt_group_hist(const void* size, const void* qualifies, int64_t n,
                              int64_t max_bin, void* counts, void* stream) {
  if (n <= 0) return 0;
  const uint32_t span =
      max_bin + 1 < kSharedBins ? static_cast<uint32_t>(max_bin + 1) : kSharedBins;
  const size_t smem = span * sizeof(uint32_t);
  const uintptr_t size_addr = reinterpret_cast<uintptr_t>(size);
  const int64_t head = size_addr % 16 != 0 ? 1 : 0;
  const int64_t n_pairs = n > head ? (n - head) / 2 : 0;
  const bool mask_pairs = (reinterpret_cast<uintptr_t>(qualifies) + head) % 2 == 0;
  auto kernel = mask_pairs ? group_hist_kernel<true> : group_hist_kernel<false>;

  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (n_pairs + kWarps * kTilePairs - 1) / (kWarps * kTilePairs);
  const int64_t blocks = needed < 1 ? 1 : needed < resident ? needed : resident;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(size), static_cast<const uint8_t*>(qualifies), n, head,
      n_pairs, max_bin, span, static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
