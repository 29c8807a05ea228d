// 2-bit genome pack for Hopper (sm_90a).
//
// Replaces the TPU kernel genome_kmers_tpu/ops/pallas_kernels.py::
// pack_rank2_words_pallas. out[i] holds the 2-bit ranks (A0 C1 G2 T3) of
// SBA bytes i..i+15, packed big-endian into one uint32:
//     out[i] = sum_j rank[i + j] << 2 * (15 - j),   rank = 0 at and past n.
// Every byte other than A, C, G, T ranks 0 (the RANK2_TABLE of
// ops/encoding.py), so the output is bit-identical to the plain version
// ops/keys.py::pack_rank2_words at every position, '$' fields included.
//
// What bounds it: device memory. Each position reads 1 byte and writes
// 4 bytes, 5 * n bytes in all; at n = 2^27 that is 671 MB, about 0.2 ms at
// the H100 SXM data-sheet bandwidth of 3.35 TB/s.
//
// Design: one block packs a tile of TILE consecutive positions. Its
// threads read the tile's bytes plus a 15-byte halo once, coalesced, map
// them through the rank table into shared memory, and then each thread
// packs 4 consecutive positions from shared memory with a rolling shift
// (19 shared reads for 4 outputs) and writes them as one 16-byte store, so
// a warp writes 512 contiguous bytes. Indices are 64-bit: n reaches 2^27
// and beyond.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kHalo = 15;

__global__ void __launch_bounds__(kThreads)
pack2_kernel(const uint8_t* __restrict__ in, uint32_t* __restrict__ out, int64_t n) {
  __shared__ uint8_t rank_table[256];
  __shared__ uint8_t ranks[kTile + kHalo];

  const int tid = threadIdx.x;
  // RANK2_TABLE: A0 C1 G2 T3, every other byte 0
  rank_table[tid] = tid == 'C' ? 1 : tid == 'G' ? 2 : tid == 'T' ? 3 : 0;
  __syncthreads();

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int k = tid; k < kTile + kHalo; k += kThreads) {
    const int64_t i = base + k;
    ranks[k] = i < n ? rank_table[in[i]] : 0;
  }
  __syncthreads();

  const int o = tid * kPerThread;
  uint32_t acc = 0;
  for (int j = 0; j < 16; ++j) acc = (acc << 2) | ranks[o + j];
  uint32_t v[kPerThread];
  v[0] = acc;
  for (int t = 1; t < kPerThread; ++t) {
    acc = (acc << 2) | ranks[o + 15 + t];
    v[t] = acc;
  }

  const int64_t i0 = base + o;
  if (i0 + kPerThread <= n) {
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    for (int t = 0; t < kPerThread && i0 + t < n; ++t) out[i0 + t] = v[t];
  }
}

}  // namespace

// Launches the pack of n bytes at `in` into n uint32 words at `out` (both
// device pointers; `out` 16-byte aligned) on `stream`. Returns the launch's
// cudaGetLastError() code, 0 on success.
extern "C" int gkt_pack2(const void* in, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + kTile - 1) / kTile;
  pack2_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
