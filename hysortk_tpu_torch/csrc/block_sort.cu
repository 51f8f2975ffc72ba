// Block sort: every B-slot block of (W + P) uint32 rows sorted by its W key
// words (lexicographic, unsigned, word 0 most significant), payload rows
// riding along; block b ascending, or descending when b is odd and
// descending_odd is set.
//
// Replaces hysortk_tpu/ops/pallas_sort.py block_bitonic_sort
// (_block_sort_kernel), phase A of sort_words(formulation="roll"). The TPU
// kernel holds a block of 65,536 slots in VMEM and exchanges by vector
// rolls; a thread block here holds one tile in shared memory, so B is
// smaller (up to 16,384 slots) and the run merge behind it does more
// levels.
//
// Design: one thread block per tile. The W key rows and each slot's source
// index lie in shared memory, (W + 1) x B words; a bitonic network runs
// over the (key, source index) pairs, each thread exchanging the pairs
// (i, i ^ j) it owns, with a block barrier between stages. The source index
// as the last key word makes every pair distinct, so the network's result is
// the stable ascending order; a descending block is written out reversed.
// Payload rows never enter shared memory: at the end each is gathered from
// device memory through the sorted source indices (the tile was just read,
// so the gather hits cache).
//
// Bound on the H100: HBM bytes, every row read once and written once,
// 8 (W + P) B/slot. The network's log2(B) (log2(B) + 1) / 2 stages each
// read and write the tile in shared memory, and that, not HBM, sets the
// kernel's time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRows = 8;
constexpr int kMaxWords = 6;

struct BlockRows {
  const uint32_t* src[kMaxRows];
  uint32_t* dst[kMaxRows];
};

template <int W>
__global__ void __launch_bounds__(kThreads)
block_sort_kernel(const __grid_constant__ BlockRows rows, int n_rows,
                  int block, int descending_odd) {
  extern __shared__ uint32_t tile[];  // W key rows of `block`, then the index
  uint32_t* index = tile + static_cast<int64_t>(W) * block;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;

  for (int t = threadIdx.x; t < block; t += blockDim.x) {
#pragma unroll
    for (int w = 0; w < W; ++w) tile[w * block + t] = rows.src[w][base + t];
    index[t] = t;
  }
  __syncthreads();

  for (int size = 2; size <= block; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < block / 2; p += blockDim.x) {
        // The p-th pair at distance j: p with a zero inserted at j's bit.
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = lo | j;
        uint32_t a[W + 1], b[W + 1];
#pragma unroll
        for (int w = 0; w <= W; ++w) {
          a[w] = tile[w * block + lo];
          b[w] = tile[w * block + hi];
        }
        bool greater = false, decided = false;
#pragma unroll
        for (int w = 0; w <= W; ++w) {
          if (!decided && a[w] != b[w]) {
            greater = a[w] > b[w];
            decided = true;
          }
        }
        const bool ascending = (lo & size) == 0;
        if (greater == ascending) {
#pragma unroll
          for (int w = 0; w <= W; ++w) {
            tile[w * block + lo] = b[w];
            tile[w * block + hi] = a[w];
          }
        }
      }
      __syncthreads();
    }
  }

  const bool reversed = descending_odd && (blockIdx.x & 1);
  for (int t = threadIdx.x; t < block; t += blockDim.x) {
    const int64_t to = base + (reversed ? block - 1 - t : t);
#pragma unroll
    for (int w = 0; w < W; ++w) rows.dst[w][to] = tile[w * block + t];
    const int64_t from = base + index[t];
    for (int q = W; q < n_rows; ++q) rows.dst[q][to] = rows.src[q][from];
  }
}

template <int W>
cudaError_t launch(const BlockRows& rows, int n_rows, int64_t n, int block,
                   int descending_odd, cudaStream_t s) {
  const size_t shared = static_cast<size_t>(W + 1) * block * sizeof(uint32_t);
  // Above 48 KB a kernel has to opt in to its dynamic shared memory.
  cudaError_t err = cudaFuncSetAttribute(
      block_sort_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const int threads = block / 2 < kThreads ? (block / 2 < 32 ? 32 : block / 2)
                                           : kThreads;
  block_sort_kernel<W><<<static_cast<unsigned>(n / block), threads, shared, s>>>(
      rows, n_rows, block, descending_odd);
  return cudaGetLastError();
}

}  // namespace

// src, dst: n_rows device pointers each to (n,) uint32 rows, the first n_keys
// of them key words; src and dst do not overlap. block: a power of two that
// divides n and whose tile fits a thread block's shared memory. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry it refuses.
extern "C" int hk_block_sort(void* const* src, void* const* dst, int n_keys,
                             int n_rows, int64_t n, int64_t block,
                             int descending_odd, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || n_keys < 1 || n_keys > kMaxWords ||
      n_rows < n_keys || n_rows > kMaxRows || block < 2 ||
      (block & (block - 1)) != 0 || n % block != 0 || block > (1 << 20)) {
    return cudaErrorInvalidValue;
  }
  BlockRows rows{};
  for (int q = 0; q < n_rows; ++q) {
    rows.src[q] = static_cast<const uint32_t*>(src[q]);
    rows.dst[q] = static_cast<uint32_t*>(dst[q]);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(block);
  cudaError_t err = cudaSuccess;
  switch (n_keys) {
    case 1: err = launch<1>(rows, n_rows, n, b, descending_odd, s); break;
    case 2: err = launch<2>(rows, n_rows, n, b, descending_odd, s); break;
    case 3: err = launch<3>(rows, n_rows, n, b, descending_odd, s); break;
    case 4: err = launch<4>(rows, n_rows, n, b, descending_odd, s); break;
    case 5: err = launch<5>(rows, n_rows, n, b, descending_odd, s); break;
    case 6: err = launch<6>(rows, n_rows, n, b, descending_odd, s); break;
  }
  return static_cast<int>(err);
}
