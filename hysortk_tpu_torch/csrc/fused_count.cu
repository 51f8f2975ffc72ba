// Run-length count + [L, U] filter over sorted, sentinel-marked key words.
//
// Replaces hysortk_tpu/ops/pallas_count.py run_length_count_filter
// (_count_kernel), with its exact semantics: a run boundary is at i = 0 or
// wherever any word differs from slot i-1; the first sentinel slot is a
// boundary (it ends the last real run) and is never a head; at a head
// cnt = next boundary - i, else 0; keep = head && lower <= cnt <= upper.
//
// The TPU kernel walks its blocks right to left and carries "first boundary
// to the right" in a scalar across the sequential grid. Blocks on the H100
// run in parallel and in no order, so the carry becomes a separate pass:
//   1. count_flags: per slot a flag byte (bit 0 boundary, bit 1 sentinel)
//      and per tile the position of its first boundary;
//   2. count_tile_suffix: one block turns those into, per tile, the first
//      boundary in any later tile (a suffix-min over tiles);
//   3. count_finish: an in-tile reverse suffix-min of boundary positions,
//      capped by the tile's suffix value, gives every head its next
//      boundary; cnt and keep are written.
// No head walks forward over its run, so a poly-A run or the long sentinel
// tail costs the same per slot as anything else.
//
// Bound on the H100: HBM bytes. Pass 1 reads 4W B/slot and writes 1 B; pass
// 3 reads 1 B and writes 5 B (cnt int32 + keep bool); pass 2 touches 8 B per
// 1024 slots. Reading the flags instead of the words again keeps pass 3 at a
// sixth of the key bytes at W = 2.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // consecutive slots per thread
constexpr int kTile = kThreads * kItems;
constexpr int kSuffixThreads = 1024;
constexpr int kMaxWords = 6;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct WordRows {
  const uint32_t* row[kMaxWords];
};

// Exclusive suffix-min over the threads of a block: the min of `v` over all
// threads with a larger index (INT_MAX for the last). `warp_buf` holds one
// int per warp.
template <int kBlock>
__device__ __forceinline__ int block_suffix_min_excl(int v, int* warp_buf) {
  constexpr int kNumWarps = kBlock / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;  // inclusive suffix-min within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl = min(incl, y);
  }
  if (lane == 0) warp_buf[warp] = incl;
  __syncthreads();
  int later_warps = INT_MAX;
  for (int w = warp + 1; w < kNumWarps; ++w) later_warps = min(later_warps, warp_buf[w]);
  int excl = __shfl_down_sync(kFull, incl, 1);
  if (lane == 31) excl = INT_MAX;
  __syncthreads();  // warp_buf may be reused by the caller
  return min(excl, later_warps);
}

__global__ void __launch_bounds__(kThreads)
count_flags(WordRows words, int n_words, int64_t n, uint8_t* __restrict__ flags,
            int* __restrict__ tile_first) {
  __shared__ int warp_min[kThreads / 32];
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  int first = INT_MAX;
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    if (i >= n) {
      flags[i] = 0;  // the flag buffer is padded to whole tiles
      continue;
    }
    bool boundary = i == 0;
    bool sentinel = true;
    for (int w = 0; w < n_words; ++w) {
      const uint32_t v = words.row[w][i];
      sentinel = sentinel && v == 0xFFFFFFFFu;
      if (i > 0) boundary = boundary || v != words.row[w][i - 1];
    }
    flags[i] = static_cast<uint8_t>(boundary) | (static_cast<uint8_t>(sentinel) << 1);
    if (boundary && first == INT_MAX) first = static_cast<int>(i);
  }
  first = __reduce_min_sync(kFull, first);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = first;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = INT_MAX;
    for (int w = 0; w < kThreads / 32; ++w) m = min(m, warp_min[w]);
    tile_first[blockIdx.x] = m;
  }
}

// tile_next[t] = min(tile_first[t+1 ..]), or n when no later tile has a
// boundary. One block walks the tiles right to left in chunks, carrying
// the min of the chunks already done.
__global__ void __launch_bounds__(kSuffixThreads)
count_tile_suffix(const int* __restrict__ tile_first, int num_tiles, int n,
                  int* __restrict__ tile_next) {
  __shared__ int warp_buf[kSuffixThreads / 32];
  __shared__ int chunk_min;
  int carry = n;
  for (int end = num_tiles; end > 0; end -= kSuffixThreads) {
    const int t = end - kSuffixThreads + static_cast<int>(threadIdx.x);
    const int v = t >= 0 ? tile_first[t] : INT_MAX;
    const int later = block_suffix_min_excl<kSuffixThreads>(v, warp_buf);
    if (t >= 0) tile_next[t] = min(later, carry);
    if (threadIdx.x == 0) chunk_min = min(later, v);
    __syncthreads();
    carry = min(carry, chunk_min);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
count_finish(const uint8_t* __restrict__ flags,
             const int* __restrict__ tile_next, int64_t n, int lower,
             int upper, int* __restrict__ cnt, uint8_t* __restrict__ keep) {
  __shared__ int warp_buf[kThreads / 32];
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  const uchar4 f4 = *reinterpret_cast<const uchar4*>(flags + base);
  const uint8_t f[kItems] = {f4.x, f4.y, f4.z, f4.w};
  int mine = INT_MAX;  // my first boundary
  for (int j = kItems - 1; j >= 0; --j) {
    if (f[j] & 1) mine = static_cast<int>(base + j);
  }
  int next = min(block_suffix_min_excl<kThreads>(mine, warp_buf),
                 tile_next[blockIdx.x]);
  for (int j = kItems - 1; j >= 0; --j) {
    const int64_t i = base + j;
    if (i < n) {
      const bool head = f[j] == 1;  // a boundary that is not a sentinel
      const int c = head ? next - static_cast<int>(i) : 0;
      cnt[i] = c;
      keep[i] = head && c >= lower && c <= upper;
    }
    if (f[j] & 1) next = static_cast<int>(i);
  }
}

}  // namespace

// Scratch in bytes: flags padded to whole tiles, then tile_first and
// tile_next (int32 each).
extern "C" int64_t hk_fused_count_scratch(int64_t n) {
  const int64_t num_tiles = (n + kTile - 1) / kTile;
  return num_tiles * kTile + 2 * num_tiles * static_cast<int64_t>(sizeof(int));
}

// words: n_words device pointers to sorted (n,) uint32 rows; cnt (n,) int32
// and keep (n,) bool out; scratch of hk_fused_count_scratch(n) bytes.
// Returns cudaGetLastError() of the first failing launch, else 0.
extern "C" int hk_fused_count(void* const* words, int n_words, int64_t n,
                              int lower, int upper, void* cnt, void* keep,
                              void* scratch, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || n_words < 1 ||
      n_words > kMaxWords) {
    return cudaErrorInvalidValue;
  }
  const int num_tiles = static_cast<int>((n + kTile - 1) / kTile);
  auto* flags = static_cast<uint8_t*>(scratch);
  int* tile_first = reinterpret_cast<int*>(flags + static_cast<int64_t>(num_tiles) * kTile);
  int* tile_next = tile_first + num_tiles;
  WordRows rows{};
  for (int w = 0; w < n_words; ++w) {
    rows.row[w] = static_cast<const uint32_t*>(words[w]);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  count_flags<<<num_tiles, kThreads, 0, s>>>(rows, n_words, n, flags, tile_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  count_tile_suffix<<<1, kSuffixThreads, 0, s>>>(tile_first, num_tiles,
                                                 static_cast<int>(n), tile_next);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  count_finish<<<num_tiles, kThreads, 0, s>>>(flags, tile_next, n, lower, upper,
                                              static_cast<int*>(cnt),
                                              static_cast<uint8_t*>(keep));
  return static_cast<int>(cudaGetLastError());
}
