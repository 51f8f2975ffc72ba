// One pass of a pairwise merge of sorted runs: W uint32 key words
// (lexicographic, unsigned, word 0 most significant) with payload rows
// riding along.
//
// Replaces hysortk_tpu/ops/pallas_sort.py merge_runs (the bitonic
// merge_levels kernels entered at region size 2 * run_len, with
// pallas_msort._tail_member_kernel as their block-local tail). The TPU
// version is a compare-exchange network over odd-run-reversed input; here it
// is a merge-path merge, which does O(n) compares per pass instead of
// O(n log run_len), needs no reversal and is stable: on equal keys the left
// run's rows come first, so merging all runs equals a stable sort of their
// concatenation. Unsigned compares put the all-ones sentinel last without a
// special case.
//
// A pass merges each pair of neighbouring runs of `len` slots into one of
// 2 * len; the caller runs log2(runs) passes, ping-ponging between buffers.
//   1. merge_partition: for every output tile of kTile slots, a binary
//      search on the tile's diagonal finds how many of the pair's first
//      d outputs come from the left run;
//   2. merge_tiles: a block loads its tile's two input segments' keys into
//      shared memory; each thread finds its own split there by the same
//      search, merges kItems outputs serially and records where each came
//      from; then the block writes every row coalesced, keys from shared
//      memory and payload rows gathered by source index.
//
// Bound on the H100: HBM bytes, every row read once and written once per
// pass (8 B x rows per slot); log2(runs) passes move that many times the
// single-pass bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 8;  // outputs merged serially per thread
constexpr int kTile = kThreads * kItems;
constexpr int kPartitionThreads = 256;
constexpr int kMaxWords = 6;
constexpr int kMaxRows = 8;

struct MergeRows {
  const uint32_t* src[kMaxRows];
  uint32_t* dst[kMaxRows];
};

// key(a) < key(b), for slots of the source rows.
template <int W>
__device__ __forceinline__ bool less_global(const MergeRows& rows, int64_t a,
                                            int64_t b) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t x = rows.src[w][a], y = rows.src[w][b];
    if (x != y) return x < y;
  }
  return false;
}

// key(a) < key(b), for slots of the tile's keys in shared memory.
template <int W>
__device__ __forceinline__ bool less_shared(uint32_t (*keys)[kTile], int a,
                                            int b) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t x = keys[w][a], y = keys[w][b];
    if (x != y) return x < y;
  }
  return false;
}

// part[t] = how many of the first d outputs of tile t's pair come from the
// left run, d being the tile's first output slot within the pair. Ties go
// to the left run: the split is the least a with right[d-1-a] < left[a].
template <int W>
__global__ void __launch_bounds__(kPartitionThreads)
merge_partition(MergeRows rows, int64_t len, int tiles_per_pair,
                int num_tiles, int* __restrict__ part) {
  const int t = blockIdx.x * kPartitionThreads + threadIdx.x;
  if (t >= num_tiles) return;
  const int64_t pair = t / tiles_per_pair;
  const int64_t d = static_cast<int64_t>(t % tiles_per_pair) * kTile;
  const int64_t left = pair * 2 * len, right = left + len;
  int64_t lo = d > len ? d - len : 0, hi = d < len ? d : len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (less_global<W>(rows, right + d - 1 - mid, left + mid)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  part[t] = static_cast<int>(lo);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
merge_tiles(MergeRows rows, int n_rows, int64_t len, int tiles_per_pair,
            const int* __restrict__ part) {
  __shared__ uint32_t keys[W][kTile];
  __shared__ uint16_t source[kTile];  // output slot -> slot of `keys`
  const int t = blockIdx.x;
  const int64_t pair = t / tiles_per_pair;
  const int tile_in_pair = t % tiles_per_pair;
  const int64_t d0 = static_cast<int64_t>(tile_in_pair) * kTile;
  const int64_t d1 = d0 + kTile < 2 * len ? d0 + kTile : 2 * len;
  const int64_t a0 = part[t];
  const int64_t a1 = tile_in_pair == tiles_per_pair - 1 ? len : part[t + 1];
  const int64_t left = pair * 2 * len + a0;            // first left-run slot
  const int64_t right = pair * 2 * len + len + d0 - a0;  // first right-run slot
  const int na = static_cast<int>(a1 - a0);
  const int total = static_cast<int>(d1 - d0);
  const int nb = total - na;

  // keys[.][0:na) = the left segment, keys[.][na:total) = the right one.
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int64_t g = i < na ? left + i : right + (i - na);
#pragma unroll
    for (int w = 0; w < W; ++w) keys[w][i] = rows.src[w][g];
  }
  __syncthreads();

  const int diag = min(static_cast<int>(threadIdx.x) * kItems, total);
  int lo = max(diag - nb, 0), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (less_shared<W>(keys, na + diag - 1 - mid, mid)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int ia = lo, ib = diag - lo;
  for (int j = 0; j < kItems && diag + j < total; ++j) {
    const bool take_left =
        ib >= nb || (ia < na && !less_shared<W>(keys, na + ib, ia));
    source[diag + j] = static_cast<uint16_t>(take_left ? ia : na + ib);
    if (take_left) {
      ++ia;
    } else {
      ++ib;
    }
  }
  __syncthreads();

  const int64_t out = pair * 2 * len + d0;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int s = source[i];
#pragma unroll
    for (int w = 0; w < W; ++w) rows.dst[w][out + i] = keys[w][s];
    const int64_t g = s < na ? left + s : right + (s - na);
    for (int q = W; q < n_rows; ++q) rows.dst[q][out + i] = rows.src[q][g];
  }
}

template <int W>
cudaError_t merge_pass(const MergeRows& rows, int n_rows, int64_t len,
                       int tiles_per_pair, int num_tiles, int* part,
                       cudaStream_t s) {
  const int blocks = (num_tiles + kPartitionThreads - 1) / kPartitionThreads;
  merge_partition<W><<<blocks, kPartitionThreads, 0, s>>>(
      rows, len, tiles_per_pair, num_tiles, part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_tiles<W><<<num_tiles, kThreads, 0, s>>>(rows, n_rows, len,
                                               tiles_per_pair, part);
  return cudaGetLastError();
}

int64_t tiles_for(int64_t n, int64_t len) {
  const int64_t tiles_per_pair = (2 * len + kTile - 1) / kTile;
  return n / (2 * len) * tiles_per_pair;
}

}  // namespace

// Scratch of one pass, in int32 elements: one split per output tile.
extern "C" int64_t hk_merge_pass_scratch(int64_t n, int64_t len) {
  return tiles_for(n, len);
}

// src, dst: n_rows device pointers each to (n,) uint32 rows, the first
// n_keys of them key words. src holds n / len sorted runs of len slots (an
// even number of runs); dst receives n / (2 * len) sorted runs of 2 * len.
// src is not modified and must not overlap dst. scratch: int32 elements as
// hk_merge_pass_scratch(n, len) says. Returns cudaGetLastError() of the
// first failing launch, else 0.
extern "C" int hk_merge_pass(void* const* src, void* const* dst, int n_keys,
                             int n_rows, int64_t n, int64_t len, void* scratch,
                             void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || len <= 0 || n % (2 * len) != 0 ||
      n_keys < 1 || n_keys > kMaxWords || n_rows < n_keys ||
      n_rows > kMaxRows) {
    return cudaErrorInvalidValue;
  }
  MergeRows rows{};
  for (int q = 0; q < n_rows; ++q) {
    rows.src[q] = static_cast<const uint32_t*>(src[q]);
    rows.dst[q] = static_cast<uint32_t*>(dst[q]);
  }
  const int tiles_per_pair = static_cast<int>((2 * len + kTile - 1) / kTile);
  const int num_tiles = static_cast<int>(tiles_for(n, len));
  int* part = static_cast<int*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_keys) {
    case 1: err = merge_pass<1>(rows, n_rows, len, tiles_per_pair, num_tiles, part, s); break;
    case 2: err = merge_pass<2>(rows, n_rows, len, tiles_per_pair, num_tiles, part, s); break;
    case 3: err = merge_pass<3>(rows, n_rows, len, tiles_per_pair, num_tiles, part, s); break;
    case 4: err = merge_pass<4>(rows, n_rows, len, tiles_per_pair, num_tiles, part, s); break;
    case 5: err = merge_pass<5>(rows, n_rows, len, tiles_per_pair, num_tiles, part, s); break;
    case 6: err = merge_pass<6>(rows, n_rows, len, tiles_per_pair, num_tiles, part, s); break;
  }
  return static_cast<int>(err);
}
