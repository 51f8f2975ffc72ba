// Stable LSD radix sort of W uint32 key words (lexicographic, word 0 most
// significant) with payload words riding along.
//
// Replaces hysortk_tpu/ops/pallas_sort.py sort_words on its production path:
// pallas_msort.block_sort_member (phase A, the in-block bitonic network) plus
// pallas_sort.merge_levels (the bitonic merge levels). The TPU sort is a
// compare-exchange network shaped by the TPU's vector registers and VMEM;
// none of that layout is carried over (no member-tile permutation, no roll
// partners, no pow2 padding). Unsigned digits put the all-ones sentinel last
// without a special case.
//
// Design: 8-bit digits, 4W passes from the lowest byte of word W-1 up to the
// top byte of word 0, ping-ponging between two sets of rows. Each pass is
//   1. radix_histogram: per-tile digit counts, counts[digit][tile];
//   2. radix_scan: each digit's row of tile counts exclusive-scanned, and
//      the digit totals;
//   3. radix_scatter: a stable scatter. A tile is walked in rounds of 256
//      elements; within a warp equal digits are ranked with
//      __match_any_sync, across the 8 warps of a round in warp order, and
//      rounds in order, so equal digits keep their input order. Stability is
//      what makes LSD correct.
//
// Bound on the H100: HBM traffic, about 4W passes x 8W bytes per element for
// keys only (each pass reads and writes every word of every element; the
// histogram re-reads one word), i.e. 64 B/element at W = 2. The scatter's
// writes land in 256 buckets per round and are not coalesced; a local
// shared-memory sort before the write and onesweep-style decoupled
// look-back (one read per pass instead of two) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;  // == kRadix: one digit per thread where needed
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // elements per tile
constexpr int kScanThreads = 1024;
constexpr int kMaxRows = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kNoDigit = kRadix;  // lanes past the end of the array

struct SortRows {
  const uint32_t* src[kMaxRows];
  uint32_t* dst[kMaxRows];
};

__global__ void __launch_bounds__(kThreads)
radix_histogram(const uint32_t* __restrict__ key, int64_t n, int shift,
                int num_tiles, int* __restrict__ counts) {
  __shared__ int hist[kRadix];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const unsigned lane = threadIdx.x & 31;
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    const unsigned d = i < n ? (key[i] >> shift) & 0xFFu : kNoDigit;
    // One shared atomic per distinct digit in the warp: a long run of equal
    // keys (the sentinel tail) would otherwise serialise 32 atomics.
    const unsigned peers = __match_any_sync(kFull, d);
    if (d != kNoDigit && lane == static_cast<unsigned>(__ffs(peers) - 1)) {
      atomicAdd(&hist[d], __popc(peers));
    }
  }
  __syncthreads();
  counts[static_cast<int64_t>(threadIdx.x) * num_tiles + blockIdx.x] =
      hist[threadIdx.x];
}

// One block per digit: exclusive scan of counts[digit][0..num_tiles) in
// place, in chunks of kScanThreads with a carry; totals[digit] = row sum.
__global__ void __launch_bounds__(kScanThreads)
radix_scan(int* __restrict__ counts, int num_tiles, int* __restrict__ totals) {
  __shared__ int warp_sums[kScanThreads / 32];
  int* row = counts + static_cast<int64_t>(blockIdx.x) * num_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int c = 0; c < num_tiles; c += kScanThreads) {
    const int i = c + threadIdx.x;
    const int v = i < num_tiles ? row[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const int before = warp == 0 ? 0 : warp_sums[warp - 1];
    if (i < num_tiles) row[i] = carry + before + x - v;
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kThreads)
radix_scatter(SortRows rows, int n_rows, int key_row, int64_t n, int shift,
              int num_tiles, const int* __restrict__ counts,
              const int* __restrict__ totals) {
  __shared__ int digit_next[kRadix];  // next output slot of each digit
  __shared__ int warp_slot[kWarps][kRadix];
  __shared__ int scan_tmp[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // This tile's first slot for digit `tid`: all smaller digits (exclusive
  // scan of the totals) plus this digit in earlier tiles (scanned counts).
  {
    const int v = totals[tid];
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) scan_tmp[warp] = x;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += scan_tmp[w];
    digit_next[tid] =
        before + x - v + counts[static_cast<int64_t>(tid) * num_tiles + blockIdx.x];
  }

  const uint32_t* key = rows.src[key_row];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_slot[w][tid] = 0;
    __syncthreads();
    const int64_t i = base + r * kThreads + tid;
    const bool in = i < n;
    const unsigned d = in ? (key[i] >> shift) & 0xFFu : kNoDigit;
    const unsigned peers = __match_any_sync(kFull, d);
    const int rank = __popc(peers & lanes_below);
    if (in && rank == 0) warp_slot[warp][d] = __popc(peers);
    __syncthreads();
    {  // digit `tid`: warp counts -> each warp's first slot, in warp order
      int next = digit_next[tid];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_slot[w][tid];
        warp_slot[w][tid] = next;
        next += c;
      }
      digit_next[tid] = next;
    }
    __syncthreads();
    if (in) {
      const int pos = warp_slot[warp][d] + rank;
      for (int q = 0; q < n_rows; ++q) rows.dst[q][pos] = rows.src[q][i];
    }
    __syncthreads();
  }
}

}  // namespace

// Scratch the sort needs, in int32 elements: counts[256][num_tiles] + totals.
extern "C" int64_t hk_radix_sort_scratch(int64_t n) {
  const int64_t num_tiles = (n + kTile - 1) / kTile;
  return kRadix * num_tiles + kRadix;
}

// rows_a: n_rows device pointers to (n,) uint32 rows, the first n_keys of
// them key words; sorted in place (the result lands back in rows_a after the
// even number of passes). rows_b: as many rows of scratch. Returns
// cudaGetLastError() of the first failing launch, else 0.
extern "C" int hk_radix_sort(void* const* rows_a, void* const* rows_b,
                             int n_keys, int n_rows, int64_t n, void* scratch,
                             void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || n_keys < 1 || n_rows < n_keys ||
      n_rows > kMaxRows) {
    return cudaErrorInvalidValue;
  }
  const int num_tiles = static_cast<int>((n + kTile - 1) / kTile);
  int* counts = static_cast<int*>(scratch);
  int* totals = counts + static_cast<int64_t>(kRadix) * num_tiles;
  const auto s = static_cast<cudaStream_t>(stream);
  SortRows a_to_b{}, b_to_a{};
  for (int q = 0; q < n_rows; ++q) {
    a_to_b.src[q] = static_cast<const uint32_t*>(rows_a[q]);
    a_to_b.dst[q] = static_cast<uint32_t*>(rows_b[q]);
    b_to_a.src[q] = static_cast<const uint32_t*>(rows_b[q]);
    b_to_a.dst[q] = static_cast<uint32_t*>(rows_a[q]);
  }
  for (int pass = 0; pass < 4 * n_keys; ++pass) {
    const int word = n_keys - 1 - pass / 4;
    const int shift = 8 * (pass % 4);
    const SortRows& rows = pass % 2 == 0 ? a_to_b : b_to_a;
    radix_histogram<<<num_tiles, kThreads, 0, s>>>(rows.src[word], n, shift,
                                                  num_tiles, counts);
    radix_scan<<<kRadix, kScanThreads, 0, s>>>(counts, num_tiles, totals);
    radix_scatter<<<num_tiles, kThreads, 0, s>>>(rows, n_rows, word, n, shift,
                                                num_tiles, counts, totals);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
