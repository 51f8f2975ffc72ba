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
// top byte of word 0, ping-ponging between two sets of rows. Each pass is a
// tile histogram, a scan and a stable scatter (radix_pass.cuh), here over
// elements read from the rows.
//
// Bound on the H100: HBM traffic, about 4W passes x 8W bytes per element for
// keys only (each pass reads and writes every word of every element; the
// histogram re-reads one word), i.e. 64 B/element at W = 2. The scatter's
// writes land in 256 buckets per round and are not coalesced; a local
// shared-memory sort before the write and onesweep-style decoupled
// look-back (one read per pass instead of two) are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "radix_pass.cuh"

namespace {

struct SortRows {
  const uint32_t* src[kMaxRows];
  uint32_t* dst[kMaxRows];
};

// A pass's elements as they lie in the rows: the digit from one key row, the
// store a copy of every row.
struct RowSource {
  const SortRows* rows;  // null where only digits are wanted
  const uint32_t* key;
  int n_rows, shift;
  int64_t i;

  __device__ __forceinline__ unsigned load(int64_t at, int) {
    i = at;
    return (key[at] >> shift) & 0xFFu;
  }
  __device__ __forceinline__ void store(int pos) const {
    for (int q = 0; q < n_rows; ++q) rows->dst[q][pos] = rows->src[q][i];
  }
};

__global__ void __launch_bounds__(kThreads)
radix_histogram(const uint32_t* __restrict__ key, int64_t n, int shift,
                int num_tiles, int* __restrict__ counts) {
  RowSource source{nullptr, key, 0, shift, 0};
  histogram_tile(source, n, num_tiles, counts);
}

__global__ void __launch_bounds__(kThreads)
radix_scatter(const __grid_constant__ SortRows rows, int n_rows, int key_row, int64_t n, int shift,
              int num_tiles, const int* __restrict__ counts,
              const int* __restrict__ totals) {
  RowSource source{&rows, rows.src[key_row], n_rows, shift, 0};
  scatter_tile(source, n, num_tiles, counts, totals);
}

}  // namespace

// Scratch the sort needs, in int32 elements: counts[256][num_tiles] + totals.
extern "C" int64_t hk_radix_sort_scratch(int64_t n) {
  const int64_t num_tiles = (n + kTile - 1) / kTile;
  return kRadix * num_tiles + kRadix;
}

// The passes first_pass .. 4 * n_keys - 1 of the sort. rows_a: n_rows device
// pointers to (n,) uint32 rows, the first n_keys of them key words; rows_b: as
// many rows of scratch. Even passes read rows_a and write rows_b, odd passes
// the other way, so the result lands in rows_a after the last (odd) pass.
// Returns cudaGetLastError() of the first failing launch, else 0.
extern "C" int hk_radix_sort_passes(void* const* rows_a, void* const* rows_b,
                                    int n_keys, int n_rows, int64_t n,
                                    void* scratch, void* stream,
                                    int first_pass) {
  if (n <= 0 || n >= (int64_t{1} << 31) || n_keys < 1 || n_rows < n_keys ||
      n_rows > kMaxRows || first_pass < 0) {
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
  for (int pass = first_pass; pass < 4 * n_keys; ++pass) {
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

// The whole sort, in place in rows_a.
extern "C" int hk_radix_sort(void* const* rows_a, void* const* rows_b,
                             int n_keys, int n_rows, int64_t n, void* scratch,
                             void* stream) {
  return hk_radix_sort_passes(rows_a, rows_b, n_keys, n_rows, n, scratch,
                              stream, 0);
}
