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
// Design (radix_pass.cuh has the detail): 8-bit digits; one kernel counts
// all 4W digits of every key, then 4W passes from the lowest byte of word
// W-1 up to the top byte of word 0, one kernel each, which reads every row
// once, finds its tile's place by decoupled look-back and writes every row
// once, in digit order within the tile so that the writes coalesce. Pass 0
// reads the caller's rows and writes rows_b; the later passes go back and
// forth between rows_a and rows_b and, 4W being even, end in rows_a. The
// caller's rows are only read, so nothing is copied in.
//
// Bound on the H100: HBM bytes, 4W (histogram) + 4W passes x 8R B per
// element for R rows: 136 B at W = R = 2, where the sorted rows alone
// (in once, out once) are 16 B. The rows stay separate (n,) words between
// passes: with the tile of 8192 elements a digit's segment averages 32
// elements, one full 128-byte line per row.

#include <cstdint>
#include <cuda_runtime.h>

#include "radix_pass.cuh"

namespace {

struct SortRows {
  const uint32_t* src[kMaxRows];
  uint32_t* dst[kMaxRows];
};

// The key words as they lie in the rows, for the histogram.
template <int W>
struct RowKeys {
  const uint32_t* row[W];
  __device__ __forceinline__ void stage(int64_t, int64_t) const {}
  __device__ __forceinline__ void get(int64_t i, int, uint32_t (&key)[W]) const {
#pragma unroll
    for (int w = 0; w < W; ++w) key[w] = row[w][i];
  }
};

template <int W>
__global__ void __launch_bounds__(kHistThreads)
digit_histogram(RowKeys<W> keys, int64_t n, unsigned* __restrict__ hist) {
  histogram_tiles<W>(keys, n, hist);
}

template <int W>
cudaError_t launch_histogram(void* const* rows, int64_t n, unsigned* hist,
                             cudaStream_t s) {
  RowKeys<W> keys{};
  for (int w = 0; w < W; ++w) keys.row[w] = static_cast<const uint32_t*>(rows[w]);
  digit_histogram<W><<<histogram_blocks(n), kHistThreads, 0, s>>>(keys, n, hist);
  return cudaGetLastError();
}

// A pass's elements as they lie in the rows: the digit from one key row,
// every row through the exchange, the key row first.
template <int kThreads, int kItems>
struct RowSource {
  const SortRows& rows;
  int n_rows, key_row, shift;
  uint32_t key[kItems];

  __device__ __forceinline__ void stage(int64_t, int64_t, unsigned char*) const {}
  __device__ __forceinline__ void load(int j, int64_t i, int) {
    key[j] = rows.src[key_row][i];
  }
  __device__ static constexpr int num_digits() { return kRadix; }
  __device__ __forceinline__ unsigned digit(int j) const {
    return (key[j] >> shift) & 0xFFu;
  }
  template <bool kFullTile>
  __device__ __forceinline__ void scatter(PassShared<kThreads, kItems>& sh,
                                          const int (&pos)[kItems], int tile_n,
                                          int64_t tile_base) const {
    int dst[kItems];
    exchange_row<kThreads, kItems, true, kFullTile>(sh, key, pos, dst, tile_n,
                                                    shift, rows.dst[key_row]);
    const int first = (threadIdx.x >> 5) * 32 * kItems + (threadIdx.x & 31);
    for (int q = 0; q < n_rows; ++q) {
      if (q == key_row) continue;
      const uint32_t* __restrict__ src = rows.src[q];
      uint32_t vals[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int local = first + 32 * j;
        vals[j] = in_tile<kFullTile>(local, tile_n) ? src[tile_base + local] : 0u;
      }
      exchange_row<kThreads, kItems, false, kFullTile>(sh, vals, pos, dst, tile_n,
                                                       shift, rows.dst[q]);
    }
  }
};

template <int kThreads, int kItems>
__global__ void __launch_bounds__(kThreads)
radix_pass(const __grid_constant__ SortRows rows, int n_rows, int key_row,
           int shift, int64_t n, const unsigned* __restrict__ hist,
           unsigned* ticket, unsigned* desc) {
  RowSource<kThreads, kItems> source{rows, n_rows, key_row, shift, {}};
  radix_pass_tile<kThreads, kItems>(source, n, hist, ticket, desc);
}

template <int kThreads, int kItems>
cudaError_t launch_pass(const SortRows& rows, int n_rows, int n_keys, int pass,
                        int64_t n, const SortScratch& sc, cudaStream_t s) {
  constexpr int kTile = kThreads * kItems;
  static_assert(kTile >= kMinTile, "the scratch is sized for tiles of kMinTile");
  const int num_tiles = static_cast<int>((n + kTile - 1) / kTile);
  const int shared = static_cast<int>(sizeof(PassShared<kThreads, kItems>));
  cudaError_t err = reset_descriptors(sc, num_tiles, s);
  if (err != cudaSuccess) return err;
  // Above 48 KB a kernel has to opt in to its dynamic shared memory.
  err = cudaFuncSetAttribute(radix_pass<kThreads, kItems>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  radix_pass<kThreads, kItems><<<num_tiles, kThreads, shared, s>>>(
      rows, n_rows, n_keys - 1 - pass / 4, 8 * (pass % 4), n,
      sc.hist + pass * kRadix, sc.tickets + pass, sc.desc);
  return cudaGetLastError();
}

// The tile: 512 threads x 16 items = 8192 slots, which takes 50 KB of the
// block's shared memory (a row of the tile and the warps' counters). A
// larger tile spills registers (16 items a thread already take 118), a tile
// of 4096 slots was slower once payload rows ride along.
constexpr int kPassThreads = 512;
constexpr int kPassItems = 16;

bool bad_shape(int n_keys, int n_rows, int64_t n) {
  return n <= 0 || n >= (int64_t{1} << 31) || n_keys < 1 ||
         n_keys > kMaxKeyWords || n_rows < n_keys || n_rows > kMaxRows;
}

}  // namespace

// Scratch the sort needs, in int32 elements.
extern "C" int64_t hk_radix_sort_scratch(int64_t n) { return scratch_words(n); }

// The passes first_pass .. 4 * n_keys - 1 of the sort, first_pass >= 1, over
// a scratch whose digit counts are filled in. rows_a, rows_b: n_rows device
// pointers each to (n,) uint32 rows, the first n_keys of them key words. Odd
// passes read rows_b and write rows_a, even passes the other way, so the
// result lands in rows_a after the last (odd) pass. Returns the first CUDA
// error, else 0.
extern "C" int hk_radix_sort_passes(void* const* rows_a, void* const* rows_b,
                                    int n_keys, int n_rows, int64_t n,
                                    void* scratch, void* stream,
                                    int first_pass) {
  if (bad_shape(n_keys, n_rows, n) || first_pass < 1) {
    return cudaErrorInvalidValue;
  }
  const SortScratch sc = carve_scratch(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  SortRows a_to_b{}, b_to_a{};
  for (int q = 0; q < n_rows; ++q) {
    a_to_b.src[q] = static_cast<const uint32_t*>(rows_a[q]);
    a_to_b.dst[q] = static_cast<uint32_t*>(rows_b[q]);
    b_to_a.src[q] = static_cast<const uint32_t*>(rows_b[q]);
    b_to_a.dst[q] = static_cast<uint32_t*>(rows_a[q]);
  }
  for (int pass = first_pass; pass < 4 * n_keys; ++pass) {
    const cudaError_t err = launch_pass<kPassThreads, kPassItems>(
        pass % 2 == 0 ? a_to_b : b_to_a, n_rows, n_keys, pass, n, sc, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The whole sort. rows_in: the caller's n_rows rows, read only; rows_a,
// rows_b: as many rows of scratch each, neither initialised; the sorted rows
// land in rows_a.
extern "C" int hk_radix_sort(void* const* rows_in, void* const* rows_a,
                             void* const* rows_b, int n_keys, int n_rows,
                             int64_t n, void* scratch, void* stream) {
  if (bad_shape(n_keys, n_rows, n)) return cudaErrorInvalidValue;
  const SortScratch sc = carve_scratch(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = reset_header(sc, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (n_keys) {
    case 1: err = launch_histogram<1>(rows_in, n, sc.hist, s); break;
    case 2: err = launch_histogram<2>(rows_in, n, sc.hist, s); break;
    case 3: err = launch_histogram<3>(rows_in, n, sc.hist, s); break;
    case 4: err = launch_histogram<4>(rows_in, n, sc.hist, s); break;
    case 5: err = launch_histogram<5>(rows_in, n, sc.hist, s); break;
    case 6: err = launch_histogram<6>(rows_in, n, sc.hist, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  SortRows in_to_b{};
  for (int q = 0; q < n_rows; ++q) {
    in_to_b.src[q] = static_cast<const uint32_t*>(rows_in[q]);
    in_to_b.dst[q] = static_cast<uint32_t*>(rows_b[q]);
  }
  err = launch_pass<kPassThreads, kPassItems>(in_to_b, n_rows, n_keys, 0, n, sc, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return hk_radix_sort_passes(rows_a, rows_b, n_keys, n_rows, n, scratch,
                              stream, 1);
}
