// Key build fused into the sort: codes (N,) int8 + valid (N,) bool -> W sorted
// key words, the all-ones sentinel last. Keys only.
//
// Replaces hysortk_tpu/ops/pallas_sort.py sort_codes_fused, i.e. the kernel
// pallas_msort.block_sort_keybuild (the key build inside phase A of the
// bitonic block sort) and the merge levels behind it. What the TPU kernel
// buys is kept, not its shape: the unsorted key words never reach device
// memory. Here the key build is fused into pass 0 of the LSD radix sort
// (radix_pass.cuh): pass 0's histogram and pass 0's scatter both derive each
// slot's canonical key from the codes (canonical_key.cuh, the definition
// keybuild.cu uses too) instead of reading key rows, and the scatter writes
// the W words straight to their pass-0 places. Passes 1 .. 4W-1 are the
// plain ones of radix_sort.cu.
//
// Bound on the H100: HBM bytes, 2 B read (code + valid) and 4W B written per
// slot. Against the unfused pair (key build, then the sort on a copy of its
// rows) the fusion never writes the unsorted key rows, never copies them,
// and pass 0 reads 2 B per slot twice instead of 4 B and then 4W B; it pays
// for that with the key arithmetic done twice. The 4W - 1 later passes,
// whose scattered writes set the sort's time, are untouched. Design: a
// block stages its tile's 4096 codes plus the (16W - 1)-base halo in shared
// memory once, as bytes; reads past N are masked to 0 in both kernels, so
// both derive the same bits; an invalid slot's key is all ones, so its
// digit is 0xFF in every pass.

#include <cstdint>
#include <cuda_runtime.h>

#include "canonical_key.cuh"
#include "radix_pass.cuh"

// The later passes, from radix_sort.cu.
extern "C" int hk_radix_sort_passes(void* const* rows_a, void* const* rows_b,
                                    int n_keys, int n_rows, int64_t n,
                                    void* scratch, void* stream,
                                    int first_pass);

namespace {

constexpr int kMaxWords = 6;

struct KeyRows {
  uint32_t* row[kMaxWords];
};

// Stage the tile's codes and halo: codes[base .. base + kTile + 16W - 1).
template <int W>
__device__ __forceinline__ void stage_codes(const int8_t* __restrict__ codes,
                                            int64_t n, uint8_t* tile) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int j = threadIdx.x; j < kTile + 16 * W - 1; j += kThreads) {
    const int64_t p = base + j;
    tile[j] = p < n ? static_cast<uint8_t>(codes[p]) & 3u : 0u;
  }
  __syncthreads();
}

// Pass 0's elements: each slot's key derived from the staged codes; the
// digit is the lowest byte of the last word, the store writes the W words.
template <int W>
struct CodeSource {
  const uint8_t* tile;
  const uint8_t* valid;
  int k;
  KeyRows out;
  uint32_t key[W];

  __device__ __forceinline__ unsigned load(int64_t i, int local) {
    if (valid[i]) {
      hk::canonical_key<W>(tile + local, k, key);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) key[w] = kFull;
    }
    return key[W - 1] & 0xFFu;
  }
  __device__ __forceinline__ void store(int pos) const {
#pragma unroll
    for (int w = 0; w < W; ++w) out.row[w][pos] = key[w];
  }
};

template <int W>
__global__ void __launch_bounds__(kThreads)
fused_histogram(const int8_t* __restrict__ codes,
                const uint8_t* __restrict__ valid, int64_t n, int k,
                int num_tiles, int* __restrict__ counts) {
  __shared__ uint8_t tile[kTile + 16 * W];
  stage_codes<W>(codes, n, tile);
  CodeSource<W> source{tile, valid, k, KeyRows{}, {}};
  histogram_tile(source, n, num_tiles, counts);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
fused_scatter(const int8_t* __restrict__ codes,
              const uint8_t* __restrict__ valid, int64_t n, int k,
              KeyRows out, int num_tiles, const int* __restrict__ counts,
              const int* __restrict__ totals) {
  __shared__ uint8_t tile[kTile + 16 * W];
  stage_codes<W>(codes, n, tile);
  CodeSource<W> source{tile, valid, k, out, {}};
  scatter_tile(source, n, num_tiles, counts, totals);
}

template <int W>
cudaError_t fused_pass0(const int8_t* codes, const uint8_t* valid, int64_t n,
                        int k, const KeyRows& out, int num_tiles, int* counts,
                        int* totals, cudaStream_t s) {
  fused_histogram<W><<<num_tiles, kThreads, 0, s>>>(codes, valid, n, k,
                                                    num_tiles, counts);
  radix_scan<<<kRadix, kScanThreads, 0, s>>>(counts, num_tiles, totals);
  fused_scatter<W><<<num_tiles, kThreads, 0, s>>>(codes, valid, n, k, out,
                                                  num_tiles, counts, totals);
  return cudaGetLastError();
}

}  // namespace

// codes (n,) int8, valid (n,) bool; rows_a, rows_b: W device pointers each to
// (n,) uint32 rows, W = ceil(k/16) in 1..6, neither initialised; scratch: as
// hk_radix_sort_scratch(n). The sorted key words land in rows_a. Returns
// cudaGetLastError() of the first failing launch, else 0.
extern "C" int hk_fused_sort(const void* codes, const void* valid, int64_t n,
                             int k, void* const* rows_a, void* const* rows_b,
                             void* scratch, void* stream) {
  const int w_count = (k + 15) / 16;
  if (n <= 0 || n >= (int64_t{1} << 31) || k < 1 || w_count > kMaxWords) {
    return cudaErrorInvalidValue;
  }
  const int num_tiles = static_cast<int>((n + kTile - 1) / kTile);
  int* counts = static_cast<int*>(scratch);
  int* totals = counts + static_cast<int64_t>(kRadix) * num_tiles;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int8_t*>(codes);
  const auto* v = static_cast<const uint8_t*>(valid);
  KeyRows out{};  // pass 0 is even: it writes rows_b
  for (int w = 0; w < w_count; ++w) {
    out.row[w] = static_cast<uint32_t*>(rows_b[w]);
  }
  cudaError_t err = cudaSuccess;
  switch (w_count) {
    case 1: err = fused_pass0<1>(c, v, n, k, out, num_tiles, counts, totals, s); break;
    case 2: err = fused_pass0<2>(c, v, n, k, out, num_tiles, counts, totals, s); break;
    case 3: err = fused_pass0<3>(c, v, n, k, out, num_tiles, counts, totals, s); break;
    case 4: err = fused_pass0<4>(c, v, n, k, out, num_tiles, counts, totals, s); break;
    case 5: err = fused_pass0<5>(c, v, n, k, out, num_tiles, counts, totals, s); break;
    case 6: err = fused_pass0<6>(c, v, n, k, out, num_tiles, counts, totals, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return hk_radix_sort_passes(rows_a, rows_b, w_count, w_count, n, scratch,
                              stream, 1);
}
