// Key build fused into the sort: codes (N,) int8 + valid (N,) bool -> W sorted
// key words, the all-ones sentinel last. Keys only.
//
// Replaces hysortk_tpu/ops/pallas_sort.py sort_codes_fused, i.e. the kernel
// pallas_msort.block_sort_keybuild (the key build inside phase A of the
// bitonic block sort) and the merge levels behind it. What the TPU kernel
// buys is kept, not its shape: the unsorted key words never reach device
// memory. Here the key build is fused into the two kernels of the LSD radix
// sort (radix_pass.cuh) that would read them: the histogram of all 4W
// digits and pass 0 both derive each slot's canonical key from the codes
// (canonical_key.cuh, the definition keybuild.cu uses too), and pass 0
// writes the W words straight to their pass-0 places. Passes 1 .. 4W-1 are
// the row passes of radix_sort.cu.
//
// Bound on the H100: HBM bytes, 2 B read (code + valid) and 4W B written per
// slot. Against the unfused pair (key build, then the sort) the fusion never
// writes the unsorted key rows and reads 2 B per slot twice where the sort
// reads 4W B twice; it pays for that with the key arithmetic done twice.
// Design: a block stages its tile's codes plus the (16W - 1)-base halo in
// shared memory once, packed 16 bases to a word, so that a slot's forward
// words are one funnel shift each of two neighbouring words (the arithmetic
// done twice has to be cheap: the passes are bound by instructions, not
// bytes); reads past N are masked to 0 in both kernels, so both derive the
// same bits; an invalid slot's key is all ones,
// so its digit is 0xFF in every pass. Pass 0 holds its tile's keys in
// registers (kItems x W words a thread) from the ranking to the write, so
// its tile is 8192 slots up to W = 2 and 4096 beyond.

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

constexpr int kPassThreads = 512;

// Items a thread of pass 0 holds, by key width.
template <int W>
struct PassItems {
  static constexpr int value = W <= 2 ? 16 : 8;
};

struct KeyRows {
  uint32_t* row[kMaxKeyWords];
};

// Words of a staged tile: its slots and the (16W - 1)-base halo, 16 bases to
// a word, and one word more, which the funnel shift reads and discards.
template <int W, int kTile>
struct StagedWords {
  static constexpr int value = kTile / 16 + W + 1;
};

// A slot's key from the staged codes, all ones where the slot is invalid.
template <int W>
__device__ __forceinline__ void slot_key(const uint32_t* staged,
                                         const uint8_t* __restrict__ valid,
                                         int k, int64_t i, int local,
                                         uint32_t (&key)[W]) {
  if (valid[i]) {
    hk::canonical_key_packed<W>(staged, local, k, key);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) key[w] = kFull;
  }
}

template <int W>
struct CodeKeys {
  const int8_t* codes;
  const uint8_t* valid;
  int k;
  uint32_t* staged;
  __device__ __forceinline__ void stage(int64_t tile_base, int64_t n) const {
    hk::stage_codes<W>(codes, n, tile_base, kHistTile, staged);
  }
  __device__ __forceinline__ void get(int64_t i, int local,
                                      uint32_t (&key)[W]) const {
    slot_key<W>(staged, valid, k, i, local, key);
  }
};

template <int W>
__global__ void __launch_bounds__(kHistThreads)
fused_digit_histogram(const int8_t* __restrict__ codes,
                const uint8_t* __restrict__ valid, int64_t n, int k,
                unsigned* __restrict__ hist) {
  __shared__ uint32_t staged[StagedWords<W, kHistTile>::value];
  CodeKeys<W> keys{codes, valid, k, staged};
  histogram_tiles<W>(keys, n, hist);
}

// Pass 0's elements: each slot's key derived from the staged codes; the
// digit is the lowest byte of the last word; all W words go through the
// exchange, the last word first.
template <int W, int kItems>
struct CodeSource {
  const int8_t* codes;
  const uint8_t* valid;
  int k;
  KeyRows out;
  const uint32_t* staged;
  uint32_t key[kItems][W];

  __device__ __forceinline__ void stage(int64_t tile_base, int64_t n,
                                        unsigned char* room) {
    uint32_t* words = reinterpret_cast<uint32_t*>(room);
    hk::stage_codes<W>(codes, n, tile_base, kPassThreads * kItems, words);
    staged = words;
  }
  __device__ __forceinline__ void load(int j, int64_t i, int local) {
    slot_key<W>(staged, valid, k, i, local, key[j]);
  }
  __device__ static constexpr int num_digits() { return kRadix; }
  __device__ __forceinline__ unsigned digit(int j) const {
    return key[j][W - 1] & 0xFFu;
  }
  template <bool kFullTile>
  __device__ __forceinline__ void scatter(PassShared<kPassThreads, kItems>& sh,
                                          const int (&pos)[kItems], int tile_n,
                                          int64_t) const {
    int dst[kItems];
    uint32_t vals[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) vals[j] = key[j][W - 1];
    exchange_row<kPassThreads, kItems, true, kFullTile>(sh, vals, pos, dst,
                                                        tile_n, 0, out.row[W - 1]);
#pragma unroll
    for (int w = 0; w < W - 1; ++w) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) vals[j] = key[j][w];
      exchange_row<kPassThreads, kItems, false, kFullTile>(sh, vals, pos, dst,
                                                           tile_n, 0, out.row[w]);
    }
  }
};

template <int W>
__global__ void __launch_bounds__(kPassThreads)
fused_pass0(const int8_t* __restrict__ codes, const uint8_t* __restrict__ valid,
            int64_t n, int k, KeyRows out, const unsigned* __restrict__ hist,
            unsigned* ticket, unsigned* desc) {
  CodeSource<W, PassItems<W>::value> source{codes, valid, k, out, nullptr, {}};
  radix_pass_tile<kPassThreads, PassItems<W>::value>(source, n, hist, ticket, desc);
}

template <int W>
cudaError_t fused_front(const int8_t* codes, const uint8_t* valid, int64_t n,
                        int k, const KeyRows& out, const SortScratch& sc,
                        cudaStream_t s) {
  constexpr int kItems = PassItems<W>::value;
  constexpr int kTile = kPassThreads * kItems;
  static_assert(kTile >= kMinTile, "the scratch is sized for tiles of kMinTile");
  cudaError_t err = reset_header(sc, s);
  if (err != cudaSuccess) return err;
  fused_digit_histogram<W><<<histogram_blocks(n), kHistThreads, 0, s>>>(codes, valid, n,
                                                                k, sc.hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int num_tiles = static_cast<int>((n + kTile - 1) / kTile);
  const int shared = static_cast<int>(sizeof(PassShared<kPassThreads, kItems>) +
                                      StagedWords<W, kTile>::value * sizeof(uint32_t));
  err = reset_descriptors(sc, num_tiles, s);
  if (err != cudaSuccess) return err;
  // Above 48 KB a kernel has to opt in to its dynamic shared memory.
  err = cudaFuncSetAttribute(fused_pass0<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  fused_pass0<W><<<num_tiles, kPassThreads, shared, s>>>(
      codes, valid, n, k, out, sc.hist, sc.tickets, sc.desc);
  return cudaGetLastError();
}

}  // namespace

// codes (n,) int8, valid (n,) bool; rows_a, rows_b: W device pointers each to
// (n,) uint32 rows, W = ceil(k/16) in 1..6, neither initialised; scratch: as
// hk_radix_sort_scratch(n). The sorted key words land in rows_a. Returns
// the first CUDA error, else 0.
extern "C" int hk_fused_sort(const void* codes, const void* valid, int64_t n,
                             int k, void* const* rows_a, void* const* rows_b,
                             void* scratch, void* stream) {
  const int w_count = (k + 15) / 16;
  if (n <= 0 || n >= (int64_t{1} << 31) || k < 1 || w_count > kMaxKeyWords) {
    return cudaErrorInvalidValue;
  }
  const SortScratch sc = carve_scratch(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int8_t*>(codes);
  const auto* v = static_cast<const uint8_t*>(valid);
  KeyRows out{};  // pass 0 is even: it writes rows_b
  for (int w = 0; w < w_count; ++w) {
    out.row[w] = static_cast<uint32_t*>(rows_b[w]);
  }
  cudaError_t err = cudaSuccess;
  switch (w_count) {
    case 1: err = fused_front<1>(c, v, n, k, out, sc, s); break;
    case 2: err = fused_front<2>(c, v, n, k, out, sc, s); break;
    case 3: err = fused_front<3>(c, v, n, k, out, sc, s); break;
    case 4: err = fused_front<4>(c, v, n, k, out, sc, s); break;
    case 5: err = fused_front<5>(c, v, n, k, out, sc, s); break;
    case 6: err = fused_front<6>(c, v, n, k, out, sc, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return hk_radix_sort_passes(rows_a, rows_b, w_count, w_count, n, scratch,
                              stream, 1);
}
