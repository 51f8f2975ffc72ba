// Canonical k-mer key build: codes (N,) int8 + valid (N,) bool -> W key words.
//
// Replaces hysortk_tpu/ops/keybuild.py canonical_keys_fused (_keybuild_kernel,
// derive_canonical, load_codes_valid). Same contract: for every position i the
// W big-endian words of min(forward k-mer, reverse complement) starting at i,
// and the all-ones sentinel in every word where valid[i] is false.
//
// Bound on the H100: HBM bytes. Each position reads 2 B (code + valid) and
// writes 4W B. Design: a block of 256 threads takes a tile of 2048 slots; it
// stages the tile's codes plus the 16W-base halo in shared memory once,
// packed 16 bases to a word from 16-byte loads (canonical_key.cuh
// stage_codes, shared with the fused sort), so the halo costs 16W / 2048 of
// the tile's reads. Each thread takes groups of four consecutive slots: one
// 4-byte load of their valid flags, W + 1 shared-memory words (four slots
// that start at a multiple of 4 share them), one funnel shift a key word
// (canonical_key_words), and one 16-byte store a row. Reads past N are
// masked to 0 (the TPU version appends zeros); those positions are invalid,
// so they hold the sentinel either way. Views at odd offsets take the
// single-byte loads and 4-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "canonical_key.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;  // groups of four slots a thread
constexpr int kTile = kThreads * 4 * kGroups;
constexpr int kMaxWords = 6;
constexpr uint32_t kFull = 0xFFFFFFFFu;

struct KeyRows {
  uint32_t* row[kMaxWords];
};

template <int W>
__global__ void __launch_bounds__(kThreads)
keybuild_kernel(const int8_t* __restrict__ codes,
                const uint8_t* __restrict__ valid, int64_t n, int k,
                KeyRows out) {
  __shared__ uint32_t staged[kTile / 16 + W + 1];
  const int64_t tile_base = static_cast<int64_t>(blockIdx.x) * kTile;

  // The valid flags first, so their loads are in flight with the codes'.
  const bool valid_vec = (reinterpret_cast<uintptr_t>(valid) & 3u) == 0;
  uint32_t flags[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int64_t i = tile_base + 4 * (g * kThreads + threadIdx.x);
    if (valid_vec && i + 4 <= n) {
      flags[g] = *reinterpret_cast<const uint32_t*>(valid + i);
    } else {
      flags[g] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < n) flags[g] |= static_cast<uint32_t>(valid[i + j]) << (8 * j);
      }
    }
  }
  hk::stage_codes<W>(codes, n, tile_base, kTile, staged);

  bool rows_vec = true;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    rows_vec = rows_vec && (reinterpret_cast<uintptr_t>(out.row[w]) & 15u) == 0;
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int local = 4 * (g * kThreads + threadIdx.x);
    const int64_t i = tile_base + local;
    if (i >= n) break;
    uint32_t q[W + 1];
#pragma unroll
    for (int w = 0; w <= W; ++w) q[w] = staged[(local >> 4) + w];
    uint32_t key[4][W];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((flags[g] >> (8 * j)) & 0xFFu) {
        hk::canonical_key_words<W>(q, (local + j) & 15, k, key[j]);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) key[j][w] = kFull;
      }
    }
    if (rows_vec && i + 4 <= n) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        *reinterpret_cast<uint4*>(out.row[w] + i) =
            make_uint4(key[0][w], key[1][w], key[2][w], key[3][w]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < n) {
#pragma unroll
          for (int w = 0; w < W; ++w) out.row[w][i + j] = key[j][w];
        }
      }
    }
  }
}

}  // namespace

// codes (n,) int8, valid (n,) bool, out_rows: W device pointers to (n,)
// uint32 rows (16-byte aligned rows take vector stores), W = ceil(k/16) in
// 1..6. Returns cudaGetLastError().
extern "C" int hk_keybuild(const void* codes, const void* valid, int64_t n,
                           int k, void* const* out_rows, void* stream) {
  const int w_count = (k + 15) / 16;
  if (n <= 0 || k < 1 || w_count > kMaxWords) return cudaErrorInvalidValue;
  KeyRows out{};
  for (int w = 0; w < w_count; ++w) {
    out.row[w] = static_cast<uint32_t*>(out_rows[w]);
  }
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int8_t*>(codes);
  const auto* v = static_cast<const uint8_t*>(valid);
  switch (w_count) {
    case 1: keybuild_kernel<1><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 2: keybuild_kernel<2><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 3: keybuild_kernel<3><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 4: keybuild_kernel<4><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 5: keybuild_kernel<5><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 6: keybuild_kernel<6><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}
