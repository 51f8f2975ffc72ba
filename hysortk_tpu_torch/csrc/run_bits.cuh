// Where the runs of sorted, sentinel-marked key words begin: the first stage
// of the run-length count (fused_count.cu) and of the weighted run-length
// sum (run_length_sum.cu), shared so that both kernels see the same runs.
//
// One tile is 256 threads x 16 slots. Slot warp_base + 128 v + 4 lane + e is
// element e of vector v of lane `lane`: every word row is read once, 16 bytes
// a thread (uint4), a warp's 32 threads on 512 consecutive bytes, four such
// loads per row in flight; slot i-1 comes from the neighbouring register,
// the neighbouring lane (__shfl_up_sync) or, for a warp's first slot only,
// one extra 4-byte load per row. The bits stay in registers, 16 of each.
//
// kFast: a full tile whose rows are 16-byte aligned, read without a bounds
// test. Otherwise (the last tile, views at odd offsets) the same body reads
// with guarded 4-byte loads, and slots past n read as sentinels.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                    // uint4 loads per thread and row
constexpr int kVecSlots = 32 * 4;           // slots a warp covers per load
constexpr int kWarpSlots = kVecs * kVecSlots;
constexpr int kTile = kWarps * kWarpSlots;  // 4096
constexpr int kMaxWords = 6;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct WordRows {
  const uint32_t* row[kMaxWords];
};

inline int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

// Four consecutive slots of a row from slot i (a multiple of 4); all ones
// past n.
template <bool kFast>
__device__ __forceinline__ void load4(const uint32_t* __restrict__ row, int64_t i,
                                      int64_t n, uint32_t (&x)[4]) {
  if (kFast) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + i);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = i + e < n ? row[i + e] : kFull;
  }
}

// Bit 4v + e of each mask is slot warp_base + 128 v + 4 lane + e. boundary:
// slot 0, and every slot where any word differs from the slot before; none
// past n. sentinel: every word all ones (so every slot past n).
template <int W, bool kFast>
__device__ __forceinline__ void boundary_bits(const WordRows& words, int64_t n,
                                              int64_t warp_base, unsigned& boundary,
                                              unsigned& sentinel) {
  const int lane = threadIdx.x & 31;
  boundary = 0;
  sentinel = (1u << (4 * kVecs)) - 1u;
  // One row at a time, the loop kept a loop: unrolled over the rows, nvcc
  // 12.9 at -O3 puts the second row's bits of vector 0 sixteen places up
  // (seen at W = 2 in the guarded body: a boundary that only the last word
  // shows was lost; the hard cases of testing.count_cases catch it).
#pragma unroll 1
  for (int w = 0; w < W; ++w) {
    const uint32_t* __restrict__ row = words.row[w];
    uint32_t x[kVecs][4];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      load4<kFast>(row, warp_base + v * kVecSlots + 4 * lane, n, x[v]);
    }
    // The slot before the warp's first: the one value no lane holds.
    uint32_t edge = 0;
    if (lane == 0 && warp_base > 0 && (kFast || warp_base - 1 < n)) {
      edge = row[warp_base - 1];
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      uint32_t left = __shfl_up_sync(kFull, x[v][3], 1);
      const uint32_t wrap =
          v > 0 ? __shfl_sync(kFull, x[v > 0 ? v - 1 : 0][3], 31) : edge;
      if (lane == 0) left = wrap;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t before = e > 0 ? x[v][e > 0 ? e - 1 : 0] : left;
        boundary |= static_cast<unsigned>(x[v][e] != before) << (4 * v + e);
        sentinel &= ~(static_cast<unsigned>(x[v][e] != kFull) << (4 * v + e));
      }
    }
  }
  if (warp_base == 0 && lane == 0) boundary |= 1u;  // slot 0
  if (!kFast) {
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int64_t left_in = n - (warp_base + v * kVecSlots + 4 * lane);
      const unsigned in = left_in >= 4 ? 15u : left_in <= 0 ? 0u : (1u << left_in) - 1u;
      boundary &= ~((15u & ~in) << (4 * v));
    }
  }
}

// Whether every row (and the outputs, folded into low_bits by the caller)
// may be read and written 16 bytes at a time.
inline bool rows_aligned(const WordRows& rows, int n_words, uintptr_t low_bits) {
  for (int w = 0; w < n_words; ++w) {
    low_bits |= reinterpret_cast<uintptr_t>(rows.row[w]);
  }
  return (low_bits & 15u) == 0;
}

}  // namespace
