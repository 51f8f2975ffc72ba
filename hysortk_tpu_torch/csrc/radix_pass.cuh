// One pass of the stable LSD radix sort: tile histogram, scan, stable scatter.
//
// Shared by radix_sort.cu, whose passes read their elements from key rows in
// device memory, and fused_sort.cu, whose first pass derives each element's
// key from the base codes instead. The two differ only in where a tile's
// elements come from, which a Source supplies:
//
//   unsigned load(int64_t i, int local)  take element i (slot `local` of the
//                                        tile) into registers; its digit
//   void store(int pos)                  write that element to output slot pos
//
// Each pass is
//   1. histogram_tile: per-tile digit counts, counts[digit][tile];
//   2. radix_scan: each digit's row of tile counts exclusive-scanned, and
//      the digit totals;
//   3. scatter_tile: a stable scatter. A tile is walked in rounds of 256
//      elements; within a warp equal digits are ranked with
//      __match_any_sync, across the 8 warps of a round in warp order, and
//      rounds in order, so equal digits keep their input order. Stability is
//      what makes LSD correct.

#pragma once

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

template <class Source>
__device__ __forceinline__ void histogram_tile(Source& source, int64_t n,
                                               int num_tiles,
                                               int* __restrict__ counts) {
  __shared__ int hist[kRadix];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const unsigned lane = threadIdx.x & 31;
  for (int r = 0; r < kRounds; ++r) {
    const int local = r * kThreads + threadIdx.x;
    const int64_t i = base + local;
    const unsigned d = i < n ? source.load(i, local) : kNoDigit;
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

template <class Source>
__device__ __forceinline__ void scatter_tile(Source& source, int64_t n,
                                             int num_tiles,
                                             const int* __restrict__ counts,
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

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_slot[w][tid] = 0;
    __syncthreads();
    const int local = r * kThreads + tid;
    const int64_t i = base + local;
    const bool in = i < n;
    const unsigned d = in ? source.load(i, local) : kNoDigit;
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
    if (in) source.store(warp_slot[warp][d] + rank);
    __syncthreads();
  }
}

}  // namespace
