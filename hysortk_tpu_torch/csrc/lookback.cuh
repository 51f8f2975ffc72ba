// A carry across the tiles of one kernel, right to left, by decoupled
// look-back: what a TPU kernel carries in a scalar over its sequential grid
// ("the first run boundary to the right of this block") is handed from tile
// to tile through one descriptor word per tile while all tiles run at once.
//
// The carry is "the value of the nearest tile to the right that has one".
// A tile that has a value of its own publishes it at once as its inclusive
// value and waits for nobody. A tile that has none publishes "none", walks
// right over its neighbours' descriptors, a warp's worth at a time, until it
// meets an inclusive value, and republishes that as its own, so that walks
// from further left end there.
//
// Forward progress: a tile's index is a ticket from an atomic counter, taken
// from the right end, so every tile a walk can wait on drew its ticket
// earlier and is running or done, whatever order the card schedules blocks
// in.
//
// A descriptor is one aligned 32-bit word, written in one store and read
// volatile, so status and value arrive together and no fence is needed:
//   0      not published yet
//   1      the tile has no value of its own: keep walking
//   v + 2  the inclusive value v
// Values are below 2^31 (slot positions, n included), so v + 2 fits.
//
// Scratch: one ticket and one descriptor per tile, zeroed per call on the
// caller's stream (reset).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned kNotReady = 0u;
constexpr unsigned kNone = 1u;
constexpr unsigned kValueBase = 2u;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

struct Scratch {
  unsigned* ticket;
  unsigned* desc;  // [tile]
};

inline int64_t scratch_bytes(int64_t num_tiles) {
  return (num_tiles + 1) * static_cast<int64_t>(sizeof(unsigned));
}

inline Scratch carve(void* scratch) {
  unsigned* base = static_cast<unsigned*>(scratch);
  return Scratch{base, base + 1};
}

// Zero the ticket and the descriptors: once per call, before the kernel.
inline cudaError_t reset(void* scratch, int64_t num_tiles, cudaStream_t s) {
  return cudaMemsetAsync(scratch, 0, static_cast<size_t>(scratch_bytes(num_tiles)), s);
}

// The next tile, from the right end. One thread of the block calls it.
__device__ __forceinline__ int take_tile(unsigned* ticket, int num_tiles) {
  return num_tiles - 1 - static_cast<int>(atomicAdd(ticket, 1u));
}

__device__ __forceinline__ void publish_none(unsigned* desc, int tile) {
  *reinterpret_cast<volatile unsigned*>(desc + tile) = kNone;
}

__device__ __forceinline__ void publish_value(unsigned* desc, int tile, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(desc + tile) = v + kValueBase;
}

// The inclusive value of the nearest tile right of `tile` that has one;
// `end_value` stands in for the tiles past the last. All 32 lanes of one
// warp call it together; every lane returns the value. Lane l reads the
// descriptor of the l-th tile of a window of 32; a window is read again
// while a tile nearer than its first value has not published.
__device__ __forceinline__ unsigned walk_right(const unsigned* desc, int tile,
                                               int num_tiles, unsigned end_value) {
  const int lane = threadIdx.x & 31;
  for (int first = tile + 1;; first += 32) {
    const int t = first + lane;
    unsigned v, with_value, pending;
    do {
      v = t < num_tiles
              ? *reinterpret_cast<const volatile unsigned*>(desc + t)
              : end_value + kValueBase;
      with_value = __ballot_sync(kAllLanes, v >= kValueBase);
      pending = __ballot_sync(kAllLanes, v == kNotReady);
      // The lanes before the first one that holds a value (all of them
      // when none does).
      const unsigned nearer = with_value ? (with_value & (0u - with_value)) - 1u
                                         : kAllLanes;
      pending &= nearer;
    } while (pending != 0);
    const int source = with_value ? __ffs(with_value) - 1 : 0;
    const unsigned found = __shfl_sync(kAllLanes, v, source);
    if (with_value) return found - kValueBase;
  }
}

}  // namespace lookback
