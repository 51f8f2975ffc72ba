// A carry across the tiles of one kernel by decoupled look-back: what a TPU
// kernel carries in a scalar over its sequential grid ("the first run
// boundary to the right of this block", "the weight of the run that
// continues into this block") is handed from tile to tile through one
// descriptor per tile while all tiles run at once. The count's carries
// walk right to left; a prefix over the tiles walks left to right.
//
// Forward progress: a tile's index is a ticket from an atomic counter,
// taken from the end the walks start at (take_tile from the right end for
// the walks right, take_tile_left from the left end for the walks left),
// so every tile a walk can wait on drew its ticket earlier and is running
// or done, whatever order the card schedules blocks in. A tile publishes a
// first descriptor before it waits on anyone.
//
// A descriptor is one aligned word, written in one store and read volatile,
// so status and value arrive together and no fence is needed. Two kinds:
//
// 32 bits, the count's carry "the value of the nearest tile to the right
// that has one" (walk_right). A tile that has a value of its own publishes
// it at once as its inclusive value and waits for nobody. A tile that has
// none publishes "none", walks right over its neighbours' descriptors, a
// warp's worth at a time, until it meets an inclusive value, and
// republishes that as its own, so that walks from further left end there:
//   0      not published yet
//   1      the tile has no value of its own: keep walking
//   v + 2  the inclusive value v
// Values are below 2^31 (slot positions, n included), so v + 2 fits.
//
// 64 bits, a sum: the status in the top two bits, the payload below it,
// either one uint32 sum (wrapping) in bits 0-31 (publish_sum,
// walk_right_sum) or two sums, each below 2^31, in bits 31-61 and 0-30
// (pair, walk_left_pairs):
//   status 0  not published yet
//   status 1  aggregate: v is the tile's own sum; keep walking and add v
//   status 2  inclusive: v is the sum up to the walk's end
// walk_right_sum is the weighted sum's segmented carry: a tile with a run
// boundary publishes its weight before that boundary as inclusive at once.
// A tile without one publishes its aggregate, walks, and republishes
// aggregate + what it found as inclusive. walk_left_pairs is a prefix over
// the tiles: the first tile publishes inclusive at once, every other one
// its aggregate, then its inclusive prefix once its walk ends.
//
// Scratch: a ticket, then from byte 8 on one descriptor per tile (aligned
// for 64 bits), zeroed per call on the caller's stream (reset).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned kNotReady = 0u;
constexpr unsigned kNone = 1u;
constexpr unsigned kValueBase = 2u;
constexpr uint64_t kSumAggregate = uint64_t{1} << 62;
constexpr uint64_t kSumInclusive = uint64_t{2} << 62;
constexpr uint64_t kPairMask = (uint64_t{1} << 31) - 1;
constexpr unsigned kAllLanes = 0xFFFFFFFFu;
constexpr int64_t kDescOffset = 8;
constexpr int kWindow = 32;  // descriptors a walk reads at a time: a lane each

template <typename Desc>
struct Scratch {
  unsigned* ticket;
  Desc* desc;  // [tile]
};

template <typename Desc>
inline int64_t scratch_bytes(int64_t num_tiles) {
  return kDescOffset + num_tiles * static_cast<int64_t>(sizeof(Desc));
}

template <typename Desc>
inline Scratch<Desc> carve(void* scratch) {
  char* base = static_cast<char*>(scratch);
  return Scratch<Desc>{reinterpret_cast<unsigned*>(base),
                       reinterpret_cast<Desc*>(base + kDescOffset)};
}

// Zero the ticket and the descriptors: once per call, before the kernel.
template <typename Desc>
inline cudaError_t reset(void* scratch, int64_t num_tiles, cudaStream_t s) {
  return cudaMemsetAsync(scratch, 0,
                         static_cast<size_t>(scratch_bytes<Desc>(num_tiles)), s);
}

// The next tile, from the right end. One thread of the block calls it.
__device__ __forceinline__ int take_tile(unsigned* ticket, int num_tiles) {
  return num_tiles - 1 - static_cast<int>(atomicAdd(ticket, 1u));
}

// The next tile, from the left end, for the walks left.
__device__ __forceinline__ int take_tile_left(unsigned* ticket) {
  return static_cast<int>(atomicAdd(ticket, 1u));
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
  for (int first = tile + 1;; first += kWindow) {
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

// status is kSumAggregate or kSumInclusive; v a uint32 sum or a pair.
__device__ __forceinline__ void publish_sum(uint64_t* desc, int tile,
                                            uint64_t status, uint64_t v) {
  *reinterpret_cast<volatile uint64_t*>(desc + tile) = status | v;
}

// Two sums, each below 2^31, as one payload.
__device__ __forceinline__ uint64_t pair(unsigned hi, unsigned lo) {
  return (static_cast<uint64_t>(hi) << 31) | lo;
}

// The descriptors from tile + kStep on, in the direction kStep (+1 right,
// -1 left), up to and with the nearest inclusive one; past either end
// stands an inclusive 0. All 32 lanes of one warp call it together. Lane l
// reads the l-th tile of a window of 32; a window is read again while a
// tile nearer than its first inclusive one has not published. Then every
// lane calls add(d) with its descriptor, or 0 where its tile lies beyond
// that inclusive one; add sums across the warp.
template <int kStep, typename Add>
__device__ __forceinline__ void walk_sums(const uint64_t* desc, int tile, int num_tiles,
                                          Add add) {
  const int lane = threadIdx.x & 31;
  for (int first = tile + kStep;; first += kWindow * kStep) {
    const int t = first + kStep * lane;
    const bool inside = kStep > 0 ? t < num_tiles : t >= 0;
    uint64_t d;
    unsigned inclusive, pending;
    do {
      d = inside ? *reinterpret_cast<const volatile uint64_t*>(desc + t) : kSumInclusive;
      inclusive = __ballot_sync(kAllLanes, d >= kSumInclusive);
      pending = __ballot_sync(kAllLanes, d < kSumAggregate);
      const unsigned nearer = inclusive ? (inclusive & (0u - inclusive)) - 1u
                                        : kAllLanes;
      pending &= nearer;
    } while (pending != 0);
    // The lanes up to and with the first inclusive one (all when none is).
    const unsigned lowest = inclusive & (0u - inclusive);
    const unsigned taken = inclusive ? lowest | (lowest - 1u) : kAllLanes;
    add((taken >> lane) & 1u ? d : uint64_t{0});
    if (inclusive) return;
  }
}

// The weight from the first slot right of `tile` up to the first boundary
// at or after it (0 past the last tile): the aggregates of the tiles up to
// the nearest inclusive one, and that one's value, added modulo 2^32.
// Every lane returns the sum.
__device__ __forceinline__ unsigned walk_right_sum(const uint64_t* desc, int tile,
                                                   int num_tiles) {
  unsigned sum = 0;
  walk_sums<1>(desc, tile, num_tiles, [&](uint64_t d) {
    sum += __reduce_add_sync(kAllLanes, static_cast<unsigned>(d));
  });
  return sum;
}

// The pair sums of the tiles left of `tile` (pair): the aggregates down to
// the nearest inclusive one, and that one's. Every lane returns them.
__device__ __forceinline__ uint2 walk_left_pairs(const uint64_t* desc, int tile) {
  uint2 sum = make_uint2(0u, 0u);
  walk_sums<-1>(desc, tile, 0, [&](uint64_t d) {
    sum.x += __reduce_add_sync(kAllLanes, static_cast<unsigned>((d >> 31) & kPairMask));
    sum.y += __reduce_add_sync(kAllLanes, static_cast<unsigned>(d & kPairMask));
  });
  return sum;
}

}  // namespace lookback
