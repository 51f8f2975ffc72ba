// The wire decode: S segments of the 2-bit packed read wire -> per position
// the base code, whether a k-mer starts there and, in extension mode, the
// read id and the position in the read; or, in run-header mode (the
// supermer route's extension-mode receive side), each run's read id and
// first position carried along it.
//
// No TPU kernel: the JAX package decodes in XLA (hysortk_tpu/ops/wire.py
// unpack_codes, valid_from_lengths, decode_block, rid_pos_from_lengths,
// decode_block_ext), and so did the port, in int64 torch ops, until this
// kernel (ops/wire.decode_block_plain, decode_block_ext_plain). Same
// contract, per segment of block_len positions:
//   * base b of the segment in word b / 16 at shift 30 - 2 * (b % 16);
//   * the reads lie back to back from the segment's position 0, by its
//     zero-padded lengths;
//   * position p is valid iff p + k <= the end of the read that holds it
//     (offset <= len - k); nothing at or past the lengths' total is, and a
//     total past the segment is cut at its end;
//   * read id = rid_base - 1 + the number of read starts at or before p
//     (zero-length reads too, whose starts stack on the next read's), and
//     position in read = p - the last of those starts (uint32 bits);
//   * run-header mode (ops/wire.decode_block_runs, whose plain version is
//     decode_block_plain + fill_run_meta): the reads are runs with headers
//     rid0 and pos0 (per segment, strided rows read in place), and with i
//     the last run whose start is at or before p, read id = rid0[i] and
//     position = pos0[i] + p - start_i (uint32 wrap); with no runs at all
//     read id 0 and position p.
//
// Two launches, no memset:
//   1. scan: the read lengths, a tile of 2048 a block, each read's end in
//      int64 (so no total wraps), the carry from the tiles to the left by
//      decoupled look-back on descriptors that the wrapper keeps zeroed
//      between calls. The ends are kept as int32, cut at 2^31 - 1
//      (positions lie below 2^31 - 128, the wrapper's bound, so every
//      comparison the decode makes with a cut end comes out as with the
//      true one). Each read marks the decode tiles whose first position it
//      holds (tile_first); the segment's last tile marks the tiles past the
//      total, so every entry is written each call.
//   2. decode: a block a tile of 16384 positions, 256 threads x 4 words of
//      16 bases (a warp's 32 words adjacent). The block stages its reads'
//      ends (at most 2048; a tile of more stacked reads walks them in
//      global memory) in shared memory with one coalesced load; a thread
//      finds its word's first read there by a binary search. Codes come
//      straight from the word and the flags a read at a time, as bit
//      ranges, into one 16-byte store each a word; in extension mode the
//      thread walks its 16 positions for their read ids and positions,
//      which go through the warp's own shared buffer, so each store
//      instruction writes 512 contiguous bytes; in run-header mode the walk
//      reads a run's two headers where it enters the run (through L1: a
//      run holds tens of positions). Its blocks zero the scan's
//      descriptors for the next call.
// No array a thread indexes at run time: the compiler would keep it in
// local memory, and one of codes and flags read and written at every
// position costs more than the kernel's stores.
//
// Bound on the H100: HBM bytes. Per position 1/4 B of words in, 1 B of code
// and 1 B of flag out (2.25 B), 8 B more with the read id and position; 4 B
// a read in. The ends (4 B a read) are written and read once more. Run-header
// mode reads 8 B a run more.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 8;
constexpr int64_t kScanTile = kThreads * kScanItems;  // lengths a scan tile
constexpr int kWords = 4;                             // words a thread a decode tile
constexpr int64_t kTile = int64_t{kThreads} * kWords * 16;  // positions a decode tile
constexpr int kStaged = 2048;              // read ends a decode tile stages
constexpr int64_t kEndCap = 0x7FFFFFFF;    // ends are kept as int32
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

// A look-back descriptor: one 64-bit word, written in one store and read
// volatile, so status and value arrive together. Status in the top two
// bits (0 not published, 1 aggregate: the tile's own sum, keep walking;
// 2 inclusive: the sum of the segment's lengths up to the tile's end), the
// sum below (lengths are int32 >= 0, so sums stay below 2^62).
constexpr uint64_t kAggregate = uint64_t{1} << 62;
constexpr uint64_t kInclusive = uint64_t{2} << 62;
constexpr uint64_t kValueMask = kAggregate - 1;

struct Dims {
  int64_t scan_tiles, decode_tiles;
  int64_t tile_first, ends, total;  // byte offsets into the work buffer
  int64_t state;                    // bytes of the descriptors, zero between calls
};

Dims dims(int64_t segments, int64_t reads, int64_t block_len) {
  Dims d;
  d.scan_tiles = (reads + kScanTile - 1) / kScanTile;
  d.decode_tiles = (block_len + kTile - 1) / kTile;
  d.tile_first = 0;
  d.ends = (4 * segments * (d.decode_tiles + 1) + 15) / 16 * 16;
  d.total = d.ends + 4 * segments * reads;
  d.state = 8 * segments * d.scan_tiles;
  return d;
}

struct Args {
  const uint32_t* packed;
  int64_t word_stride;
  const int32_t* lengths;
  int64_t len_stride;
  int reads, block_len, k;
  uint32_t rid_base;
  int64_t segments, scan_tiles, decode_tiles;
  uint64_t* desc;      // [segment][scan tile], zero between calls
  int32_t* tile_first;  // [segment][decode tile + 1]: 1 + the read holding the
                        // tile's first position; reads past the total
  int32_t* ends;        // [segment][read], cut at 2^31 - 1
  int8_t* codes;
  uint8_t* valid;
  uint32_t* rid;
  uint32_t* pos;
  const int32_t* rid0;  // run-header mode: [segment][run] at rid0 + s * rid0_stride
  const uint32_t* pos0;
  int64_t rid0_stride, pos0_stride;
};

// The read id and the first position's offset of read (run) i of a segment,
// i = -1 where the segment has no reads.
struct ReadIds {  // extension mode: numbered from rid_base, positions from the start
  uint32_t rid_base;
  __device__ __forceinline__ uint32_t rid(int i) const {
    return static_cast<uint32_t>(i) + rid_base;
  }
  __device__ __forceinline__ uint32_t first_pos(int) const { return 0u; }
};

struct RunHeaders {  // run-header mode: the runs' own headers
  const int32_t* rid0;
  const uint32_t* pos0;
  __device__ __forceinline__ uint32_t rid(int i) const {
    return i >= 0 ? static_cast<uint32_t>(__ldg(rid0 + i)) : 0u;
  }
  __device__ __forceinline__ uint32_t first_pos(int i) const {
    return i >= 0 ? __ldg(pos0 + i) : 0u;
  }
};

__device__ __forceinline__ int64_t warp_inclusive_sum(int64_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(kAllLanes, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ void publish(uint64_t* desc, int64_t tile, uint64_t status,
                                        int64_t v) {
  *reinterpret_cast<volatile uint64_t*>(desc + tile) =
      status | static_cast<uint64_t>(v);
}

// The sum of the segment's lengths before scan tile `tile`: the aggregates
// of the tiles to its left up to the nearest inclusive one, and that one's
// value (0 left of the segment's first tile). All 32 lanes of one warp call
// it; every lane returns the sum. Lane l reads the descriptor of the l-th
// tile to the left in a window of 32; the window is read again while a tile
// nearer than its first inclusive one has not published.
__device__ __forceinline__ int64_t walk_left(const uint64_t* desc, int64_t tile) {
  const int lane = threadIdx.x & 31;
  int64_t sum = 0;
  for (int64_t nearest = tile - 1;; nearest -= 32) {
    const int64_t t = nearest - lane;
    uint64_t d;
    unsigned inclusive, pending;
    do {
      d = t >= 0 ? *reinterpret_cast<const volatile uint64_t*>(desc + t) : kInclusive;
      inclusive = __ballot_sync(kAllLanes, d >= kInclusive);
      pending = __ballot_sync(kAllLanes, d < kAggregate);
      // The lanes nearer than the first one that is inclusive (all of them
      // when none is).
      const unsigned nearer = inclusive ? (inclusive & (0u - inclusive)) - 1u
                                        : kAllLanes;
      pending &= nearer;
    } while (pending != 0);
    // The lanes up to and with the first inclusive one (all when none is).
    const unsigned lowest = inclusive & (0u - inclusive);
    const unsigned taken = inclusive ? lowest | (lowest - 1u) : kAllLanes;
    int64_t mine = (taken >> lane) & 1u ? static_cast<int64_t>(d & kValueMask) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(kAllLanes, mine, o);
    sum += mine;
    if (inclusive) return sum;
  }
}

// A scan tile: the ends of reads [tile * 2048, +2048) of segment `seg`.
__device__ void scan_tile(const Args& a, int64_t seg, int64_t tile) {
  __shared__ int64_t warp_sums[kWarps];
  __shared__ int64_t carry, total;
  const int32_t* len = a.lengths + seg * a.len_stride;
  uint64_t* desc = a.desc + seg * a.scan_tiles;

  const int64_t first = tile * kScanTile + threadIdx.x * kScanItems;
  int64_t v[kScanItems];
  int64_t own = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = first + i < a.reads ? static_cast<int64_t>(len[first + i]) : 0;
    own += v[i];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t incl = warp_inclusive_sum(own);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < kWarps ? warp_sums[lane] : 0;
    w = warp_inclusive_sum(w);
    if (lane < kWarps) warp_sums[lane] = w;
    const int64_t aggregate = __shfl_sync(kAllLanes, w, kWarps - 1);
    int64_t before = 0;
    if (tile == 0) {
      if (lane == 0) publish(desc, tile, kInclusive, aggregate);
    } else {
      if (lane == 0) publish(desc, tile, kAggregate, aggregate);
      before = walk_left(desc, tile);
      if (lane == 0) publish(desc, tile, kInclusive, before + aggregate);
    }
    if (lane == 0) {
      carry = before;
      total = before + aggregate;
    }
  }
  __syncthreads();

  int32_t* ends = a.ends + seg * a.reads;
  int32_t* tile_first = a.tile_first + seg * (a.decode_tiles + 1);
  int64_t end = carry + (warp ? warp_sums[warp - 1] : 0) + incl - own;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int64_t r = first + i;
    if (r >= a.reads) break;
    const int64_t start = end;
    end += v[i];
    ends[r] = static_cast<int32_t>(end < kEndCap ? end : kEndCap);
    // The decode tiles whose first position lies in [start, end).
    for (int64_t b = (start + kTile - 1) / kTile; b < a.decode_tiles && b * kTile < end;
         ++b) {
      tile_first[b] = static_cast<int32_t>(r + 1);
    }
  }
  if (tile == a.scan_tiles - 1) {
    // The tiles whose first position lies at or past the total, and the
    // entry after the last tile, hold no read's start: `reads`.
    int64_t past = (total + kTile - 1) / kTile;
    if (past > a.decode_tiles) past = a.decode_tiles;
    for (int64_t b = past + threadIdx.x; b <= a.decode_tiles; b += kThreads) {
      tile_first[b] = a.reads;
    }
  }
}

// The read ends a decode tile walks: from its shared copy, or (a tile of
// more reads than kStaged) from global memory.
struct SharedEnds {
  const int32_t* e;  // e[j] = the end of read lo - 1 + j (0 before read 0)
  int lo;
  __device__ __forceinline__ int32_t end(int i) const { return e[i - lo + 1]; }
  __device__ __forceinline__ int32_t start(int i) const { return e[i - lo]; }
};

struct GlobalEnds {
  const int32_t* e;
  __device__ __forceinline__ int32_t end(int i) const { return e[i]; }
  __device__ __forceinline__ int32_t start(int i) const { return i ? e[i - 1] : 0; }
};

// The first index in [lo, hi) whose end is past p, else hi.
template <class Ends>
__device__ __forceinline__ int first_end_after(const Ends& ends, int lo, int hi, int p) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends.end(mid) <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One word's 16 positions from p0: the valid flags as a 16-bit mask (bit
// j for position p0 + j), read ids and positions (meta.rid(i) and
// meta.first_pos(i) + p - start_i). The read i holding p, where p lies
// before the lengths' total, is the last read whose start is at or before
// p: the number of reads but the last whose end is at or before p. It is
// the last read for every p at or past the total, and for no read at all
// (lo = hi = -1) i = -1 with start 0.
template <class Ends, class Meta>
__device__ __forceinline__ uint32_t decode_word(const Ends& ends, int lo, int hi, int p0,
                                                int count, int k, const Meta& meta,
                                                uint32_t rids[16], uint32_t poss[16]) {
  int i = -1, start = 0, end = 0;
  if (hi >= 0) {
    i = first_end_after(ends, lo, hi, p0);
    end = ends.end(i);
    start = ends.start(i);
  }
  uint32_t rid = meta.rid(i), off = meta.first_pos(i);
  uint32_t flags = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int p = p0 + j;
    if (j < count) {
      if (p >= end && i < hi) {
        // The next read starts at this one's end; past zero-length reads
        // (whose ends equal it), a search.
        start = end;
        end = ends.end(++i);
        if (end <= p && i < hi) {
          i = first_end_after(ends, i + 1, hi, p);
          start = ends.start(i);
          end = ends.end(i);
        }
        rid = meta.rid(i);
        off = meta.first_pos(i);
      }
      flags |= static_cast<uint32_t>(p + k <= end) << j;
    }
    rids[j] = rid;
    poss[j] = off + static_cast<uint32_t>(p - start);
  }
  return flags;
}

// Codes and flags only: the word's valid flags a read at a time, each read
// a range of bits (positions p0 + j up to its end - k), where decode_word
// takes its positions one by one for their read ids.
template <class Ends>
__device__ __forceinline__ uint32_t decode_flags(const Ends& ends, int lo, int hi, int p0,
                                                 int count, int k) {
  if (hi < 0) return 0u;
  int i = first_end_after(ends, lo, hi, p0);
  int end = ends.end(i);
  uint32_t flags = 0;
  for (int j = 0;;) {
    // Read i holds p0 + j (or i = hi and p0 + j lies past its end): its
    // positions below p0 + top start a k-mer.
    int top = end - k - p0 + 1;
    top = top < count ? top : count;
    if (top > j) flags |= (0xFFFFu >> (16 - top)) & ~((1u << j) - 1u);
    if (end - p0 >= count || i >= hi) break;
    j = end - p0;
    end = ends.end(++i);
    if (end <= p0 + j && i < hi) {
      i = first_end_after(ends, i + 1, hi, p0 + j);
      end = ends.end(i);
    }
  }
  return flags;
}

// Bases 4 q .. 4 q + 3 of a word, a byte each (first lowest).
__device__ __forceinline__ uint32_t code_bytes(uint32_t word, int q) {
  const uint32_t g = (word >> (24 - 8 * q)) & 0xFFu;
  return ((g >> 6) & 3u) | ((g >> 4) & 3u) << 8 | ((g >> 2) & 3u) << 16 | (g & 3u) << 24;
}

// Flags 4 q .. 4 q + 3 of a mask, a byte each: bit b of the nibble lands on
// bit 8 b of the product (the four shifted copies do not overlap).
__device__ __forceinline__ uint32_t flag_bytes(uint32_t flags, int q) {
  return (((flags >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
}

// A warp's 512 positions of one 32-bit output from its lanes' registers
// (lane l holds positions 16 l .. 16 l + 15) to out[0 .. limit), through
// the warp's shared buffer: chunk c of lane l (4 positions) sits at
// 16 l + 4 (c ^ ((l >> 1) & 3)), so neither the lanes' 16-byte writes nor
// the 16-byte reads below meet in a bank; lane l then stores chunks l, l +
// 32, l + 64 and l + 96, one contiguous 512 bytes a store instruction.
__device__ __forceinline__ void warp_store(uint32_t* stage, const uint32_t vals[16],
                                           uint32_t* out, int limit) {
  const int lane = threadIdx.x & 31;
  const int swz = (lane >> 1) & 3;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    *reinterpret_cast<uint4*>(stage + 16 * lane + 4 * (c ^ swz)) =
        make_uint4(vals[4 * c], vals[4 * c + 1], vals[4 * c + 2], vals[4 * c + 3]);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = 32 * r + lane;  // the chunk: positions 4 m .. 4 m + 3
    const int owner = m >> 2;
    const uint4 v = *reinterpret_cast<const uint4*>(
        stage + 16 * owner + 4 * ((m & 3) ^ ((owner >> 1) & 3)));
    uint32_t* dst = out + 4 * m;
    if (4 * m + 4 <= limit && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      if (4 * m < limit) dst[0] = v.x;
      if (4 * m + 1 < limit) dst[1] = v.y;
      if (4 * m + 2 < limit) dst[2] = v.z;
      if (4 * m + 3 < limit) dst[3] = v.w;
    }
  }
  __syncwarp();
}

// Decode modes: codes and flags; with read ids; with run headers.
enum Mode { kFlags = 0, kReadIds = 1, kRuns = 2 };

// A decode tile: positions [b * kTile, (b + 1) * kTile) of segment `seg`.
template <int kMode>
__device__ void decode_tile(const Args& a, int64_t seg, int64_t b) {
  constexpr bool kExt = kMode != kFlags;
  __shared__ int32_t staged[kStaged];
  __shared__ __align__(16) uint32_t stage[kExt ? kWarps * 512 : 4];
  __shared__ int range[2];
  const int warp = threadIdx.x >> 5;
  const int w0 = static_cast<int>(b * (kTile / 16));

  int lo = -1, hi = -1;  // no reads: nothing to walk
  bool in_shared = true;
  if (a.reads > 0) {
    if (threadIdx.x < 2) {
      range[threadIdx.x] = a.tile_first[seg * (a.decode_tiles + 1) + b + threadIdx.x] - 1;
    }
    __syncthreads();
    lo = range[0];
    hi = range[1];
    const int count = hi - lo + 2;  // the end before read lo, then lo .. hi
    in_shared = count <= kStaged;
    if (in_shared) {
      const int32_t* ends = a.ends + seg * a.reads;
      for (int j = threadIdx.x; j < count; j += kThreads) {
        const int r = lo - 1 + j;
        staged[j] = r >= 0 ? ends[r] : 0;
      }
    }
    __syncthreads();
  }

  const SharedEnds shared_ends{staged, lo};
  const GlobalEnds global_ends{a.ends + seg * a.reads};
  const uint32_t* packed = a.packed + seg * a.word_stride;
  const int64_t base = seg * static_cast<int64_t>(a.block_len);
#pragma unroll 1
  for (int q = 0; q < kWords; ++q) {
    // Positions as int64 until they are known to lie in the segment (the
    // last tile's words past it would pass 2^31 at the largest block_len).
    const int w = w0 + q * kThreads + threadIdx.x;
    const int64_t p0_wide = 16 * static_cast<int64_t>(w);
    const int count = a.block_len - p0_wide <= 0 ? 0
                      : a.block_len - p0_wide < 16 ? static_cast<int>(a.block_len - p0_wide)
                                                   : 16;
    uint32_t rids[16], poss[16];
    if (count > 0) {
      const int p0 = static_cast<int>(p0_wide);
      const uint32_t word = __ldg(packed + w);
      uint32_t flags;
      if (kMode == kRuns) {
        const RunHeaders meta{a.rid0 + seg * a.rid0_stride, a.pos0 + seg * a.pos0_stride};
        flags = in_shared
            ? decode_word(shared_ends, lo, hi, p0, count, a.k, meta, rids, poss)
            : decode_word(global_ends, lo, hi, p0, count, a.k, meta, rids, poss);
      } else if (kMode == kReadIds) {
        const ReadIds meta{a.rid_base};
        flags = in_shared
            ? decode_word(shared_ends, lo, hi, p0, count, a.k, meta, rids, poss)
            : decode_word(global_ends, lo, hi, p0, count, a.k, meta, rids, poss);
      } else {
        flags = in_shared ? decode_flags(shared_ends, lo, hi, p0, count, a.k)
                          : decode_flags(global_ends, lo, hi, p0, count, a.k);
      }
      const int64_t o = base + p0;
      const bool vec = count == 16 &&
          ((reinterpret_cast<uintptr_t>(a.codes + o) |
            reinterpret_cast<uintptr_t>(a.valid + o)) & 15u) == 0;
      if (vec) {
        *reinterpret_cast<uint4*>(a.codes + o) = make_uint4(
            code_bytes(word, 0), code_bytes(word, 1), code_bytes(word, 2), code_bytes(word, 3));
        *reinterpret_cast<uint4*>(a.valid + o) = make_uint4(
            flag_bytes(flags, 0), flag_bytes(flags, 1), flag_bytes(flags, 2),
            flag_bytes(flags, 3));
      } else {
        for (int j = 0; j < count; ++j) {
          a.codes[o + j] = static_cast<int8_t>((word >> (30 - 2 * j)) & 3u);
          a.valid[o + j] = static_cast<uint8_t>((flags >> j) & 1u);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) rids[j] = poss[j] = 0;
    }
    if (kExt) {
      // The warp's 32 words are adjacent: positions [wp0, wp0 + 512).
      const int64_t wp0 = 16 * static_cast<int64_t>(w0 + q * kThreads + 32 * warp);
      if (wp0 < a.block_len) {  // the same for every lane of the warp
        const int limit = static_cast<int>(a.block_len - wp0);
        uint32_t* my_stage = stage + warp * 512;
        warp_store(my_stage, rids, a.rid + base + wp0, limit);
        warp_store(my_stage, poss, a.pos + base + wp0, limit);
      }
    }
  }
}

// Launch 1: the scan tiles, tile i of the segments' tiles by blockIdx.x (a
// look-back waits only on tiles of lower index, which the card starts no
// later, as a single-pass scan relies on).
__global__ void __launch_bounds__(kThreads) scan_kernel(Args a) {
  scan_tile(a, blockIdx.x / a.scan_tiles, blockIdx.x % a.scan_tiles);
}

// Launch 2: decode tile blockIdx.x of segment blockIdx.y. The scan's
// descriptors are read no more: the decode's blocks zero them for the
// next call.
template <int kMode>
__global__ void __launch_bounds__(kThreads) decode_kernel(Args a) {
  const int64_t descs = a.segments * a.scan_tiles;
  const int64_t block = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * gridDim.y * kThreads;
  for (int64_t i = block * kThreads + threadIdx.x; i < descs; i += stride) a.desc[i] = 0;
  decode_tile<kMode>(a, blockIdx.y, blockIdx.x);
}

}  // namespace

// Bytes of the state hk_wire_decode keeps between calls for these
// dimensions: the caller allocates it zeroed once and hands it to every
// call (on one stream, one call at a time); each call leaves it zero.
extern "C" int64_t hk_wire_decode_state(int64_t segments, int64_t reads) {
  return dims(segments, reads, 1).state;
}

// Bytes of the work buffer a call needs (no initial contents).
extern "C" int64_t hk_wire_decode_scratch(int64_t segments, int64_t reads,
                                          int64_t block_len) {
  return dims(segments, reads, block_len).total;
}

namespace {

// The launches of every mode: codes and flags without rid and pos, read
// ids with them, run headers with them and `runs` (rid0 and pos0 then
// needed where there are reads).
int decode(const void* packed, int64_t word_stride, const void* lengths,
           int64_t len_stride, int64_t segments, int64_t reads, int64_t block_len, int k,
           int rid_base, bool runs, const void* rid0, int64_t rid0_stride,
           const void* pos0, int64_t pos0_stride, void* state, void* scratch, void* codes,
           void* valid, void* rid, void* pos, void* stream) {
  if (segments < 1 || segments > 65535 || block_len < 1 || block_len >= kEndCap - 128 ||
      reads < 0 || reads >= kEndCap || k < 1 || k > 128 ||
      (rid == nullptr) != (pos == nullptr) || (runs && rid == nullptr) ||
      (runs && reads > 0 && (rid0 == nullptr || pos0 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const Dims d = dims(segments, reads, block_len);
  if (segments * d.scan_tiles >= (int64_t{1} << 31) ||
      d.decode_tiles >= (int64_t{1} << 31)) {
    return cudaErrorInvalidValue;
  }
  char* work = static_cast<char*>(scratch);
  Args a;
  a.packed = static_cast<const uint32_t*>(packed);
  a.word_stride = word_stride;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.len_stride = len_stride;
  a.reads = static_cast<int>(reads);
  a.block_len = static_cast<int>(block_len);
  a.k = k;
  a.rid_base = static_cast<uint32_t>(rid_base);
  a.segments = segments;
  a.scan_tiles = d.scan_tiles;
  a.decode_tiles = d.decode_tiles;
  a.desc = static_cast<uint64_t*>(state);
  a.tile_first = reinterpret_cast<int32_t*>(work + d.tile_first);
  a.ends = reinterpret_cast<int32_t*>(work + d.ends);
  a.codes = static_cast<int8_t*>(codes);
  a.valid = static_cast<uint8_t*>(valid);
  a.rid = static_cast<uint32_t*>(rid);
  a.pos = static_cast<uint32_t*>(pos);
  a.rid0 = static_cast<const int32_t*>(rid0);
  a.pos0 = static_cast<const uint32_t*>(pos0);
  a.rid0_stride = rid0_stride;
  a.pos0_stride = pos0_stride;
  const auto s = static_cast<cudaStream_t>(stream);
  if (reads > 0) {
    scan_kernel<<<static_cast<unsigned>(segments * d.scan_tiles), kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(d.decode_tiles), static_cast<unsigned>(segments));
  if (runs) {
    decode_kernel<kRuns><<<grid, kThreads, 0, s>>>(a);
  } else if (rid != nullptr) {
    decode_kernel<kReadIds><<<grid, kThreads, 0, s>>>(a);
  } else {
    decode_kernel<kFlags><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// packed: segment s's ceil(block_len / 16) words at packed + s * word_stride
// (uint32 bit patterns); lengths: its `reads` int32 lengths at lengths + s *
// len_stride. Writes codes (S * block_len,) int8 and valid (S * block_len,)
// bool, and with rid and pos (both or neither) the int32 read ids and
// uint32 positions. 1 <= S <= 65535, 1 <= block_len < 2^31 - 128,
// 0 <= reads < 2^31 - 1, 1 <= k <= 128; state: at least
// hk_wire_decode_state bytes, zero; scratch: hk_wire_decode_scratch bytes.
// Returns the launch's CUDA error.
extern "C" int hk_wire_decode(const void* packed, int64_t word_stride, const void* lengths,
                              int64_t len_stride, int64_t segments, int64_t reads,
                              int64_t block_len, int k, int rid_base, void* state,
                              void* scratch, void* codes, void* valid, void* rid, void* pos,
                              void* stream) {
  return decode(packed, word_stride, lengths, len_stride, segments, reads, block_len, k,
                rid_base, false, nullptr, 0, nullptr, 0, state, scratch, codes, valid, rid,
                pos, stream);
}

// Run-header mode: as hk_wire_decode with rid and pos, the reads being
// runs whose `reads` int32 read ids lie at rid0 + s * rid0_stride and
// uint32 first positions at pos0 + s * pos0_stride for segment s (both
// may be null where reads is 0).
extern "C" int hk_wire_decode_runs(const void* packed, int64_t word_stride,
                                   const void* lengths, int64_t len_stride,
                                   const void* rid0, int64_t rid0_stride, const void* pos0,
                                   int64_t pos0_stride, int64_t segments, int64_t reads,
                                   int64_t block_len, int k, void* state, void* scratch,
                                   void* codes, void* valid, void* rid, void* pos,
                                   void* stream) {
  return decode(packed, word_stride, lengths, len_stride, segments, reads, block_len, k, 0,
                true, rid0, rid0_stride, pos0, pos0_stride, state, scratch, codes, valid,
                rid, pos, stream);
}
