// The wire decode: S segments of the 2-bit packed read wire -> per position
// the base code, whether a k-mer starts there and, in extension mode, the
// read id and the position in the read.
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
//     position in read = p - the last of those starts (uint32 bits).
//
// Two launches after one memset:
//   1. ends: each read's end offset by a chained scan of the lengths in
//      int64 (so no total wraps), one tile of 2048 lengths a block, the
//      carry from the tiles to the left by decoupled look-back; each read
//      also marks the decode tiles whose first position it holds
//      (tile_first). The ends are kept as int32, cut at 2^31 - 1: positions
//      lie below 2^31 - 128 (the wrapper's bound), so every comparison the
//      decode makes with a cut end comes out as with the true one.
//   2. decode: a thread a 32-bit word (16 positions), 256 a block, a block
//      one decode tile of 4096 positions. The reads that can hold the tile's
//      positions lie between its tile_first and the next tile's, so a
//      thread finds its first position's read by a binary search over a few
//      cached ends, then walks on over its 16 positions: the next read at a
//      read's end, a binary search only past zero-length reads. int32
//      positions and ends halve the walk's arithmetic and the ends' bytes.
//
// Bound on the H100: HBM bytes. Per position 1/4 B of words in, 1 B of code
// and 1 B of flag out (2.25 B), 8 B more with the read id and position; 4 B
// a read in. The ends (4 B a read) are written and read once more; the
// decode's stores are 16-byte vectors where the segment's offset allows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr int64_t kScanTile = kScanThreads * kScanItems;  // lengths a scan tile
constexpr int kThreads = 256;
constexpr int64_t kTile = kThreads * 16;  // positions a decode tile
constexpr int64_t kEndCap = 0x7FFFFFFF;   // ends are kept as int32
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

// A look-back descriptor: one 64-bit word, written in one store and read
// volatile, so status and value arrive together. Status in the top two
// bits (0 not published, 1 aggregate: the tile's own sum, keep walking;
// 2 inclusive: the sum of the segment's lengths up to the tile's end), the
// sum below (lengths are int32 >= 0, so sums stay below 2^62).
constexpr uint64_t kAggregate = uint64_t{1} << 62;
constexpr uint64_t kInclusive = uint64_t{2} << 62;
constexpr uint64_t kValueMask = kAggregate - 1;

struct Layout {
  int64_t scan_tiles, decode_tiles;
  int64_t desc, tile_first, ends, total;  // byte offsets into the scratch
};

Layout layout(int64_t segments, int64_t reads, int64_t block_len) {
  Layout l;
  l.scan_tiles = (reads + kScanTile - 1) / kScanTile;
  l.decode_tiles = (block_len + kTile - 1) / kTile;
  l.desc = 8;  // after the ticket
  l.tile_first = l.desc + 8 * segments * l.scan_tiles;
  l.ends = (l.tile_first + 4 * segments * (l.decode_tiles + 1) + 7) / 8 * 8;
  l.total = l.ends + 4 * segments * reads;
  return l;
}

struct Scratch {
  unsigned* ticket;
  uint64_t* desc;       // [segment][scan tile]
  int32_t* tile_first;  // [segment][decode tile + 1]: 1 + the read holding the
                        // tile's first position; 0 (never marked) = the last read
  int32_t* ends;        // [segment][read], cut at 2^31 - 1
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

// Launch 1. A block's tile is a ticket from the left end over all segments'
// tiles, so every tile a walk waits on drew its ticket earlier and is
// running or done, whatever order the card schedules blocks in.
__global__ void __launch_bounds__(kScanThreads)
ends_kernel(const int32_t* __restrict__ lengths, int64_t len_stride, int64_t reads,
            Layout l, Scratch sc) {
  __shared__ int64_t tile_index;
  __shared__ int64_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry;
  if (threadIdx.x == 0) tile_index = atomicAdd(sc.ticket, 1u);
  __syncthreads();
  const int64_t seg = tile_index / l.scan_tiles;
  const int64_t tile = tile_index % l.scan_tiles;
  const int32_t* len = lengths + seg * len_stride;
  uint64_t* desc = sc.desc + seg * l.scan_tiles;

  const int64_t first = tile * kScanTile + threadIdx.x * kScanItems;
  int64_t v[kScanItems];
  int64_t own = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = first + i < reads ? static_cast<int64_t>(len[first + i]) : 0;
    own += v[i];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t incl = warp_inclusive_sum(own);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
    w = warp_inclusive_sum(w);
    if (lane < kScanThreads / 32) warp_sums[lane] = w;
    const int64_t aggregate = __shfl_sync(kAllLanes, w, kScanThreads / 32 - 1);
    int64_t before = 0;
    if (tile == 0) {
      if (lane == 0) publish(desc, tile, kInclusive, aggregate);
    } else {
      if (lane == 0) publish(desc, tile, kAggregate, aggregate);
      before = walk_left(desc, tile);
      if (lane == 0) publish(desc, tile, kInclusive, before + aggregate);
    }
    if (lane == 0) carry = before;
  }
  __syncthreads();

  int32_t* ends = sc.ends + seg * reads;
  int32_t* tile_first = sc.tile_first + seg * (l.decode_tiles + 1);
  int64_t end = carry + (warp ? warp_sums[warp - 1] : 0) + incl - own;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int64_t r = first + i;
    if (r >= reads) break;
    const int64_t start = end;
    end += v[i];
    ends[r] = static_cast<int32_t>(end < kEndCap ? end : kEndCap);
    // The decode tiles whose first position lies in [start, end).
    for (int64_t b = (start + kTile - 1) / kTile; b < l.decode_tiles && b * kTile < end;
         ++b) {
      tile_first[b] = static_cast<int32_t>(r + 1);
    }
  }
}

// The first index in [lo, hi) whose end is past p, else hi.
__device__ __forceinline__ int first_end_after(const int32_t* __restrict__ ends, int lo,
                                               int hi, int p) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Launch 2. The read holding p, where p lies before the lengths' total, is
// the last read whose start is at or before p: the number of reads but the
// last whose end is at or before p. It is the last read for every p at or
// past the total, and for no read at all rid = rid_base - 1, pos = p.
template <bool kExt>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ packed, int64_t word_stride, int reads,
              int block_len, int k, uint32_t rid_base, Layout l, Scratch sc,
              int8_t* __restrict__ codes, uint8_t* __restrict__ valid,
              uint32_t* __restrict__ rid, uint32_t* __restrict__ pos) {
  const int64_t seg = blockIdx.y;
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= (block_len + 15) / 16) return;
  const int p0 = 16 * w;
  const uint32_t word = __ldg(packed + seg * word_stride + w);
  const int32_t* ends = sc.ends + seg * reads;

  int i = -1, start = 0, end = 0, hi = -1;  // no read: nothing to walk
  if (reads > 0) {
    const int32_t* tf = sc.tile_first + seg * (l.decode_tiles + 1) + blockIdx.x;
    const int32_t a = tf[0], z = tf[1];
    hi = z ? z - 1 : reads - 1;
    i = first_end_after(ends, a ? a - 1 : reads - 1, hi, p0);
    end = ends[i];
    start = i ? ends[i - 1] : 0;
  }

  uint32_t code4[4] = {0, 0, 0, 0}, flag4[4] = {0, 0, 0, 0};
  uint32_t rids[16], poss[16];
  const int count = block_len - p0 < 16 ? block_len - p0 : 16;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int p = p0 + j;
    if (j < count) {
      if (p >= end && i < hi) {
        // The next read starts at this one's end; past zero-length reads
        // (whose ends equal it), a search.
        start = end;
        end = ends[++i];
        if (end <= p && i < hi) {
          i = first_end_after(ends, i + 1, hi, p);
          start = ends[i - 1];
          end = ends[i];
        }
      }
      code4[j >> 2] |= ((word >> (30 - 2 * j)) & 3u) << (8 * (j & 3));
      flag4[j >> 2] |= static_cast<uint32_t>(p + k <= end) << (8 * (j & 3));
      rids[j] = static_cast<uint32_t>(i) + rid_base;
      poss[j] = static_cast<uint32_t>(p - start);
    }
  }

  const int64_t o = seg * block_len + p0;
  const bool bytes_vec = count == 16 &&
      ((reinterpret_cast<uintptr_t>(codes + o) | reinterpret_cast<uintptr_t>(valid + o)) &
       15u) == 0;
  if (bytes_vec) {
    *reinterpret_cast<uint4*>(codes + o) = make_uint4(code4[0], code4[1], code4[2], code4[3]);
    *reinterpret_cast<uint4*>(valid + o) = make_uint4(flag4[0], flag4[1], flag4[2], flag4[3]);
  } else {
    for (int j = 0; j < count; ++j) {
      codes[o + j] = static_cast<int8_t>((code4[j >> 2] >> (8 * (j & 3))) & 0xFFu);
      valid[o + j] = static_cast<uint8_t>((flag4[j >> 2] >> (8 * (j & 3))) & 0xFFu);
    }
  }
  if (kExt) {
    const bool words_vec = count == 16 &&
        ((reinterpret_cast<uintptr_t>(rid + o) | reinterpret_cast<uintptr_t>(pos + o)) &
         15u) == 0;
    if (words_vec) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        reinterpret_cast<uint4*>(rid + o)[q] =
            make_uint4(rids[4 * q], rids[4 * q + 1], rids[4 * q + 2], rids[4 * q + 3]);
        reinterpret_cast<uint4*>(pos + o)[q] =
            make_uint4(poss[4 * q], poss[4 * q + 1], poss[4 * q + 2], poss[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j < count) {
          rid[o + j] = rids[j];
          pos[o + j] = poss[j];
        }
      }
    }
  }
}

}  // namespace

// Bytes of scratch hk_wire_decode needs for these dimensions.
extern "C" int64_t hk_wire_decode_scratch(int64_t segments, int64_t reads,
                                          int64_t block_len) {
  return layout(segments, reads, block_len).total;
}

// packed: segment s's ceil(block_len / 16) words at packed + s * word_stride
// (uint32 bit patterns); lengths: its `reads` int32 lengths at lengths + s *
// len_stride. Writes codes (S * block_len,) int8 and valid (S * block_len,)
// bool, and with rid and pos (both or neither) the int32 read ids and
// uint32 positions. 1 <= S <= 65535, 1 <= block_len < 2^31 - 128,
// 0 <= reads < 2^31 - 1, 1 <= k <= 128.
// Returns the first CUDA error of the memset and the launches.
extern "C" int hk_wire_decode(const void* packed, int64_t word_stride, const void* lengths,
                              int64_t len_stride, int64_t segments, int64_t reads,
                              int64_t block_len, int k, int rid_base, void* scratch,
                              void* codes, void* valid, void* rid, void* pos,
                              void* stream) {
  if (segments < 1 || segments > 65535 || block_len < 1 || block_len >= kEndCap - 128 ||
      reads < 0 || reads >= kEndCap || k < 1 || k > 128 ||
      (rid == nullptr) != (pos == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const Layout l = layout(segments, reads, block_len);
  char* base = static_cast<char*>(scratch);
  const Scratch sc{reinterpret_cast<unsigned*>(base),
                   reinterpret_cast<uint64_t*>(base + l.desc),
                   reinterpret_cast<int32_t*>(base + l.tile_first),
                   reinterpret_cast<int32_t*>(base + l.ends)};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(l.ends), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (reads > 0) {
    ends_kernel<<<static_cast<unsigned>(segments * l.scan_tiles), kScanThreads, 0, s>>>(
        static_cast<const int32_t*>(lengths), len_stride, reads, l, sc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(l.decode_tiles), static_cast<unsigned>(segments));
  const auto* words = static_cast<const uint32_t*>(packed);
  auto* c = static_cast<int8_t*>(codes);
  auto* v = static_cast<uint8_t*>(valid);
  const auto base_id = static_cast<uint32_t>(rid_base);
  if (rid != nullptr) {
    decode_kernel<true><<<grid, kThreads, 0, s>>>(
        words, word_stride, static_cast<int>(reads), static_cast<int>(block_len), k,
        base_id, l, sc, c, v,
        static_cast<uint32_t*>(rid), static_cast<uint32_t*>(pos));
  } else {
    decode_kernel<false><<<grid, kThreads, 0, s>>>(
        words, word_stride, static_cast<int>(reads), static_cast<int>(block_len), k,
        base_id, l, sc, c, v, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
