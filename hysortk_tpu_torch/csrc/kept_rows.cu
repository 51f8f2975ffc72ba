// The result stage: the kept rows of a sorted, counted block compacted in
// slot order, their keys unmixed (range routing), their counts narrowed and
// binned into the histogram, in one pass over the block; and the kept runs'
// occurrences gathered end to end.
//
// No TPU kernel: the JAX package does this on the host and in XLA
// (hysortk_tpu/pipeline.py:477 compact_keys, :482 host_histogram, :114
// assemble_ext_result with split_occurrences, :288 device_compact's fold to
// the sentinel; ops/mixkey.py:105 unmix_keys_np; the sharded results of
// parallel/pipeline.py:694-706, :1028-1037, :1330-1343), and so did the
// port, as torch.nonzero, an index gather a key word and a stack, a cast, a
// clamp and torch.bincount, and for the occurrences cumsum,
// repeat_interleave and arange (ops/compact.py compact_kept_plain and
// gather_runs_plain keep those chains). Launches:
//
// kept_count  A block kGroup write tiles (kCountTile slots), its index a
//             ticket, so every block it waits on is running or done. A
//             thread loads its kChunks 16-byte chunks of keep together,
//             packs each into 16 bits of the keep mask, which the write
//             launch reads instead of keep (n/8 bytes for n), and, for the
//             occurrence offsets, then loads the kept slots' counts of
//             every chunk together, four in one 16-byte load where the four
//             hold a kept slot. The block's (rows, occurrences) are
//             carried across the blocks by a decoupled look-back to the
//             left on one 64-bit descriptor a block (lookback.cuh's
//             walk_left_pairs); it leaves each of its write tiles'
//             exclusive prefixes for the write launch, and the last block
//             writes the totals to the header, which the count's entry
//             point reads once on the host (the one sync torch.nonzero
//             paid), or not at all in the mode that does not sync.
// kept_write  Persistent blocks walk the tiles, a thread kItems adjacent
//             slots (one byte of the mask). The loads run a tile ahead: the
//             next tile's kept words and counts are loaded into registers
//             while this tile is written, and the keep bits two tiles
//             ahead. A warp scan of the kept bits gives each kept slot its
//             rank among the tile's, in slot order; the kept slots' key
//             words, count and slot go to shared memory at their ranks (a
//             dropped slot's words are never read). Then a thread a kept
//             row unmixes it in place (mixkey.cuh) and bins its count in
//             shared bins below kSharedBins (a warp's equal counts with one
//             atomic, match.any) and straight into the int64 histogram above
//             them; the block writes the rows out contiguously: (m, W)
//             row-major or W rows of the output length, counts as uint8 /
//             uint16 / int32, the slots, and the runs' occurrence offsets by
//             a block scan of the counts. Where the output is longer than
//             the kept rows, each tile writes its share of the sentinel tail
//             (-1 words, 0 counts), so every output slot is written once and
//             nothing is cleared beforehand. Shared bins are added to the
//             histogram once a block. Two barriers a tile (three with the
//             unmix, one more for the offsets' scan).
// count_hist  The histogram alone of a row of counts (every row kept, none
//             written): 16-byte loads, shared-memory atomics, the grid
//             sized to the card, each block's bins flushed once.
// gather_runs A block an output tile of kGatherTile occurrences. Two warps
//             find the tile's first and last run by 32-way searches over
//             the runs' output offsets; the block stages those runs (output
//             offset relative to the tile and source - offset) in shared
//             memory, or reads them in place past kGatherStaged. A thread
//             takes four adjacent outputs at a time: one binary search for
//             the first, a step for each run edge after it, one 16-byte load
//             where the four sit in one run at an aligned source, one
//             16-byte store.
//
// Bound on the H100: HBM bytes. kept_rows reads keep (1 B a slot) and, of
// the count and the W key words, only the 32-byte sectors that hold a kept
// slot (a dropped slot's word is never read), and writes the kept rows (4 W
// B of keys, the narrowed count, the slot and offset where asked). The card
// fetches those sectors in 64-byte pieces (tools/kept_sector_probe.cu), and
// what the write launch waits on is their latency: the next tile's loads
// are in flight while a tile is written, so a block always has a tile's
// kept sectors outstanding. The unmix is 2 x W fmix32 inversions a kept
// row. gather_runs reads and writes each occurrence's words once and each
// run's start and offset once.
//
// Two designs were measured and dropped (PERF.md §6, row 15): one launch in all
// (the look-back inside the write, the tail written from the output's end)
// was slower, as the walk stalls every write tile and rows written from
// registers scatter their stores; and offsets fixed up after the write (so
// that the count reads no count) saved device time but needed a second
// host read, after which nothing overlaps the write. The write launch's
// configuration (shared-memory attribute, blocks an SM holds) and the SM
// count are set and asked once per device and W, not per call.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "mixkey.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // slots a thread of the write launch takes: a byte of the mask
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;  // 2048 slots
constexpr int kMaxWords = mixkey::kMaxWords;
constexpr int kSharedBins = 1024;
// The count launch: a block kGroup write tiles, a thread kChunks 16-byte
// chunks of keep. A warp's 32 chunks span 512 slots, so kWarpsATile warps
// read a write tile's share of a row of chunks, which spans two tiles.
constexpr int kCountTile = 32768;
constexpr int kGroup = kCountTile / kTile;  // 16
constexpr int kChunks = kCountTile / 16 / kThreads;  // 8
constexpr int kWarpsATile = kTile / 512;  // 4
static_assert(2 * kWarpsATile == kWarps, "a row of chunks spans two write tiles");
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

// --------------------------------------------------------------------------
// The launch configuration, asked once per device (and W).

struct DeviceConfig {
  std::atomic<int> sms{0};
  std::atomic<int> write_blocks[kMaxWords + 1];  // kept_write<W>'s blocks an SM holds
  std::atomic<int> hist_blocks{0};
};

DeviceConfig g_config[kMaxDevices];

// The current device's entry, its SM count asked at first use; null where
// the device cannot be told or lies past kMaxDevices.
inline DeviceConfig* device_config() {
  int device = -1;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) {
    return nullptr;
  }
  DeviceConfig& c = g_config[device];
  if (c.sms.load(std::memory_order_relaxed) == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    c.sms.store(sms < 1 ? 1 : sms, std::memory_order_relaxed);
  }
  return &c;
}

// Blocks of `kernel` an SM holds at kThreads threads and `shared` bytes of
// dynamic shared memory (the attribute set first where it is above the
// default), asked once into `slot`; 0 where the card refuses.
template <class Kernel>
inline int blocks_per_sm(std::atomic<int>& slot, Kernel kernel, int shared) {
  int per_sm = slot.load(std::memory_order_relaxed);
  if (per_sm == 0) {
    if (shared > 0 && cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           shared) != cudaSuccess) {
      return 0;
    }
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shared) !=
        cudaSuccess) {
      return 0;
    }
    if (per_sm < 1) per_sm = 1;
    slot.store(per_sm, std::memory_order_relaxed);
  }
  return per_sm;
}

// --------------------------------------------------------------------------
// The buffers of a compaction. The head: the header (the kept rows and their
// occurrences) and the histogram (hist_upper + 1 counts, none where
// hist_upper < 0), int64 each, which the caller may keep. The scratch: the
// count's look-back (lookback.cuh: the ticket, a block's (rows,
// occurrences) as a pair), then each write tile's exclusive (rows,
// occurrences). The keep mask (a bit a slot, through the last count
// block). The count's entry point clears the head and the look-back.

inline int64_t tiles_of(int64_t n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

inline int64_t groups_of(int64_t tiles) { return (tiles + kGroup - 1) / kGroup; }

inline int64_t head_bytes_of(int hist_upper) {
  return 16 + 8 * (hist_upper >= 0 ? static_cast<int64_t>(hist_upper) + 1 : 0);
}

// Bytes of the look-back, the scratch's first part.
inline int64_t look_bytes_of(int64_t n) {
  return lookback::scratch_bytes<uint64_t>(groups_of(tiles_of(n)));
}

inline int64_t scratch_bytes_of(int64_t n) { return look_bytes_of(n) + 8 * tiles_of(n); }

// The mask through the last count block, so that its stores need no bound.
inline int64_t mask_bytes_of(int64_t n) {
  return groups_of(tiles_of(n)) * (kCountTile / 8);
}

// Bits 0-3: the bytes of v (each 0 or 1) in order. The four shifted copies
// land byte i on bit 24 + i and nowhere else among bits 24-27, without
// carries.
__device__ __forceinline__ unsigned nibble(uint32_t v) {
  return ((v * 0x01020408u) >> 24) & 0xFu;
}

// --------------------------------------------------------------------------
// The count launch.

__global__ void __launch_bounds__(kThreads)
kept_count_kernel(const uint8_t* __restrict__ keep, const int32_t* __restrict__ cnt,
                  int64_t n, int num_tiles, int num_groups, bool aligned, bool cnt_aligned,
                  lookback::Scratch<uint64_t> sc, int2* __restrict__ before,
                  uint32_t* __restrict__ mask, int64_t* __restrict__ header) {
  __shared__ int group_s;
  __shared__ unsigned sums[2][kWarps][kChunks];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) group_s = lookback::take_tile_left(sc.ticket);
  __syncthreads();
  const int group = group_s;
  const int64_t group_base = static_cast<int64_t>(group) * kCountTile;
  // Chunk k of this thread, 16 slots from first + 16 kThreads k, lies in
  // write tile 2 k + (tid >= kThreads / 2) of the group.
  const int64_t first = group_base + 16 * tid;
  unsigned bits[kChunks];
  if (aligned && group_base + kCountTile <= n) {
    uint4 v[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      v[k] = *reinterpret_cast<const uint4*>(keep + first + 16 * kThreads * k);
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      bits[k] = nibble(v[k].x) | nibble(v[k].y) << 4 | nibble(v[k].z) << 8 |
                nibble(v[k].w) << 12;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int64_t at = first + 16 * kThreads * k;
      bits[k] = 0;
      for (int j = 0; j < 16 && at + j < n; ++j) {
        if (keep[at + j]) bits[k] |= 1u << j;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    // Two adjacent chunks make a 32-bit word of the mask.
    const unsigned up = __shfl_down_sync(kAll, bits[k], 1);
    if ((lane & 1) == 0) mask[(first + 16 * kThreads * k) >> 5] = bits[k] | up << 16;
  }
  // The kept slots' counts of every chunk, their loads in flight together:
  // a quad of slots with a kept one in one 16-byte load.
  unsigned occ[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) occ[k] = 0;
  if (cnt != nullptr) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int64_t at = first + 16 * kThreads * k;
      if (cnt_aligned && at + 16 <= n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned b = (bits[k] >> (4 * q)) & 0xFu;
          if (b != 0) {
            const int4 c = __ldg(reinterpret_cast<const int4*>(cnt + at + 4 * q));
            occ[k] += ((b & 1u) ? static_cast<unsigned>(c.x) : 0u) +
                      ((b & 2u) ? static_cast<unsigned>(c.y) : 0u) +
                      ((b & 4u) ? static_cast<unsigned>(c.z) : 0u) +
                      ((b & 8u) ? static_cast<unsigned>(c.w) : 0u);
          }
        }
      } else {
        for (int j = 0; j < 16; ++j) {
          if ((bits[k] >> j) & 1u) occ[k] += static_cast<unsigned>(__ldg(cnt + at + j));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const unsigned rows = __reduce_add_sync(kAll, static_cast<unsigned>(__popc(bits[k])));
    const unsigned o = __reduce_add_sync(kAll, occ[k]);
    if (lane == 0) {
      sums[0][warp][k] = rows;
      sums[1][warp][k] = o;
    }
  }
  __syncthreads();
  // Thread g < kGroup: write tile g's (rows, occurrences), from the warps
  // that read its half of a row of chunks; then their exclusive scan over
  // the group by warp 0.
  unsigned rows = 0, occ_tile = 0;
  if (tid < kGroup) {
    const int k = tid >> 1, h = tid & 1;
#pragma unroll
    for (int w = 0; w < kWarpsATile; ++w) {
      rows += sums[0][kWarpsATile * h + w][k];
      occ_tile += sums[1][kWarpsATile * h + w][k];
    }
  }
  if (tid < 32) {
    unsigned incl_rows = rows, incl_occ = occ_tile;
#pragma unroll
    for (int o = 1; o < kGroup; o <<= 1) {
      const unsigned yr = __shfl_up_sync(kAll, incl_rows, o);
      const unsigned yo = __shfl_up_sync(kAll, incl_occ, o);
      if (lane >= o) {
        incl_rows += yr;
        incl_occ += yo;
      }
    }
    const unsigned group_rows = __shfl_sync(kAll, incl_rows, kGroup - 1);
    const unsigned group_occ = __shfl_sync(kAll, incl_occ, kGroup - 1);
    uint2 left = make_uint2(0u, 0u);
    if (group > 0) {
      if (lane == 0) {
        lookback::publish_sum(sc.desc, group, lookback::kSumAggregate,
                              lookback::pair(group_rows, group_occ));
      }
      left = lookback::walk_left_pairs(sc.desc, group);
    }
    if (lane == 0) {
      lookback::publish_sum(sc.desc, group, lookback::kSumInclusive,
                            lookback::pair(left.x + group_rows, left.y + group_occ));
      if (group == num_groups - 1) {
        header[0] = left.x + group_rows;
        header[1] = left.y + group_occ;
      }
    }
    const int tile = group * kGroup + lane;
    if (lane < kGroup && tile < num_tiles) {
      before[tile] = make_int2(static_cast<int>(left.x + incl_rows - rows),
                               static_cast<int>(left.y + incl_occ - occ_tile));
    }
  }
}

// --------------------------------------------------------------------------
// The histogram: a warp's lanes with equal counts add with one atomic.

// Every lane of the warp calls it. `take`: the lane holds a count to bin.
__device__ __forceinline__ void bin_count(bool take, uint32_t c, uint32_t upper,
                                          unsigned* bins,
                                          unsigned long long* __restrict__ hist) {
  take = take && c <= upper;
  if (!__any_sync(kAll, take)) return;
  // A count that bins is at most upper < 2^31, so no such lane shares the
  // key of the lanes that do not bin.
  const unsigned peers = __match_any_sync(kAll, take ? c : kAll);
  if (take && (threadIdx.x & 31) == __ffs(peers) - 1) {
    const unsigned add = __popc(peers);
    if (c < kSharedBins) {
      atomicAdd(bins + c, add);
    } else {
      atomicAdd(hist + c, static_cast<unsigned long long>(add));
    }
  }
}

__device__ __forceinline__ void zero_bins(unsigned* bins) {
  for (int b = threadIdx.x; b < kSharedBins; b += blockDim.x) bins[b] = 0;
}

__device__ __forceinline__ void flush_bins(const unsigned* bins, uint32_t upper,
                                           unsigned long long* __restrict__ hist) {
  const int top = upper < kSharedBins ? static_cast<int>(upper) + 1 : kSharedBins;
  for (int b = threadIdx.x; b < top; b += blockDim.x) {
    if (bins[b] != 0) atomicAdd(hist + b, static_cast<unsigned long long>(bins[b]));
  }
}

// One count of the histogram-only launch: shared-memory atomics (the
// conflicts of equal counts in a warp are replayed by the hardware).
__device__ __forceinline__ void bin_one(uint32_t c, uint32_t upper, unsigned* bins,
                                        unsigned long long* __restrict__ hist) {
  if (c > upper) return;
  if (c < kSharedBins) {
    atomicAdd(bins + c, 1u);
  } else {
    atomicAdd(hist + c, 1ull);
  }
}

__global__ void __launch_bounds__(kThreads)
count_hist_kernel(const int32_t* __restrict__ counts, int64_t n, bool aligned, uint32_t upper,
                  unsigned long long* __restrict__ hist) {
  __shared__ unsigned bins[kSharedBins];
  zero_bins(bins);
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * 4;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4; i < n;
       i += stride) {
    if (aligned && i + 4 <= n) {
      const int4 v = *reinterpret_cast<const int4*>(counts + i);
      bin_one(static_cast<uint32_t>(v.x), upper, bins, hist);
      bin_one(static_cast<uint32_t>(v.y), upper, bins, hist);
      bin_one(static_cast<uint32_t>(v.z), upper, bins, hist);
      bin_one(static_cast<uint32_t>(v.w), upper, bins, hist);
    } else {
      for (int64_t j = i; j < i + 4 && j < n; ++j) {
        bin_one(static_cast<uint32_t>(counts[j]), upper, bins, hist);
      }
    }
  }
  __syncthreads();
  flush_bins(bins, upper, hist);
}

// --------------------------------------------------------------------------
// The write launch.

struct WriteArgs {
  const uint8_t* mask;    // a thread's kItems keep bits, by (tile * kTile + tid * kItems) / kItems
  const uint32_t* words[kMaxWords];
  const int32_t* cnt;
  int64_t n;
  int num_tiles;
  const int2* before;     // each tile's exclusive (rows, occurrences)
  const int64_t* header;  // (rows, occurrences) in all
  uint32_t* keys;         // word q of output row p at keys[p * row_stride + q * word_stride]
  int64_t row_stride;
  int64_t word_stride;
  int64_t length;         // output rows: the kept rows, then the sentinel tail
  void* counts;
  int count_bytes;        // 1, 2 or 4
  int32_t* slots;         // or null
  int32_t* offsets;       // or null
  bool mixed;
  mixkey::Consts mix;
  unsigned long long* hist;  // or null
  uint32_t hist_upper;
};

// The shared memory of a write block: the W key words, the counts and the
// slots of the tile's kept rows at their ranks, then the bins.
template <int W>
struct WriteShared {
  uint32_t key[W][kTile];
  int32_t cnt[kTile];
  int32_t slot[kTile];
  unsigned bins[kSharedBins];
  unsigned warp_kept[kWarps];
  unsigned scan[kWarps];
};

__device__ __forceinline__ void store_count(void* counts, int bytes, int64_t p, int32_t c) {
  if (bytes == 1) {
    static_cast<uint8_t*>(counts)[p] = static_cast<uint8_t>(c);
  } else if (bytes == 2) {
    static_cast<uint16_t*>(counts)[p] = static_cast<uint16_t>(c);
  } else {
    static_cast<int32_t*>(counts)[p] = c;
  }
}

// Bytes [begin, end) of base set to `byte` by the block: 16-byte stores
// between the aligned edges, single bytes outside them.
__device__ __forceinline__ void fill_bytes(char* base, int64_t begin, int64_t end,
                                           unsigned byte) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(base);
  int64_t lo = static_cast<int64_t>(((b + begin + 15) & ~uintptr_t{15}) - b);
  int64_t hi = static_cast<int64_t>(((b + end) & ~uintptr_t{15}) - b);
  if (lo > hi) lo = hi = end;
  const unsigned w = byte * 0x01010101u;
  const uint4 v = make_uint4(w, w, w, w);
  for (int64_t i = lo + 16 * threadIdx.x; i < hi; i += 16 * kThreads) {
    *reinterpret_cast<uint4*>(base + i) = v;
  }
  const int64_t edge = (lo - begin) + (end - hi);
  for (int64_t x = threadIdx.x; x < edge; x += kThreads) {
    base[x < lo - begin ? begin + x : hi + (x - (lo - begin))] = static_cast<char>(byte);
  }
}

// A thread's keep bits of `tile` (bit j: its slot j); none past the last.
__device__ __forceinline__ unsigned load_bits(const WriteArgs& a, int tile) {
  return tile < a.num_tiles ? __ldg(a.mask + static_cast<int64_t>(tile) * kThreads + threadIdx.x)
                            : 0u;
}

// A thread's kept slots' words and counts of `tile` into registers (0 for
// the dropped ones, whose words are never read).
template <int W>
__device__ __forceinline__ void load_kept(const WriteArgs& a, int tile, unsigned bits,
                                          uint32_t (&vals)[W][kItems],
                                          int32_t (&c)[kItems]) {
  const int64_t first = static_cast<int64_t>(tile) * kTile + threadIdx.x * kItems;
#pragma unroll
  for (int q = 0; q < W; ++q) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      vals[q][j] = (bits >> j) & 1u ? __ldg(a.words[q] + first + j) : 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) c[j] = (bits >> j) & 1u ? __ldg(a.cnt + first + j) : 0;
}

// One tile: `bits`, `vals` and `c` its kept slots (load_kept). Loads the
// next tile's into them while this one is written, and `bits_after` (the
// keep bits of the tile after that) into `bits_ahead`.
template <int W>
__device__ __forceinline__ void write_tile(const WriteArgs& a, WriteShared<W>& sh, int tile,
                                           unsigned& bits, unsigned& bits_ahead,
                                           uint32_t (&vals)[W][kItems], int32_t (&c)[kItems],
                                           int64_t kept_all) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile_base = static_cast<int64_t>(tile) * kTile;
  const int64_t left = a.n - tile_base;
  const int tile_n = left < kTile ? static_cast<int>(left) : kTile;
  const int64_t first = tile_base + tid * kItems;  // this thread's slots

  // Each kept slot's rank among the tile's, in slot order: the kept slots
  // of the threads before this one (a warp scan, the warps before it),
  // then the kept bits below the slot's.
  const unsigned mine = __popc(bits);
  unsigned incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kAll, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sh.warp_kept[warp] = incl;
  __syncthreads();
  int rank = static_cast<int>(incl - mine), tile_kept = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int k = static_cast<int>(sh.warp_kept[w]);
    rank += w < warp ? k : 0;
    tile_kept += k;
  }
  const int2 before = a.before[tile];

  // The kept slots' words, counts and slots to shared memory at their ranks.
  {
    int r = rank;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if ((bits >> j) & 1u) {
#pragma unroll
        for (int q = 0; q < W; ++q) sh.key[q][r] = vals[q][j];
        sh.cnt[r] = c[j];
        sh.slot[r] = static_cast<int32_t>(first + j);
        ++r;
      }
    }
  }
  // The next tile's loads, in flight while this one is written.
  const int next = tile + static_cast<int>(gridDim.x);
  bits = bits_ahead;
  load_kept<W>(a, next, bits, vals, c);
  bits_ahead = load_bits(a, next + static_cast<int>(gridDim.x));
  __syncthreads();

  // Unmixed in place and binned, a kept row a thread (every lane takes
  // part in a round, for the warp's match); only the unmix needs a barrier
  // after it.
  if (a.mixed || a.hist != nullptr) {
    for (int p0 = 0; p0 < tile_kept; p0 += kThreads) {
      const int p = p0 + tid;
      const bool in = p < tile_kept;
      if (a.mixed && in) {
        uint32_t w[W];
#pragma unroll
        for (int q = 0; q < W; ++q) w[q] = sh.key[q][p];
        mixkey::unmix<W>(w, a.mix);
#pragma unroll
        for (int q = 0; q < W; ++q) sh.key[q][p] = w[q];
      }
      if (a.hist != nullptr) {
        bin_count(in, in ? static_cast<uint32_t>(sh.cnt[p]) : 0u, a.hist_upper, sh.bins,
                  a.hist);
      }
    }
    if (a.mixed) __syncthreads();
  }

  const int64_t out0 = before.x;
  if (a.row_stride == W && a.word_stride == 1) {
    uint32_t* __restrict__ out = a.keys + out0 * W;
    for (int e = tid; e < tile_kept * W; e += kThreads) {
      const int p = e / W;
      out[e] = sh.key[e - p * W][p];
    }
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) {
      uint32_t* __restrict__ out = a.keys + q * a.word_stride;
      for (int p = tid; p < tile_kept; p += kThreads) out[(out0 + p) * a.row_stride] = sh.key[q][p];
    }
  }
  for (int p = tid; p < tile_kept; p += kThreads) {
    store_count(a.counts, a.count_bytes, out0 + p, sh.cnt[p]);
    if (a.slots != nullptr) a.slots[out0 + p] = sh.slot[p];
  }

  if (a.offsets != nullptr) {
    // Each run's first occurrence: the tile's occurrences before it plus an
    // exclusive scan of the kept counts, kItems consecutive rows a thread.
    const int p0 = tid * kItems;
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (p0 + i < tile_kept) sum += static_cast<unsigned>(sh.cnt[p0 + i]);
    }
    unsigned run = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kAll, run, o);
      if (lane >= o) run += y;
    }
    if (lane == 31) sh.scan[warp] = run;
    __syncthreads();
    run += static_cast<unsigned>(before.y) - sum;
    for (int w = 0; w < warp; ++w) run += sh.scan[w];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (p0 + i < tile_kept) {
        a.offsets[out0 + p0 + i] = static_cast<int32_t>(run);
        run += static_cast<unsigned>(sh.cnt[p0 + i]);
      }
    }
  }

  if (a.length > kept_all) {
    // This tile's dropped slots take the sentinel tail from their place
    // among all dropped slots, as far as the output reaches: rows [p0, p1).
    const int64_t p0 = kept_all + (tile_base - before.x);
    const int64_t end = p0 + (tile_n - tile_kept);
    const int64_t p1 = end < a.length ? end : a.length;
    if (p0 < p1) {
      char* keys = reinterpret_cast<char*>(a.keys);
      if (a.row_stride == W && a.word_stride == 1) {
        fill_bytes(keys, 4 * W * p0, 4 * W * p1, 0xFF);
      } else if (a.row_stride == 1) {
#pragma unroll
        for (int q = 0; q < W; ++q) {
          fill_bytes(keys + 4 * q * a.word_stride, 4 * p0, 4 * p1, 0xFF);
        }
      } else {
        for (int64_t p = p0 + tid; p < p1; p += kThreads) {
#pragma unroll
          for (int q = 0; q < W; ++q) a.keys[p * a.row_stride + q * a.word_stride] = kAll;
        }
      }
      fill_bytes(static_cast<char*>(a.counts), a.count_bytes * p0, a.count_bytes * p1, 0);
    }
  }
  // No barrier here: the next tile stages its rows only after its first
  // barrier, which every thread reaches once done with this tile's.
}

template <int W>
__global__ void __launch_bounds__(kThreads)
kept_write_kernel(const __grid_constant__ WriteArgs a) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  WriteShared<W>& sh = *reinterpret_cast<WriteShared<W>*>(shared_raw);
  if (a.hist != nullptr) {
    zero_bins(sh.bins);
    __syncthreads();
  }
  const int64_t kept_all = a.header[0];
  int tile = blockIdx.x;
  unsigned bits = load_bits(a, tile);
  uint32_t vals[W][kItems];
  int32_t c[kItems];
  load_kept<W>(a, tile, bits, vals, c);
  unsigned bits_ahead = load_bits(a, tile + static_cast<int>(gridDim.x));
  for (; tile < a.num_tiles; tile += gridDim.x) {
    write_tile<W>(a, sh, tile, bits, bits_ahead, vals, c, kept_all);
  }
  if (a.hist != nullptr) {
    __syncthreads();
    flush_bins(sh.bins, a.hist_upper, a.hist);
  }
}

template <int W>
cudaError_t launch_write(const WriteArgs& a, cudaStream_t s) {
  DeviceConfig* c = device_config();
  if (c == nullptr) return cudaErrorInvalidDevice;
  const int shared = static_cast<int>(sizeof(WriteShared<W>));
  const int per_sm = blocks_per_sm(c->write_blocks[W], kept_write_kernel<W>, shared);
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const int64_t resident = static_cast<int64_t>(c->sms.load(std::memory_order_relaxed)) * per_sm;
  const int blocks = static_cast<int>(a.num_tiles < resident ? a.num_tiles : resident);
  kept_write_kernel<W><<<blocks, kThreads, shared, s>>>(a);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// The runs gathered end to end.

constexpr int kGatherThreads = 256;
constexpr int kGatherVec = 4;    // adjacent outputs a thread takes at once
constexpr int kGatherSteps = 4;
constexpr int kGatherTile = kGatherThreads * kGatherVec * kGatherSteps;  // 4096
constexpr int kGatherStaged = 2048;  // runs a block stages
constexpr int kMaxArrays = 2;

struct GatherArgs {
  const int32_t* starts;   // (m,) each run's first source slot
  const int32_t* offsets;  // (m,) its first output slot, ascending
  int64_t m;
  int64_t total;
  const int32_t* src[kMaxArrays];
  int32_t* out[kMaxArrays];
  int n_arrays;
};

// The number of runs j in [0, m) with offsets[j] <= x, by one warp: each
// round, lane l tests the end of the l-th of 32 equal steps of [lo, hi),
// and the range shrinks to the step after the last that holds. Every lane
// returns it.
__device__ __forceinline__ int64_t runs_at_or_below(const int32_t* offsets, int64_t m,
                                                    int64_t x) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = m;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + step * lane;  // runs lo .. probe are <= x?
    const bool holds = probe < hi && __ldg(offsets + probe) <= x;
    const int c = __popc(__ballot_sync(kAll, holds));
    if (c == 0) return lo;
    const int64_t new_lo = lo + step * (c - 1) + 1;
    const int64_t new_hi = lo + step * c;
    lo = new_lo;
    hi = new_hi < hi ? new_hi : hi;
  }
  return lo;
}

// The tile's runs r = 0 .. count - 1 (run first + r): output offset
// relative to the tile, and source - offset.
struct StagedRuns {
  const int32_t* off;
  const int32_t* shift;
  __device__ __forceinline__ int32_t off_at(int r) const { return off[r]; }
  __device__ __forceinline__ int32_t shift_at(int r) const { return shift[r]; }
};

struct PlacedRuns {
  const int32_t* offsets;  // at the tile's first run
  const int32_t* starts;
  int64_t base;
  __device__ __forceinline__ int32_t off_at(int r) const {
    return static_cast<int32_t>(__ldg(offsets + r) - base);
  }
  __device__ __forceinline__ int32_t shift_at(int r) const {
    return __ldg(starts + r) - __ldg(offsets + r);
  }
};

// The last run r in [0, count) with off_at(r) <= x (off_at(0) <= x).
template <class Runs>
__device__ __forceinline__ int run_of(const Runs& runs, int count, int x) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (runs.off_at(mid) <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <class Runs>
__device__ __forceinline__ void gather_tile(const GatherArgs& a, const Runs& runs, int count,
                                            int64_t base, int tile_n) {
#pragma unroll 1
  for (int step = 0; step < kGatherSteps; ++step) {
    const int v = (step * kGatherThreads + threadIdx.x) * kGatherVec;
    if (v >= tile_n) break;
    int r = run_of(runs, count, v);
    int64_t src[kGatherVec];
    bool one_run = true;
#pragma unroll
    for (int u = 0; u < kGatherVec; ++u) {
      const int x = v + u;
      if (u > 0) {
        const int before = r;
        while (r + 1 < count && runs.off_at(r + 1) <= x) ++r;
        one_run = one_run && r == before;
      }
      src[u] = base + x + runs.shift_at(r);
    }
    const bool whole = v + kGatherVec <= tile_n;
#pragma unroll
    for (int k = 0; k < kMaxArrays; ++k) {
      if (k >= a.n_arrays) break;
      int4 vals;
      if (whole && one_run && reinterpret_cast<uintptr_t>(a.src[k] + src[0]) % 16 == 0) {
        vals = __ldg(reinterpret_cast<const int4*>(a.src[k] + src[0]));
      } else {
        vals.x = __ldg(a.src[k] + src[0]);
        vals.y = v + 1 < tile_n ? __ldg(a.src[k] + src[1]) : 0;
        vals.z = v + 2 < tile_n ? __ldg(a.src[k] + src[2]) : 0;
        vals.w = v + 3 < tile_n ? __ldg(a.src[k] + src[3]) : 0;
      }
      int32_t* out = a.out[k] + base + v;
      if (whole) {
        *reinterpret_cast<int4*>(out) = vals;
      } else {
        out[0] = vals.x;
        if (v + 1 < tile_n) out[1] = vals.y;
        if (v + 2 < tile_n) out[2] = vals.z;
      }
    }
  }
}

__global__ void __launch_bounds__(kGatherThreads)
gather_runs_kernel(const __grid_constant__ GatherArgs a) {
  __shared__ int64_t bounds[2];
  __shared__ int32_t s_off[kGatherStaged];
  __shared__ int32_t s_shift[kGatherStaged];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kGatherTile;
  const int64_t left = a.total - base;
  const int tile_n = left < kGatherTile ? static_cast<int>(left) : kGatherTile;
  // The tile's runs: from the last that starts at or before its first
  // output to the last that starts at or before its last output.
  if (warp < 2) {
    const int64_t x = warp == 0 ? base : base + tile_n - 1;
    const int64_t c = runs_at_or_below(a.offsets, a.m, x);
    if ((tid & 31) == 0) bounds[warp] = c;
  }
  __syncthreads();
  const int64_t first = bounds[0] - 1;
  const int count = static_cast<int>(bounds[1] - first);
  if (count <= kGatherStaged) {
    for (int r = tid; r < count; r += kGatherThreads) {
      const int32_t off = a.offsets[first + r];
      s_off[r] = static_cast<int32_t>(off - base);
      s_shift[r] = a.starts[first + r] - off;
    }
    __syncthreads();
    gather_tile(a, StagedRuns{s_off, s_shift}, count, base, tile_n);
  } else {
    gather_tile(a, PlacedRuns{a.offsets + first, a.starts + first, base}, count, base, tile_n);
  }
}

}  // namespace

// The tiles and shared bins of kept_rows, the slots a count block covers
// (its look-back's unit) and the count blocks its look-back reads at a
// time, and the output tile and staged runs of gather_runs, which
// testing.kept_rows_cases and gather_runs_cases size their cases by.
extern "C" void hk_kept_rows_geometry(int* tile, int* shared_bins, int* group, int* window,
                                      int* gather_tile, int* gather_staged) {
  *tile = kTile;
  *shared_bins = kSharedBins;
  *group = kCountTile;
  *window = lookback::kWindow;
  *gather_tile = kGatherTile;
  *gather_staged = kGatherStaged;
}

// Bytes of the scratch and of the keep mask of a compaction of n slots.
extern "C" int64_t hk_kept_rows_scratch(int64_t n) { return scratch_bytes_of(n); }

extern "C" int64_t hk_kept_mask_bytes(int64_t n) { return mask_bytes_of(n); }

// keep: (n,) bool; cnt: (n,) int32 counts where the kept runs' occurrences
// are to be summed, else null; head: (2 + hist_upper + 1) int64 (2 where
// hist_upper < 0). Clears the head and the scratch's look-back, writes the
// keep mask (hk_kept_mask_bytes), the header (head[0:2]: the kept rows and
// their occurrences in all, the occurrences 0 without cnt) and the tiles'
// prefixes; where `host` (2 int64) is given, waits for the stream and
// copies the header there. 0 <= n < 2^31; the occurrences below 2^31.
extern "C" int hk_kept_count(const void* keep, const void* cnt, int64_t n, void* head,
                             int hist_upper, void* scratch, void* mask, void* stream,
                             int64_t* host) {
  if (n < 0 || n >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(head, 0, static_cast<size_t>(head_bytes_of(hist_upper)), s);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(look_bytes_of(n)), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = tiles_of(n);
  const int64_t groups = groups_of(tiles);
  char* base = static_cast<char*>(scratch);
  kept_count_kernel<<<static_cast<unsigned>(groups), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(keep), static_cast<const int32_t*>(cnt), n,
      static_cast<int>(tiles), static_cast<int>(groups),
      reinterpret_cast<uintptr_t>(keep) % 16 == 0, reinterpret_cast<uintptr_t>(cnt) % 16 == 0,
      lookback::carve<uint64_t>(base), reinterpret_cast<int2*>(base + look_bytes_of(n)),
      static_cast<uint32_t*>(mask), static_cast<int64_t*>(head));
  err = cudaGetLastError();
  if (err != cudaSuccess || host == nullptr) return static_cast<int>(err);
  err = cudaMemcpyAsync(host, head, 16, cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return static_cast<int>(err);
}

// After hk_kept_count on the same n, head, scratch and mask (hist_upper as
// there): the kept rows of words (w_count device pointers to (n,) 32-bit
// rows) and cnt, in slot order. keys: word q of output row p at keys[p *
// row_stride + q * word_stride]; counts: count_bytes (1, 2, 4) each, cast
// from int32; rows [m, length) get -1 words and 0 counts, m the header's
// rows (length <= n). slots, offsets ((m,) int32: each kept slot, each kept
// run's first occurrence; offsets needs the header's occurrences) may be
// null. round_consts / fix (rounds * W and W host values): the keys are
// unmixed (mixkey.cuh), or null. hist_upper >= 0: head[2:] gets the
// histogram of the kept counts (a count above hist_upper dropped).
extern "C" int hk_kept_write(const void* mask, void* const* words, int w_count,
                             const void* cnt, int64_t n, void* head, void* scratch, void* keys,
                             int64_t row_stride, int64_t word_stride, int64_t length,
                             void* counts, int count_bytes, void* slots, void* offsets,
                             const uint32_t* round_consts, int rounds, const uint32_t* fix,
                             int hist_upper, void* stream) {
  if (n < 0 || n >= (int64_t{1} << 31) || w_count < 1 || w_count > kMaxWords ||
      (count_bytes != 1 && count_bytes != 2 && count_bytes != 4) || length < 0 ||
      length > n || (round_consts != nullptr && (rounds < 1 || rounds > mixkey::kMaxRounds))) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  int64_t* header = static_cast<int64_t*>(head);
  WriteArgs a{};
  a.mask = static_cast<const uint8_t*>(mask);
  for (int q = 0; q < w_count; ++q) a.words[q] = static_cast<const uint32_t*>(words[q]);
  a.cnt = static_cast<const int32_t*>(cnt);
  a.n = n;
  a.num_tiles = static_cast<int>(tiles_of(n));
  a.before = reinterpret_cast<const int2*>(static_cast<char*>(scratch) + look_bytes_of(n));
  a.header = header;
  a.keys = static_cast<uint32_t*>(keys);
  a.row_stride = row_stride;
  a.word_stride = word_stride;
  a.length = length;
  a.counts = counts;
  a.count_bytes = count_bytes;
  a.slots = static_cast<int32_t*>(slots);
  a.offsets = static_cast<int32_t*>(offsets);
  a.mixed = round_consts != nullptr;
  if (a.mixed) a.mix = mixkey::make_consts(round_consts, rounds, fix, w_count);
  a.hist = hist_upper >= 0 ? reinterpret_cast<unsigned long long*>(header + 2) : nullptr;
  a.hist_upper = static_cast<uint32_t>(hist_upper);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  switch (w_count) {
    case 1: err = launch_write<1>(a, s); break;
    case 2: err = launch_write<2>(a, s); break;
    case 3: err = launch_write<3>(a, s); break;
    case 4: err = launch_write<4>(a, s); break;
    case 5: err = launch_write<5>(a, s); break;
    case 6: err = launch_write<6>(a, s); break;
  }
  return static_cast<int>(err);
}

// counts: (n,) int32; hist: (hist_upper + 1,) int64, zeroed here and filled
// with the histogram of every count (a count above hist_upper dropped).
extern "C" int hk_count_histogram(const void* counts, int64_t n, void* hist, int hist_upper,
                                  void* stream) {
  if (n < 0 || hist_upper < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, (static_cast<size_t>(hist_upper) + 1) * 8, s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  DeviceConfig* c = device_config();
  if (c == nullptr) return cudaErrorInvalidDevice;
  const int per_sm = blocks_per_sm(c->hist_blocks, count_hist_kernel, 0);
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const int64_t cap = static_cast<int64_t>(c->sms.load(std::memory_order_relaxed)) * per_sm;
  const int64_t blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  count_hist_kernel<<<static_cast<unsigned>(blocks < cap ? blocks : cap), kThreads, 0, s>>>(
      static_cast<const int32_t*>(counts), n, reinterpret_cast<uintptr_t>(counts) % 16 == 0,
      static_cast<uint32_t>(hist_upper), static_cast<unsigned long long*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// starts, offsets: (m,) int32, run j's first source slot and its first
// output slot (the exclusive prefix of the run lengths, so offsets[0] = 0),
// total = the lengths' sum, 0 < total < 2^31; src / out: n_arrays (1 or 2)
// device pointers to int32 rows, the outputs (total,) and 16-byte aligned.
extern "C" int hk_gather_runs(const void* starts, const void* offsets, int64_t m,
                              int64_t total, void* const* src, void* const* out,
                              int n_arrays, void* stream) {
  if (m < 1 || total < 1 || total >= (int64_t{1} << 31) || n_arrays < 1 ||
      n_arrays > kMaxArrays) {
    return cudaErrorInvalidValue;
  }
  GatherArgs a{};
  a.starts = static_cast<const int32_t*>(starts);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.m = m;
  a.total = total;
  for (int k = 0; k < n_arrays; ++k) {
    a.src[k] = static_cast<const int32_t*>(src[k]);
    a.out[k] = static_cast<int32_t*>(out[k]);
    if (reinterpret_cast<uintptr_t>(out[k]) % 16 != 0) return cudaErrorInvalidValue;
  }
  a.n_arrays = n_arrays;
  const int64_t blocks = (total + kGatherTile - 1) / kGatherTile;
  gather_runs_kernel<<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
