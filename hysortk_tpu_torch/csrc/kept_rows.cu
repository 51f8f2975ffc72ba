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
//             ticket, so every block it waits on is running or done. Each
//             thread reads 16 keep bytes at a time in one 16-byte load where
//             it can, and counts them (and, for the occurrence offsets, adds
//             the kept slots' counts). The block's (rows, occurrences) are
//             carried across the blocks by a decoupled look-back to the
//             left on one 64-bit descriptor a block (lookback.cuh's
//             walk_left_pairs); it leaves each of its write tiles'
//             exclusive prefixes for the write launch, and the last block
//             writes the totals to the header, which the wrapper reads once
//             on the host (the one sync torch.nonzero paid), or not at all
//             in the mode that does not sync.
// kept_write  Blocks walk the tiles, the next tile's keep bytes loaded while
//             this one is written. A thread takes kItems adjacent slots (one
//             8-byte load of keep); a warp scan of their kept counts gives
//             each kept slot its rank among the tile's, in slot order. The
//             kept slots' key words, count and slot go to shared memory at
//             their ranks (a dropped slot's words are never read; a row's
//             loads issued together). Then a thread a kept row unmixes it in
//             place (mixkey.cuh) and bins its count, a warp's equal counts
//             with one atomic (match.any), in shared bins below kSharedBins
//             and straight into the int64 histogram above them; the block
//             writes the rows out contiguously: (m, W) row-major or W rows of the
//             output length, counts as uint8 / uint16 / int32, the slots,
//             and the runs' occurrence offsets by a block scan of the
//             counts. Where the output is longer than the kept rows, each
//             tile writes its share of the sentinel tail (-1 words, 0
//             counts), so every output slot is written once and nothing is
//             cleared beforehand. Shared bins are added to the histogram
//             once a block.
// count_hist  The histogram alone of a row of counts (every row kept, none
//             written): the same warp-aggregated bins, coalesced loads.
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
// B of keys, the narrowed count, the slot and offset where asked). The
// unmix is 2 x W fmix32 inversions a kept row. gather_runs reads and writes
// each occurrence's words once and each run's start and offset once.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "mixkey.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;  // 2048 slots
constexpr int kMaxWords = mixkey::kMaxWords;
constexpr int kSharedBins = 1024;
// The count launch: a block kGroup write tiles, a thread kChunks 16-byte
// chunks of keep.
constexpr int kGroup = 16;
constexpr int kCountTile = kGroup * kTile;
constexpr int kChunks = kCountTile / 16 / kThreads;
static_assert(kChunks * kThreads * 16 == kCountTile && kTile / 16 == kThreads / 2,
              "a write tile is the half-block's chunks of one chunk row");
constexpr unsigned kAll = 0xFFFFFFFFu;

// --------------------------------------------------------------------------
// The scratch of the two launches: the count's look-back (lookback.cuh: the
// ticket, a block's (rows, occurrences) as a pair), then each write tile's
// exclusive (rows, occurrences), which the write launch reads.

inline int64_t tiles_of(int64_t n) { return n > 0 ? (n + kTile - 1) / kTile : 1; }

inline int64_t groups_of(int64_t tiles) { return (tiles + kGroup - 1) / kGroup; }

inline int64_t zeroed_bytes(int64_t tiles) {
  return lookback::scratch_bytes<uint64_t>(groups_of(tiles));
}

inline int64_t scratch_bytes_for(int64_t n) {
  const int64_t tiles = tiles_of(n);
  return zeroed_bytes(tiles) + 8 * tiles;
}

inline int2* tile_prefixes(void* scratch, int64_t tiles) {
  return reinterpret_cast<int2*>(static_cast<char*>(scratch) + zeroed_bytes(tiles));
}

__global__ void __launch_bounds__(kThreads)
kept_count_kernel(const uint8_t* __restrict__ keep, const int32_t* __restrict__ cnt,
                  int64_t n, int num_tiles, int num_groups, bool aligned,
                  lookback::Scratch<uint64_t> sc, int2* __restrict__ before,
                  int64_t* __restrict__ header) {
  __shared__ int group_s;
  __shared__ unsigned sums[2][kWarps][kChunks];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) group_s = lookback::take_tile_left(sc.ticket);
  __syncthreads();
  const int group = group_s;
  const int64_t group_base = static_cast<int64_t>(group) * kCountTile;
  // Chunk k of this thread, 16 slots, lies in write tile 2 k + (tid >= 128).
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int64_t first = group_base + 16 * (tid + static_cast<int64_t>(kThreads) * k);
    unsigned rows = 0, occ = 0;
    if (aligned && first + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(keep + first);
      rows = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);  // bytes 0 or 1
      if (cnt != nullptr && rows != 0) {
        const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if ((words[j >> 2] >> (8 * (j & 3))) & 0xFFu) {
            occ += static_cast<unsigned>(cnt[first + j]);
          }
        }
      }
    } else {
      for (int j = 0; j < 16 && first + j < n; ++j) {
        if (keep[first + j]) {
          ++rows;
          if (cnt != nullptr) occ += static_cast<unsigned>(cnt[first + j]);
        }
      }
    }
    rows = __reduce_add_sync(kAll, rows);
    occ = __reduce_add_sync(kAll, occ);
    if (lane == 0) {
      sums[0][warp][k] = rows;
      sums[1][warp][k] = occ;
    }
  }
  __syncthreads();
  // Thread g < kGroup: write tile g's (rows, occurrences), from the four
  // warps that read its half of each chunk row; then their exclusive scan
  // over the group by warp 0.
  unsigned rows = 0, occ = 0;
  if (tid < kGroup) {
    const int k = tid >> 1, h = tid & 1;
#pragma unroll
    for (int w = 0; w < kWarps / 2; ++w) {
      rows += sums[0][(kWarps / 2) * h + w][k];
      occ += sums[1][(kWarps / 2) * h + w][k];
    }
  }
  if (tid < 32) {
    unsigned incl_rows = rows, incl_occ = occ;
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
                               static_cast<int>(left.y + incl_occ - occ));
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

__global__ void __launch_bounds__(kThreads)
count_hist_kernel(const int32_t* __restrict__ counts, int64_t n, uint32_t upper,
                  unsigned long long* __restrict__ hist) {
  __shared__ unsigned bins[kSharedBins];
  zero_bins(bins);
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTile;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTile; base < n; base += stride) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = base + j * kThreads + threadIdx.x;
      const bool in = i < n;
      bin_count(in, in ? static_cast<uint32_t>(counts[i]) : 0u, upper, bins, hist);
    }
  }
  __syncthreads();
  flush_bins(bins, upper, hist);
}

// --------------------------------------------------------------------------
// The write launch.

struct WriteArgs {
  const uint8_t* keep;
  bool keep_aligned;      // keep at an 8-byte boundary
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

// Slot first + j of the keep row kept, as bit j, for a thread's kItems
// slots: one 8-byte load where they are whole and aligned.
__device__ __forceinline__ unsigned keep_bits(const WriteArgs& a, int64_t first) {
  unsigned bits = 0;
  if (a.keep_aligned && first + kItems <= a.n) {
    const uint2 v = *reinterpret_cast<const uint2*>(a.keep + first);
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bool bytes are 0 or 1
      bits |= ((v.x >> (7 * i)) & (1u << i)) | (((v.y << 4) >> (7 * i)) & (16u << i));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (first + j < a.n && a.keep[first + j]) bits |= 1u << j;
    }
  }
  return bits;
}

// One tile: `bits` its kept slots (keep_bits); returns those of the tile
// gridDim.x further on, loaded while this one is written.
template <int W>
__device__ __forceinline__ unsigned write_tile(const WriteArgs& a, WriteShared<W>& sh,
                                               int tile, unsigned bits, int64_t kept_all) {
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
  const int next_tile = tile + static_cast<int>(gridDim.x);
  const unsigned next = next_tile < a.num_tiles
                            ? keep_bits(a, static_cast<int64_t>(next_tile) * kTile + tid * kItems)
                            : 0u;
  __syncthreads();
  int rank = static_cast<int>(incl - mine), tile_kept = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = static_cast<int>(sh.warp_kept[w]);
    rank += w < warp ? c : 0;
    tile_kept += c;
  }
  const int2 before = a.before[tile];

  // The kept slots' words, counts and slots to shared memory at their
  // ranks; only the kept slots are read, all of a row's loads at once.
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const uint32_t* __restrict__ src = a.words[q] + first;
    uint32_t vals[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) vals[j] = (bits >> j) & 1u ? src[j] : 0u;
    int r = rank;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if ((bits >> j) & 1u) sh.key[q][r++] = vals[j];
    }
  }
  {
    const int32_t* __restrict__ src = a.cnt + first;
    int32_t vals[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) vals[j] = (bits >> j) & 1u ? src[j] : 0;
    int r = rank;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if ((bits >> j) & 1u) {
        sh.cnt[r] = vals[j];
        sh.slot[r++] = static_cast<int32_t>(first + j);
      }
    }
  }
  __syncthreads();

  // Unmixed in place and binned, a kept row a thread (every lane takes
  // part in a round, for the warp's match).
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
    __syncthreads();
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
    // among all dropped slots, as far as the output reaches.
    const int64_t tail0 = kept_all + (tile_base - before.x);
    for (int x = tid; x < tile_n - tile_kept; x += kThreads) {
      const int64_t p = tail0 + x;
      if (p >= a.length) break;
#pragma unroll
      for (int q = 0; q < W; ++q) a.keys[p * a.row_stride + q * a.word_stride] = kAll;
      store_count(a.counts, a.count_bytes, p, 0);
    }
  }
  __syncthreads();  // the buffers are free for the next tile
  return next;
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
  unsigned bits = tile < a.num_tiles
                      ? keep_bits(a, static_cast<int64_t>(tile) * kTile + threadIdx.x * kItems)
                      : 0u;
  for (; tile < a.num_tiles; tile += gridDim.x) bits = write_tile<W>(a, sh, tile, bits, kept_all);
  if (a.hist != nullptr) flush_bins(sh.bins, a.hist_upper, a.hist);
}

template <int W>
cudaError_t launch_write(const WriteArgs& a, cudaStream_t s) {
  const int shared = static_cast<int>(sizeof(WriteShared<W>));
  cudaError_t err = cudaFuncSetAttribute(kept_write_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kept_write_kernel<W>, kThreads,
                                                      shared);
  if (err != cudaSuccess) return err;
  const int64_t resident = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
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

// The tiles and shared bins of kept_rows and the output tile and staged
// runs of gather_runs, which testing.kept_rows_cases and gather_runs_cases
// size their cases by.
extern "C" void hk_kept_rows_geometry(int* tile, int* shared_bins, int* gather_tile,
                                      int* gather_staged) {
  *tile = kTile;
  *shared_bins = kSharedBins;
  *gather_tile = kGatherTile;
  *gather_staged = kGatherStaged;
}

// Bytes of scratch for hk_kept_count and hk_kept_write on n slots (no
// initial contents).
extern "C" int64_t hk_kept_rows_scratch(int64_t n) { return scratch_bytes_for(n); }

// keep: (n,) bool; cnt: (n,) int32 counts where the kept runs' occurrences
// are to be summed, else null. Writes header (2,) int64: the kept rows and
// their occurrences in all (the occurrences 0 without cnt), and the tiles'
// prefixes into scratch. 0 <= n < 2^31; the occurrences below 2^31.
extern "C" int hk_kept_count(const void* keep, const void* cnt, int64_t n, void* scratch,
                             void* header, void* stream) {
  if (n < 0 || n >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const int64_t tiles = tiles_of(n);
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t groups = groups_of(tiles);
  cudaError_t err = lookback::reset<uint64_t>(scratch, groups, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = reinterpret_cast<uintptr_t>(keep) % 16 == 0;
  kept_count_kernel<<<static_cast<unsigned>(groups), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(keep), static_cast<const int32_t*>(cnt), n,
      static_cast<int>(tiles), static_cast<int>(groups), aligned,
      lookback::carve<uint64_t>(scratch), tile_prefixes(scratch, tiles),
      static_cast<int64_t*>(header));
  return static_cast<int>(cudaGetLastError());
}

// After hk_kept_count on the same keep, n and scratch (and its header):
// the kept rows of words (w_count device pointers to (n,) 32-bit rows) and
// cnt, in slot order. keys: word q of output row p at keys[p * row_stride +
// q * word_stride]; counts: count_bytes (1, 2, 4) each, cast from int32;
// rows [m, length) get -1 words and 0 counts, m the header's rows (length
// <= n). slots, offsets ((m,) int32: each kept slot, each kept run's first
// occurrence; offsets needs the header's occurrences) may be null.
// round_consts / fix (rounds * W and W host values): the keys are unmixed
// (mixkey.cuh), or null. hist: (hist_upper + 1,) int64 zeroed here and
// filled with the histogram of the kept counts (a count above hist_upper is
// dropped), or null.
extern "C" int hk_kept_write(const void* keep, void* const* words, int w_count,
                             const void* cnt, int64_t n, const void* scratch,
                             const void* header, void* keys, int64_t row_stride,
                             int64_t word_stride, int64_t length, void* counts,
                             int count_bytes, void* slots, void* offsets,
                             const uint32_t* round_consts, int rounds, const uint32_t* fix,
                             void* hist, int hist_upper, void* stream) {
  if (n < 0 || n >= (int64_t{1} << 31) || w_count < 1 || w_count > kMaxWords ||
      (count_bytes != 1 && count_bytes != 2 && count_bytes != 4) || length < 0 ||
      length > n || (hist != nullptr && hist_upper < 0) ||
      (round_consts != nullptr && (rounds < 1 || rounds > mixkey::kMaxRounds))) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (hist != nullptr) {
    cudaError_t err = cudaMemsetAsync(hist, 0, (static_cast<size_t>(hist_upper) + 1) * 8, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int64_t tiles = tiles_of(n);
  WriteArgs a{};
  a.keep = static_cast<const uint8_t*>(keep);
  a.keep_aligned = reinterpret_cast<uintptr_t>(keep) % 8 == 0;
  for (int q = 0; q < w_count; ++q) a.words[q] = static_cast<const uint32_t*>(words[q]);
  a.cnt = static_cast<const int32_t*>(cnt);
  a.n = n;
  a.num_tiles = static_cast<int>(tiles);
  a.before = tile_prefixes(const_cast<void*>(scratch), tiles);
  a.header = static_cast<const int64_t*>(header);
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
  a.hist = static_cast<unsigned long long*>(hist);
  a.hist_upper = static_cast<uint32_t>(hist_upper);
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
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * 8;
  count_hist_kernel<<<static_cast<unsigned>(tiles < cap ? tiles : cap), kThreads, 0, s>>>(
      static_cast<const int32_t*>(counts), n, static_cast<uint32_t>(hist_upper),
      static_cast<unsigned long long*>(hist));
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
