// The supermer runs written as the segment layout: from the validity of
// each k-mer start, its minimizer bucket and the bucket -> rank table, every
// run of the supermer wire with its first base, its offset in its
// destination's segment and its length, grouped by destination rank (flat
// order within a destination), with the destinations' run bounds and the
// largest base and run counts of any destination.
//
// No TPU kernel: the JAX package finds the runs on the host
// (hysortk_tpu/io/supermer.py run_boundaries, the reference's
// SupermerEncoder boundary rule, src/kmerops.cpp:1096-1148) and lays them
// out per destination there (encode_supermer_streams); the port's plain
// composition is ops/supermer.segment_layout(*run_table_plain(valid,
// assign[dest], max_kmers), k, num_dest). Same rule: over the valid k-mer
// starts, with r = assign[dest] the destination rank, a run starts
//   * at the first valid position;
//   * where the position before is not valid (a gap or a read boundary);
//   * where the destination rank changes;
//   * every max_kmers k-mers from the start of the uncapped stretch (a run
//     of R k-mers spans R + k - 1 bases, capped at MAX_SUPERMER_LEN).
// A *segment* is a maximal stretch of valid positions of one rank; its
// first position is a *head*. A run starts at p iff p is valid and (p - the
// last head at or before p) % max_kmers == 0, and ends at p iff p is valid
// and the next position is not valid, has another rank, or starts a capped
// run. A run's offset in its destination's segment is the bases of the
// destination's earlier runs: j (k - 1) + V for the destination's j-th run,
// V its valid positions before the run.
//
// What held the first kernel back (a run table in flat order, then torch
// ops): three launches, the middle one a single block walking all 16,384
// tile summaries on one SM, a host read of the run count between them, then
// a 512 MiB int64 gather of the destination ranks before it and a stable
// sort, bincounts, cumsums and a second host read after it. Here:
//   * the bucket -> rank table is staged in shared memory (up to
//     kSharedBuckets buckets; read from device memory past that) and the
//     rank is looked up as a thread loads its 16 positions (16-byte loads,
//     all of a tile's in flight at once; staging a tile position by
//     position waited on device memory 16 times a thread, ~20 us a tile):
//     no destination-rank array;
//   * two launches over tiles of 256 threads x 16 consecutive positions.
//     The count: each tile's run starts and valid positions per rank
//     (shared atomics, aggregated per thread and per warp), its carried
//     head by a decoupled look-back on one word a tile (lookback.cuh, the
//     tiles in ticket order from the left), then its per-rank counts
//     combined across tiles by a second decoupled look-back on 2 x num_dest
//     words a tile (aggregate, then inclusive, with fences; one warp reads
//     256 tiles' flags at a time and, up to 16 destinations, sums their
//     vectors itself with no barrier of the block); the last tile
//     turns the totals into the destinations' run bounds and the (runs,
//     cmax, smax) record, which the host reads once (the segment dims'
//     all-reduce needs it anyway);
//   * the write: each tile compacts its run starts in flat order (entry 0
//     the run continued from the left), each run end records its length
//     within the tile, then one warp takes the entries 32 at a time and
//     gives each its index and offset in its destination from per-rank
//     counters (match_any groups, popcounts, a shuffle sum), writing the
//     layout's rows destination-major.
//
// Bound on the H100: HBM bytes, 5 B a position in (valid + int32 bucket;
// both launches read them, the bound counts once) and 20 B a run out
// (int64 source, int64 offset, int32 length): 0.10 ms at 2^26 positions.
// Measured there (tools/bench_torch_scan_layout.py, one destination): the
// count launch 0.42 ms, the write 0.23 ms: neither reads at its byte rate;
// each tile's chain of dependent loads, barriers and fences (two
// look-backs in the count) is what a tile waits on.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxDest = 8192;
constexpr int kReach = 8;  // rounds of 32 tiles a look-back window reads at once
constexpr int kSharedBuckets = 8192;
constexpr unsigned kFull = 0xFFFFFFFFu;
// A write entry packs its start in the tile (13 bits), its valid positions
// in the tile (13 bits) and whether its run ends in the tile.
constexpr int kLenShift = 13;
constexpr int kStartMask = (1 << kLenShift) - 1;
constexpr int kEnded = 1 << 26;

struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};

template <typename Op>
__device__ __forceinline__ int warp_inclusive(int x, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = op(x, y);
  }
  return x;
}

// Exclusive scan of one int a thread, in thread order, over the block;
// *total receives the block's aggregate. `scratch` holds kWarps ints of
// shared memory. Every thread of the block calls it.
template <typename Op>
__device__ int block_exclusive(int x, int identity, Op op, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_inclusive(x, op);
  const int left = __shfl_up_sync(kFull, incl, 1);
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? scratch[lane] : identity;
    w = warp_inclusive(w, op);
    if (lane < kWarps) scratch[lane] = w;
  }
  __syncthreads();
  const int before = warp == 0 ? identity : scratch[warp - 1];
  const int excl = op(before, lane == 0 ? identity : left);
  *total = scratch[kWarps - 1];
  __syncthreads();
  return excl;
}

// The block's largest int64 (thread 0 receives it).
__device__ long long block_max64(long long x, long long* scratch) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_down_sync(kFull, x, o);
    x = x > y ? x : y;
  }
  if (lane == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) x = x > scratch[w] ? x : scratch[w];
  }
  __syncthreads();
  return x;
}

struct TileShared {
  int scratch[kWarps];
  long long scratch64[kWarps];
  int tile;
  int carry;
  int window_taken;  // the count look-back's window: the tiles it adds
  bool window_incl;  // and whether the last of them is inclusive
};

// The bucket -> rank table: in shared memory when staged, else as given.
__device__ __forceinline__ const int32_t* stage_table(const int32_t* assign, int buckets,
                                                      bool staged, int32_t* room) {
  if (!staged) return assign;
  for (int b = threadIdx.x; b < buckets; b += kThreads) room[b] = assign[b];
  __syncthreads();
  return room;
}

// A thread's 16 consecutive positions (v, r: the rank where valid, else 0)
// and the neighbours on either side.
struct Items {
  bool v[kItems];
  int r[kItems];
  bool v_prev, v_next;
  int r_prev, r_next;
};

// One position's validity and rank; the loads do not wait on each other.
__device__ __forceinline__ void load_position(const uint8_t* valid, const int32_t* dest,
                                              const int32_t* table, int64_t n, int64_t p,
                                              bool& v, int& r) {
  const bool in = p >= 0 && p < n;
  const uint8_t b = in ? valid[p] : 0;
  const int32_t d = in ? dest[p] : 0;
  v = b != 0;
  r = v ? table[d] : 0;
}

// The thread's items straight from device memory: one 16-byte load of the
// validity and four of the buckets where aligned and in range (a tile's
// loads all in flight at once), then the ranks from the table.
__device__ __forceinline__ Items load_items(const uint8_t* valid, const int32_t* dest,
                                            const int32_t* table, int64_t n, int64_t p0) {
  Items it;
  uint32_t vw[4] = {0, 0, 0, 0};
  int32_t d[kItems];
  const bool vector =
      p0 + kItems <= n &&
      ((reinterpret_cast<uintptr_t>(valid) | reinterpret_cast<uintptr_t>(dest)) & 15u) == 0;
  if (vector) {
    const uint4 v = *reinterpret_cast<const uint4*>(valid + p0);
    vw[0] = v.x;
    vw[1] = v.y;
    vw[2] = v.z;
    vw[3] = v.w;
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 x = reinterpret_cast<const int4*>(dest + p0)[q];
      d[4 * q] = x.x;
      d[4 * q + 1] = x.y;
      d[4 * q + 2] = x.z;
      d[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = p0 + j < n;
      vw[j >> 2] |= static_cast<uint32_t>(in ? valid[p0 + j] : 0) << (8 * (j & 3));
      d[j] = in ? dest[p0 + j] : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    it.v[j] = ((vw[j >> 2] >> (8 * (j & 3))) & 0xFFu) != 0;
    it.r[j] = it.v[j] ? table[d[j]] : 0;
  }
  load_position(valid, dest, table, n, p0 - 1, it.v_prev, it.r_prev);
  load_position(valid, dest, table, n, p0 + kItems, it.v_next, it.r_next);
  return it;
}

__device__ __forceinline__ bool head_at(const Items& it, int j) {
  const bool vp = j == 0 ? it.v_prev : it.v[j > 0 ? j - 1 : 0];
  const int rp = j == 0 ? it.r_prev : it.r[j > 0 ? j - 1 : 0];
  return it.v[j] && (!vp || rp != it.r[j]);
}

// The thread's heads, bit j for position p0 + j.
__device__ __forceinline__ unsigned head_bits(const Items& it) {
  unsigned heads = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) heads |= static_cast<unsigned>(head_at(it, j)) << j;
  return heads;
}

// The last of those heads, or -1.
__device__ __forceinline__ int last_head(unsigned heads, int p0) {
  return heads ? p0 + 31 - __clz(heads) : -1;
}

// The thread's run starts and run ends, bit j for position p0 + j, from
// seg0, the last head before p0 (or -1: then p0 starts whatever is valid).
// A valid position's place in its capped run, (p - its segment's head) mod
// max_kmers, is stepped position by position from one modulo a thread
// (the next valid position after a gap is a head); *pre receives it at p0
// - 1, so a run that crosses into the strip started at p0 - 1 - *pre.
struct RunMarks {
  unsigned starts, ends;
  int pre;
};

__device__ __forceinline__ RunMarks run_marks(const Items& it, unsigned heads, int seg0,
                                              int p0, int max_kmers) {
  RunMarks m;
  m.pre = seg0 >= 0 ? (p0 - 1 - seg0) % max_kmers : max_kmers - 1;
  m.starts = m.ends = 0;
  int at = m.pre;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (!it.v[j]) continue;
    at = (heads >> j) & 1u || at + 1 == max_kmers ? 0 : at + 1;
    const bool v_next = j == kItems - 1 ? it.v_next : it.v[j < kItems - 1 ? j + 1 : 0];
    const int r_next = j == kItems - 1 ? it.r_next : it.r[j < kItems - 1 ? j + 1 : 0];
    m.starts |= static_cast<unsigned>(at == 0) << j;
    m.ends |= static_cast<unsigned>(!v_next || r_next != it.r[j] || at == max_kmers - 1) << j;
  }
  return m;
}

__host__ __device__ inline int num_tiles(int64_t n) {
  return static_cast<int>((n + kTile - 1) / kTile);
}

// Scratch: the ticket, the head look-back's descriptors (lookback.cuh), the
// count look-back's flags, each tile's carried head, then each tile's
// aggregate and inclusive per-rank counts (runs of rank s at [s], valid
// positions at [num_dest + s]). The ticket, the descriptors and the flags
// are zeroed per call.
struct Scratch {
  unsigned* ticket;
  unsigned* head_desc;
  unsigned* flag;
  int* carry;
  int* agg;
  int* incl;
};

inline int64_t zeroed_bytes(int tiles) {
  return lookback::kDescOffset + 2 * static_cast<int64_t>(tiles) * sizeof(unsigned);
}

inline Scratch carve(void* base, int tiles, int num_dest) {
  char* p = static_cast<char*>(base);
  Scratch s;
  s.ticket = reinterpret_cast<unsigned*>(p);
  s.head_desc = reinterpret_cast<unsigned*>(p + lookback::kDescOffset);
  s.flag = s.head_desc + tiles;
  s.carry = reinterpret_cast<int*>(s.flag + tiles);
  s.agg = s.carry + tiles;
  s.incl = s.agg + static_cast<int64_t>(tiles) * 2 * num_dest;
  return s;
}

__device__ __forceinline__ int load_cg(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// Warp 0 of a tile's count look-back, one window back from tile hi: the
// flags of tiles hi, hi - 1, ..., hi - 32 kReach + 1 (lane l, round u: tile
// hi - l - 32u), all in flight at once, read again until every tile before
// the nearest inclusive one has published. *found receives how many tiles
// to add (up to and with that inclusive one); returns whether there was
// one. Tile 0 is inclusive, so no tile before it is ever taken. All 32
// lanes call it; every lane returns the same.
__device__ __forceinline__ bool count_window(const unsigned* flags, int hi, int* found) {
  const int lane = threadIdx.x & 31;
  bool hit, pending;
  do {
    unsigned f[kReach];
#pragma unroll
    for (int u = 0; u < kReach; ++u) {
      const int j = hi - lane - 32 * u;
      f[u] = j >= 0 ? *reinterpret_cast<const volatile unsigned*>(flags + j) : 2u;
    }
    *found = 32 * kReach;
    hit = pending = false;
#pragma unroll
    for (int u = 0; u < kReach; ++u) {
      const unsigned inclusive = __ballot_sync(kFull, f[u] == 2u);
      unsigned waiting = __ballot_sync(kFull, f[u] == 0u);
      if (!hit) {
        const unsigned lowest = inclusive & (0u - inclusive);
        waiting &= inclusive ? lowest - 1u : kFull;
        pending = pending || waiting != 0;
        if (inclusive) {
          *found = 32 * u + __popc(lowest - 1u) + 1;
          hit = true;
        }
      }
    }
  } while (pending);
  return hit;
}

__global__ void __launch_bounds__(kThreads, 4)
layout_count(const uint8_t* valid, const int32_t* dest, const int32_t* assign, int buckets,
             bool staged, int64_t n, int max_kmers, int k, int num_dest, Scratch sc,
             int64_t* dest_begin, int64_t* info) {
  __shared__ TileShared s;
  extern __shared__ int dyn[];
  int* bins = dyn;                   // 2 num_dest: this tile's counts
  int* excl = bins + 2 * num_dest;   // 2 num_dest: the tiles' before it
  int32_t* room = excl + 2 * num_dest;
  const int tiles = num_tiles(n);
  const int width = 2 * num_dest;

  if (threadIdx.x == 0) s.tile = static_cast<int>(atomicAdd(sc.ticket, 1u));
  for (int i = threadIdx.x; i < width; i += kThreads) bins[i] = excl[i] = 0;
  __syncthreads();
  const int t = s.tile;
  const int64_t begin = static_cast<int64_t>(t) * kTile;
  const int32_t* table = stage_table(assign, buckets, staged, room);
  const int p0 = static_cast<int>(begin) + threadIdx.x * kItems;
  const Items it = load_items(valid, dest, table, n, p0);
  int head_total;
  const unsigned heads = head_bits(it);
  int seg = block_exclusive(last_head(heads, p0), -1, Max(), s.scratch, &head_total);

  // The head carried in from the left: the tiles in reversed index order
  // for lookback.cuh's right-to-left walk, a value head + 1 (0: none).
  if (threadIdx.x < 32) {
    const int q = tiles - 1 - t;
    if (threadIdx.x == 0) {
      if (head_total >= 0) {
        lookback::publish_value(sc.head_desc, q, static_cast<unsigned>(head_total) + 1u);
      } else {
        lookback::publish_none(sc.head_desc, q);
      }
    }
    __syncwarp();
    const unsigned carried = lookback::walk_right(sc.head_desc, q, tiles, 0u);
    if (threadIdx.x == 0) {
      if (head_total < 0) lookback::publish_value(sc.head_desc, q, carried);
      s.carry = static_cast<int>(carried) - 1;
      sc.carry[t] = s.carry;
    }
  }
  __syncthreads();
  seg = Max()(seg, s.carry);

  // The tile's run starts and valid positions per rank, a thread's runs of
  // one rank added at once.
  int cur = -1, runs = 0, kmers = 0;
  const unsigned starts = run_marks(it, heads, seg, p0, max_kmers).starts;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (!it.v[j]) continue;
    if (it.r[j] != cur) {
      if (cur >= 0) {
        if (runs) atomicAdd(bins + cur, runs);
        atomicAdd(bins + num_dest + cur, kmers);
      }
      cur = it.r[j];
      runs = kmers = 0;
    }
    runs += (starts >> j) & 1u;
    ++kmers;
  }
  // The strip's last rank, added once by each group of lanes that share it.
  const unsigned group = __match_any_sync(kFull, cur);
  runs = __reduce_add_sync(group, runs);
  kmers = __reduce_add_sync(group, kmers);
  if (cur >= 0 && (group & ((1u << (threadIdx.x & 31)) - 1u)) == 0) {
    if (runs) atomicAdd(bins + cur, runs);
    atomicAdd(bins + num_dest + cur, kmers);
  }
  __syncthreads();

  // The counts of the tiles before this one, by decoupled look-back: flag
  // 1 an aggregate, 2 an inclusive vector; each writer fences its part
  // before the flag. Warp 0 finds how far back to add (count_window); up to
  // 32 components (16 destinations) it also adds them, each lane holding
  // one, with no barrier of the block on the way; past that the block adds
  // them, a thread a component.
  int* mine = (t == 0 ? sc.incl : sc.agg) + static_cast<int64_t>(t) * width;
  volatile unsigned* flag = sc.flag;
  if (width <= 32) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int own = lane < width ? bins[lane] : 0;
      if (lane < width) mine[lane] = own;
      __threadfence();
      __syncwarp();
      if (lane == 0) flag[t] = t == 0 ? 2u : 1u;
      if (t > 0) {
        int sum = 0;  // lane c: component c of the tiles before
        for (int hi = t - 1;; hi -= 32 * kReach) {
          int found;
          const bool hit = count_window(sc.flag, hi, &found);
          __threadfence();
          for (int c = 0; c < width; ++c) {
            int part = 0;
#pragma unroll
            for (int u = 0; u < kReach; ++u) {
              const int tau = lane + 32 * u;
              if (tau < found) {
                const int* from = hit && tau == found - 1 ? sc.incl : sc.agg;
                part += load_cg(from + static_cast<int64_t>(hi - tau) * width + c);
              }
            }
            const int total = __reduce_add_sync(kFull, part);
            if (lane == c) sum += total;
          }
          if (hit) break;
        }
        if (lane < width) {
          excl[lane] = sum;
          sc.incl[static_cast<int64_t>(t) * width + lane] = sum + own;
        }
        __threadfence();
        __syncwarp();
        if (lane == 0) flag[t] = 2u;
      }
    }
  } else {
    for (int i = threadIdx.x; i < width; i += kThreads) mine[i] = bins[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) flag[t] = t == 0 ? 2u : 1u;
    for (int hi = t - 1; t > 0; hi -= 32 * kReach) {
      if (threadIdx.x < 32) {
        int found;
        const bool hit = count_window(sc.flag, hi, &found);
        if (threadIdx.x == 0) {
          s.window_taken = found;
          s.window_incl = hit;
        }
      }
      __syncthreads();
      const int taken = s.window_taken;
      const bool hit = s.window_incl;
      __threadfence();
      // The taken tiles are hi, hi - 1, ..., hi - taken + 1, the last one
      // inclusive where the walk ends there.
      for (int c = threadIdx.x; c < width; c += kThreads) {
        int sum = 0;
        for (int tau = 0; tau < taken; ++tau) {
          const int* from = hit && tau == taken - 1 ? sc.incl : sc.agg;
          sum += load_cg(from + static_cast<int64_t>(hi - tau) * width + c);
        }
        excl[c] += sum;
      }
      __syncthreads();
      if (hit) {
        int* incl = sc.incl + static_cast<int64_t>(t) * width;
        for (int i = threadIdx.x; i < width; i += kThreads) incl[i] = excl[i] + bins[i];
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) flag[t] = 2u;
        break;
      }
    }
  }
  if (t != tiles - 1) return;

  // The last tile: the totals -> the destinations' run bounds, the run
  // count and the largest base and run counts of any destination.
  __syncthreads();
  for (int i = threadIdx.x; i < width; i += kThreads) excl[i] += bins[i];
  __syncthreads();
  int running = 0;
  long long cmax = 0, smax = 0;
  for (int first = 0; first < num_dest; first += kThreads) {
    const int d = first + threadIdx.x;
    const int r = d < num_dest ? excl[d] : 0;
    int total;
    const int before = block_exclusive(r, 0, Sum(), s.scratch, &total);
    if (d < num_dest) {
      dest_begin[d] = running + before;
      const long long bases = static_cast<long long>(r) * (k - 1) + excl[num_dest + d];
      cmax = cmax > bases ? cmax : bases;
      smax = smax > r ? smax : r;
    }
    running += total;
  }
  cmax = block_max64(cmax, s.scratch64);
  smax = block_max64(smax, s.scratch64);
  if (threadIdx.x == 0) {
    dest_begin[num_dest] = running;
    info[0] = running;
    info[1] = cmax;
    info[2] = smax;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
layout_write(const uint8_t* valid, const int32_t* dest, const int32_t* assign, int buckets,
             bool staged, int64_t n, int max_kmers, int k, int num_dest, Scratch sc,
             const int64_t* dest_begin, int64_t* src, int64_t* off, int32_t* bases) {
  __shared__ TileShared s;
  extern __shared__ int dyn[];
  // kTile + 1 entries: a run's first position in the tile, its valid
  // positions in the tile and whether it ends there (packed), its rank.
  int* e_pack = dyn;
  int* e_rank = e_pack + kTile + 1;
  int* cnt = e_rank + kTile + 1;  // 2 num_dest: runs and valid positions per rank so far
  auto* first_row = reinterpret_cast<int64_t*>(cnt + 2 * num_dest);  // num_dest
  int32_t* room = reinterpret_cast<int32_t*>(first_row + num_dest);
  const int t = blockIdx.x;
  const int64_t begin = static_cast<int64_t>(t) * kTile;
  const int tile_len = static_cast<int>(n - begin < kTile ? n - begin : kTile);
  const int width = 2 * num_dest;
  const int carry = sc.carry[t];
  // The ranks' counts before the tile and the destinations' first rows:
  // loaded at once, with the items, so no later step waits on them.
  const int* before = sc.incl + static_cast<int64_t>(t - 1) * width;
  for (int i = threadIdx.x; i < width; i += kThreads) cnt[i] = t > 0 ? load_cg(before + i) : 0;
  for (int d = threadIdx.x; d < num_dest; d += kThreads) first_row[d] = dest_begin[d];

  const int32_t* table = stage_table(assign, buckets, staged, room);
  const int p0 = static_cast<int>(begin) + threadIdx.x * kItems;
  const Items it = load_items(valid, dest, table, n, p0);
  int unused;
  const unsigned heads = head_bits(it);
  const int seg0 = Max()(carry,
      block_exclusive(last_head(heads, p0), -1, Max(), s.scratch, &unused));
  const RunMarks marks = run_marks(it, heads, seg0, p0, max_kmers);
  int starts;
  const int first_entry =
      1 + block_exclusive(__popc(marks.starts), 0, Sum(), s.scratch, &starts);
  const int entries = starts + 1;

  // Entry 0: the run continued from the left, where the tile's first
  // position is valid and starts no run.
  if (threadIdx.x == 0) {
    e_rank[0] = it.v[0] && !(marks.starts & 1u) ? it.r[0] : -1;
    e_pack[0] = tile_len << kLenShift;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if ((marks.starts >> j) & 1u) {
      const unsigned before = marks.starts & ((1u << j) - 1u);
      const int e = first_entry + __popc(before);
      const int q = p0 + j - static_cast<int>(begin);
      e_pack[e] = q | (tile_len - q) << kLenShift;
      e_rank[e] = it.r[j];
    }
  }
  __syncthreads();

  // Each run end: the run's length within the tile, and that it ended.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if ((marks.ends >> j) & 1u) {
      const unsigned upto = marks.starts & ((2u << j) - 1u);
      const int e = first_entry - 1 + __popc(upto);
      const int run_start = upto ? p0 + 31 - __clz(upto) : p0 - 1 - marks.pre;
      const int from = run_start > static_cast<int>(begin) ? run_start : static_cast<int>(begin);
      e_pack[e] = (e_pack[e] & kStartMask) | (p0 + j - from + 1) << kLenShift | kEnded;
    }
  }
  __syncthreads();

  // One warp gives each entry its place, 32 entries a step, in flat order.
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  for (int first = 0; first < entries; first += 32) {
    const int en = first + lane;
    const int key = en < entries ? e_rank[en] : -1;
    const int packed = en < entries ? e_pack[en] : 0;
    const int len = (packed & ~kEnded) >> kLenShift;
    const bool ended = (packed & kEnded) != 0;
    const bool opens = key >= 0 && en > 0;
    const unsigned group = __match_any_sync(kFull, key);
    const unsigned opening = __ballot_sync(kFull, opens);
    int valid_sum = 0;  // the lengths of this rank's entries on lower lanes
    for (int l = 0; l < 32; ++l) {
      const int x = __shfl_sync(kFull, len, l);
      if ((group & below) >> l & 1u) valid_sum += x;
    }
    if (key >= 0) {
      const int runs = cnt[key] + __popc(group & below & opening);
      const int j = opens ? runs : runs - 1;  // entry 0: the run in progress
      const int64_t g = first_row[key] + j;
      if (opens) {
        src[g] = begin + (packed & kStartMask);
        off[g] = static_cast<int64_t>(j) * (k - 1) + cnt[num_dest + key] + valid_sum;
      }
      if (ended) {
        const int kmers = opens ? len
            : (static_cast<int>(begin) + len - 1 - carry) % max_kmers + 1;
        bases[g] = kmers + k - 1;
      }
    }
    __syncwarp();
    if (key >= 0 && (group >> lane) == 1u) {  // the group's highest lane
      cnt[key] += __popc(group & opening);
      cnt[num_dest + key] += valid_sum + len;
    }
    __syncwarp();
  }
}

struct Launch {
  int tiles;
  bool staged;
  size_t count_bytes, write_bytes;
};

Launch plan(int64_t n, int buckets, int num_dest) {
  Launch l;
  l.tiles = num_tiles(n);
  l.staged = buckets <= kSharedBuckets;
  const size_t table = l.staged ? static_cast<size_t>(buckets) * sizeof(int32_t) : 0;
  l.count_bytes = 4 * static_cast<size_t>(num_dest) * sizeof(int) + table;
  // 2 (kTile + 1) + 2 num_dest ints: first_row starts 8-byte aligned.
  l.write_bytes = (2 * static_cast<size_t>(kTile + 1) + 2 * static_cast<size_t>(num_dest)) *
                  sizeof(int) + static_cast<size_t>(num_dest) * sizeof(int64_t) + table;
  return l;
}

bool bad_args(int64_t n, int buckets, int max_kmers, int k, int num_dest) {
  return n <= 0 || n >= (int64_t{1} << 31) - kTile || buckets < 1 || max_kmers < 1 ||
         k < 1 || num_dest < 1 || num_dest > kMaxDest;
}

}  // namespace

// Scratch of hk_run_layout_count / _write for n positions and num_dest
// destinations (the tiles' descriptors, carries and per-rank counts).
extern "C" int64_t hk_run_layout_scratch(int64_t n, int num_dest) {
  const int64_t tiles = num_tiles(n);
  return zeroed_bytes(static_cast<int>(tiles)) + tiles * sizeof(int) +
         2 * tiles * 2 * static_cast<int64_t>(num_dest) * sizeof(int);
}

// valid (n,) bool, dest (n,) int32 buckets in [0, buckets) where valid,
// assign (buckets,) int32 ranks in [0, num_dest), device pointers;
// 0 < n < 2^31 - 4096, 1 <= num_dest <= 8192, max_kmers >= 1. Writes
// dest_begin (num_dest + 1, int64) and info (3, int64: runs, cmax, smax),
// and leaves what hk_run_layout_write reads in `scratch`.
extern "C" int hk_run_layout_count(const void* valid, const void* dest, const void* assign,
                                   int buckets, int64_t n, int max_kmers, int k,
                                   int num_dest, void* scratch, void* dest_begin, void* info,
                                   void* stream) {
  if (bad_args(n, buckets, max_kmers, k, num_dest)) return cudaErrorInvalidValue;
  const Launch l = plan(n, buckets, num_dest);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(zeroed_bytes(l.tiles)), s);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(layout_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(l.count_bytes));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  layout_count<<<l.tiles, kThreads, l.count_bytes, s>>>(
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(dest),
      static_cast<const int32_t*>(assign), buckets, l.staged, n, max_kmers, k, num_dest,
      carve(scratch, l.tiles, num_dest), static_cast<int64_t*>(dest_begin),
      static_cast<int64_t*>(info));
  return static_cast<int>(cudaGetLastError());
}

// The same inputs and the scratch and dest_begin that hk_run_layout_count
// filled; src, off (int64) and bases (int32) hold its run count.
extern "C" int hk_run_layout_write(const void* valid, const void* dest, const void* assign,
                                   int buckets, int64_t n, int max_kmers, int k,
                                   int num_dest, void* scratch, const void* dest_begin,
                                   void* src, void* off, void* bases, void* stream) {
  if (bad_args(n, buckets, max_kmers, k, num_dest)) return cudaErrorInvalidValue;
  const Launch l = plan(n, buckets, num_dest);
  const cudaError_t err = cudaFuncSetAttribute(
      layout_write, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.write_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  layout_write<<<l.tiles, kThreads, l.write_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(dest),
      static_cast<const int32_t*>(assign), buckets, l.staged, n, max_kmers, k, num_dest,
      carve(scratch, l.tiles, num_dest), static_cast<const int64_t*>(dest_begin),
      static_cast<int64_t*>(src), static_cast<int64_t*>(off), static_cast<int32_t*>(bases));
  return static_cast<int>(cudaGetLastError());
}
