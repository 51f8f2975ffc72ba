// The supermer run table: where each run of the supermer wire starts, how
// many k-mers it holds and which rank it goes to, in ascending flat order.
//
// No TPU kernel: the JAX package finds the runs on the host
// (hysortk_tpu/io/supermer.py run_boundaries, the reference's
// SupermerEncoder boundary rule, src/kmerops.cpp:1096-1148), and so did the
// port until this kernel (io/supermer.run_boundaries_plain, the host
// library's hk_run_boundaries). Same rule: over the valid k-mer starts, a
// run starts
//   * at the first valid position;
//   * where the position before is not valid (a gap or a read boundary);
//   * where the destination rank changes;
//   * every max_kmers k-mers from the start of the uncapped stretch (a run
//     of R k-mers spans R + k - 1 bases, capped at MAX_SUPERMER_LEN).
// A *segment* is a maximal stretch of valid positions of one destination;
// its first position is a *head*. A run starts at p iff p is valid and
// (p - the last head at or before p) % max_kmers == 0, and ends at p iff p
// is valid and the next position is not valid, has another destination, or
// starts a capped run. The run through p starts at
// head + (p - head) / max_kmers * max_kmers.
//
// The cap needs each position's head, and the output needs each run's
// index: two scans, a max-scan of head positions and a sum of run starts.
// Three launches, one tile = 256 threads x 16 consecutive positions:
//   1. summary: per tile its last head, the end of the stretch that
//      continues into it from the left (the first invalid or head
//      position), and the run starts after its first head (they need no
//      carry);
//   2. scan: one block walks the tiles' summaries in order, 1024 at a time:
//      each tile's carried head (the last head left of it), its run count
//      (its own runs plus those of the continued stretch, counted from the
//      carried head in O(1)), its first output index, and the total;
//   3. write: per tile again, with its carried head and first index: each
//      run start writes (start, destination), each run end the run's k-mer
//      count at the run's index.
// Inside a tile the positions and destinations are staged in shared memory
// (coalesced loads, one pad word every 16 so that a thread's 16 positions
// fall in distinct banks across a warp), and thread-level carries come
// from block scans by warp shuffles.
//
// Bound on the H100: HBM bytes, 5 B a position in (valid + int32
// destination; passes 1 and 3 each read them, the bound counts once) and 16
// B a run out (int64 start, int32 count, int32 destination).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kPadded = kTile + kTile / kItems;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct Min {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
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

// Exclusive scan of one int a thread, in thread order, over a block of
// kBlock threads; *total receives the block's aggregate. `scratch` holds
// kBlock / 32 ints of shared memory. Every thread of the block calls it.
template <int kBlock, typename Op>
__device__ int block_exclusive(int x, int identity, Op op, int* scratch, int* total) {
  constexpr int kWarps = kBlock / 32;
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

struct TileShared {
  uint8_t v[kPadded];
  int32_t d[kPadded];
  uint8_t edge_v[2];  // the positions just left and just right of the tile
  int32_t edge_d[2];
  int scratch[kThreads / 32];
};

__device__ __forceinline__ int padded(int q) { return q + q / kItems; }

// Stage the tile's validity and destinations, and its two neighbours.
__device__ __forceinline__ void stage_tile(const uint8_t* valid, const int32_t* dest,
                                           int64_t n, int64_t begin, TileShared& s) {
  for (int q = threadIdx.x; q < kTile; q += kThreads) {
    const int64_t p = begin + q;
    const bool in = p < n;
    s.v[padded(q)] = in ? valid[p] : 0;
    s.d[padded(q)] = in ? dest[p] : 0;
  }
  if (threadIdx.x < 2) {
    const int64_t p = threadIdx.x == 0 ? begin - 1 : begin + kTile;
    const bool in = p >= 0 && p < n;
    s.edge_v[threadIdx.x] = in ? valid[p] : 0;
    s.edge_d[threadIdx.x] = in ? dest[p] : 0;
  }
  __syncthreads();
}

// A thread's 16 positions (v, d) and the neighbours on either side.
struct Items {
  bool v[kItems];
  int d[kItems];
  bool v_prev, v_next;
  int d_prev, d_next;
};

__device__ __forceinline__ Items load_items(const TileShared& s) {
  Items it;
  const int q0 = threadIdx.x * kItems;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    it.v[j] = s.v[padded(q0 + j)] != 0;
    it.d[j] = s.d[padded(q0 + j)];
  }
  if (threadIdx.x == 0) {
    it.v_prev = s.edge_v[0] != 0;
    it.d_prev = s.edge_d[0];
  } else {
    it.v_prev = s.v[padded(q0 - 1)] != 0;
    it.d_prev = s.d[padded(q0 - 1)];
  }
  if (threadIdx.x == kThreads - 1) {
    it.v_next = s.edge_v[1] != 0;
    it.d_next = s.edge_d[1];
  } else {
    it.v_next = s.v[padded(q0 + kItems)] != 0;
    it.d_next = s.d[padded(q0 + kItems)];
  }
  return it;
}

__device__ __forceinline__ bool head_at(const Items& it, int j) {
  const bool vp = j == 0 ? it.v_prev : it.v[j > 0 ? j - 1 : 0];
  const int dp = j == 0 ? it.d_prev : it.d[j > 0 ? j - 1 : 0];
  return it.v[j] && (!vp || dp != it.d[j]);
}

// The thread's last head, or -1.
__device__ __forceinline__ int last_head(const Items& it, int p0) {
  int h = -1;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (head_at(it, j)) h = p0 + j;
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
runs_summary(const uint8_t* valid, const int32_t* dest, int64_t n, int max_kmers,
             int* tile_head, int* tile_prefix_end, int* tile_inner) {
  __shared__ TileShared s;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kTile;
  stage_tile(valid, dest, n, begin, s);
  const Items it = load_items(s);
  const int p0 = static_cast<int>(begin) + threadIdx.x * kItems;
  const int mine = last_head(it, p0);
  int head_total;
  int seg = block_exclusive<kThreads>(mine, -1, Max(), s.scratch, &head_total);
  int first_break = INT_MAX;
  int inner = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = p0 + j;
    const bool head = head_at(it, j);
    if ((!it.v[j] || head) && first_break == INT_MAX) first_break = p;
    if (head) seg = p;
    if (it.v[j] && seg >= 0 && (p - seg) % max_kmers == 0) ++inner;
  }
  int break_min, inner_sum;
  block_exclusive<kThreads>(first_break, INT_MAX, Min(), s.scratch, &break_min);
  block_exclusive<kThreads>(inner, 0, Sum(), s.scratch, &inner_sum);
  if (threadIdx.x == 0) {
    const int64_t end = begin + kTile < n ? begin + kTile : n;
    tile_head[blockIdx.x] = head_total;
    tile_prefix_end[blockIdx.x] =
        break_min < end ? break_min : static_cast<int>(end);
    tile_inner[blockIdx.x] = inner_sum;
  }
}

// The run starts in [b, e), a stretch continuing the segment whose head is
// h < b: the p with (p - h) % m == 0.
__device__ __forceinline__ int continued_runs(int h, int b, int e, int m) {
  if (e <= b || h < 0) return 0;
  return (e - 1 - h) / m - (b - 1 - h) / m;
}

__global__ void __launch_bounds__(kScanThreads)
runs_scan(const int* tile_head, const int* tile_prefix_end, const int* tile_inner,
          int num_tiles, int max_kmers, int* tile_carry, int* tile_offset,
          int* n_runs) {
  __shared__ int scratch[kScanThreads / 32];
  int head_carry = -1;
  int run_carry = 0;
  for (int first = 0; first < num_tiles; first += kScanThreads) {
    const int t = first + threadIdx.x;
    const bool in = t < num_tiles;
    const int h = in ? tile_head[t] : -1;
    int heads;
    const int carried = Max()(head_carry,
        block_exclusive<kScanThreads>(h, -1, Max(), scratch, &heads));
    const int runs = in ? tile_inner[t] + continued_runs(carried, t * kTile,
                                                         tile_prefix_end[t], max_kmers)
                        : 0;
    int total;
    const int before = run_carry +
        block_exclusive<kScanThreads>(runs, 0, Sum(), scratch, &total);
    if (in) {
      tile_carry[t] = carried;
      tile_offset[t] = before;
    }
    head_carry = Max()(head_carry, heads);
    run_carry += total;
  }
  if (threadIdx.x == 0) *n_runs = run_carry;
}

__global__ void __launch_bounds__(kThreads)
runs_write(const uint8_t* valid, const int32_t* dest, int64_t n, int max_kmers,
           const int* tile_carry, const int* tile_offset, int64_t* starts,
           int32_t* kmers, int32_t* run_dest) {
  __shared__ TileShared s;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kTile;
  stage_tile(valid, dest, n, begin, s);
  const Items it = load_items(s);
  const int p0 = static_cast<int>(begin) + threadIdx.x * kItems;
  int unused;
  const int seg0 = Max()(tile_carry[blockIdx.x],
      block_exclusive<kThreads>(last_head(it, p0), -1, Max(), s.scratch, &unused));
  int seg = seg0;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = p0 + j;
    if (head_at(it, j)) seg = p;
    if (it.v[j] && (p - seg) % max_kmers == 0) ++mine;
  }
  int r = tile_offset[blockIdx.x] +
          block_exclusive<kThreads>(mine, 0, Sum(), s.scratch, &unused);
  seg = seg0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (!it.v[j]) continue;
    const int p = p0 + j;
    if (head_at(it, j)) seg = p;
    const int into = p - seg;
    if (into % max_kmers == 0) {
      starts[r] = p;
      run_dest[r] = it.d[j];
      ++r;
    }
    const bool v_next = j == kItems - 1 ? it.v_next : it.v[j < kItems - 1 ? j + 1 : 0];
    const int d_next = j == kItems - 1 ? it.d_next : it.d[j < kItems - 1 ? j + 1 : 0];
    if (!v_next || d_next != it.d[j] || (into + 1) % max_kmers == 0) {
      kmers[r - 1] = into % max_kmers + 1;
    }
  }
}

inline int num_tiles(int64_t n) { return static_cast<int>((n + kTile - 1) / kTile); }

}  // namespace

// Scratch of hk_supermer_runs_count / _write for n positions: five ints a
// tile (head, prefix end, inner runs, carried head, first index).
extern "C" int64_t hk_supermer_runs_scratch(int64_t n) {
  return static_cast<int64_t>(num_tiles(n)) * 5 * static_cast<int64_t>(sizeof(int));
}

// valid: (n,) bool, dest: (n,) int32, device pointers; 0 < n < 2^31,
// max_kmers >= 1. Writes the run count to *n_runs (one int32 on the
// device) and leaves the carries in `scratch` for hk_supermer_runs_write.
extern "C" int hk_supermer_runs_count(const void* valid, const void* dest, int64_t n,
                                      int max_kmers, void* scratch, void* n_runs,
                                      void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) - kTile || max_kmers < 1) {
    return cudaErrorInvalidValue;
  }
  const int tiles = num_tiles(n);
  int* base = static_cast<int*>(scratch);
  const auto s = static_cast<cudaStream_t>(stream);
  runs_summary<<<tiles, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(dest), n,
      max_kmers, base, base + tiles, base + 2 * tiles);
  runs_scan<<<1, kScanThreads, 0, s>>>(base, base + tiles, base + 2 * tiles, tiles,
                                       max_kmers, base + 3 * tiles, base + 4 * tiles,
                                       static_cast<int*>(n_runs));
  return static_cast<int>(cudaGetLastError());
}

// The same (valid, dest, n, max_kmers) and the scratch that
// hk_supermer_runs_count filled; starts (int64), kmers (int32) and
// run_dest (int32) hold the run count it wrote.
extern "C" int hk_supermer_runs_write(const void* valid, const void* dest, int64_t n,
                                      int max_kmers, const void* scratch, void* starts,
                                      void* kmers, void* run_dest, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) - kTile || max_kmers < 1) {
    return cudaErrorInvalidValue;
  }
  const int tiles = num_tiles(n);
  const int* base = static_cast<const int*>(scratch);
  runs_write<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(dest), n,
      max_kmers, base + 3 * tiles, base + 4 * tiles, static_cast<int64_t*>(starts),
      static_cast<int32_t*>(kmers), static_cast<int32_t*>(run_dest));
  return static_cast<int>(cudaGetLastError());
}
