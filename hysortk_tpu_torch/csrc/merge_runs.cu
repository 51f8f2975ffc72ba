// Stable merge of sorted runs in passes of fan-in up to kMaxFanIn: W uint32
// key words (lexicographic, unsigned, word 0 most significant) with payload
// rows riding along.
//
// Replaces hysortk_tpu/ops/pallas_sort.py merge_runs (the bitonic
// merge_levels kernels entered at region size 2 * run_len, with
// pallas_msort._tail_member_kernel as their block-local tail). The TPU
// version is a compare-exchange network over odd-run-reversed input; here it
// is a multiway merge that is stable: on equal keys the earlier run's rows
// come first, so merging all runs equals a stable sort of their
// concatenation. Unsigned compares put the all-ones sentinel last without a
// special case.
//
// The runs are given by their boundaries, not by a common length: a pass
// merges each group of fan_in neighbouring runs (the last group may hold
// fewer) into one run, and the caller runs passes until one run is left.
// Two kernels a pass:
//   1. merge_partition: for every output tile boundary, a segment of lanes
//      (one lane per run of the group, 32 / lanes boundaries a warp) finds
//      how many of the group's first d outputs come from each run: a
//      multisequence selection in the order (key, run, slot), which makes
//      every element distinct. Coarse to fine, it keeps the d / q smallest
//      blocks of q slots by their last element, halving q from the longest
//      run's power of two down to 1; each step takes, gives back or swaps
//      one block after a butterfly of shuffles over the segment (depth
//      log2(lanes)). log2(run length) + 1 rounds of a few steps, where a
//      bisection of the key domain would take 32W rounds of a binary
//      search each.
//   2. merge_tiles: a block loads its tile's (up to fan_in) input segments
//      into shared memory with coalesced loads, merges them in log2(fan_in)
//      two-way merge-path levels inside shared memory (ping-pong between two
//      buffers of keys and, with payload rows, source slots; each thread
//      merges kItems outputs without branches), then writes the keys with
//      16-byte stores and gathers each payload row once by source slot.
//
// Bound on the H100: HBM bytes, every row read once and written once per
// pass (8 B x rows per slot). One pass merges up to fan_in runs, so S <=
// fan_in runs cost one pass and S runs ceil(log_fan_in(S)) passes. The
// partition reads a few elements per run and boundary; the merge levels are
// shared-memory work that four small blocks an SM overlap with each other's
// loads and stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // merge_tiles
constexpr int kPartWarps = 8;     // warps per merge_partition block
constexpr int kMaxFanIn = 32;     // one lane of a warp per run
constexpr int kMaxWords = 6;
constexpr int kMaxRows = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Output slots per tile. Two buffers of W + 1 rows: four blocks an SM at
// W <= 2 (51 KB each), so that some blocks stream while others merge.
constexpr int kTile = 2048;
constexpr int kItems = kTile / kThreads;  // consecutive outputs a thread merges

// Shared-memory index of tile slot i: one pad word per 32 slots, so that a
// thread's run of kItems consecutive merge outputs and its
// neighbours' fall in different banks.
__device__ __forceinline__ int phys(int i) { return i + (i >> 5); }

struct MergeRows {
  const uint32_t* src[kMaxRows];
  uint32_t* dst[kMaxRows];
};

// One pass's plan (device arrays). bounds[0 .. n_runs]: run boundaries in
// slots; group g is runs [g * fan_in, min((g + 1) * fan_in, n_runs)).
// group_tiles[0 .. n_groups]: prefix sums of the groups' output tiles.
// Group g has group_tiles[g + 1] - group_tiles[g] + 1 tile boundaries, so
// boundary b of tile t in group g is t + g. The partition keeps `width`
// splits a boundary (the most runs a group holds).
struct Plan {
  const int* bounds;
  const int* group_tiles;
  int n_runs;
  int n_groups;
  int fan_in;
  __device__ __forceinline__ int width() const { return min(fan_in, n_runs); }
};

// The largest g in [0, n) with f(g) <= x, f increasing.
template <typename F>
__device__ __forceinline__ int last_at_most(int n, int x, F f) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (f(mid) <= x) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// ---------------------------------------------------------------- partition

// A lane's candidate element as a compare key. Classes order the candidates
// before their words do: none below anything (a lane with nothing taken),
// a real key, a slot past the run's end (after every real key), none above
// anything (a lane with nothing left to take). Among equal keys the lane
// (the run) decides.
constexpr unsigned kNoneLow = 0, kReal = 1, kPastEnd = 2, kNoneHigh = 3;

template <int W>
struct Cand {
  unsigned cls;
  uint32_t key[W];
};

template <int W>
__device__ __forceinline__ Cand<W> element(const MergeRows& rows, int64_t base,
                                           int64_t len, int64_t p) {
  Cand<W> c;
  c.cls = p < len ? kReal : kPastEnd;
#pragma unroll
  for (int w = 0; w < W; ++w) c.key[w] = p < len ? rows.src[w][base + p] : 0u;
  return c;
}

template <int W>
__device__ __forceinline__ Cand<W> none(unsigned cls) {
  Cand<W> c;
  c.cls = cls;
#pragma unroll
  for (int w = 0; w < W; ++w) c.key[w] = 0u;
  return c;
}

// Whether candidate x (of lane lx) comes before y (of lane ly).
template <int W>
__device__ __forceinline__ bool before(const Cand<W>& x, int lx,
                                       const Cand<W>& y, int ly) {
  if (x.cls != y.cls) return x.cls < y.cls;
  if (x.cls == kReal) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (x.key[w] != y.key[w]) return x.key[w] < y.key[w];
    }
  }
  return lx < ly;
}

// The first (or with kLast the last) candidate of each segment of `width`
// lanes and its lane, on every lane of the segment: a butterfly of
// log2(width) shuffle steps, all lanes taking part.
template <int W, bool kLast>
__device__ __forceinline__ void segment_pick(Cand<W>& c, int& from, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    Cand<W> o;
    o.cls = __shfl_xor_sync(kFull, c.cls, off, width);
#pragma unroll
    for (int w = 0; w < W; ++w) o.key[w] = __shfl_xor_sync(kFull, c.key[w], off, width);
    const int lo = __shfl_xor_sync(kFull, from, off, width);
    if (kLast ? before<W>(c, from, o, lo) : before<W>(o, lo, c, from)) {
      c = o;
      from = lo;
    }
  }
}

// Lanes a boundary takes: the group's most runs, rounded up to a power of two.
__device__ __host__ __forceinline__ int segment_lanes(int fan_in, int n_runs) {
  const int runs = fan_in < n_runs ? fan_in : n_runs;
  int lanes = 1;
  while (lanes < runs) lanes <<= 1;
  return lanes;
}

// part[b * width + r] = how many of group g's first d outputs come from
// its run r, d being boundary b's first output slot within the group. A
// warp takes 32 / lanes boundaries, one segment of lanes each, lane r of a
// segment for run r.
template <int W>
__global__ void __launch_bounds__(kPartWarps * 32, 4)
merge_partition(const __grid_constant__ MergeRows rows, Plan plan, int tile,
                int n_boundaries, int* __restrict__ part) {
  const int lanes = segment_lanes(plan.fan_in, plan.n_runs);
  const int lane = threadIdx.x & 31;
  const int r = lane & (lanes - 1);
  const int b = ((blockIdx.x * kPartWarps + (threadIdx.x >> 5)) * 32 + lane) / lanes;
  bool done = b >= n_boundaries;
  int runs = 0;
  int64_t base = 0, len = 0, d = 0;
  if (!done) {
    const int g = last_at_most(plan.n_groups, b, [&](int x) {
      return plan.group_tiles[x] + x;
    });
    const int first_run = g * plan.fan_in;
    runs = min(plan.fan_in, plan.n_runs - first_run);
    if (r < runs) {
      base = plan.bounds[first_run + r];
      len = plan.bounds[first_run + r + 1] - base;
    }
    const int64_t group_len =
        plan.bounds[first_run + runs] - plan.bounds[first_run];
    const int64_t at = static_cast<int64_t>(b - plan.group_tiles[g] - g) * tile;
    d = at < group_len ? at : group_len;
    done = d == 0 || d == group_len;  // every run wholly out or wholly in
    if (done && r < runs) {
      part[static_cast<int64_t>(b) * plan.width() + r] =
          d == 0 ? 0 : static_cast<int>(len);
    }
  }
  const bool active = r < runs;
  int* split = part + static_cast<int64_t>(b) * plan.width();

  // top: the longest run's length rounded up to a power of two. Slots from
  // a run's length up to top read as past its end.
  int64_t longest = len;
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    const int64_t o = __shfl_xor_sync(kFull, longest, off, lanes);
    longest = o > longest ? o : longest;
  }
  int64_t top = 1;
  while (top < longest) top <<= 1;
  auto load = [&](int64_t p, unsigned empty) {
    return active && p >= 0 && p < top ? element<W>(rows, base, len, p)
                                       : none<W>(empty);
  };

  // Invariant at block size q: the lane has taken its first a slots, a a
  // multiple of q, and the blocks taken are the d / q smallest q-slot blocks
  // by their last element. `in` is the last taken block's last element,
  // `out` the first untaken block's. Each step takes the first untaken
  // block, gives back the last taken one, or swaps the two while the last
  // taken comes after the first untaken; a balanced step halves q.
  int64_t q = top, a = 0, taken = 0;  // taken: blocks of q slots, over the segment
  Cand<W> in = none<W>(kNoneLow);
  Cand<W> out = load(top - 1, kNoneHigh);
  while (__any_sync(kFull, !done)) {
    Cand<W> last = in, first = out;
    int hi = r, lo = r;
    segment_pick<W, true>(last, hi, lanes);
    segment_pick<W, false>(first, lo, lanes);
    if (!done) {
      const int64_t want = d / q;
      const bool crossed = hi != lo && before<W>(first, lo, last, hi);
      const bool take = taken < want || (taken == want && crossed);
      const bool give = taken > want || (taken == want && crossed);
      if (take && r == lo) {
        a += q;
        in = out;
        out = load(a + q - 1, kNoneHigh);
      }
      if (give && r == hi) {
        a -= q;
        out = in;
        in = load(a - 1, kNoneLow);
      }
      taken += (take ? 1 : 0) - (give ? 1 : 0);
      if (!take && !give) {
        if (q == 1) {
          done = true;
          if (active) split[r] = static_cast<int>(a);
        } else {
          q >>= 1;
          taken *= 2;
          out = load(a + q - 1, kNoneHigh);
        }
      }
    }
  }
}

// -------------------------------------------------------------------- tiles

template <int W>
__device__ __forceinline__ bool less_at(const uint32_t* buf, int pitch, int x,
                                        int y) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t u = buf[w * pitch + x], v = buf[w * pitch + y];
    if (u != v) return u < v;
  }
  return false;
}

template <int W>
__device__ __forceinline__ bool less_reg(const uint32_t (&x)[W],
                                         const uint32_t (&y)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (x[w] != y[w]) return x[w] < y[w];
  }
  return false;
}

template <int W>
__device__ __forceinline__ void read_key(const uint32_t* buf, int pitch, int x,
                                         uint32_t (&key)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) key[w] = buf[w * pitch + x];
}

// Four blocks an SM at W <= 2, two above (as many as fit its shared
// memory, up to W = 5): at most 64 or 128 registers a thread.
template <int W, bool kPayload>
__global__ void __launch_bounds__(kThreads, W <= 2 ? 4 : 2)
merge_tiles(const __grid_constant__ MergeRows rows, int n_rows, Plan plan,
            const int* __restrict__ part) {
  constexpr int kPitch = kTile + kTile / 32;
  constexpr int kRows = W + (kPayload ? 1 : 0);  // keys, then source slots
  extern __shared__ uint32_t smem[];  // two buffers of kRows rows of kPitch
  __shared__ int seg[kMaxFanIn + 1];  // segment r is tile slots [seg[r], seg[r + 1])
  __shared__ int seg_src[kMaxFanIn];  // its first source slot

  const int t = blockIdx.x;
  const int g = last_at_most(plan.n_groups, t, [&](int x) {
    return plan.group_tiles[x];
  });
  const int first_run = g * plan.fan_in;
  const int runs = min(plan.fan_in, plan.n_runs - first_run);
  const int b = t + g;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int from = 0, to = 0, start = 0;
    if (lane < runs) {
      from = part[static_cast<int64_t>(b) * plan.width() + lane];
      to = part[static_cast<int64_t>(b + 1) * plan.width() + lane];
      start = plan.bounds[first_run + lane] + from;
    }
    int end = to - from;  // inclusive scan of the segment lengths
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, end, o);
      if (lane >= o) end += v;
    }
    seg[lane + 1] = end;
    seg_src[lane] = start;
    if (lane == 0) seg[0] = 0;
  }
  __syncthreads();
  const int total = seg[kMaxFanIn];
  const int64_t out0 = plan.bounds[first_run] +
                       static_cast<int64_t>(t - plan.group_tiles[g]) * kTile;

  // Load: every slot of the tile once, all loads of a thread in flight
  // together.
  {
    uint32_t v[kItems][W];
    int src[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = it * kThreads + threadIdx.x;
      if (i < total) {
        const int r = last_at_most(runs, i, [&](int x) { return seg[x]; });
        src[it] = seg_src[r] + (i - seg[r]);
#pragma unroll
        for (int w = 0; w < W; ++w) v[it][w] = rows.src[w][src[it]];
      }
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = it * kThreads + threadIdx.x;
      if (i < total) {
#pragma unroll
        for (int w = 0; w < W; ++w) smem[w * kPitch + phys(i)] = v[it][w];
        if (kPayload) smem[W * kPitch + phys(i)] = static_cast<uint32_t>(src[it]);
      }
    }
  }

  // Merge levels: at level lv, pairs of 2^lv-segment runs (empty segments
  // pad the count to a power of two). Each thread makes kItems consecutive
  // outputs; its range may cross from one pair into the next.
  int levels = 0;
  while ((1 << levels) < runs) ++levels;
  int cur = 0;
  for (int lv = 0; lv < levels; ++lv) {
    __syncthreads();
    const uint32_t* in = smem + cur * kRows * kPitch;
    uint32_t* outb = smem + (cur ^ 1) * kRows * kPitch;
    const int width = 1 << lv;
    const int pairs = (1 << levels) >> (lv + 1);
    int pos = min(static_cast<int>(threadIdx.x) * kItems, total);
    const int end = min(pos + kItems, total);
    while (pos < end) {
      const int p = last_at_most(pairs, pos, [&](int x) { return seg[2 * x * width]; });
      const int a0 = seg[2 * p * width];
      const int m = seg[(2 * p + 1) * width];
      const int b1 = seg[(2 * p + 2) * width];
      const int na = m - a0, nb = b1 - m;
      const int diag = pos - a0;
      // The least split a with B[diag - 1 - a] < A[a]: ties go to A, the
      // earlier runs.
      int lo = max(diag - nb, 0), hi = min(diag, na);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (less_at<W>(in, kPitch, phys(m + diag - 1 - mid), phys(a0 + mid))) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      // Serial merge without branches: one shared-memory read a step, of
      // the side just taken from (its next key, or a harmless slot once the
      // side is used up).
      int ia = a0 + lo, ib = m + diag - lo;  // tile slots
      uint32_t ka[W], kb[W];
      read_key<W>(in, kPitch, phys(min(ia, b1 - 1)), ka);
      read_key<W>(in, kPitch, phys(min(ib, b1 - 1)), kb);
      const int stop = min(end, b1);
      for (; pos < stop; ++pos) {
        const bool take_a = ib >= b1 || (ia < m && !less_reg<W>(kb, ka));
        const int s = take_a ? ia : ib;
        const int o = phys(pos);
#pragma unroll
        for (int w = 0; w < W; ++w) outb[w * kPitch + o] = take_a ? ka[w] : kb[w];
        if (kPayload) outb[W * kPitch + o] = in[W * kPitch + phys(s)];
        ia += take_a ? 1 : 0;
        ib += take_a ? 0 : 1;
        uint32_t next[W];
        read_key<W>(in, kPitch, phys(min(s + 1, b1 - 1)), next);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          ka[w] = take_a ? next[w] : ka[w];
          kb[w] = take_a ? kb[w] : next[w];
        }
      }
    }
    cur ^= 1;
  }
  __syncthreads();

  // Write-out: keys from shared memory, payload rows gathered once by
  // source slot; 16-byte stores where every destination row allows them.
  const uint32_t* res = smem + cur * kRows * kPitch;
  bool vec = (out0 & 3) == 0 && (total & 3) == 0;
  for (int q = 0; q < n_rows; ++q) {
    vec = vec && (reinterpret_cast<uintptr_t>(rows.dst[q]) & 15u) == 0;
  }
  if (vec) {
    // A thread's slots are 4 * (k * kThreads + threadIdx.x) + [0, 4).
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int i = 4 * (k * kThreads + threadIdx.x);
      if (i < total) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          *reinterpret_cast<uint4*>(rows.dst[w] + out0 + i) = make_uint4(
              res[w * kPitch + phys(i)], res[w * kPitch + phys(i + 1)],
              res[w * kPitch + phys(i + 2)], res[w * kPitch + phys(i + 3)]);
        }
      }
    }
    if (kPayload) {
      uint32_t from[kItems];  // source slots, all gathers of a row in flight
#pragma unroll
      for (int k = 0; k < kItems / 4; ++k) {
        const int i = 4 * (k * kThreads + threadIdx.x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          from[4 * k + j] = i < total ? res[W * kPitch + phys(i + j)] : 0u;
        }
      }
      for (int q = W; q < n_rows; ++q) {
        const uint32_t* row = rows.src[q];
        uint32_t v[kItems];
#pragma unroll
        for (int k = 0; k < kItems / 4; ++k) {
          const int i = 4 * (k * kThreads + threadIdx.x);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[4 * k + j] = i < total ? row[from[4 * k + j]] : 0u;
        }
#pragma unroll
        for (int k = 0; k < kItems / 4; ++k) {
          const int i = 4 * (k * kThreads + threadIdx.x);
          if (i < total) {
            *reinterpret_cast<uint4*>(rows.dst[q] + out0 + i) =
                make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads) {
#pragma unroll
      for (int w = 0; w < W; ++w) rows.dst[w][out0 + i] = res[w * kPitch + phys(i)];
      if (kPayload) {
        const uint32_t s = res[W * kPitch + phys(i)];
        for (int q = W; q < n_rows; ++q) rows.dst[q][out0 + i] = rows.src[q][s];
      }
    }
  }
}

template <int W, bool kPayload>
cudaError_t launch_tiles(const MergeRows& rows, int n_rows, const Plan& plan,
                         int num_tiles, const int* part, cudaStream_t s) {
  constexpr int kRows = W + (kPayload ? 1 : 0);
  const int shared =
      static_cast<int>(2 * kRows * (kTile + kTile / 32) * sizeof(uint32_t));
  // Above 48 KB a kernel has to opt in to its dynamic shared memory.
  cudaError_t err = cudaFuncSetAttribute(
      merge_tiles<W, kPayload>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared);
  if (err != cudaSuccess) return err;
  merge_tiles<W, kPayload><<<num_tiles, kThreads, shared, s>>>(rows, n_rows,
                                                               plan, part);
  return cudaGetLastError();
}

template <int W>
cudaError_t merge_pass(const MergeRows& rows, int n_rows, const Plan& plan,
                       int num_tiles, int* part, cudaStream_t s) {
  const int n_boundaries = num_tiles + plan.n_groups;
  const int per_block = kPartWarps * (32 / segment_lanes(plan.fan_in, plan.n_runs));
  merge_partition<W><<<(n_boundaries + per_block - 1) / per_block,
                       kPartWarps * 32, 0, s>>>(rows, plan, kTile, n_boundaries,
                                                part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_tiles == 0) return err;
  return n_rows > W ? launch_tiles<W, true>(rows, n_rows, plan, num_tiles, part, s)
                    : launch_tiles<W, false>(rows, n_rows, plan, num_tiles, part, s);
}

}  // namespace

// One pass. src, dst: n_rows device pointers each to uint32 rows, the first
// n_keys of them key words; dst must not overlap src. bounds (n_runs + 1)
// and group_tiles (n_groups + 1): device int32 arrays as Plan describes,
// n_groups = ceil(n_runs / fan_in), group_tiles[n_groups] = num_tiles, tiles
// of `tile` slots (2048, checked here). Each group of
// fan_in neighbouring sorted runs of src becomes one sorted run of dst at
// the same slots; fan_in is at most 32. part: (num_tiles + n_groups) *
// min(fan_in, n_runs) int32 elements of scratch. Returns cudaGetLastError() of the first failing
// launch, else 0.
extern "C" int hk_merge_pass(void* const* src, void* const* dst, int n_keys,
                             int n_rows, const void* bounds, int n_runs,
                             const void* group_tiles, int n_groups, int fan_in,
                             int tile, int num_tiles, void* part, void* stream) {
  if (n_keys < 1 || n_keys > kMaxWords || n_rows < n_keys ||
      n_rows > kMaxRows || fan_in < 2 || fan_in > kMaxFanIn || n_runs < 1 ||
      n_groups != (n_runs + fan_in - 1) / fan_in || num_tiles < 0 ||
      tile != kTile) {
    return cudaErrorInvalidValue;
  }
  MergeRows rows{};
  for (int q = 0; q < n_rows; ++q) {
    rows.src[q] = static_cast<const uint32_t*>(src[q]);
    rows.dst[q] = static_cast<uint32_t*>(dst[q]);
  }
  const Plan plan{static_cast<const int*>(bounds),
                  static_cast<const int*>(group_tiles), n_runs, n_groups,
                  fan_in};
  int* p = static_cast<int*>(part);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_keys) {
    case 1: err = merge_pass<1>(rows, n_rows, plan, num_tiles, p, s); break;
    case 2: err = merge_pass<2>(rows, n_rows, plan, num_tiles, p, s); break;
    case 3: err = merge_pass<3>(rows, n_rows, plan, num_tiles, p, s); break;
    case 4: err = merge_pass<4>(rows, n_rows, plan, num_tiles, p, s); break;
    case 5: err = merge_pass<5>(rows, n_rows, plan, num_tiles, p, s); break;
    case 6: err = merge_pass<6>(rows, n_rows, plan, num_tiles, p, s); break;
  }
  return static_cast<int>(err);
}
