// Weighted run-length sum over sorted, sentinel-marked key words.
//
// Replaces hysortk_tpu/ops/pallas_count.py run_length_sum_fused
// (_sum_kernel), with its exact semantics: a run boundary is at i = 0 or
// wherever any word differs from slot i-1; a slot whose words are all ones
// is a sentinel, weighs 0 and is never a head (the first sentinel slot is a
// boundary, so it ends the last real run); head = boundary && !sentinel; at
// a head total = the int32 sum (wrapping) of the weights of its run, i.e. of
// every slot up to the next boundary; elsewhere total = 0.
//
// The TPU kernel walks its blocks right to left and carries the open run's
// partial sum in a scalar across the sequential grid. Blocks on the H100 run
// in parallel and in no order, so the carry becomes a pass of its own. All
// three passes are one reverse segmented scan with the operator
//   (v, f) . (v', f') = (f ? v : v + v', f || f')        (left . right)
// over slots, where a slot is (boundary ? 0 : weight, boundary): the v of an
// aggregate is the weight that continues a run ending just left of it.
//   1. sum_flags: per slot a flag byte (bit 0 boundary, bit 1 sentinel) and
//      per tile the aggregate of its slots;
//   2. sum_tile_carry: one block scans the tile aggregates right to left
//      and gives every tile the aggregate of all later tiles;
//   3. sum_finish: the in-tile exclusive scan, closed by the tile's carry,
//      gives every slot the weight to its right that belongs to its run;
//      heads write weight + that.
// No head walks forward over its run, so a 10^6-slot run costs the same per
// slot as anything else.
//
// Bound on the H100: HBM bytes. Pass 1 reads 4W + 4 B/slot and writes 1 B;
// pass 3 reads 1 + 4 B and writes 5 B (total int32 + head bool); pass 2
// touches 12 B per 1024 slots.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // consecutive slots per thread
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;
constexpr int kMaxWords = 6;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct WordRows {
  const uint32_t* row[kMaxWords];
};

// An aggregate of consecutive slots: v = the sum of the weights before its
// first boundary (all of them if it has none), f = whether it has one.
struct Seg {
  int v;
  int f;
};

__device__ __forceinline__ Seg seg_join(Seg left, Seg right) {
  return Seg{left.f ? left.v : left.v + right.v, left.f | right.f};
}

// The aggregate of all threads of the block with a larger index (the
// identity (0, 0) for the last). `warp_buf` holds one Seg per warp.
template <int kBlock>
__device__ __forceinline__ Seg block_suffix_excl(Seg mine, Seg* warp_buf) {
  constexpr int kNumWarps = kBlock / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg incl = mine;  // aggregate of lanes lane..31 of this warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Seg y;
    y.v = __shfl_down_sync(kFull, incl.v, o);
    y.f = __shfl_down_sync(kFull, incl.f, o);
    if (lane + o < 32) incl = seg_join(incl, y);
  }
  if (lane == 0) warp_buf[warp] = incl;
  __syncthreads();
  Seg later_warps{0, 0};
  for (int w = kNumWarps - 1; w > warp; --w) {
    later_warps = seg_join(warp_buf[w], later_warps);
  }
  Seg excl;
  excl.v = __shfl_down_sync(kFull, incl.v, 1);
  excl.f = __shfl_down_sync(kFull, incl.f, 1);
  if (lane == 31) excl = Seg{0, 0};
  __syncthreads();  // warp_buf may be reused by the caller
  return seg_join(excl, later_warps);
}

__global__ void __launch_bounds__(kThreads)
sum_flags(WordRows words, int n_words, const int* __restrict__ weights,
          int64_t n, uint8_t* __restrict__ flags, int* __restrict__ tile_v,
          int* __restrict__ tile_f) {
  __shared__ Seg warp_buf[kThreads / 32];
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  uint8_t f[kItems];
  int wt[kItems];
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    f[j] = 0;
    wt[j] = 0;
    if (i >= n) continue;  // past the end: no boundary, no weight
    bool boundary = i == 0;
    bool sentinel = true;
    for (int w = 0; w < n_words; ++w) {
      const uint32_t v = words.row[w][i];
      sentinel = sentinel && v == 0xFFFFFFFFu;
      if (i > 0) boundary = boundary || v != words.row[w][i - 1];
    }
    f[j] = static_cast<uint8_t>(boundary) | (static_cast<uint8_t>(sentinel) << 1);
    wt[j] = sentinel ? 0 : weights[i];
  }
  // The flag buffer is padded to whole tiles.
  *reinterpret_cast<uchar4*>(flags + base) = make_uchar4(f[0], f[1], f[2], f[3]);
  Seg mine{0, 0};
  for (int j = kItems - 1; j >= 0; --j) {
    mine = seg_join(Seg{(f[j] & 1) ? 0 : wt[j], f[j] & 1}, mine);
  }
  const Seg later = block_suffix_excl<kThreads>(mine, warp_buf);
  if (threadIdx.x == 0) {
    const Seg tile = seg_join(mine, later);
    tile_v[blockIdx.x] = tile.v;
    tile_f[blockIdx.x] = tile.f;
  }
}

// tile_carry[t] = the v of the aggregate of tiles t+1 .. num_tiles-1: the
// weight in later tiles that continues tile t's last run. One block walks
// the tiles right to left in chunks, carrying the aggregate of the chunks
// already done.
__global__ void __launch_bounds__(kCarryThreads)
sum_tile_carry(const int* __restrict__ tile_v, const int* __restrict__ tile_f,
               int num_tiles, int* __restrict__ tile_carry) {
  __shared__ Seg warp_buf[kCarryThreads / 32];
  __shared__ Seg chunk;
  Seg carry{0, 0};
  for (int end = num_tiles; end > 0; end -= kCarryThreads) {
    const int t = end - kCarryThreads + static_cast<int>(threadIdx.x);
    const Seg mine = t >= 0 ? Seg{tile_v[t], tile_f[t]} : Seg{0, 0};
    const Seg later = block_suffix_excl<kCarryThreads>(mine, warp_buf);
    if (t >= 0) tile_carry[t] = seg_join(later, carry).v;
    if (threadIdx.x == 0) chunk = seg_join(mine, later);
    __syncthreads();
    carry = seg_join(chunk, carry);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
sum_finish(const uint8_t* __restrict__ flags, const int* __restrict__ weights,
           const int* __restrict__ tile_carry, int64_t n,
           int* __restrict__ total, uint8_t* __restrict__ head) {
  __shared__ Seg warp_buf[kThreads / 32];
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kItems;
  const uchar4 f4 = *reinterpret_cast<const uchar4*>(flags + base);
  const uint8_t f[kItems] = {f4.x, f4.y, f4.z, f4.w};
  int wt[kItems];
  Seg mine{0, 0};
  for (int j = kItems - 1; j >= 0; --j) {
    const int64_t i = base + j;
    wt[j] = (i < n && !(f[j] & 2)) ? weights[i] : 0;
    mine = seg_join(Seg{(f[j] & 1) ? 0 : wt[j], f[j] & 1}, mine);
  }
  const Seg later = block_suffix_excl<kThreads>(mine, warp_buf);
  // The weight right of my last slot that continues the run it is in.
  int right = seg_join(later, Seg{tile_carry[blockIdx.x], 1}).v;
  for (int j = kItems - 1; j >= 0; --j) {
    const int64_t i = base + j;
    if (i < n) {
      const bool is_head = f[j] == 1;  // a boundary that is not a sentinel
      total[i] = is_head ? wt[j] + right : 0;
      head[i] = is_head;
    }
    right = (f[j] & 1) ? 0 : wt[j] + right;
  }
}

}  // namespace

// Scratch in bytes: flags padded to whole tiles, then tile_v, tile_f and
// tile_carry (int32 each).
extern "C" int64_t hk_run_length_sum_scratch(int64_t n) {
  const int64_t num_tiles = (n + kTile - 1) / kTile;
  return num_tiles * kTile + 3 * num_tiles * static_cast<int64_t>(sizeof(int));
}

// words: n_words device pointers to sorted (n,) uint32 rows; weights (n,)
// int32; head (n,) bool and total (n,) int32 out; scratch of
// hk_run_length_sum_scratch(n) bytes. Returns cudaGetLastError() of the
// first failing launch, else 0.
extern "C" int hk_run_length_sum(void* const* words, int n_words,
                                 const void* weights, int64_t n, void* head,
                                 void* total, void* scratch, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || n_words < 1 ||
      n_words > kMaxWords) {
    return cudaErrorInvalidValue;
  }
  const int num_tiles = static_cast<int>((n + kTile - 1) / kTile);
  auto* flags = static_cast<uint8_t*>(scratch);
  int* tile_v = reinterpret_cast<int*>(flags + static_cast<int64_t>(num_tiles) * kTile);
  int* tile_f = tile_v + num_tiles;
  int* tile_carry = tile_f + num_tiles;
  WordRows rows{};
  for (int w = 0; w < n_words; ++w) {
    rows.row[w] = static_cast<const uint32_t*>(words[w]);
  }
  const auto* wts = static_cast<const int*>(weights);
  const auto s = static_cast<cudaStream_t>(stream);
  sum_flags<<<num_tiles, kThreads, 0, s>>>(rows, n_words, wts, n, flags,
                                           tile_v, tile_f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_tile_carry<<<1, kCarryThreads, 0, s>>>(tile_v, tile_f, num_tiles,
                                             tile_carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_finish<<<num_tiles, kThreads, 0, s>>>(flags, wts, tile_carry, n,
                                            static_cast<int*>(total),
                                            static_cast<uint8_t*>(head));
  return static_cast<int>(cudaGetLastError());
}
