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
// partial sum in a scalar across the sequential grid. Here all tiles run at
// once, in one kernel. The sum is one reverse segmented scan with the
// operator
//   (v, f) . (v', f') = (f ? v : v + v', f || f')        (left . right)
// over slots, where a slot is (boundary ? 0 : weight, boundary): the v of an
// aggregate is the weight that continues a run ending just left of it. The
// scan's carry between tiles travels by a decoupled look-back that runs
// right to left (lookback.cuh, 64-bit descriptors: status and sum): a tile
// with a boundary publishes its v at once and waits for nobody; a tile
// without one publishes its aggregate and adds what it finds to its right.
//
// One tile is 256 threads x 16 slots, the count's layout (fused_count.cu):
//   1. the weights and every word row are read once, 16 bytes a thread, four
//      loads a row in flight; boundary and sentinel bits come from
//      run_bits.cuh; sentinel slots weigh 0;
//   2. per vector of 128 slots a thread folds its 4 slots, and the warp
//      scans the lanes' aggregates by 5 shuffles (the flags by one ballot);
//      the warps' aggregates meet in shared memory (one barrier), warp 0
//      publishes the tile's and looks right (second barrier);
//   3. each thread walks its 16 slots right to left with the weight to
//      their right and writes total as int4 and head as uchar4.
// No head walks forward over its run, so a 10^6-slot run costs the same per
// slot as anything else; a look-back over a long run steps over 32 tiles
// per read. All sums are uint32 (wrapping), cast to int32 at the store.
//
// A full tile whose rows are 16-byte aligned takes the body above without a
// bounds test. The last tile, and every tile of rows that are not aligned
// (views at odd offsets), take the same body with guarded 4-byte loads and
// stores.
//
// Bound on the H100: HBM bytes, 4W + 4 B/slot in (words, weights), 5 B/slot
// out (total int32 + head bool), moved once each; scratch is a ticket and 8
// bytes per tile.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "run_bits.cuh"

namespace {

struct SumShared {
  unsigned warp_v[kWarps];  // each warp's aggregate: (v, f)
  unsigned warp_f[kWarps];
  unsigned right;           // the weight right of the tile that continues its last run
  int tile;
};

// The v of (v, f) . (right, 1): the weight that continues a run ending just
// left of a stretch whose aggregate is (v, f), given the stretch's right.
__device__ __forceinline__ unsigned extend(unsigned v, bool f, unsigned right) {
  return f ? v : v + right;
}

template <int W, bool kFast>
__device__ __forceinline__ void sum_tile(const WordRows& words,
                                         const uint32_t* __restrict__ weights,
                                         int64_t n, int tile, int num_tiles,
                                         int* __restrict__ total,
                                         uint8_t* __restrict__ head,
                                         uint64_t* desc, SumShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t warp_base =
      static_cast<int64_t>(tile) * kTile + warp * kWarpSlots;
  // The weights first, so that their loads are in flight while the word
  // rows are read.
  uint32_t wt[kVecs][4];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    load4<kFast>(weights, warp_base + v * kVecSlots + 4 * lane, n, wt[v]);
  }
  // Bit 4v + e of each mask: slot warp_base + 128 v + 4 lane + e.
  unsigned boundary, sentinel;
  boundary_bits<W, kFast>(words, n, warp_base, boundary, sentinel);

  // Per vector: the lanes with a boundary, the aggregate of the lanes after
  // mine (v only: its f is a test of `flags`), and the vector's aggregate.
  unsigned flags[kVecs], after[kVecs], vec_v[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    unsigned mine = 0;
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const int bit = 4 * v + e;
      if ((sentinel >> bit) & 1u) wt[v][e] = 0;
      mine = (boundary >> bit) & 1u ? 0u : wt[v][e] + mine;
    }
    flags[v] = __ballot_sync(kFull, ((boundary >> (4 * v)) & 15u) != 0);
    // Inclusive over lanes lane .. 31: after the step of width o, lanes
    // lane .. lane + 2o - 1.
    unsigned incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_down_sync(kFull, incl, o);
      const unsigned covered = (flags[v] >> lane) & ((1u << o) - 1u);
      if (lane + o < 32 && covered == 0) incl += y;
    }
    after[v] = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) after[v] = 0;
    vec_v[v] = __shfl_sync(kFull, incl, 0);
  }
  unsigned warp_v = 0;
#pragma unroll
  for (int v = kVecs - 1; v >= 0; --v) warp_v = extend(vec_v[v], flags[v] != 0, warp_v);
  if (lane == 0) {
    sh.warp_v[warp] = warp_v;
    sh.warp_f[warp] = (flags[0] | flags[1] | flags[2] | flags[3]) != 0;
  }
  __syncthreads();

  if (warp == 0) {
    unsigned tile_v = 0;
    bool tile_f = false;
#pragma unroll
    for (int w = kWarps - 1; w >= 0; --w) {
      tile_v = extend(sh.warp_v[w], sh.warp_f[w], tile_v);
      tile_f = tile_f || sh.warp_f[w];
    }
    if (lane == 0) {
      lookback::publish_sum(desc, tile,
                            tile_f ? lookback::kSumInclusive : lookback::kSumAggregate,
                            tile_v);
    }
    const unsigned right = lookback::walk_right_sum(desc, tile, num_tiles);
    if (lane == 0) {
      if (!tile_f) lookback::publish_sum(desc, tile, lookback::kSumInclusive, tile_v + right);
      sh.right = right;
    }
  }
  __syncthreads();

  // The weight after this warp's slots that continues its last run.
  unsigned carry = sh.right;
  for (int w = kWarps - 1; w > warp; --w) carry = extend(sh.warp_v[w], sh.warp_f[w], carry);
#pragma unroll
  for (int v = kVecs - 1; v >= 0; --v) {
    const int64_t pos0 = warp_base + v * kVecSlots + 4 * lane;
    unsigned right = extend(after[v], ((flags[v] >> lane) >> 1) != 0, carry);
    int t[4];
    uint8_t h[4];
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const bool is_boundary = (boundary >> (4 * v + e)) & 1u;
      const bool is_head = is_boundary && !((sentinel >> (4 * v + e)) & 1u);
      t[e] = is_head ? static_cast<int>(wt[v][e] + right) : 0;
      h[e] = is_head;
      right = is_boundary ? 0u : wt[v][e] + right;
    }
    if (kFast) {
      *reinterpret_cast<int4*>(total + pos0) = make_int4(t[0], t[1], t[2], t[3]);
      *reinterpret_cast<uchar4*>(head + pos0) = make_uchar4(h[0], h[1], h[2], h[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (pos0 + e < n) {
          total[pos0 + e] = t[e];
          head[pos0 + e] = h[e];
        }
      }
    }
    carry = extend(vec_v[v], flags[v] != 0, carry);
  }
}

// aligned: every row, the weights, total and head may be read and written
// 16 (head: 4) bytes at a time.
template <int W>
__global__ void __launch_bounds__(kThreads)
sum_kernel(const __grid_constant__ WordRows words, const uint32_t* __restrict__ weights,
           int64_t n, int num_tiles, int aligned, int* __restrict__ total,
           uint8_t* __restrict__ head, unsigned* ticket, uint64_t* desc) {
  __shared__ SumShared sh;
  if (threadIdx.x == 0) sh.tile = lookback::take_tile(ticket, num_tiles);
  __syncthreads();
  const int tile = sh.tile;
  if (aligned && (static_cast<int64_t>(tile) + 1) * kTile <= n) {
    sum_tile<W, true>(words, weights, n, tile, num_tiles, total, head, desc, sh);
  } else {
    sum_tile<W, false>(words, weights, n, tile, num_tiles, total, head, desc, sh);
  }
}

template <int W>
cudaError_t launch(const WordRows& rows, const void* weights, int64_t n,
                   int num_tiles, int aligned, void* total, void* head,
                   const lookback::Scratch<uint64_t>& sc, cudaStream_t s) {
  sum_kernel<W><<<num_tiles, kThreads, 0, s>>>(
      rows, static_cast<const uint32_t*>(weights), n, num_tiles, aligned,
      static_cast<int*>(total), static_cast<uint8_t*>(head), sc.ticket, sc.desc);
  return cudaGetLastError();
}

}  // namespace

// Scratch in bytes: the look-back's ticket and one 64-bit descriptor per
// tile.
extern "C" int64_t hk_run_length_sum_scratch(int64_t n) {
  return lookback::scratch_bytes<uint64_t>(tiles_of(n));
}

// words: n_words device pointers to sorted (n,) uint32 rows; weights (n,)
// int32; head (n,) bool and total (n,) int32 out; scratch of
// hk_run_length_sum_scratch(n) bytes. Returns the first CUDA error of the
// reset or the launch, else 0.
extern "C" int hk_run_length_sum(void* const* words, int n_words,
                                 const void* weights, int64_t n, void* head,
                                 void* total, void* scratch, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || n_words < 1 ||
      n_words > kMaxWords) {
    return cudaErrorInvalidValue;
  }
  const int num_tiles = static_cast<int>(tiles_of(n));
  WordRows rows{};
  for (int w = 0; w < n_words; ++w) {
    rows.row[w] = static_cast<const uint32_t*>(words[w]);
  }
  const int aligned = rows_aligned(
      rows, n_words,
      reinterpret_cast<uintptr_t>(weights) | reinterpret_cast<uintptr_t>(total) |
          (reinterpret_cast<uintptr_t>(head) << 2));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = lookback::carve<uint64_t>(scratch);
  cudaError_t err = lookback::reset<uint64_t>(scratch, num_tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (n_words) {
    case 1: err = launch<1>(rows, weights, n, num_tiles, aligned, total, head, sc, s); break;
    case 2: err = launch<2>(rows, weights, n, num_tiles, aligned, total, head, sc, s); break;
    case 3: err = launch<3>(rows, weights, n, num_tiles, aligned, total, head, sc, s); break;
    case 4: err = launch<4>(rows, weights, n, num_tiles, aligned, total, head, sc, s); break;
    case 5: err = launch<5>(rows, weights, n, num_tiles, aligned, total, head, sc, s); break;
    case 6: err = launch<6>(rows, weights, n, num_tiles, aligned, total, head, sc, s); break;
  }
  return static_cast<int>(err);
}
