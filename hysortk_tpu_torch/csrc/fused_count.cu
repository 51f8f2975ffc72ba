// Run-length count + [L, U] filter over sorted, sentinel-marked key words.
//
// Replaces hysortk_tpu/ops/pallas_count.py run_length_count_filter
// (_count_kernel), with its exact semantics: a run boundary is at i = 0 or
// wherever any word differs from slot i-1; the first sentinel slot is a
// boundary (it ends the last real run) and is never a head; at a head
// cnt = next boundary - i, else 0; keep = head && lower <= cnt <= upper.
//
// The TPU kernel walks its blocks right to left and carries "first boundary
// to the right" in a scalar across the sequential grid. Here all tiles run
// at once, in one kernel, and the carry travels by a decoupled look-back
// that runs right to left (lookback.cuh): a tile publishes its own first
// boundary, or "none" and then what it found further right. A tile with a
// boundary waits for nobody; only the last boundary of a tile needs the
// carry at all.
//
// One tile is 256 threads x 16 slots:
//   1. every word row is read once, 16 bytes a thread, into 16 boundary and
//      16 sentinel bits in registers (run_bits.cuh, shared with
//      run_length_sum.cu);
//   2. a warp finds, per vector of 128 slots, every lane's next boundary in
//      a later lane by one ballot and one shuffle, and the vector's first
//      boundary; the warps' first boundaries meet in shared memory (one
//      barrier), warp 0 publishes the tile's and looks right (second
//      barrier);
//   3. each thread walks its 16 slots right to left and writes cnt as int4
//      and keep as uchar4.
// No head walks forward over its run, so a poly-A run or the sentinel tail
// costs the same per slot as anything else; a look-back over a long run
// steps over 32 tiles per read.
//
// A full tile whose rows are 16-byte aligned takes the body above without a
// bounds test. The last tile, and every tile of rows that are not aligned
// (views at odd offsets), take the same body with guarded 4-byte loads and
// stores.
//
// Bound on the H100: HBM bytes, 4W B/slot in, 5 B/slot out (cnt int32 + keep
// bool), moved once each; scratch is one word per tile.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"
#include "run_bits.cuh"

namespace {

constexpr unsigned kNoBoundary = 0xFFFFFFFFu;  // above every position

struct CountShared {
  unsigned warp_first[kWarps];  // each warp's first boundary
  unsigned right;               // the first boundary right of the tile
  int tile;
};

// One tile. Positions are unsigned 32-bit: n < 2^31, and a ragged last
// tile's slots past n stay below 2^31 + kTile.
template <int W, bool kFast>
__device__ __forceinline__ void count_tile(const WordRows& words, int64_t n,
                                           int tile, int num_tiles, int lower,
                                           int upper, int* __restrict__ cnt,
                                           uint8_t* __restrict__ keep,
                                           unsigned* desc, CountShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t warp_base =
      static_cast<int64_t>(tile) * kTile + warp * kWarpSlots;
  // Bit 4v + e of each mask: slot warp_base + 128 v + 4 lane + e. No
  // boundary past n: the carry of the last tile is n itself.
  unsigned boundary, sentinel;
  boundary_bits<W, kFast>(words, n, warp_base, boundary, sentinel);

  // Within each vector: my next boundary in a later lane, and the vector's
  // first boundary.
  const unsigned pos_base = static_cast<unsigned>(warp_base);
  unsigned next_lane[kVecs], vec_first[kVecs];
  unsigned warp_first = kNoBoundary;
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const unsigned bits = (boundary >> (4 * v)) & 15u;
    const int first_e = __ffs(bits) - 1;
    const unsigned lanes = __ballot_sync(kFull, bits != 0);
    const unsigned later = lanes & (0xFFFFFFFEu << lane);
    const int next = __ffs(later) - 1;
    const int lowest = __ffs(lanes) - 1;
    const int next_e = __shfl_sync(kFull, first_e, next & 31);
    const int lowest_e = __shfl_sync(kFull, first_e, lowest & 31);
    const unsigned vec_base = pos_base + v * kVecSlots;
    next_lane[v] = later ? vec_base + 4 * next + next_e : kNoBoundary;
    vec_first[v] = lanes ? vec_base + 4 * lowest + lowest_e : kNoBoundary;
    warp_first = min(warp_first, vec_first[v]);
  }
  if (lane == 0) sh.warp_first[warp] = warp_first;
  __syncthreads();

  if (warp == 0) {
    unsigned first = lane < kWarps ? sh.warp_first[lane] : kNoBoundary;
    first = __reduce_min_sync(kFull, first);
    if (lane == 0) {
      if (first != kNoBoundary) {
        lookback::publish_value(desc, tile, first);
      } else {
        lookback::publish_none(desc, tile);
      }
    }
    const unsigned right =
        lookback::walk_right(desc, tile, num_tiles, static_cast<unsigned>(n));
    if (lane == 0) {
      if (first == kNoBoundary) lookback::publish_value(desc, tile, right);
      sh.right = right;
    }
  }
  __syncthreads();

  // The first boundary after this warp's slots.
  unsigned carry = sh.right;
  for (int w = kWarps - 1; w > warp; --w) {
    const unsigned f = sh.warp_first[w];
    if (f != kNoBoundary) carry = f;
  }
#pragma unroll
  for (int v = kVecs - 1; v >= 0; --v) {
    const unsigned pos0 = pos_base + v * kVecSlots + 4 * lane;
    unsigned next = next_lane[v] != kNoBoundary ? next_lane[v] : carry;
    int c[4];
    uint8_t k[4];
#pragma unroll
    for (int e = 3; e >= 0; --e) {
      const bool is_boundary = (boundary >> (4 * v + e)) & 1u;
      const bool head = is_boundary && !((sentinel >> (4 * v + e)) & 1u);
      c[e] = head ? static_cast<int>(next - (pos0 + e)) : 0;
      k[e] = head && c[e] >= lower && c[e] <= upper;
      if (is_boundary) next = pos0 + e;
    }
    if (kFast) {
      *reinterpret_cast<int4*>(cnt + pos0) = make_int4(c[0], c[1], c[2], c[3]);
      *reinterpret_cast<uchar4*>(keep + pos0) = make_uchar4(k[0], k[1], k[2], k[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (static_cast<int64_t>(pos0) + e < n) {
          cnt[pos0 + e] = c[e];
          keep[pos0 + e] = k[e];
        }
      }
    }
    if (vec_first[v] != kNoBoundary) carry = vec_first[v];
  }
}

// aligned: every row, cnt and keep may be read and written 16 (keep: 4)
// bytes at a time.
template <int W>
__global__ void __launch_bounds__(kThreads)
count_kernel(const __grid_constant__ WordRows words, int64_t n, int num_tiles,
             int aligned, int lower, int upper, int* __restrict__ cnt,
             uint8_t* __restrict__ keep, unsigned* ticket, unsigned* desc) {
  __shared__ CountShared sh;
  if (threadIdx.x == 0) sh.tile = lookback::take_tile(ticket, num_tiles);
  __syncthreads();
  const int tile = sh.tile;
  if (aligned && (static_cast<int64_t>(tile) + 1) * kTile <= n) {
    count_tile<W, true>(words, n, tile, num_tiles, lower, upper, cnt, keep, desc, sh);
  } else {
    count_tile<W, false>(words, n, tile, num_tiles, lower, upper, cnt, keep, desc, sh);
  }
}

template <int W>
cudaError_t launch(const WordRows& rows, int64_t n, int num_tiles, int aligned,
                   int lower, int upper, void* cnt, void* keep,
                   const lookback::Scratch<unsigned>& sc, cudaStream_t s) {
  count_kernel<W><<<num_tiles, kThreads, 0, s>>>(
      rows, n, num_tiles, aligned, lower, upper, static_cast<int*>(cnt),
      static_cast<uint8_t*>(keep), sc.ticket, sc.desc);
  return cudaGetLastError();
}

}  // namespace

// Scratch in bytes: the look-back's ticket and one descriptor per tile.
extern "C" int64_t hk_fused_count_scratch(int64_t n) {
  return lookback::scratch_bytes<unsigned>(tiles_of(n));
}

// words: n_words device pointers to sorted (n,) uint32 rows; cnt (n,) int32
// and keep (n,) bool out; scratch of hk_fused_count_scratch(n) bytes.
// Returns the first CUDA error of the reset or the launch, else 0.
extern "C" int hk_fused_count(void* const* words, int n_words, int64_t n,
                              int lower, int upper, void* cnt, void* keep,
                              void* scratch, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || n_words < 1 ||
      n_words > kMaxWords) {
    return cudaErrorInvalidValue;
  }
  const int num_tiles = static_cast<int>(tiles_of(n));
  WordRows rows{};
  for (int w = 0; w < n_words; ++w) {
    rows.row[w] = static_cast<const uint32_t*>(words[w]);
  }
  const int aligned = rows_aligned(rows, n_words,
                                   reinterpret_cast<uintptr_t>(cnt) |
                                       (reinterpret_cast<uintptr_t>(keep) << 2));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = lookback::carve<unsigned>(scratch);
  cudaError_t err = lookback::reset<unsigned>(scratch, num_tiles, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (n_words) {
    case 1: err = launch<1>(rows, n, num_tiles, aligned, lower, upper, cnt, keep, sc, s); break;
    case 2: err = launch<2>(rows, n, num_tiles, aligned, lower, upper, cnt, keep, sc, s); break;
    case 3: err = launch<3>(rows, n, num_tiles, aligned, lower, upper, cnt, keep, sc, s); break;
    case 4: err = launch<4>(rows, n, num_tiles, aligned, lower, upper, cnt, keep, sc, s); break;
    case 5: err = launch<5>(rows, n, num_tiles, aligned, lower, upper, cnt, keep, sc, s); break;
    case 6: err = launch<6>(rows, n, num_tiles, aligned, lower, upper, cnt, keep, sc, s); break;
  }
  return static_cast<int>(err);
}
