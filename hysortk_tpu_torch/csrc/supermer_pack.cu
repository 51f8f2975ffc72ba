// The supermer send tensor: each destination's runs gathered from the
// rank's base codes and packed 2 bits a base straight into its segment of
// the exchange, with the runs' lengths (and, in extension mode, their read
// ids and in-read positions) beside them.
//
// No TPU kernel: the JAX package gathers the runs and packs the segments on
// the host (hysortk_tpu/io/supermer.py encode_supermer_streams[_ext], then
// parallel/supermer_route.py _pack_streams / _prepare_exchange_arrays), and
// so did the port until this kernel (io/supermer's encoders with the host
// library's hk_gather_runs, then supermer_route._segments). The result is
// the tensor `_segments` builds, bit for bit: (S, width) int32, width = nw +
// lmax (x3 in extension mode); row s holds destination s's runs, in
// ascending flat order, as
//   words [0, nw)            16 bases a word, big-endian (base b of the
//                            segment at shift 30 - 2 * (b % 16)), zero past
//                            the last run's last base;
//   [nw, nw + lmax)          each run's length in bases, then zeros;
//   [nw + lmax, + 2 lmax)    extension mode: each run's first read id;
//   [nw + 2 lmax, + 3 lmax)  extension mode: each run's first in-read
//                            position (uint32 bits).
// The per-destination bookkeeping (runs grouped by destination in flat
// order, each run's base offset in its segment, the destinations' run
// bounds) comes from the run-layout kernel (csrc/supermer_runs.cu, through
// ops/supermer.run_layout); a destination's runs lie back to back in its
// segment from offset 0.
//
// One launch, grid (tiles, S), every output word written exactly once, the
// padding included: no memset.
//   * A word block owns 1024 words (16384 bases) of one destination's row,
//     4 a thread, a warp's 32 words adjacent. Two warps find the runs that
//     hold its first and last base by a 32-way search over the
//     destination's offsets (a few rounds of 32 loads), then the block
//     stages those runs (at most 1024: offsets and ends relative to the
//     tile as int32, source - offset as int64) in shared memory. A thread
//     finds its word's run there by a binary search. A word inside one
//     stretch of the source (its runs share src - off, as adjacent reads'
//     runs do) takes its 16 codes from two aligned 16-byte loads, a byte
//     permute and a multiply that packs four codes at once; any other word
//     (a run edge between unrelated sources, the last run's end) takes its
//     codes one by one. A tile of more runs searches them in global memory.
//   * A column block owns 1024 entries of one column group of a row: the
//     row's run lengths (or read ids, or positions) by coalesced int32
//     loads, zeros past the destination's runs; no 64-bit divide.
//
// Bound on the H100: HBM bytes. In: the bases the runs cover, each once
// (1 B each; the k - 1 bases a run shares with the run before it come from
// cache), the per-run rows (src, off and length: 20 B a run; 28 B with the
// extension-mode headers) and the destinations' bounds. Out: the send
// tensor (1/4 B a base plus the columns).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 8;                           // words a thread
constexpr int kTileWords = kThreads * kWords;       // words a word block
constexpr int kTileBases = kTileWords * 16;         // bases a word block
constexpr int kStaged = 1024;                       // runs a word block stages
constexpr int kColumns = kThreads * 4;              // entries a column block
constexpr unsigned kAllLanes = 0xFFFFFFFFu;

struct Runs {
  const int64_t* src;    // first base of each run in the codes
  const int64_t* off;    // its first base in its destination's segment
  const int32_t* bases;  // its length in bases
  const int32_t* rid0;   // extension mode: its first read id, else null
  const int32_t* pos0;   // extension mode: its first in-read position
  const int64_t* dest_begin;  // (S + 1,) the runs of destination s
};

// The first index f in [lo, hi) with off[f] > x (hi if none), off
// ascending: a warp's 32-way search, every lane returns f. Lane l probes
// the (l + 1)-th of 32 evenly spaced indices; the probes at or below x are
// a prefix of the lanes, and the answer lies in the step after the last.
__device__ __forceinline__ int64_t warp_first_after(const int64_t* off, int64_t lo,
                                                    int64_t hi, int64_t x) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + step * (lane + 1) - 1;
    const bool le = probe < hi && __ldg(off + probe) <= x;
    const int c = __popc(__ballot_sync(kAllLanes, le));
    const int64_t next_hi = lo + step * (c + 1) - 1;
    lo += step * c;
    hi = next_hi < hi ? next_hi : hi;
  }
  return lo;
}

// A tile's runs j = 0 .. count - 1 (run first + j of the layout): offset
// and end relative to the tile's first base, clamped to [0, kTileBases],
// and src - off. From shared memory, or from global memory (a tile of more
// runs than kStaged).
struct SharedRuns {
  const int32_t* off;
  const int32_t* end;
  const int64_t* shift;
  __device__ __forceinline__ int32_t off_at(int j) const { return off[j]; }
  __device__ __forceinline__ int32_t end_at(int j) const { return end[j]; }
  __device__ __forceinline__ int64_t shift_at(int j) const { return shift[j]; }
};

__device__ __forceinline__ int32_t clamp_tile(int64_t x) {
  return static_cast<int32_t>(x < 0 ? 0 : x > kTileBases ? kTileBases : x);
}

struct GlobalRuns {
  const int64_t* off;  // each pointer at the tile's first run
  const int32_t* bases;
  const int64_t* src;
  int64_t tile0;
  __device__ __forceinline__ int32_t off_at(int j) const {
    return clamp_tile(__ldg(off + j) - tile0);
  }
  __device__ __forceinline__ int32_t end_at(int j) const {
    return clamp_tile(__ldg(off + j) + __ldg(bases + j) - tile0);
  }
  __device__ __forceinline__ int64_t shift_at(int j) const {
    return __ldg(src + j) - __ldg(off + j);
  }
};

// Four codes (the low bytes of x, first code lowest) -> one byte, the first
// code in its top two bits: each masked code times 2^30 + 2^20 + 2^10 + 1
// lands at bits 30 - 2 i of the product; the other terms stay below bit 24.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 0x03030303u) * 0x40100401u) >> 24;
}

// The two aligned 16-byte pieces that hold codes[q .. q + 15] (the second
// only when q is not aligned: it then holds codes[q + 15], so it lies
// inside the codes' allocation), and q's offset in the first.
struct Pieces {
  uint4 x, y;
  int o;
};

__device__ __forceinline__ Pieces load_pieces(const int8_t* codes, int64_t q) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(codes + q);
  const uint4* piece = reinterpret_cast<const uint4*>(at & ~uintptr_t{15});
  Pieces p;
  p.o = static_cast<int>(at & 15u);
  p.x = __ldg(piece);
  p.y = p.o ? __ldg(piece + 1) : make_uint4(0u, 0u, 0u, 0u);
  return p;
}

// The 16 codes of the pieces as one send word: the word-aligned window by
// selects, its bytes by a byte permute, four codes a byte by pack4.
__device__ __forceinline__ uint32_t assemble(const Pieces& p) {
  const uint32_t w[8] = {p.x.x, p.x.y, p.x.z, p.x.w, p.y.x, p.y.y, p.y.z, p.y.w};
  const int s = p.o >> 2;
  uint32_t v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    v[i] = s == 0 ? w[i] : s == 1 ? w[i + 1] : s == 2 ? w[i + 2] : w[i + 3];
  }
  const unsigned select = 0x3210u + 0x1111u * static_cast<unsigned>(p.o & 3);
  uint32_t word = 0;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    word |= pack4(__byte_perm(v[g], v[g + 1], select)) << (24 - 8 * g);
  }
  return word;
}

// The last of the tile's `count` runs that starts at or before p (-1 if
// none).
template <class TileRuns>
__device__ __forceinline__ int run_at(const TileRuns& runs, int count, int p) {
  int a = 0, b = count;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (runs.off_at(mid) <= p) a = mid + 1; else b = mid;
  }
  return a - 1;
}

// The send word whose 16 bases start at p0 (relative to the tile), of the
// tile's `count` runs, j the run that holds p0 (-1: past the destination's
// runs).
template <class TileRuns>
__device__ __forceinline__ uint32_t pack_word(const TileRuns& runs, int count, int j, int p0,
                                              int64_t tile0, const int8_t* codes) {
  if (j < 0) return 0u;
  // The runs that hold p0 .. p0 + 15 read one stretch of the source when
  // they share src - off and the last reaches p0 + 15.
  const int64_t shift = runs.shift_at(j);
  int last = j;
  bool stretch = true;
  while (last + 1 < count && runs.off_at(last + 1) <= p0 + 15) {
    ++last;
    stretch = stretch && runs.shift_at(last) == shift;
  }
  if (stretch && p0 + 15 < runs.end_at(last)) {
    return assemble(load_pieces(codes, shift + tile0 + p0));
  }
  // Base by base: each from the run that holds it, zero past the
  // destination's last run.
  int run_end = runs.end_at(j);
  int64_t run_shift = shift;
  uint32_t word = 0;
  for (int i = 0; i < 16; ++i) {
    const int p = p0 + i;
    while (p >= run_end && j < last) {
      ++j;
      run_end = runs.end_at(j);
      run_shift = runs.shift_at(j);
    }
    if (p >= run_end) break;
    const uint32_t code = static_cast<uint32_t>(__ldg(codes + run_shift + tile0 + p)) & 3u;
    word |= code << (30 - 2 * i);
  }
  return word;
}

__global__ void __launch_bounds__(kThreads)
pack_segments(const int8_t* __restrict__ codes, Runs runs, int64_t nw, int64_t lmax,
              int64_t width, unsigned word_tiles, unsigned col_tiles,
              int32_t* __restrict__ send) {
  __shared__ int32_t s_off[kStaged];
  __shared__ int32_t s_end[kStaged];
  __shared__ int64_t s_shift[kStaged];
  __shared__ int16_t s_run[kTileWords];
  __shared__ int64_t s_bounds[2];
  const int64_t s = blockIdx.y;
  const int64_t lo = __ldg(runs.dest_begin + s);
  const int64_t hi = __ldg(runs.dest_begin + s + 1);
  int32_t* row = send + s * width;

  if (blockIdx.x >= word_tiles) {
    // Column entries: group `which` (lengths, read ids, positions), ranks
    // [first, first + kColumns).
    const unsigned cx = blockIdx.x - word_tiles;
    const unsigned which = cx / col_tiles;
    const int64_t first = static_cast<int64_t>(cx - which * col_tiles) * kColumns;
    const int32_t* src = which == 0 ? runs.bases : which == 1 ? runs.rid0 : runs.pos0;
    int32_t* out = row + nw + which * lmax;
#pragma unroll
    for (int q = 0; q < kColumns / kThreads; ++q) {
      const int64_t r = first + q * kThreads + threadIdx.x;
      if (r < lmax) out[r] = r < hi - lo ? __ldg(src + lo + r) : 0;
    }
    return;
  }

  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTileWords;
  const int64_t tile0 = w0 * 16;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    // Warp 0: the first run past the tile's first base; warp 1: the first
    // run past its last. The tile's runs lie between them.
    const int64_t tile_last = (w0 + kTileWords < nw ? w0 + kTileWords : nw) * 16 - 1;
    const int64_t f = warp_first_after(runs.off, lo, hi, warp == 0 ? tile0 : tile_last);
    if ((threadIdx.x & 31) == 0) s_bounds[warp] = f;
  }
  for (int lw = threadIdx.x; lw < kTileWords; lw += kThreads) s_run[lw] = -1;
  __syncthreads();
  const int64_t first = s_bounds[0] - 1 < lo ? lo : s_bounds[0] - 1;
  const int64_t count = s_bounds[1] - first > 0 ? s_bounds[1] - first : 0;
  const int n = static_cast<int>(count);
  if (count <= kStaged) {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int64_t off = __ldg(runs.off + first + j);
      const int32_t rel_off = clamp_tile(off - tile0);
      const int32_t rel_end = clamp_tile(off + __ldg(runs.bases + first + j) - tile0);
      s_off[j] = rel_off;
      s_end[j] = rel_end;
      s_shift[j] = __ldg(runs.src + first + j) - off;
      // The words whose first base this run holds (runs lie back to back,
      // so each word below the last run's end is marked once).
      for (int lw = (rel_off + 15) >> 4; lw < (rel_end + 15) >> 4; ++lw) {
        s_run[lw] = static_cast<int16_t>(j);
      }
    }
    __syncthreads();
    const SharedRuns shared_runs{s_off, s_end, s_shift};
#pragma unroll 1
    for (int q = 0; q < kWords; ++q) {
      const int lw = q * kThreads + threadIdx.x;
      if (w0 + lw >= nw) break;
      row[w0 + lw] = static_cast<int32_t>(
          pack_word(shared_runs, n, s_run[lw], 16 * lw, tile0, codes));
    }
  } else {
    const GlobalRuns global_runs{runs.off + first, runs.bases + first, runs.src + first,
                                 tile0};
#pragma unroll 1
    for (int q = 0; q < kWords; ++q) {
      const int lw = q * kThreads + threadIdx.x;
      if (w0 + lw >= nw) break;
      int j = run_at(global_runs, n, 16 * lw);
      if (j >= 0 && 16 * lw >= global_runs.end_at(j)) j = -1;
      row[w0 + lw] = static_cast<int32_t>(
          pack_word(global_runs, n, j, 16 * lw, tile0, codes));
    }
  }
}

}  // namespace

// codes: (n,) int8; src, off: (R,) int64; bases, rid0, pos0: (R,) int32
// (rid0 and pos0 null unless extension mode); dest_begin: (S + 1,) int64;
// send: (S, width) int32 with width = nw + lmax * (ext ? 3 : 1). All device
// pointers; 1 <= S <= 65535. Returns cudaGetLastError().
extern "C" int hk_supermer_pack(const void* codes, const void* src, const void* off,
                                const void* bases, const void* rid0, const void* pos0,
                                const void* dest_begin, int64_t num_dest, int64_t nw,
                                int64_t lmax, int ext, void* send, void* stream) {
  const int64_t groups = ext ? 3 : 1;
  const int64_t width = nw + lmax * groups;
  const int64_t word_tiles = (nw + kTileWords - 1) / kTileWords;
  const int64_t col_tiles = (lmax + kColumns - 1) / kColumns;
  if (num_dest < 1 || num_dest > 65535 || nw < 1 || lmax < 1 ||
      word_tiles + groups * col_tiles >= (int64_t{1} << 31) ||
      (ext && (!rid0 || !pos0))) {
    return cudaErrorInvalidValue;
  }
  const Runs runs{static_cast<const int64_t*>(src), static_cast<const int64_t*>(off),
                  static_cast<const int32_t*>(bases), static_cast<const int32_t*>(rid0),
                  static_cast<const int32_t*>(pos0),
                  static_cast<const int64_t*>(dest_begin)};
  const dim3 grid(static_cast<unsigned>(word_tiles + groups * col_tiles),
                  static_cast<unsigned>(num_dest));
  pack_segments<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), runs, nw, lmax, width,
      static_cast<unsigned>(word_tiles), static_cast<unsigned>(col_tiles),
      static_cast<int32_t*>(send));
  return static_cast<int>(cudaGetLastError());
}
