// The stable LSD radix sort's two kernels: one histogram of every digit up
// front, then one kernel per 8-bit digit that reads the data once.
//
// Shared by radix_sort.cu, whose elements lie in key and payload rows in
// device memory, and fused_sort.cu, whose first pass derives each element's
// key from the base codes instead. Together they replace the TPU's bitonic
// network (hysortk_tpu/ops/pallas_msort.py block_sort_member /
// block_sort_keybuild and pallas_sort.py merge_levels); nothing of that
// network's layout is carried over. dest_pack.cu runs one pass of it, with
// the destination rank as its only digit and no histogram (each
// destination's output starts at a fixed place).
//
// Bound on the H100: bytes. A sort of R rows of which W are key words moves at
// least 4W B/slot for the histogram and 4W passes x 8R B/slot: each pass must
// read and write every row once. The design keeps each pass at exactly that:
//
//   histogram_tiles  reads the key words once and counts all 4W digits into
//                    shared-memory histograms (a warp whose 32 keys are
//                    equal, as in the sentinel tail or a poly-A run, adds 32
//                    with one atomic per digit instead of serialising 32 on
//                    one address), added to 4W x 256 global counters at the
//                    block's end. Their exclusive scan, which every pass
//                    block recomputes from the 256 counters of its pass (1
//                    KB from L2), is each digit's first output slot.
//   radix_pass_tile  one block per tile of kThreads x kItems elements:
//     1. the tile id is a ticket from an atomic counter, so every earlier
//        tile is running or done whatever order blocks are scheduled in;
//     2. each warp loads a contiguous chunk, item j of lane l at 32j + l
//        (4-byte loads, 128 B per warp and instruction: a 16-byte load would
//        give a lane four neighbouring elements, and the rank below needs
//        lanes in element order), and ranks its elements per digit in that
//        order: eight ballots, one per bit of the digit, give the lanes of
//        equal digit (the card's match.any instruction takes a step per
//        distinct value, up to 32 on random digits), the lowest of them
//        bumps the warp's counter of that digit in shared memory, the
//        others take their place behind it. The whole tile is ranked in
//        kItems steps without a block-wide barrier;
//     3. thread d turns the warps' counters of digit d into each warp's
//        first slot and the tile's count, and publishes the count in the
//        tile's descriptor (status "count"); it then walks back over the
//        earlier tiles' descriptors of digit d, adding counts until it meets
//        one with status "inclusive prefix" (decoupled look-back), and
//        publishes its own inclusive prefix. Every tile publishes all 256
//        digits, empty ones too, so a walk ends at the nearest finished
//        tile: it is at most as long as the number of blocks resident on
//        the card, and each step is one coalesced 1 KB read by 256 threads;
//     4. the rows go through shared memory one at a time, the key row of
//        the pass first: each thread writes its elements to their ranks in
//        the tile's digit order, and the block reads the buffer back in
//        slot order, so consecutive threads write consecutive addresses of
//        one digit's segment. Ranks and destinations stay in registers, so
//        eight rows need the shared memory of one.
//
// A descriptor is one 32-bit word, so that status and value arrive together
// and no fence is needed: 0 = not ready, (count + 1) << 1 = the tile's own
// count, (prefix << 1) | 1 = the inclusive prefix over tiles 0 .. this one.
// A prefix is below n < 2^31, so it fits.
//
// Stability (which LSD needs): ranks follow element order within a warp
// (item, then lane), warps are taken in order, tiles in ticket order.
//
// All tiles but the last have every slot, so the pass body is compiled twice:
// once without any test against the tile's length, once with.
//
// What holds a pass back on the H100 is its instructions, not its bytes: the
// ranking costs some 40 instructions a slot, and a sort of equal keys, whose
// writes are one contiguous run per tile, is only a sixth faster than one of
// random keys. So the rows stay separate (n,) words between passes (an
// interleaved layout could only win back part of that sixth), the tile's
// loads are plain loads (a TMA bulk copy would hide latency that the SM's
// other warps already hide), and the tensor cores have no work in a sort.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRadix = 256;
constexpr int kMaxRows = 8;
constexpr int kMaxKeyWords = 6;
constexpr int kMaxPasses = 4 * kMaxKeyWords;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Scratch, in 32-bit words: the global digit counts of every pass, one tile
// ticket per pass, then one pass's descriptors (a word per tile and digit),
// sized for the smallest tile any pass uses.
constexpr int kHistWords = kMaxPasses * kRadix;
constexpr int kTicketWords = 32;
constexpr int kHeaderWords = kHistWords + kTicketWords;
constexpr int kMinTile = 4096;

struct SortScratch {
  unsigned* hist;     // [pass][digit]
  unsigned* tickets;  // [pass]
  unsigned* desc;     // [tile][digit] of the running pass
};

inline int64_t scratch_words(int64_t n) {
  return kHeaderWords + kRadix * ((n + kMinTile - 1) / kMinTile);
}

inline SortScratch carve_scratch(void* scratch) {
  unsigned* base = static_cast<unsigned*>(scratch);
  return SortScratch{base, base + kHistWords, base + kHeaderWords};
}

// Zero the counts and tickets: once per sort, before the histogram.
inline cudaError_t reset_header(const SortScratch& sc, cudaStream_t s) {
  return cudaMemsetAsync(sc.hist, 0, kHeaderWords * sizeof(unsigned), s);
}

// Zero the descriptors: before every pass.
inline cudaError_t reset_descriptors(const SortScratch& sc, int num_tiles,
                                     cudaStream_t s) {
  return cudaMemsetAsync(sc.desc, 0,
                         static_cast<size_t>(num_tiles) * kRadix * sizeof(unsigned), s);
}

// --------------------------------------------------------------------------
// The histogram of every digit.

constexpr int kHistThreads = 512;
constexpr int kHistItems = 16;
constexpr int kHistTile = kHistThreads * kHistItems;

// Keys supplies the elements of a tile:
//   void stage(int64_t tile_base, int64_t n)   bring the tile in (block-wide)
//   void get(int64_t i, int local, uint32_t (&key)[W])
// hist[4 * (W - 1 - w) + b][d] counts the elements whose byte b of word w is
// d: the digit of pass 4 * (W - 1 - w) + b.
template <int W, class Keys>
__device__ __forceinline__ void histogram_tiles(Keys& keys, int64_t n,
                                                unsigned* __restrict__ hist) {
  __shared__ unsigned counts[4 * W * kRadix];
  for (int i = threadIdx.x; i < 4 * W * kRadix; i += kHistThreads) counts[i] = 0;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31;
  const int64_t num_tiles = (n + kHistTile - 1) / kHistTile;
  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t tile_base = tile * kHistTile;
    keys.stage(tile_base, n);
#pragma unroll 4
    for (int j = 0; j < kHistItems; ++j) {
      const int local = j * kHistThreads + threadIdx.x;
      const int64_t i = tile_base + local;
      const bool in = i < n;
      uint32_t key[W];
#pragma unroll
      for (int w = 0; w < W; ++w) key[w] = 0;
      if (in) keys.get(i, local, key);
      // A warp whose 32 keys are one key (the sentinel tail, a poly-A run)
      // counts them with one atomic per digit instead of 32 on one address.
      bool same = in;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t first_lane = __shfl_sync(kFull, key[w], 0);
        same = same && key[w] == first_lane;
      }
      const bool uniform = __all_sync(kFull, same);
      if (in && (!uniform || lane == 0)) {
        const unsigned weight = uniform ? 32u : 1u;
#pragma unroll
        for (int w = 0; w < W; ++w) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const unsigned d = (key[w] >> (8 * b)) & 0xFFu;
            atomicAdd(&counts[(4 * (W - 1 - w) + b) * kRadix + d], weight);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * W * kRadix; i += kHistThreads) {
    if (counts[i] != 0) atomicAdd(&hist[i], counts[i]);
  }
}

// Blocks of the histogram kernel: enough to fill the card, few enough that
// their global atomics stay cheap.
inline int histogram_blocks(int64_t n) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t tiles = (n + kHistTile - 1) / kHistTile;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * 8;
  return static_cast<int>(tiles < cap ? tiles : cap);
}

// --------------------------------------------------------------------------
// One pass.

template <int kThreads, int kItems>
struct PassShared {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTile = kThreads * kItems;
  unsigned warp_count[kWarps][kRadix];  // per warp and digit: count, then first slot
  int local_start[kRadix];  // the digit's first slot in the tile's digit order
  int offset[kRadix];       // output slot of tile slot p with digit d: offset[d] + p
  int scan_tmp[2][kRadix / 32];
  int tile;
  int pad[3];
  uint32_t buffer[kTile];   // one row of the tile, in digit order
};

__device__ __forceinline__ unsigned load_descriptor(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_descriptor(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// Words between two tiles' descriptors: `digits` rounded up to a 128-byte
// line, so that blocks polling their neighbours' descriptors do not share a
// line with tiles they do not wait on (a sort pass's 256 digits fill whole
// lines already).
constexpr int kDescLineWords = 32;
__host__ __device__ __forceinline__ int desc_stride(int digits) {
  return (digits + kDescLineWords - 1) / kDescLineWords * kDescLineWords;
}

// Whether tile slot `local` holds an element; a full tile needs no test.
template <bool kFullTile>
__device__ __forceinline__ bool in_tile(int local, int tile_n) {
  return kFullTile || local < tile_n;
}

// The lanes of the warp whose digit equals this lane's: one ballot per bit
// of the digit, kept or inverted by the lane's own bit. Written in PTX so
// that a bit costs four instructions (test, vote, predicated not, and).
// Digits below 2^kBits need only kBits ballots. Every lane of the warp
// calls it.
template <int kBits = 8>
__device__ __forceinline__ unsigned lanes_of_digit(unsigned d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    unsigned with_bit;
    asm volatile("{\n"
        "    .reg .pred p;\n"
        "    and.b32 %0, %1, %2;\n"
        "    setp.ne.u32 p, %0, 0;\n"
        "    vote.ballot.sync.b32 %0, p, 0xffffffff;\n"
        "    @!p not.b32 %0, %0;\n"
        "}\n"
        : "=r"(with_bit)
        : "r"(d), "r"(1u << b));
    peers &= with_bit;
  }
  return peers;
}

// Exclusive scans of a and of b over threads 0 .. 255, one value per digit.
// Every thread of the block calls it.
__device__ __forceinline__ void scan_digits(int& a, int& b,
                                            int (*tmp)[kRadix / 32]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int xa = a, xb = b;
  if (tid < kRadix) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(kFull, xa, o);
      const int yb = __shfl_up_sync(kFull, xb, o);
      if (lane >= o) {
        xa += ya;
        xb += yb;
      }
    }
    if (lane == 31) {
      tmp[0][warp] = xa;
      tmp[1][warp] = xb;
    }
  }
  __syncthreads();
  if (tid < kRadix) {
    int before_a = 0, before_b = 0;
    for (int w = 0; w < warp; ++w) {
      before_a += tmp[0][w];
      before_b += tmp[1][w];
    }
    a = before_a + xa - a;
    b = before_b + xb - b;
  }
}

// One row of the tile through shared memory: vals[j] is this thread's item
// j, pos[j] its slot in the tile's digit order. The key row of the pass goes
// first and leaves each slot's output index in dst for the rows after it.
template <int kThreads, int kItems, bool kIsKey, bool kFullTile>
__device__ __forceinline__ void exchange_row(PassShared<kThreads, kItems>& sh,
                                             const uint32_t (&vals)[kItems],
                                             const int (&pos)[kItems],
                                             int (&dst)[kItems], int tile_n,
                                             int shift,
                                             uint32_t* __restrict__ out) {
  const int tid = threadIdx.x;
  const int first = (tid >> 5) * 32 * kItems + (tid & 31);
  if (!kIsKey) __syncthreads();  // the row before has left the buffer
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (in_tile<kFullTile>(first + 32 * j, tile_n)) sh.buffer[pos[j]] = vals[j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = tid + i * kThreads;
    if (in_tile<kFullTile>(p, tile_n)) {
      const uint32_t v = sh.buffer[p];
      if (kIsKey) dst[i] = sh.offset[(v >> shift) & 0xFFu] + p;
      out[dst[i]] = v;
    }
  }
}

// Source supplies a tile's elements and takes them back in digit order:
//   int num_digits()               the digits that occur (<= kRadix): a
//                                  tile publishes and walks that many
//   void stage(int64_t tile_base, int64_t n, unsigned char* room)
//                                  bring the tile in (block-wide), if needed
//   void load(int j, int64_t i, int local)   element i into item j
//   unsigned digit(int j)                    item j's digit in this pass
//   void scatter<kFullTile>(sh, pos, tile_n, tile_base)
//                                  every row through exchange_row
// hist: the 256 global counts of this pass's digit, or null where every
// digit's output starts at 0 (sh.offset[d] is then the digit's slots before
// this tile less its first slot in the tile); desc: its descriptors, all
// zero at launch. kFullTile: the tile has all its slots, so no slot is
// tested against tile_n (all tiles but the last). kBits: the digits lie
// below 2^kBits.
template <int kThreads, int kItems, bool kFullTile, class Source, int kBits = 8>
__device__ __forceinline__ void radix_pass_body(
    Source& source, PassShared<kThreads, kItems>& sh, int tile, int tile_n,
    int64_t tile_base, const unsigned* __restrict__ hist, unsigned* desc) {
  using Shared = PassShared<kThreads, kItems>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = warp * 32 * kItems + lane;  // item j is tile slot first + 32 j
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int local = first + 32 * j;
    if (in_tile<kFullTile>(local, tile_n)) source.load(j, tile_base + local, local);
  }

  // Rank within the warp, in element order.
  int pos[kItems];
  {
    unsigned* counters = sh.warp_count[warp];
    const unsigned lanes_below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = in_tile<kFullTile>(first + 32 * j, tile_n);
      const unsigned d = in ? source.digit(j) : 0u;
      unsigned peers = lanes_of_digit<kBits>(d);
      if (!kFullTile) {
        peers &= __ballot_sync(kFull, in);
        if (!in) peers = 1u << lane;  // its rank is not used
      }
      const int leader = __ffs(peers) - 1;
      unsigned before = 0;
      if (lane == leader && in) {
        before = counters[d];
        counters[d] = before + static_cast<unsigned>(__popc(peers));
      }
      before = __shfl_sync(kFull, before, leader);
      pos[j] = static_cast<int>(before) + __popc(peers & lanes_below);
      __syncwarp();
    }
  }
  __syncthreads();

  // Digit `tid`: the warps' counts -> each warp's first slot; the tile's
  // count, published at once. A tile's `digits` descriptors start a line
  // of their own (desc_stride).
  const int digits = source.num_digits();
  const int stride = desc_stride(digits);
  int count = 0, base = 0;
  unsigned* mine = desc + static_cast<int64_t>(tile) * stride + tid;
  if (tid < kRadix) {
    unsigned running = 0;
#pragma unroll
    for (int w = 0; w < Shared::kWarps; ++w) {
      const unsigned c = sh.warp_count[w][tid];
      sh.warp_count[w][tid] = running;
      running += c;
    }
    count = static_cast<int>(running);
    if (tid < digits) store_descriptor(mine, static_cast<unsigned>(count + 1) << 1);
    base = hist != nullptr ? static_cast<int>(hist[tid]) : 0;
  }
  int start = count;
  scan_digits(start, base, sh.scan_tmp);
  if (tid < kRadix) {
    // Decoupled look-back: this digit in the tiles before this one.
    unsigned before = 0;
    for (int t = tid < digits ? tile - 1 : -1; t >= 0; --t) {
      const unsigned* theirs = desc + static_cast<int64_t>(t) * stride + tid;
      unsigned v;
      do {
        v = load_descriptor(theirs);
      } while (v == 0);
      if (v & 1u) {
        before += v >> 1;
        break;
      }
      before += (v >> 1) - 1u;
    }
    if (tid < digits) {
      store_descriptor(mine, ((before + static_cast<unsigned>(count)) << 1) | 1u);
    }
    sh.local_start[tid] = start;
    sh.offset[tid] = base + static_cast<int>(before) - start;
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (in_tile<kFullTile>(first + 32 * j, tile_n)) {
      const unsigned d = source.digit(j);
      pos[j] += sh.local_start[d] + static_cast<int>(sh.warp_count[warp][d]);
    }
  }
  source.template scatter<kFullTile>(sh, pos, tile_n, tile_base);
}

// One tile of one pass: take a ticket, bring the tile in, run the body.
// ticket: the pass's tile counter, zero at launch.
template <int kThreads, int kItems, class Source, int kBits = 8>
__device__ __forceinline__ void radix_pass_tile(Source& source, int64_t n,
                                                const unsigned* __restrict__ hist,
                                                unsigned* ticket, unsigned* desc) {
  static_assert(kThreads >= kRadix && kThreads % 32 == 0,
                "one thread per digit is needed");
  using Shared = PassShared<kThreads, kItems>;
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(shared_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) sh.tile = static_cast<int>(atomicAdd(ticket, 1u));
  for (int d = lane; d < kRadix; d += 32) sh.warp_count[warp][d] = 0;
  __syncthreads();
  const int tile = sh.tile;
  const int64_t tile_base = static_cast<int64_t>(tile) * Shared::kTile;
  const int64_t left = n - tile_base;
  source.stage(tile_base, n, shared_raw + sizeof(Shared));
  if (left >= Shared::kTile) {
    radix_pass_body<kThreads, kItems, true, Source, kBits>(
        source, sh, tile, Shared::kTile, tile_base, hist, desc);
  } else {
    radix_pass_body<kThreads, kItems, false, Source, kBits>(
        source, sh, tile, static_cast<int>(left), tile_base, hist, desc);
  }
}

}  // namespace
