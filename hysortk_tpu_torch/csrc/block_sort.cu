// Block sort: every B-slot block of (W + P) uint32 rows sorted by its W key
// words (lexicographic, unsigned, word 0 most significant), payload rows
// riding along; block b ascending, or descending when b is odd and
// descending_odd is set.
//
// Replaces hysortk_tpu/ops/pallas_sort.py block_bitonic_sort
// (_block_sort_kernel), phase A of sort_words(formulation="roll"). The TPU
// kernel holds a block of 65,536 slots in VMEM and exchanges by vector
// rolls. Here a block is at most 16,384 slots (what a thread block's shared
// memory holds) and the run merge behind it does more levels.
//
// What it computes: a bitonic network over (key, source index) pairs. The
// source index as the last key word makes every pair distinct, so the
// network's result is the stable ascending order; a descending block is
// written out reversed. Payload rows never enter the network: at the end
// each is gathered from device memory through the sorted source indices (the
// tile was just read, so the gather hits cache). Without payload rows equal
// keys cannot be told apart, so the index word is left out and every step
// moves and compares W words instead of W + 1.
//
// Bound on the H100: HBM bytes in principle, every row read once and written
// once, 8 (W + P) B/slot; in fact the network's log2(B) (log2(B) + 1) / 2
// compare-exchange steps. Run through shared memory with a barrier each
// (66 at B = 2048), they cost twenty times the bound. So the steps are taken
// where the data already is:
//
//   - a group of 256 threads holds a chunk of 2048 slots in registers, 8 per
//     thread: slot i of the chunk is warp i[10:8], register pair i[7],
//     lane i[6:2], register i[1:0], which is what 16-byte loads of a warp
//     on consecutive addresses give;
//   - steps of stride 1, 2 and 128 compare two registers of one thread;
//   - steps of stride 4 .. 64 take the partner's words by __shfl_xor_sync
//     (both lanes compare, one keeps the smaller, one the larger);
//   - steps of stride 256, 512 and 1024 cross warps. A stage that has any
//     writes the chunk to shared memory (16 bytes a thread, no bank
//     conflict), reads it back transposed, slot i[10:8] now the register and
//     i[7:0] the thread (4-byte reads of consecutive lanes, no conflict),
//     runs up to three steps in registers, and transposes back: two
//     barriers per such stage, 6 at B = 2048 instead of 66;
//   - B < 2048: the chunk holds 2048 / B whole blocks and the network stops
//     at stage B; a ragged last chunk is filled with zeros;
//   - B > 2048: the block's B / 2048 chunks are sorted as above, one or two
//     at a time (512 threads are two groups), and left in shared memory,
//     W or W + 1 words a slot; each later stage runs its strides of 2048 and up
//     over shared memory with a barrier each (the earlier design, now 1 + 2
//     + 3 steps at B = 16,384) and the rest per chunk in registers again;
//   - the result leaves from registers, 16 bytes a thread; a reversed block
//     is mirrored by index arithmetic (slot i goes to i ^ (B - 1)).
// Rows that are not 16-byte aligned, and B = 2, take the same body with
// 4-byte loads and stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroupThreads = 256;
constexpr int kMaxGroups = 2;
constexpr int kSlotsPerThread = 8;
constexpr int kChunk = kGroupThreads * kSlotsPerThread;  // 2048
constexpr int kMaxRows = 8;
constexpr int kMaxWords = 6;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct BlockRows {
  const uint32_t* src[kMaxRows];
  uint32_t* dst[kMaxRows];
};

// Where a thread of a group stands, and where its register r = 4 g + e
// lies in the chunk: first + 128 g + e.
struct Place {
  int thread;  // in the group
  int lane;
  int first;   // chunk slot of register 0: 256 warp + 4 lane
};

__device__ __forceinline__ int slot_of(const Place& at, int r) {
  return at.first + (r >> 2) * 128 + (r & 3);
}

// a > b, word 0 most significant. With the source index as the last word
// two elements never compare equal; without it equal elements are the same
// bits, and it does not matter which of them a step keeps.
template <int N>
__device__ __forceinline__ bool greater(const uint32_t (&a)[N], const uint32_t (&b)[N]) {
  bool g = a[N - 1] > b[N - 1];
#pragma unroll
  for (int w = N - 2; w >= 0; --w) g = a[w] > b[w] || (a[w] == b[w] && g);
  return g;
}

// Order two registers: lo <= hi when ascending, else lo >= hi.
template <int N>
__device__ __forceinline__ void exchange(uint32_t (&lo)[N], uint32_t (&hi)[N],
                                         bool ascending) {
  const bool swap = greater(lo, hi) == ascending;
#pragma unroll
  for (int w = 0; w < N; ++w) {
    const uint32_t a = lo[w], b = hi[w];
    lo[w] = swap ? b : a;
    hi[w] = swap ? a : b;
  }
}

// A step between registers r and r | kBit of one thread (strides 1, 2, 128).
// slot & direction == 0: that element's sequence ascends in this stage.
template <int N, int kBit>
__device__ __forceinline__ void register_step(uint32_t (&k)[kSlotsPerThread][N],
                                              const Place& at, int chunk_base,
                                              int direction) {
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r) {
    if (r & kBit) continue;
    const bool ascending = ((chunk_base + slot_of(at, r)) & direction) == 0;
    exchange(k[r], k[r | kBit], ascending);
  }
}

// A step between lanes l and l ^ kLaneBit (stride 4 kLaneBit). Every lane of
// the warp calls it.
template <int N, int kLaneBit>
__device__ __forceinline__ void shuffle_step(uint32_t (&k)[kSlotsPerThread][N],
                                             const Place& at, int chunk_base,
                                             int direction) {
  const bool lower = (at.lane & kLaneBit) == 0;
#pragma unroll
  for (int r = 0; r < kSlotsPerThread; ++r) {
    uint32_t p[N];
#pragma unroll
    for (int w = 0; w < N; ++w) p[w] = __shfl_xor_sync(kFull, k[r][w], kLaneBit);
    const bool ascending = ((chunk_base + slot_of(at, r)) & direction) == 0;
    const bool keep_smaller = lower == ascending;
    const bool take = greater(k[r], p) == keep_smaller;
#pragma unroll
    for (int w = 0; w < N; ++w) k[r][w] = take ? p[w] : k[r][w];
  }
}

// A step in the transposed layout, register q holding chunk slot
// 256 q + thread (strides 256 kBit).
template <int N, int kBit>
__device__ __forceinline__ void transposed_step(uint32_t (&k)[kSlotsPerThread][N],
                                                const Place& at, int chunk_base,
                                                int direction) {
#pragma unroll
  for (int q = 0; q < kSlotsPerThread; ++q) {
    if (q & kBit) continue;
    const bool ascending = ((chunk_base + q * 256 + at.thread) & direction) == 0;
    exchange(k[q], k[q | kBit], ascending);
  }
}

// The chunk between registers and its place in shared memory (row w of the
// tile at sm + w * span), in the layout of the loads ...
template <int N>
__device__ __forceinline__ void store_chunk(const uint32_t (&k)[kSlotsPerThread][N],
                                            uint32_t* sm, int span, int at_slot) {
#pragma unroll
  for (int w = 0; w < N; ++w) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      *reinterpret_cast<uint4*>(sm + w * span + at_slot + 128 * g) = make_uint4(
          k[4 * g][w], k[4 * g + 1][w], k[4 * g + 2][w], k[4 * g + 3][w]);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_chunk(uint32_t (&k)[kSlotsPerThread][N],
                                           const uint32_t* sm, int span, int at_slot) {
#pragma unroll
  for (int w = 0; w < N; ++w) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const uint4 v = *reinterpret_cast<const uint4*>(sm + w * span + at_slot + 128 * g);
      k[4 * g][w] = v.x; k[4 * g + 1][w] = v.y; k[4 * g + 2][w] = v.z; k[4 * g + 3][w] = v.w;
    }
  }
}

// ... and transposed.
template <int N>
__device__ __forceinline__ void store_transposed(const uint32_t (&k)[kSlotsPerThread][N],
                                                 uint32_t* sm, int span, int at_slot) {
#pragma unroll
  for (int w = 0; w < N; ++w) {
#pragma unroll
    for (int q = 0; q < kSlotsPerThread; ++q) sm[w * span + at_slot + 256 * q] = k[q][w];
  }
}

template <int N>
__device__ __forceinline__ void load_transposed(uint32_t (&k)[kSlotsPerThread][N],
                                                const uint32_t* sm, int span, int at_slot) {
#pragma unroll
  for (int w = 0; w < N; ++w) {
#pragma unroll
    for (int q = 0; q < kSlotsPerThread; ++q) k[q][w] = sm[w * span + at_slot + 256 * q];
  }
}

// Every step of stage `size` whose stride is below 2048, on one chunk.
// kFromShared: the chunk lies in shared memory (and size > 2048, so every
// step is taken); otherwise it is in the registers. It ends in the
// registers. Every thread of the block calls it, the same number of times.
template <int N, bool kFromShared>
__device__ __forceinline__ void stage_in_chunk(uint32_t (&k)[kSlotsPerThread][N],
                                               uint32_t* sm, int span,
                                               const Place& at, int chunk_base,
                                               int size, int direction) {
  if (kFromShared || size > 256) {
    if (!kFromShared) {
      store_chunk(k, sm, span, chunk_base + at.first);
      __syncthreads();
    }
    load_transposed(k, sm, span, chunk_base + at.thread);
    if (kFromShared || size > 1024) transposed_step<N, 4>(k, at, chunk_base, direction);
    if (kFromShared || size > 512) transposed_step<N, 2>(k, at, chunk_base, direction);
    transposed_step<N, 1>(k, at, chunk_base, direction);
    store_transposed(k, sm, span, chunk_base + at.thread);
    __syncthreads();
    load_chunk(k, sm, span, chunk_base + at.first);
  }
  if (kFromShared || size > 128) register_step<N, 4>(k, at, chunk_base, direction);
  if (kFromShared || size > 64) shuffle_step<N, 16>(k, at, chunk_base, direction);
  if (kFromShared || size > 32) shuffle_step<N, 8>(k, at, chunk_base, direction);
  if (kFromShared || size > 16) shuffle_step<N, 4>(k, at, chunk_base, direction);
  if (kFromShared || size > 8) shuffle_step<N, 2>(k, at, chunk_base, direction);
  if (kFromShared || size > 4) shuffle_step<N, 1>(k, at, chunk_base, direction);
  if (kFromShared || size > 2) register_step<N, 2>(k, at, chunk_base, direction);
  register_step<N, 1>(k, at, chunk_base, direction);
}

// One step of stride j >= 2048 over the whole tile in shared memory.
template <int N>
__device__ __forceinline__ void shared_step(uint32_t* sm, int span, int j,
                                            int direction) {
  for (int p = threadIdx.x; p < span / 2; p += blockDim.x) {
    // The p-th pair at distance j: p with a zero inserted at j's bit.
    const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int hi = lo | j;
    uint32_t a[N], b[N];
#pragma unroll
    for (int w = 0; w < N; ++w) {
      a[w] = sm[w * span + lo];
      b[w] = sm[w * span + hi];
    }
    if (greater(a, b) == ((lo & direction) == 0)) {
#pragma unroll
      for (int w = 0; w < N; ++w) {
        sm[w * span + lo] = b[w];
        sm[w * span + hi] = a[w];
      }
    }
  }
}

struct Geometry {
  int64_t n;
  int64_t tile_base;  // first slot of this thread block's tile
  int block;          // B
  int log2_block;
  int descending_odd;
  int wide;           // 16-byte loads and stores may be used
};

// Four values of consecutive tile slots (from slot `first`, a multiple of
// 4) to where the block's orientation puts them.
__device__ __forceinline__ void put4(uint32_t* __restrict__ dst, const Geometry& geo,
                                     int first, const uint32_t (&v)[4]) {
  const int mirror = geo.block - 1;
  if (geo.wide) {
    const int64_t slot = geo.tile_base + first;
    if (slot >= geo.n) return;
    const bool reversed = geo.descending_odd && ((slot >> geo.log2_block) & 1);
    if (reversed) {
      *reinterpret_cast<uint4*>(dst + geo.tile_base + (first ^ (mirror & ~3))) =
          make_uint4(v[3], v[2], v[1], v[0]);
    } else {
      *reinterpret_cast<uint4*>(dst + slot) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t slot = geo.tile_base + first + e;
      if (slot >= geo.n) continue;
      const bool reversed = geo.descending_odd && ((slot >> geo.log2_block) & 1);
      dst[reversed ? geo.tile_base + ((first + e) ^ mirror) : slot] = v[e];
    }
  }
}

// The sorted chunk from registers to device memory: key rows as they are,
// payload rows gathered through the source indices (word W of an element,
// relative to the tile).
template <int W, int N>
__device__ __forceinline__ void emit_chunk(const uint32_t (&k)[kSlotsPerThread][N],
                                           const BlockRows& rows, int n_rows,
                                           const Geometry& geo, int first) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int at_slot = first + 128 * g;
    if (geo.tile_base + at_slot >= geo.n) continue;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t v[4] = {k[4 * g][w], k[4 * g + 1][w], k[4 * g + 2][w], k[4 * g + 3][w]};
      put4(rows.dst[w], geo, at_slot, v);
    }
    for (int q = W; N > W && q < n_rows; ++q) {
      const uint32_t* __restrict__ src = rows.src[q] + geo.tile_base;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // A slot past n (B = 2 only) holds a filler whose index is in range
        // of the chunk, not of the row.
        const int64_t from = k[4 * g + e][N - 1];
        v[e] = geo.tile_base + from < geo.n ? src[from] : 0u;
      }
      put4(rows.dst[q], geo, at_slot, v);
    }
  }
}

// A chunk's key rows from device memory, with each slot's index in the tile
// where the elements carry one (N = W + 1).
template <int W, int N>
__device__ __forceinline__ void fetch_chunk(uint32_t (&k)[kSlotsPerThread][N],
                                            const BlockRows& rows, const Geometry& geo,
                                            int first) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int at_slot = first + 128 * g;
    const int64_t slot = geo.tile_base + at_slot;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (geo.wide) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (slot < geo.n) v = *reinterpret_cast<const uint4*>(rows.src[w] + slot);
        k[4 * g][w] = v.x; k[4 * g + 1][w] = v.y; k[4 * g + 2][w] = v.z; k[4 * g + 3][w] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          k[4 * g + e][w] = slot + e < geo.n ? rows.src[w][slot + e] : 0u;
        }
      }
    }
    if (N > W) {
#pragma unroll
      for (int e = 0; e < 4; ++e) k[4 * g + e][N - 1] = at_slot + e;
    }
  }
}

// One thread block per tile of span = max(B, 2048) slots; 256 threads per
// chunk of the tile, at most 512. kIndexed: the elements carry their source
// index (there are payload rows). Dynamic shared memory: N x span words.
template <int W, bool kIndexed>
__global__ void __launch_bounds__(kGroupThreads * kMaxGroups)
block_sort_kernel(const __grid_constant__ BlockRows rows, int n_rows, int64_t n,
                  int block, int span, int descending_odd, int wide) {
  constexpr int N = W + (kIndexed ? 1 : 0);
  extern __shared__ __align__(16) uint32_t sm[];
  Place at;
  at.thread = threadIdx.x % kGroupThreads;
  at.lane = at.thread & 31;
  at.first = (at.thread >> 5) * 256 + 4 * at.lane;
  const int group = threadIdx.x / kGroupThreads;
  const int groups = blockDim.x / kGroupThreads;
  Geometry geo;
  geo.n = n;
  geo.tile_base = static_cast<int64_t>(blockIdx.x) * span;
  geo.block = block;
  geo.log2_block = __ffs(block) - 1;
  geo.descending_odd = descending_odd;
  geo.wide = wide;
  // Stage `size` ascends where slot & size == 0, the last stage everywhere.
  const int in_block = block - 1;
  const int in_chunk_top = block < kChunk ? block : kChunk;

  uint32_t k[kSlotsPerThread][N];
  for (int chunk_base = group * kChunk; chunk_base < span;
       chunk_base += groups * kChunk) {
    fetch_chunk<W, N>(k, rows, geo, chunk_base + at.first);
    for (int size = 2; size <= in_chunk_top; size <<= 1) {
      stage_in_chunk<N, false>(k, sm, span, at, chunk_base, size, size & in_block);
    }
    if (block > kChunk) {
      store_chunk(k, sm, span, chunk_base + at.first);
    } else {
      emit_chunk<W, N>(k, rows, n_rows, geo, chunk_base + at.first);
    }
  }
  if (block <= kChunk) return;
  __syncthreads();

  for (int size = 2 * kChunk; size <= block; size <<= 1) {
    const int direction = size & in_block;
    for (int j = size >> 1; j >= kChunk; j >>= 1) {
      shared_step<N>(sm, span, j, direction);
      __syncthreads();
    }
    for (int chunk_base = group * kChunk; chunk_base < span;
         chunk_base += groups * kChunk) {
      stage_in_chunk<N, true>(k, sm, span, at, chunk_base, size, direction);
      if (size < block) {
        store_chunk(k, sm, span, chunk_base + at.first);
      } else {
        emit_chunk<W, N>(k, rows, n_rows, geo, chunk_base + at.first);
      }
    }
    __syncthreads();
  }
}

template <int W, bool kIndexed>
cudaError_t launch_kernel(const BlockRows& rows, int n_rows, int64_t n, int block,
                          int descending_odd, int wide, cudaStream_t s) {
  const int span = block > kChunk ? block : kChunk;
  const int chunks = span / kChunk;
  const int threads = kGroupThreads * (chunks < kMaxGroups ? chunks : kMaxGroups);
  const size_t shared =
      static_cast<size_t>(W + (kIndexed ? 1 : 0)) * span * sizeof(uint32_t);
  // Above 48 KB a kernel has to opt in to its dynamic shared memory.
  cudaError_t err = cudaFuncSetAttribute(
      block_sort_kernel<W, kIndexed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + span - 1) / span;
  block_sort_kernel<W, kIndexed><<<static_cast<unsigned>(tiles), threads, shared, s>>>(
      rows, n_rows, n, block, span, descending_odd, wide);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch(const BlockRows& rows, int n_rows, int64_t n, int block,
                   int descending_odd, int wide, cudaStream_t s) {
  return n_rows > W
             ? launch_kernel<W, true>(rows, n_rows, n, block, descending_odd, wide, s)
             : launch_kernel<W, false>(rows, n_rows, n, block, descending_odd, wide, s);
}

}  // namespace

// src, dst: n_rows device pointers each to (n,) uint32 rows, the first n_keys
// of them key words; src and dst do not overlap. block: a power of two that
// divides n and whose tile fits a thread block's shared memory. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a geometry it refuses.
extern "C" int hk_block_sort(void* const* src, void* const* dst, int n_keys,
                             int n_rows, int64_t n, int64_t block,
                             int descending_odd, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || n_keys < 1 || n_keys > kMaxWords ||
      n_rows < n_keys || n_rows > kMaxRows || block < 2 ||
      (block & (block - 1)) != 0 || n % block != 0 || block > (1 << 20)) {
    return cudaErrorInvalidValue;
  }
  BlockRows rows{};
  uintptr_t low_bits = 0;
  for (int q = 0; q < n_rows; ++q) {
    rows.src[q] = static_cast<const uint32_t*>(src[q]);
    rows.dst[q] = static_cast<uint32_t*>(dst[q]);
    low_bits |= reinterpret_cast<uintptr_t>(src[q]) | reinterpret_cast<uintptr_t>(dst[q]);
  }
  // With B >= 4 a group of four slots lies in one block and inside n.
  const int wide = (low_bits & 15u) == 0 && block >= 4;
  const auto s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(block);
  cudaError_t err = cudaSuccess;
  switch (n_keys) {
    case 1: err = launch<1>(rows, n_rows, n, b, descending_odd, wide, s); break;
    case 2: err = launch<2>(rows, n_rows, n, b, descending_odd, wide, s); break;
    case 3: err = launch<3>(rows, n_rows, n, b, descending_odd, wide, s); break;
    case 4: err = launch<4>(rows, n_rows, n, b, descending_odd, wide, s); break;
    case 5: err = launch<5>(rows, n_rows, n, b, descending_odd, wide, s); break;
    case 6: err = launch<6>(rows, n_rows, n, b, descending_odd, wide, s); break;
  }
  return static_cast<int>(err);
}
