// Pack by destination: the valid slots of a rank's block grouped by their
// destination rank into an (S, rows, capacity) send block, every key row
// and then every payload row; destination s keeps its first `capacity`
// slots in input order, the slots past its count hold -1, and the (S,)
// uncapped counts and an overflow flag (some count above capacity) come
// back in a small device tensor.
//
// No TPU kernel: the JAX package packs in XLA (hysortk_tpu/parallel/
// exchange.py:33 pack_by_destination, a sort of [dest, *rows] and a
// gather), and so did the port, as a radix sort of the destination with a
// slot-index payload, a bincount and a gather per row, until this kernel
// (parallel/exchange.pack_by_destination_plain keeps that function in plain
// torch).
//
// Design: ONE stable pass of radix_pass.cuh whose digit is the destination
// rank (S for a slot that is not sent, so S + 1 <= 256 digits), a block a
// tile of 256 threads x 16 slots, three blocks an SM:
//   * the tile's source reads `valid` and the destination row in place
//     (int32 or int64, by a stride in words: only the low word is read),
//     or the bucket row and a bucket -> rank table staged in shared memory
//     (up to kStagedTable entries; a larger table is read through L1);
//   * the in-warp rank takes ceil(log2(S + 1)) ballots, not eight (kBits:
//     1, 2, 4 or 8);
//   * each digit's tile count is published and its slots in earlier tiles
//     found by decoupled look-back, as in a sort pass, but with no
//     histogram launch: destination s starts at s * capacity of its rows;
//   * the digits, then each row, go through shared memory in the tile's
//     digit order, so a destination's writes are contiguous; a slot is
//     written only where its place in its destination is below capacity;
//   * the last tile (by ticket) writes the inclusive counts and the flag.
// A second, small launch writes -1 over [min(count, capacity), capacity)
// of every (destination, row), reading the counts on the device.
//
// Bound on the H100: bytes. Per slot 1 B of validity, 4 B of destination
// (or bucket) and 4 B a row in; 4 B a row a sent slot out, and 4 B a row
// for every pad slot. The rank costs some 20 instructions a slot at S = 1
// (one ballot); chip_smoke.py phase 10(d) times it at the minimizer
// route's one-rank shape (2^26 slots, two rows) against that bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "radix_pass.cuh"

namespace {

// The tile: 256 threads x 16 slots, three blocks an SM (80 registers a
// thread), so that one block's look-back and barriers overlap the others'
// loads; the sort's 512 x 16 at one block an SM ran slower.
constexpr int kPackThreads = 256;
constexpr int kPackItems = 16;
constexpr int kPackMinBlocks = 3;
constexpr int kPackTile = kPackThreads * kPackItems;
constexpr int kStagedTable = 4096;  // bucket -> rank entries staged in shared memory
constexpr int kMaxDest = kRadix - 1;

struct PackArgs {
  const uint8_t* valid;
  const uint32_t* dest;  // the low word of slot i at dest[i * dest_stride]
  int64_t dest_stride;
  const int32_t* table;  // bucket -> rank, or null: dest holds ranks
  int table_size;
  int num_dest;
  int n_rows;
  int num_tiles;
  int64_t n;
  int64_t capacity;
  const uint32_t* rows[kMaxRows];
  uint32_t* send;   // (num_dest, n_rows, capacity)
  int32_t* counts;  // (num_dest + 1,): the counts, then the overflow flag
};

// The shared memory after PassShared: the tile's digits in digit order,
// then the staged table (staged entries).
inline size_t pack_shared_bytes(int staged) {
  return sizeof(PassShared<kPackThreads, kPackItems>) + kPackTile + 4 * size_t(staged);
}

// Where a slot's rank comes from: its destination row; the bucket row and
// the table staged in shared memory; the bucket row and the table in
// global memory (more than kStagedTable buckets). Each mode its own
// kernel, so the compiler knows the table's memory: one pointer to either
// made every table read a generic load, 1.2x slower at 2^26 slots.
enum TableMode { kRanks = 0, kStaged = 1, kGlobal = 2 };

template <int kTable>
struct PackSource {
  using Shared = PassShared<kPackThreads, kPackItems>;
  const PackArgs& a;
  const int32_t* staged;  // kStaged: the table in shared memory
  uint8_t* digits;        // [kPackTile] in the tile's digit order
  uint32_t dig[kPackItems];

  __device__ __forceinline__ void stage(int64_t, int64_t, unsigned char* room) {
    digits = room;
    if (kTable == kStaged) {
      int32_t* table = reinterpret_cast<int32_t*>(room + kPackTile);
      for (int i = threadIdx.x; i < a.table_size; i += kPackThreads) table[i] = a.table[i];
      __syncthreads();
      staged = table;
    }
  }

  // Slot i's digit: its destination, or num_dest where it is not valid or
  // its destination (bucket) lies outside [0, num_dest) (the table). No
  // branch: the table is read at a clamped bucket whatever the slot, so the
  // compiler issues every item's loads before it waits on any (a branch a
  // slot cost 1.5x at 2^26 slots).
  __device__ __forceinline__ void load(int j, int64_t i, int) {
    const unsigned none = static_cast<unsigned>(a.num_dest);
    const uint32_t x = a.dest[i * a.dest_stride];
    const bool valid = a.valid[i] != 0;
    unsigned d = x;
    if (kTable != kRanks) {
      const bool in_table = x < static_cast<uint32_t>(a.table_size);
      const uint32_t b = in_table ? x : 0u;
      d = static_cast<unsigned>(kTable == kStaged ? staged[b] : __ldg(a.table + b));
      d = in_table ? d : none;
    }
    dig[j] = valid && d < none ? d : none;
  }

  __device__ __forceinline__ unsigned digit(int j) const { return dig[j]; }
  __device__ __forceinline__ int num_digits() const { return a.num_dest + 1; }

  template <bool kFullTile>
  __device__ __forceinline__ void scatter(Shared& sh, const int (&pos)[kPackItems],
                                          int tile_n, int64_t tile_base) {
    const int tid = threadIdx.x;
    const int first = (tid >> 5) * 32 * kPackItems + (tid & 31);
    const int64_t cap = a.capacity;
    const unsigned none = static_cast<unsigned>(a.num_dest);
    const int64_t dest_block = static_cast<int64_t>(a.n_rows) * cap;
    // The digits in the tile's digit order; each output slot's column in
    // its destination's rows, or -1 where it is not written.
#pragma unroll
    for (int j = 0; j < kPackItems; ++j) {
      if (in_tile<kFullTile>(first + 32 * j, tile_n)) sh.buffer[pos[j]] = dig[j];
    }
    __syncthreads();
    int col[kPackItems];
#pragma unroll
    for (int i = 0; i < kPackItems; ++i) {
      const int p = tid + i * kPackThreads;
      col[i] = -1;
      if (in_tile<kFullTile>(p, tile_n)) {
        const unsigned d = sh.buffer[p];
        digits[p] = static_cast<uint8_t>(d);
        const int c = sh.offset[d] + p;
        if (d < none && c < cap) col[i] = c;
      }
    }
#pragma unroll 1
    for (int q = 0; q < a.n_rows; ++q) {
      const uint32_t* __restrict__ src = a.rows[q];
      uint32_t vals[kPackItems];
#pragma unroll
      for (int j = 0; j < kPackItems; ++j) {
        const int local = first + 32 * j;
        vals[j] = in_tile<kFullTile>(local, tile_n) ? src[tile_base + local] : 0u;
      }
      __syncthreads();  // the buffer's last readers are done
#pragma unroll
      for (int j = 0; j < kPackItems; ++j) {
        if (in_tile<kFullTile>(first + 32 * j, tile_n)) sh.buffer[pos[j]] = vals[j];
      }
      __syncthreads();
      uint32_t* out = a.send + q * cap;
#pragma unroll
      for (int i = 0; i < kPackItems; ++i) {
        const int p = tid + i * kPackThreads;
        if (col[i] >= 0) out[digits[p] * dest_block + col[i]] = sh.buffer[p];
      }
    }
    write_counts(sh);
  }

  // The last tile (by ticket): every earlier tile has published its
  // inclusive prefixes.
  __device__ __forceinline__ void write_counts(const Shared& sh) const {
    const int tid = threadIdx.x;
    const int64_t cap = a.capacity;
    if (sh.tile == a.num_tiles - 1) {
      // Every earlier tile has published its inclusive prefixes: digit d's
      // slots before this tile are offset[d] + local_start[d], its own
      // local_start[d + 1] - local_start[d] (d + 1 <= num_dest <= 255).
      int over = 0;
      if (tid < a.num_dest) {
        const int total = sh.offset[tid] + sh.local_start[tid + 1];
        a.counts[tid] = total;
        over = total > cap;
      }
      over = __syncthreads_or(over);
      if (tid == 0) a.counts[a.num_dest] = over;
    }
  }
};

template <int kTable, int kBits>
__global__ void __launch_bounds__(kPackThreads, kPackMinBlocks)
dest_pack_kernel(const __grid_constant__ PackArgs a, unsigned* ticket, unsigned* desc) {
  PackSource<kTable> source{a, nullptr, nullptr, {}};
  radix_pass_tile<kPackThreads, kPackItems, PackSource<kTable>, kBits>(
      source, a.n, nullptr, ticket, desc);
}

// Launch 2: -1 over [min(count, capacity), capacity) of (destination, row)
// blockIdx.y.
__global__ void __launch_bounds__(256)
dest_pad_kernel(uint32_t* send, const int32_t* counts, int n_rows, int64_t capacity) {
  const int y = blockIdx.y;
  const int64_t count = counts[y / n_rows];
  uint32_t* row = send + y * capacity;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = (count < capacity ? count : capacity) + blockIdx.x * blockDim.x +
                   threadIdx.x;
       c < capacity; c += stride) {
    row[c] = 0xFFFFFFFFu;
  }
}

template <int kTable, int kBits>
cudaError_t launch_pack(const PackArgs& a, unsigned* ticket, unsigned* desc,
                        cudaStream_t s) {
  const int shared = static_cast<int>(pack_shared_bytes(kTable == kStaged ? a.table_size : 0));
  cudaError_t err = cudaFuncSetAttribute(dest_pack_kernel<kTable, kBits>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shared);
  if (err != cudaSuccess) return err;
  dest_pack_kernel<kTable, kBits><<<a.num_tiles, kPackThreads, shared, s>>>(a, ticket, desc);
  return cudaGetLastError();
}

template <int kTable>
cudaError_t launch_bits(const PackArgs& a, unsigned* ticket, unsigned* desc,
                        cudaStream_t s) {
  // Digits 0 .. num_dest.
  if (a.num_dest < 2) return launch_pack<kTable, 1>(a, ticket, desc, s);
  if (a.num_dest < 4) return launch_pack<kTable, 2>(a, ticket, desc, s);
  if (a.num_dest < 16) return launch_pack<kTable, 4>(a, ticket, desc, s);
  return launch_pack<kTable, 8>(a, ticket, desc, s);
}

// Scratch in 32-bit words: the ticket (padded), then the descriptors of
// every tile (num_dest + 1 digits, a line a tile).
int64_t scratch_words_for(int64_t n, int num_dest) {
  const int64_t tiles = n > 0 ? (n + kPackTile - 1) / kPackTile : 1;
  return kTicketWords + int64_t{desc_stride(num_dest + 1)} * tiles;
}

}  // namespace

// The tile's slots and the table entries staged in shared memory, which
// testing.dest_pack_cases sizes its cases by.
extern "C" void hk_dest_pack_geometry(int* tile, int* staged_table) {
  *tile = kPackTile;
  *staged_table = kStagedTable;
}

extern "C" int64_t hk_dest_pack_scratch(int64_t n, int num_dest) {
  return scratch_words_for(n, num_dest);
}

// valid: (n,) bool; dest: the low 32-bit word of slot i at dest + 4 * i *
// dest_stride bytes (dest_stride 1 for int32, 2 for int64): the rank, or
// with a table (table_size int32 entries) the bucket; rows: n_rows device
// pointers to (n,) 32-bit rows. Writes send (num_dest, n_rows, capacity)
// and counts (num_dest + 1,) int32. 1 <= num_dest <= 255, 1 <= n_rows <=
// 8, 0 <= n < 2^31, 0 <= capacity < 2^31; scratch: hk_dest_pack_scratch(n,
// num_dest) words, no initial contents. Returns the first CUDA error, else 0.
extern "C" int hk_dest_pack(const void* valid, const void* dest, int64_t dest_stride,
                            const void* table, int table_size, void* const* rows,
                            int n_rows, int64_t n, int num_dest, int64_t capacity,
                            void* send, void* counts, void* scratch, void* stream) {
  if (num_dest < 1 || num_dest > kMaxDest || n_rows < 1 || n_rows > kMaxRows || n < 0 ||
      n >= (int64_t{1} << 31) || capacity < 0 || capacity >= (int64_t{1} << 31) ||
      (dest_stride != 1 && dest_stride != 2) || (table != nullptr && table_size < 1)) {
    return cudaErrorInvalidValue;
  }
  PackArgs a{};
  a.valid = static_cast<const uint8_t*>(valid);
  a.dest = static_cast<const uint32_t*>(dest);
  a.dest_stride = dest_stride;
  a.table = static_cast<const int32_t*>(table);
  a.table_size = table != nullptr ? table_size : 0;
  a.num_dest = num_dest;
  a.n_rows = n_rows;
  a.n = n;
  a.num_tiles = static_cast<int>(n > 0 ? (n + kPackTile - 1) / kPackTile : 1);
  a.capacity = capacity;
  for (int q = 0; q < n_rows; ++q) a.rows[q] = static_cast<const uint32_t*>(rows[q]);
  a.send = static_cast<uint32_t*>(send);
  a.counts = static_cast<int32_t*>(counts);
  const auto s = static_cast<cudaStream_t>(stream);
  unsigned* ticket = static_cast<unsigned*>(scratch);
  unsigned* desc = ticket + kTicketWords;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(scratch_words_for(n, num_dest)) * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = table == nullptr            ? launch_bits<kRanks>(a, ticket, desc, s)
        : table_size <= kStagedTable ? launch_bits<kStaged>(a, ticket, desc, s)
                                     : launch_bits<kGlobal>(a, ticket, desc, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (capacity > 0) {
    const int64_t row_blocks = (capacity + 2047) / 2048;
    const int64_t cap_blocks = 1056 / (int64_t{num_dest} * n_rows);
    const int64_t bx = row_blocks < cap_blocks ? row_blocks : (cap_blocks > 0 ? cap_blocks : 1);
    dest_pad_kernel<<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(num_dest * n_rows)),
                      256, 0, s>>>(a.send, a.counts, n_rows, capacity);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
