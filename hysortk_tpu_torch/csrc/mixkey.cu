// Invertible key mix: W uint32 key words -> W mixed words, slot by slot.
//
// No TPU kernel: the JAX package computes the mix in XLA
// (hysortk_tpu/ops/mixkey.py mix_keys, inside
// parallel/pipeline._build_marked_mixed). Same contract: `rounds` passes of
// a cyclic Feistel network of murmur3 fmix32 steps,
//   w[i] = fmix32(w[i] + w[(i+1) % W] + rc[r*W + i])   (W > 1)
//   w[0] = fmix32(w[0] + rc[r])                          (W = 1)
// then w[i] ^= fix[i], the XORs that keep the all-ones sentinel a fixed
// point. The round constants and the XORs are computed on the host
// (ops/mixkey.py _RC, _sentinel_fix) and passed by value.
//
// Bound on the H100: HBM bytes, 8W B a slot (W words in, W out); the 4 W
// rounds of fmix32 are 20 W integer operations a slot, far below the
// card's rate. Design: the simplest kernel that streams at the memory
// rate: each thread takes kItems slots kThreads apart, so every load and
// store of a warp covers 128 contiguous bytes of a row, issues all its
// loads before it mixes, and keeps the W words of a slot in registers (W
// is a template argument). Rows may start at any 4-byte offset.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kMaxWords = 6;
constexpr int kMaxRounds = 4;

struct Rows {
  const uint32_t* in[kMaxWords];
  uint32_t* out[kMaxWords];
};

struct MixConsts {
  uint32_t rc[kMaxRounds * kMaxWords];
  uint32_t fix[kMaxWords];
  int rounds;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
mix_kernel(Rows rows, int64_t n, MixConsts c) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * (kThreads * kItems) + threadIdx.x;
  uint32_t w[kItems][W];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads;
#pragma unroll
    for (int k = 0; k < W; ++k) w[j][k] = i < n ? rows.in[k][i] : 0u;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    // Unrolled to the largest round count, so that every constant is read
    // at a fixed offset of the kernel's parameters (a dynamic index would
    // copy them to local memory).
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) {
      if (r >= c.rounds) break;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const uint32_t next = W == 1 ? 0u : w[j][(k + 1) % W];
        w[j][k] = fmix32(w[j][k] + next + c.rc[r * W + k]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j * kThreads;
    if (i < n) {
#pragma unroll
      for (int k = 0; k < W; ++k) rows.out[k][i] = w[j][k] ^ c.fix[k];
    }
  }
}

}  // namespace

// in_rows, out_rows: W device pointers to (n,) uint32 rows (out may not
// alias in). round_consts: rounds * W host values, fix: W host values.
// W in 1..6, rounds in 1..4. Returns cudaGetLastError().
extern "C" int hk_mix_keys(void* const* in_rows, void* const* out_rows,
                           int w_count, int64_t n,
                           const uint32_t* round_consts, int rounds,
                           const uint32_t* fix, void* stream) {
  if (n <= 0 || w_count < 1 || w_count > kMaxWords || rounds < 1 ||
      rounds > kMaxRounds) {
    return cudaErrorInvalidValue;
  }
  Rows rows{};
  MixConsts c{};
  for (int k = 0; k < w_count; ++k) {
    rows.in[k] = static_cast<const uint32_t*>(in_rows[k]);
    rows.out[k] = static_cast<uint32_t*>(out_rows[k]);
    c.fix[k] = fix[k];
  }
  for (int i = 0; i < rounds * w_count; ++i) c.rc[i] = round_consts[i];
  c.rounds = rounds;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kItems;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block));
  const auto s = static_cast<cudaStream_t>(stream);
  switch (w_count) {
    case 1: mix_kernel<1><<<grid, kThreads, 0, s>>>(rows, n, c); break;
    case 2: mix_kernel<2><<<grid, kThreads, 0, s>>>(rows, n, c); break;
    case 3: mix_kernel<3><<<grid, kThreads, 0, s>>>(rows, n, c); break;
    case 4: mix_kernel<4><<<grid, kThreads, 0, s>>>(rows, n, c); break;
    case 5: mix_kernel<5><<<grid, kThreads, 0, s>>>(rows, n, c); break;
    case 6: mix_kernel<6><<<grid, kThreads, 0, s>>>(rows, n, c); break;
  }
  return static_cast<int>(cudaGetLastError());
}
