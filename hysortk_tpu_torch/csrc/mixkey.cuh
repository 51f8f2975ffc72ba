// The invertible key mix of ops/mixkey.py, one slot's W words in registers:
// `rounds` passes of a cyclic Feistel network of murmur3 fmix32 steps,
//   w[i] = fmix32(w[i] + w[(i+1) % W] + rc[r*W + i])   (W > 1)
//   w[0] = fmix32(w[0] + rc[r])                          (W = 1)
// then w[i] ^= fix[i], the XORs that keep the all-ones sentinel a fixed
// point; and its exact inverse. The round constants and the XORs are
// computed on the host (ops/mixkey.py _RC, _sentinel_fix) and passed by
// value in a Consts. mixkey.cu mixes with it, kept_rows.cu unmixes the kept
// rows of a range route in its write epilogue.

#pragma once

#include <cstdint>

namespace mixkey {

constexpr int kMaxWords = 6;
constexpr int kMaxRounds = 4;

// fmix32's multipliers and their inverses modulo 2^32.
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kInvC1 = 0xA5CB9243u;
constexpr uint32_t kInvC2 = 0x7ED1B41Du;
static_assert(kC1 * kInvC1 == 1u && kC2 * kInvC2 == 1u, "not the inverses");

struct Consts {
  uint32_t rc[kMaxRounds * kMaxWords];
  uint32_t fix[kMaxWords];
  int rounds;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t fmix32_inv(uint32_t h) {
  h ^= h >> 16;
  h *= kInvC2;
  h ^= (h >> 13) ^ (h >> 26);
  h *= kInvC1;
  h ^= h >> 16;
  return h;
}

// Both loops run to the largest round count, so that every constant is
// read at a fixed offset of the kernel's parameters (a dynamic index would
// copy them to local memory).
template <int W>
__device__ __forceinline__ void mix(uint32_t (&w)[W], const Consts& c) {
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    if (r >= c.rounds) break;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint32_t next = W == 1 ? 0u : w[(k + 1) % W];
      w[k] = fmix32(w[k] + next + c.rc[r * W + k]);
    }
  }
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] ^= c.fix[k];
}

template <int W>
__device__ __forceinline__ void unmix(uint32_t (&w)[W], const Consts& c) {
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] ^= c.fix[k];
#pragma unroll
  for (int r = kMaxRounds - 1; r >= 0; --r) {
    if (r >= c.rounds) continue;
#pragma unroll
    for (int k = W - 1; k >= 0; --k) {
      const uint32_t next = W == 1 ? 0u : w[(k + 1) % W];
      w[k] = fmix32_inv(w[k]) - next - c.rc[r * W + k];
    }
  }
}

// Consts from host arrays: round_consts (rounds * W values), fix (W).
inline Consts make_consts(const uint32_t* round_consts, int rounds, const uint32_t* fix,
                          int w_count) {
  Consts c{};
  for (int k = 0; k < w_count; ++k) c.fix[k] = fix[k];
  for (int i = 0; i < rounds * w_count; ++i) c.rc[i] = round_consts[i];
  c.rounds = rounds;
  return c;
}

}  // namespace mixkey
