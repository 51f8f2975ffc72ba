// One slot's canonical k-mer key, derived from the base codes that follow it.
//
// The one definition of the key shared by the key-build kernel (keybuild.cu)
// and by the key build fused into the first radix pass (fused_sort.cu), so
// that every kernel that derives a key derives the same bits. Semantics of
// hysortk_tpu/ops/keybuild.py derive_canonical: the W big-endian words of
// min(forward k-mer, reverse complement), word 0 most significant, the last
// word cut to the k-mer's remaining bases and zero below them.

#pragma once

#include <cstdint>

namespace hk {

__device__ __forceinline__ uint32_t crumb_reverse32(uint32_t x) {
  x = (x >> 16) | (x << 16);
  x = ((x & 0xFF00FF00u) >> 8) | ((x & 0x00FF00FFu) << 8);
  x = ((x & 0xF0F0F0F0u) >> 4) | ((x & 0x0F0F0F0Fu) << 4);
  x = ((x & 0xCCCCCCCCu) >> 2) | ((x & 0x33333333u) << 2);
  return x;
}

// s[0 .. 16W): the slot's base codes in 0..3, one per element (any unsigned
// integer type), those past the end of the input given as 0. key[0 .. W)
// receives the canonical key of the k-mer that starts at s[0], 16(W-1) < k
// <= 16W.
template <int W, typename Code>
__device__ __forceinline__ void canonical_key(const Code* s, int k,
                                              uint32_t (&key)[W]) {
  // Forward words: bases 16w .. 16w+15, the last word cut to r bases.
  uint32_t fwd[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      word = (word << 2) | static_cast<uint32_t>(s[16 * w + j]);
    }
    fwd[w] = word;
  }
  const int r = k - 16 * (W - 1);
  if (r < 16) fwd[W - 1] &= 0xFFFFFFFFu << (32 - 2 * r);

  // Twin: reverse the crumbs of the reversed word list, complement, and
  // shift the whole key left so its first base sits at the top of word 0.
  uint32_t rev[W];
#pragma unroll
  for (int w = 0; w < W; ++w) rev[w] = ~crumb_reverse32(fwd[W - 1 - w]);
  const int shift = 32 * W - 2 * k;  // 0 when k == 16W
  uint32_t twn[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (shift == 0) {
      twn[w] = rev[w];
    } else {
      const uint32_t lo = w + 1 < W ? rev[w + 1] >> (32 - shift) : 0u;
      twn[w] = (rev[w] << shift) | lo;
    }
  }

  // Canonical = lexicographic min(fwd, twn), word 0 most significant.
  bool less = false, decided = false;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (!decided && twn[w] != fwd[w]) {
      less = twn[w] < fwd[w];
      decided = true;
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) key[w] = less ? twn[w] : fwd[w];
}

}  // namespace hk
