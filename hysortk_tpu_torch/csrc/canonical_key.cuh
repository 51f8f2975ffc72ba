// One slot's canonical k-mer key, derived from the base codes that follow it.
//
// The one definition of the key shared by the key-build kernel (keybuild.cu)
// and by the key build fused into the radix sort (fused_sort.cu), so that
// every kernel that derives a key derives the same bits: from codes held one
// to a byte (canonical_key) or 16 to a word (canonical_key_packed). Semantics of
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

// fwd[0 .. W): the forward k-mer's words, bases 16w .. 16w+15 of the slot in
// word w, whatever follows the k-mer still in the last word. key[0 .. W)
// receives the canonical key, 16(W-1) < k <= 16W.
template <int W>
__device__ __forceinline__ void canonical_from_forward(uint32_t (&fwd)[W], int k,
                                                       uint32_t (&key)[W]) {
  // The last word cut to its r bases.
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

// s[0 .. 16W): the slot's base codes in 0..3, one per element (any unsigned
// integer type), those past the end of the input given as 0. key[0 .. W)
// receives the canonical key of the k-mer that starts at s[0].
template <int W, typename Code>
__device__ __forceinline__ void canonical_key(const Code* s, int k,
                                              uint32_t (&key)[W]) {
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
  canonical_from_forward<W>(fwd, k, key);
}

// Four base codes, one per byte of v (the first in the lowest byte), as
// eight bits, the first base in the top crumb. Bits above a code's low two
// are dropped.
__device__ __forceinline__ uint32_t pack_four_codes(uint32_t v) {
  const uint32_t t = v & 0x03030303u;
  return ((t << 6) | (t >> 4) | (t >> 14) | (t >> 24)) & 0xFFu;
}

// packed: base codes 16 to a word, the first in the top crumb, those past
// the end of the input given as 0. The k-mer starts at base `at` of packed;
// words packed[at / 16 .. at / 16 + W] are read. Each forward word is one
// funnel shift of two neighbouring words.
template <int W>
__device__ __forceinline__ void canonical_key_packed(const uint32_t* packed,
                                                     int at, int k,
                                                     uint32_t (&key)[W]) {
  const uint32_t* q = packed + (at >> 4);
  const unsigned shift = 2u * (static_cast<unsigned>(at) & 15u);
  uint32_t fwd[W];
  uint32_t hi = q[0];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uint32_t lo = q[w + 1];
    fwd[w] = __funnelshift_l(lo, hi, shift);
    hi = lo;
  }
  canonical_from_forward<W>(fwd, k, key);
}

}  // namespace hk
