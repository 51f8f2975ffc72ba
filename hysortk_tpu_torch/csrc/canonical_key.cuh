// One slot's canonical k-mer key, derived from the base codes that follow it.
//
// The one definition of the key shared by the key-build kernel (keybuild.cu)
// and by the key build fused into the radix sort (fused_sort.cu), so that
// every kernel that derives a key derives the same bits, from codes staged
// 16 to a word in shared memory by stage_codes (canonical_key_packed,
// canonical_key_words). Semantics of
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

// The mask of the last key word's r = k - 16(W - 1) bases (its top 2r bits).
template <int W>
__device__ __forceinline__ uint32_t last_word_mask(int k) {
  const int r = k - 16 * (W - 1);
  return r < 16 ? 0xFFFFFFFFu << (32 - 2 * r) : 0xFFFFFFFFu;
}

// fwd[0 .. W): a forward k-mer's words, its last word already cut to its
// bases. twn[0 .. W) receives its reverse complement in the same layout.
template <int W>
__device__ __forceinline__ void twin_from_forward(const uint32_t (&fwd)[W], int k,
                                                  uint32_t (&twn)[W]) {
  // Reverse the crumbs of the reversed word list, complement, and shift the
  // whole key left so its first base sits at the top of word 0.
  uint32_t rev[W];
#pragma unroll
  for (int w = 0; w < W; ++w) rev[w] = ~crumb_reverse32(fwd[W - 1 - w]);
  const int shift = 32 * W - 2 * k;  // 0 when k == 16W
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (shift == 0) {
      twn[w] = rev[w];
    } else {
      const uint32_t lo = w + 1 < W ? rev[w + 1] >> (32 - shift) : 0u;
      twn[w] = (rev[w] << shift) | lo;
    }
  }
}

// key[0 .. W) = the lexicographic minimum of a k-mer's forward words and
// its twin's, word 0 most significant: its canonical key.
template <int W>
__device__ __forceinline__ void canonical_of(const uint32_t (&fwd)[W],
                                             const uint32_t (&twn)[W],
                                             uint32_t (&key)[W]) {
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

// fwd[0 .. W): the forward k-mer's words, bases 16w .. 16w+15 of the slot in
// word w, whatever follows the k-mer still in the last word. key[0 .. W)
// receives the canonical key, 16(W-1) < k <= 16W.
template <int W>
__device__ __forceinline__ void canonical_from_forward(uint32_t (&fwd)[W], int k,
                                                       uint32_t (&key)[W]) {
  fwd[W - 1] &= last_word_mask<W>(k);  // the last word cut to its bases
  uint32_t twn[W];
  twin_from_forward<W>(fwd, k, twn);
  canonical_of<W>(fwd, twn, key);
}

// Four base codes, one per byte of v (the first in the lowest byte), as
// eight bits, the first base in the top crumb. Bits above a code's low two
// are dropped.
__device__ __forceinline__ uint32_t pack_four_codes(uint32_t v) {
  const uint32_t t = v & 0x03030303u;
  return ((t << 6) | (t >> 4) | (t >> 14) | (t >> 24)) & 0xFFu;
}

// q[0 .. W]: packed base codes 16 to a word (the first in the top crumb),
// the k-mer's first base at crumb `at` (0..15) of q[0]. Each forward word is
// one funnel shift of two neighbouring words.
template <int W>
__device__ __forceinline__ void canonical_key_words(const uint32_t (&q)[W + 1],
                                                    int at, int k,
                                                    uint32_t (&key)[W]) {
  const unsigned shift = 2u * static_cast<unsigned>(at);
  uint32_t fwd[W];
#pragma unroll
  for (int w = 0; w < W; ++w) fwd[w] = __funnelshift_l(q[w + 1], q[w], shift);
  canonical_from_forward<W>(fwd, k, key);
}

// packed: base codes 16 to a word, the first in the top crumb, those past
// the end of the input given as 0. The k-mer starts at base `at` of packed;
// words packed[at / 16 .. at / 16 + W] are read.
template <int W>
__device__ __forceinline__ void canonical_key_packed(const uint32_t* packed,
                                                     int at, int k,
                                                     uint32_t (&key)[W]) {
  const uint32_t* p = packed + (at >> 4);
  uint32_t q[W + 1];
#pragma unroll
  for (int w = 0; w <= W; ++w) q[w] = p[w];
  canonical_key_words<W>(q, at & 15, k, key);
}

// Stage codes[tile_base ..] for a tile of `tile` slots (a multiple of 16)
// and its (16W - 1)-base halo in shared memory, packed 16 bases to a word
// (the first in the top crumb), bases past n as 0: tile / 16 + W + 1 words,
// the last one read by the funnel shift and discarded. 16-byte loads where
// the codes are 16-byte aligned, single bytes where they are not. Begins
// and ends with a barrier, so a block can stage one tile after another.
template <int W>
__device__ __forceinline__ void stage_codes(const int8_t* __restrict__ codes,
                                            int64_t n, int64_t tile_base,
                                            int tile, uint32_t* room) {
  __syncthreads();  // the tile before has been read
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
  for (int m = threadIdx.x; m < tile / 16 + W + 1; m += blockDim.x) {
    const int64_t p = tile_base + 16 * static_cast<int64_t>(m);
    uint32_t word = 0;
    if (aligned && p + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(codes + p);
      word = (pack_four_codes(v.x) << 24) | (pack_four_codes(v.y) << 16) |
             (pack_four_codes(v.z) << 8) | pack_four_codes(v.w);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t c =
            p + j < n ? static_cast<uint8_t>(codes[p + j]) & 3u : 0u;
        word = (word << 2) | c;
      }
    }
    room[m] = word;
  }
  __syncthreads();
}

}  // namespace hk
