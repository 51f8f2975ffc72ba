// The minimizer scan: codes (n,) int8 -> the destination bucket (n,) int32
// of the k-mer that starts at each position.
//
// No TPU kernel: the JAX package scans in XLA (hysortk_tpu/ops/minimizer.py
// mmer_hashes, sliding_window_min, kmer_destinations: the TPU form of the
// reference's monotonic-deque minimum, src/kmerops.cpp:1010-1073), and so
// did the port, in int64 torch ops, until this kernel
// (ops/minimizer.kmer_destinations_plain). Same contract: the hash of the
// canonical m-mer starting at j is hashes.mix_words of its W = ceil(m / 16)
// key words (seed 313; per word h = (h ^ fmix32(w)) * 0x9E3779B1 +
// 0xE6546B64; then fmix32(h), all mod 2^32), the bucket of position i is the
// unsigned minimum of the hashes at i .. i + k - m modulo num_buckets. The
// m-mer words are the key build's, bit for bit (canonical_key.cuh). At the
// last k - 1 positions no k-mer fits: their windows read codes past n as 0,
// so they hold some bucket in [0, num_buckets), not the plain version's
// wrapped one.
//
// One block of 256 threads a tile of 2048 positions:
//   1. the tile's codes and the 112 after them (k - 1 <= 95 are read),
//      packed 16 to a word in shared memory (stage_codes, shared with the
//      key build);
//   2. the hashes of the tile's m-mers and of the window - 1 after them, in
//      shared memory (window = k - m + 1 <= 96);
//   3. the window minimum by van Herk / Gil-Werman: in segments of `window`
//      hashes each segment's suffix and prefix minima, so the minimum over
//      [i, i + window) is min(suffix[i], prefix[i + window - 1]): three
//      shared-memory reads a position whatever the window.
// Every m (1 <= m < k <= 96) takes the same kernel, templated on W.
//
// Bound on the H100: HBM bytes, 1 B of code in and 4 B of bucket out a
// position. The hash's arithmetic is some 70 integer operations a position
// at m = 17 (a funnel shift, a crumb reversal and a compare a word for the
// canonical m-mer, two multiplies and six shifts or xors a word for the
// mix), so the card's integer rate may bound it before its bytes do; the
// halo costs (window - 1) / 2048 more hashes a tile.

#include <cstdint>
#include <cuda_runtime.h>

#include "canonical_key.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;
constexpr int kMaxWindow = 96;
// Staged words past the tile's: the last hash of a tile starts at base
// kTile + window - 2 and reads W + 1 words from word (kTile + window - 2) /
// 16; (k - m - 1) / 16 + ceil(m / 16) <= 6 for every k <= 96.
constexpr int kHaloWords = 6;
constexpr int kHashes = kTile + kMaxWindow - 1;

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
scan_kernel(const int8_t* __restrict__ codes, int64_t n, int k, int m, uint32_t buckets,
            int32_t* __restrict__ out) {
  __shared__ uint32_t staged[kTile / 16 + kHaloWords + 1];
  __shared__ uint32_t hash[kHashes];  // the hashes, then their prefix minima
  __shared__ uint32_t suffix[kHashes];
  const int64_t tile_base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int window = k - m + 1;
  const int count = kTile + window - 1;

  hk::stage_codes<kHaloWords>(codes, n, tile_base, kTile, staged);
  for (int j = threadIdx.x; j < count; j += kThreads) {
    uint32_t q[W + 1];
#pragma unroll
    for (int w = 0; w <= W; ++w) q[w] = staged[(j >> 4) + w];
    uint32_t key[W];
    hk::canonical_key_words<W>(q, j & 15, m, key);
    uint32_t h = 313u;
#pragma unroll
    for (int w = 0; w < W; ++w) h = (h ^ fmix32(key[w])) * 0x9E3779B1u + 0xE6546B64u;
    hash[j] = fmix32(h);
  }
  __syncthreads();

  for (int lo = threadIdx.x * window; lo < count; lo += kThreads * window) {
    const int hi = lo + window < count ? lo + window : count;
    uint32_t run = 0xFFFFFFFFu;
    for (int j = hi - 1; j >= lo; --j) {
      run = min(run, hash[j]);
      suffix[j] = run;
    }
    run = 0xFFFFFFFFu;
    for (int j = lo; j < hi; ++j) {
      run = min(run, hash[j]);
      hash[j] = run;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int64_t p = tile_base + i;
    if (p >= n) break;
    const uint32_t least = min(suffix[i], hash[i + window - 1]);
    out[p] = static_cast<int32_t>(least % buckets);
  }
}

}  // namespace

// codes (n,) int8 in [0, 3] (device pointer; bits above the low two are
// dropped), out (n,) int32; n >= 1, 1 <= m < k <= 96, num_buckets >= 1.
// Returns cudaGetLastError().
extern "C" int hk_minimizer_scan(const void* codes, int64_t n, int k, int m,
                                 uint32_t num_buckets, void* out, void* stream) {
  if (n <= 0 || m < 1 || k <= m || k > kMaxWindow || num_buckets == 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int8_t*>(codes);
  auto* o = static_cast<int32_t*>(out);
  switch ((m + 15) / 16) {
    case 1: scan_kernel<1><<<grid, kThreads, 0, s>>>(c, n, k, m, num_buckets, o); break;
    case 2: scan_kernel<2><<<grid, kThreads, 0, s>>>(c, n, k, m, num_buckets, o); break;
    case 3: scan_kernel<3><<<grid, kThreads, 0, s>>>(c, n, k, m, num_buckets, o); break;
    case 4: scan_kernel<4><<<grid, kThreads, 0, s>>>(c, n, k, m, num_buckets, o); break;
    case 5: scan_kernel<5><<<grid, kThreads, 0, s>>>(c, n, k, m, num_buckets, o); break;
    case 6: scan_kernel<6><<<grid, kThreads, 0, s>>>(c, n, k, m, num_buckets, o); break;
  }
  return static_cast<int>(cudaGetLastError());
}
