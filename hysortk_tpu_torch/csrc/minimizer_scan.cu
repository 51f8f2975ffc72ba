// The minimizer scan: codes (n,) int8 -> the destination bucket (n,) int32
// of the k-mer that starts at each position, and with a validity mask the
// valid k-mers of every bucket (the bucket sizes of the route's plan).
//
// No TPU kernel: the JAX package scans in XLA (hysortk_tpu/ops/minimizer.py
// mmer_hashes, sliding_window_min, kmer_destinations: the TPU form of the
// reference's monotonic-deque minimum, src/kmerops.cpp:1010-1073) and counts
// the buckets by a one-hot sum (hysortk_tpu/parallel/dispatch.py
// bucket_sizes_device); the port's plain versions are
// ops/minimizer.kmer_destinations_plain and ops/count.chunked_bincount.
// Same contract: the hash of the canonical m-mer starting at j is
// hashes.mix_words of its W = ceil(m / 16) key words (seed 313; per word
// h = (h ^ fmix32(w)) * 0x9E3779B1 + 0xE6546B64; then fmix32(h), all mod
// 2^32), the bucket of position i is the unsigned minimum of the hashes at
// i .. i + k - m modulo num_buckets. Codes are read modulo n, as the plain
// version's rolls wrap them, so every position is exact, the last k - 1
// included. The sizes count the valid positions of each bucket.
//
// What bounds it on the H100: integer issue. Bytes are 1 B of code and 1 B
// of validity in and 4 B of bucket out a position (0.12 ms at 2^26); the
// hash alone is some 30 integer operations a position at m = 17 (W = 2),
// and rebuilding every canonical m-mer from its packed words cost ~50 more
// (a funnel shift, a crumb reversal and a compare a word), ~84 in all: 0.34
// ms of the first kernel's 0.39 at the card's 64 INT32 lanes an SM. So:
//   * a thread owns a strip of consecutive positions and keeps the forward
//     and the reverse-complement m-mer in registers, rolling both by one
//     base a position (a funnel shift a word each, the new base or its
//     complement put in at one end); it builds them from packed words only
//     at the strip's start;
//   * the window minimum is van Herk / Gil-Werman over segments of w = k -
//     m + 1 hashes, and a strip is a whole number of segments: its thread
//     writes its segments' prefix minima while it rolls and their suffix
//     minima in one backward pass over its own strip, so every thread
//     works and none walks another's segment; a position's minimum is then
//     min(suffix[i], prefix[i + w - 1]), two shared reads;
//   * the modulo is a multiply-high by a 64-bit reciprocal (Lemire's
//     fastmod, exact for every 32-bit numerator and divisor);
//   * the sizes are counted in the same pass, in shared memory per block:
//     a warp's lanes hold consecutive positions, whose buckets come in runs
//     (a minimizer spans ~w / 2 positions), so one lane a run adds the run's
//     length (warp-aggregated shared atomics, into a copy of the bins a warp
//     where they fit); each block then adds its nonzero bins to the output
//     with one global atomic each. Above kSharedBins (2048) buckets the same
//     kernel adds straight to the output.
//
// Measured on an H100 (tools/bench_torch_scan_layout.py, 2^26 positions,
// K = 31, m = 17): 0.35 ms without the sizes, 0.44 ms with them, against
// the design's integer floor of ~58 operations a position at 64 INT32
// lanes an SM (0.23 ms, chip_smoke.py phase 11) and 0.12 ms of bytes.
//
// Geometry: a strip is L = w * max(1, 16 / w) positions (8 to 96), a block
// nt = min(256, 4096 / L rounded down to warps) threads, so P = nt * L <=
// 4096 hashes a block; its last segment only serves the segment before it,
// so a block outputs T = (P - w) rounded down to 16 positions (blocks
// overlap by w hashes, under 4%). Shared memory: the packed codes, the
// prefix and the suffix minima, the bins and the output positions'
// validity (45 KB), all staged at the start with the codes, so that no
// later loop waits on device memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "canonical_key.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxBlockHashes = 4096;
constexpr int kMaxWindow = 96;
// Packed words past a block's P positions: the last m-mer ends at base P +
// m - 2 <= P + 94, so P / 16 + 7 words cover it (and the funnel's spare).
constexpr int kHaloWords = 7;
constexpr int kSharedBins = 2048;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kNoBucket = 0xFFFFFFFFu;

struct Geometry {
  int window;   // w = k - m + 1
  int strip;    // L, positions a thread
  int threads;  // nt
  int out;      // T, positions a block outputs
};

Geometry geometry(int k, int m) {
  Geometry g;
  g.window = k - m + 1;
  g.strip = g.window * (16 / g.window > 1 ? 16 / g.window : 1);
  const int fit = (kMaxBlockHashes / g.strip) / 32 * 32;
  g.threads = fit < kMaxThreads ? fit : kMaxThreads;
  g.out = (g.threads * g.strip - g.window) & ~15;
  return g;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// x mod d for the d whose reciprocal is recip = floor((2^64 - 1) / d) + 1
// (mod 2^64).
__device__ __forceinline__ uint32_t fastmod(uint32_t x, uint64_t recip, uint32_t d) {
  const uint64_t low = recip * static_cast<uint64_t>(x);
  return static_cast<uint32_t>(__umul64hi(low, static_cast<uint64_t>(d)));
}

// Stage codes[(base + q) mod n] for q < words * 16, 16 to a word (the first
// in the top crumb). 16-byte loads where the codes are 16-byte aligned and
// the word lies below n (base is a multiple of 16).
__device__ __forceinline__ void stage_wrapped(const int8_t* __restrict__ codes, int64_t n,
                                              int64_t base, int words, uint32_t* room) {
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15u) == 0;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int64_t p = base + 16 * static_cast<int64_t>(w);
    uint32_t word = 0;
    if (aligned && p + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(codes + p);
      word = (hk::pack_four_codes(v.x) << 24) | (hk::pack_four_codes(v.y) << 16) |
             (hk::pack_four_codes(v.z) << 8) | hk::pack_four_codes(v.w);
    } else {
      for (int j = 0; j < 16; ++j) {
        const int64_t q = p + j < n ? p + j : (p + j) % n;
        word = (word << 2) | (static_cast<uint8_t>(codes[q]) & 3u);
      }
    }
    room[w] = word;
  }
}

// Stage valid[base + i] for i < count (count <= kMaxBlockHashes) as bytes,
// 16 at a time where aligned and below n, so that the output loop reads no
// device memory but its stores.
__device__ __forceinline__ void stage_valid(const uint8_t* __restrict__ valid, int64_t n,
                                            int64_t base, int count, uint4* room) {
  const bool aligned = (reinterpret_cast<uintptr_t>(valid) & 15u) == 0;
  for (int c = threadIdx.x; c < (count + 15) / 16; c += blockDim.x) {
    const int64_t p = base + 16 * static_cast<int64_t>(c);
    uint4 v;
    if (aligned && p + 16 <= n) {
      v = *reinterpret_cast<const uint4*>(valid + p);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      for (int j = 0; j < 16; ++j) {
        if (p + j < n) w[j >> 2] |= static_cast<uint32_t>(valid[p + j] != 0) << (8 * (j & 3));
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    room[c] = v;
  }
}

__device__ __forceinline__ uint32_t base_at(const uint32_t* packed, int q) {
  return (packed[q >> 4] >> (30 - 2 * (q & 15))) & 3u;
}

// Drop the m-mer's first base and append c: the forward words shift left
// one base, c enters at the last base's crumb (lead = 32 - 2r).
template <int W>
__device__ __forceinline__ void roll_forward(uint32_t (&f)[W], uint32_t c, int lead) {
#pragma unroll
  for (int w = 0; w + 1 < W; ++w) f[w] = __funnelshift_l(f[w + 1], f[w], 2);
  f[W - 1] = (f[W - 1] << 2) | (c << lead);
}

// The same step on the reverse complement: it shifts right one base, the
// complement of c enters at the top, the dropped base is cut off the end.
template <int W>
__device__ __forceinline__ void roll_twin(uint32_t (&t)[W], uint32_t c, uint32_t last_mask) {
#pragma unroll
  for (int w = W - 1; w > 0; --w) t[w] = __funnelshift_r(t[w], t[w - 1], 2);
  t[0] = (t[0] >> 2) | ((3u - c) << 30);
  t[W - 1] &= last_mask;
}

template <int W>
__device__ __forceinline__ uint32_t mix(const uint32_t (&key)[W]) {
  uint32_t h = 313u;
#pragma unroll
  for (int w = 0; w < W; ++w) h = (h ^ fmix32(key[w])) * 0x9E3779B1u + 0xE6546B64u;
  return fmix32(h);
}


template <int W>
__global__ void __launch_bounds__(kMaxThreads)
scan_kernel(const int8_t* __restrict__ codes, const uint8_t* __restrict__ valid, int64_t n,
            int k, int m, Geometry g, uint32_t buckets, uint64_t recip,
            int32_t* __restrict__ out, int* __restrict__ sizes) {
  __shared__ uint32_t packed[kMaxBlockHashes / 16 + kHaloWords];
  __shared__ uint32_t prefix[kMaxBlockHashes];
  __shared__ uint32_t suffix[kMaxBlockHashes];  // the hashes, then their suffix minima
  __shared__ int bins[kSharedBins];
  __shared__ uint4 valid_s[kMaxBlockHashes / 16];  // the block's output positions' validity
  const int64_t base = static_cast<int64_t>(blockIdx.x) * g.out;
  const int w = g.window;
  const int hashes = g.threads * g.strip;
  const bool sized = valid != nullptr;
  // Shared bins up to kSharedBins buckets: a copy a warp where they fit
  // (no two warps add to one address), else one for the block.
  const int nb = static_cast<int>(buckets);
  const bool shared_bins = buckets <= static_cast<uint32_t>(kSharedBins);
  const int warps = static_cast<int>(blockDim.x) / 32;
  const int copies = shared_bins && nb * warps <= kSharedBins ? warps : 1;
  int* my_bins = bins + (static_cast<int>(threadIdx.x) / 32 % copies) * nb;

  if (sized && shared_bins) {
    for (int b = threadIdx.x; b < nb * copies; b += blockDim.x) bins[b] = 0;
  }
  stage_wrapped(codes, n, base, hashes / 16 + kHaloWords, packed);
  if (sized) stage_valid(valid, n, base, g.out, valid_s);
  __syncthreads();

  // The strip's m-mers, rolled: forward and twin built once at its start.
  const int s0 = threadIdx.x * g.strip;
  const uint32_t last_mask = hk::last_word_mask<W>(m);
  const int lead = 32 - 2 * (m - 16 * (W - 1));
  uint32_t fwd[W], twn[W];
  {
    uint32_t q[W + 1];
#pragma unroll
    for (int j = 0; j <= W; ++j) q[j] = packed[(s0 >> 4) + j];
    const unsigned at = 2u * static_cast<unsigned>(s0 & 15);
#pragma unroll
    for (int j = 0; j < W; ++j) fwd[j] = __funnelshift_l(q[j + 1], q[j], at);
    fwd[W - 1] &= last_mask;
    hk::twin_from_forward<W>(fwd, m, twn);
  }
  uint32_t run = 0;
  for (int j = 0, into = 0; j < g.strip; ++j) {
    uint32_t key[W];
    hk::canonical_of<W>(fwd, twn, key);
    const uint32_t h = mix<W>(key);
    run = into == 0 ? h : min(run, h);
    prefix[s0 + j] = run;
    suffix[s0 + j] = h;
    if (++into == w) into = 0;
    if (j + 1 < g.strip) {
      const uint32_t c = base_at(packed, s0 + j + m);
      roll_forward<W>(fwd, c, lead);
      roll_twin<W>(twn, c, last_mask);
    }
  }
  for (int j = g.strip - 1, into = w - 1; j >= 0; --j) {
    run = into == w - 1 ? suffix[s0 + j] : min(run, suffix[s0 + j]);
    suffix[s0 + j] = run;
    if (--into < 0) into = w - 1;
  }
  __syncthreads();

  // Output: lanes on consecutive positions, so stores coalesce and a
  // warp's equal buckets come in runs.
  const int lane = threadIdx.x & 31;
  for (int first = 0; first < g.out; first += blockDim.x) {
    const int i = first + threadIdx.x;
    const int64_t p = base + i;
    const bool in = i < g.out && p < n;
    uint32_t bucket = 0;
    if (in) {
      bucket = fastmod(min(suffix[i], prefix[i + w - 1]), recip, buckets);
      out[p] = static_cast<int32_t>(bucket);
    }
    if (sized) {
      const uint32_t key =
          in && reinterpret_cast<const uint8_t*>(valid_s)[i] ? bucket : kNoBucket;
      const uint32_t before = __shfl_up_sync(kFull, key, 1);
      const bool starts = lane == 0 || key != before;
      const unsigned bounds = __ballot_sync(kFull, starts);
      if (starts && key != kNoBucket) {
        const unsigned above = bounds & ~((2u << lane) - 1u);
        const int end = above ? __ffs(above) - 1 : 32;
        atomicAdd((shared_bins ? my_bins : sizes) + key, end - lane);
      }
    }
  }
  if (sized && shared_bins) {
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      int sum = 0;
      for (int c = 0; c < copies; ++c) sum += bins[c * nb + b];
      if (sum) atomicAdd(sizes + b, sum);
    }
  }
}

}  // namespace

// codes (n,) int8 in [0, 3] (device pointer; bits above the low two are
// dropped), out (n,) int32; valid (n,) bool and sizes (num_buckets,) int32
// both null, or both given (sizes is zeroed here, then counted); n >= 1,
// 1 <= m < k <= 96, 1 <= num_buckets < 2^31, recip = floor((2^64 - 1) /
// num_buckets) + 1 mod 2^64. Returns cudaGetLastError().
extern "C" int hk_minimizer_scan(const void* codes, const void* valid, int64_t n, int k,
                                 int m, uint32_t num_buckets, uint64_t recip, void* out,
                                 void* sizes, void* stream) {
  if (n <= 0 || m < 1 || k <= m || k > kMaxWindow || num_buckets == 0 ||
      num_buckets >= 0x80000000u || (valid == nullptr) != (sizes == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (sizes != nullptr) {
    const cudaError_t err =
        cudaMemsetAsync(sizes, 0, static_cast<size_t>(num_buckets) * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Geometry g = geometry(k, m);
  const dim3 grid(static_cast<unsigned>((n + g.out - 1) / g.out));
  const auto* c = static_cast<const int8_t*>(codes);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<int32_t*>(out);
  auto* z = static_cast<int*>(sizes);
  switch ((m + 15) / 16) {
    case 1: scan_kernel<1><<<grid, g.threads, 0, s>>>(c, v, n, k, m, g, num_buckets, recip, o, z); break;
    case 2: scan_kernel<2><<<grid, g.threads, 0, s>>>(c, v, n, k, m, g, num_buckets, recip, o, z); break;
    case 3: scan_kernel<3><<<grid, g.threads, 0, s>>>(c, v, n, k, m, g, num_buckets, recip, o, z); break;
    case 4: scan_kernel<4><<<grid, g.threads, 0, s>>>(c, v, n, k, m, g, num_buckets, recip, o, z); break;
    case 5: scan_kernel<5><<<grid, g.threads, 0, s>>>(c, v, n, k, m, g, num_buckets, recip, o, z); break;
    case 6: scan_kernel<6><<<grid, g.threads, 0, s>>>(c, v, n, k, m, g, num_buckets, recip, o, z); break;
  }
  return static_cast<int>(cudaGetLastError());
}
