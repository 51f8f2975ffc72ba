// Canonical k-mer key build: codes (N,) int8 + valid (N,) bool -> W key words.
//
// Replaces hysortk_tpu/ops/keybuild.py canonical_keys_fused (_keybuild_kernel,
// derive_canonical, load_codes_valid). Same contract: for every position i the
// W big-endian words of min(forward k-mer, reverse complement) starting at i,
// and the all-ones sentinel in every word where valid[i] is false.
//
// Bound on the H100: HBM bytes. Each position reads 2 B (code + valid) and
// writes 4W B; the arithmetic (16W shift-ORs, a crumb reversal per word, a
// W-word compare) is far below the memory time. Design: one thread per
// position; a block stages its 256 codes plus the (16W - 1)-base halo in
// shared memory once, so each code is read from HBM about once, and each
// thread writes its W words to W separate rows with coalesced stores. Reads
// past N are masked to 0 (the TPU version wraps around with a roll); those
// positions are invalid, so they hold the sentinel either way.

#include <cstdint>
#include <cuda_runtime.h>

#include "canonical_key.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 6;

struct KeyRows {
  uint32_t* row[kMaxWords];
};

template <int W>
__global__ void __launch_bounds__(kThreads)
keybuild_kernel(const int8_t* __restrict__ codes,
                const uint8_t* __restrict__ valid, int64_t n, int k,
                KeyRows out) {
  __shared__ uint32_t tile[kThreads + 16 * W];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kThreads;
  for (int j = threadIdx.x; j < kThreads + 16 * W - 1; j += kThreads) {
    const int64_t p = start + j;
    tile[j] = p < n ? static_cast<uint32_t>(codes[p]) & 3u : 0u;
  }
  __syncthreads();

  const int64_t i = start + threadIdx.x;
  if (i >= n) return;
  if (!valid[i]) {
#pragma unroll
    for (int w = 0; w < W; ++w) out.row[w][i] = 0xFFFFFFFFu;
    return;
  }

  uint32_t key[W];
  hk::canonical_key<W>(tile + threadIdx.x, k, key);
#pragma unroll
  for (int w = 0; w < W; ++w) out.row[w][i] = key[w];
}

}  // namespace

// codes (n,) int8, valid (n,) bool, out_rows: W device pointers to (n,)
// uint32 rows, W = ceil(k/16) in 1..6. Returns cudaGetLastError().
extern "C" int hk_keybuild(const void* codes, const void* valid, int64_t n,
                           int k, void* const* out_rows, void* stream) {
  const int w_count = (k + 15) / 16;
  if (n <= 0 || k < 1 || w_count > kMaxWords) return cudaErrorInvalidValue;
  KeyRows out{};
  for (int w = 0; w < w_count; ++w) {
    out.row[w] = static_cast<uint32_t*>(out_rows[w]);
  }
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int8_t*>(codes);
  const auto* v = static_cast<const uint8_t*>(valid);
  switch (w_count) {
    case 1: keybuild_kernel<1><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 2: keybuild_kernel<2><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 3: keybuild_kernel<3><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 4: keybuild_kernel<4><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 5: keybuild_kernel<5><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
    case 6: keybuild_kernel<6><<<grid, kThreads, 0, s>>>(c, v, n, k, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}
