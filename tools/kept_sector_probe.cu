// A floor on the card for the compaction of csrc/kept_rows.cu: one launch
// that reads keep once and, of R rows of 32-bit words (the key words and
// the counts), only the G-byte pieces that hold a slot where keep holds
// (G = 32, a sector, or 64, two), and does nothing else with them. With
// `dense` every piece is read. Its time against the compaction's says what
// the scattered reads alone cost, and its time at G = 32 against G = 64
// which granularity the card pays for.
//
// Built by tools/bench_torch_kept_rows.py at first use (nvcc, sm_90a, a
// plain C entry point loaded with ctypes); not part of the package.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;

struct ProbeArgs {
  const uint8_t* keep;
  const uint4* rows[kMaxRows];
  int n_rows;
  int64_t pieces;
  bool dense;
  unsigned* sink;
};

template <int G>
__global__ void __launch_bounds__(kThreads) probe_kernel(const __grid_constant__ ProbeArgs a) {
  constexpr int kSlots = G / 4;  // 32-bit slots a piece
  constexpr int kVec = G / 16;   // 16-byte loads a piece
  unsigned acc = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < a.pieces;
       g += stride) {
    bool any;
    if constexpr (kSlots == 8) {
      const uint2 k = *reinterpret_cast<const uint2*>(a.keep + g * kSlots);
      any = (k.x | k.y) != 0;
    } else {
      const uint4 k = *reinterpret_cast<const uint4*>(a.keep + g * kSlots);
      any = (k.x | k.y | k.z | k.w) != 0;
    }
    if (any || a.dense) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r >= a.n_rows) break;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          const uint4 x = __ldg(a.rows[r] + g * kVec + v);
          acc ^= x.x ^ x.y ^ x.z ^ x.w;
        }
      }
    }
  }
  if (acc == 0x9E3779B9u) a.sink[0] = acc;  // keeps the loads
}

}  // namespace

// keep: (n,) bool, 16-byte aligned; rows: n_rows (<= 8) device pointers to
// (n,) 32-bit rows, 64-byte aligned; n a multiple of 16; gran 32 or 64;
// sink: one device word. blocks: the grid.
extern "C" int hk_probe_sectors(const void* keep, void* const* rows, int n_rows, int64_t n,
                                int gran, int dense, void* sink, int blocks, void* stream) {
  if (n_rows < 1 || n_rows > kMaxRows || n % 16 != 0 || (gran != 32 && gran != 64) ||
      blocks < 1) {
    return cudaErrorInvalidValue;
  }
  ProbeArgs a{};
  a.keep = static_cast<const uint8_t*>(keep);
  for (int r = 0; r < n_rows; ++r) a.rows[r] = static_cast<const uint4*>(rows[r]);
  a.n_rows = n_rows;
  a.pieces = n / (gran / 4);
  a.dense = dense != 0;
  a.sink = static_cast<unsigned*>(sink);
  const auto s = static_cast<cudaStream_t>(stream);
  if (gran == 32) {
    probe_kernel<32><<<blocks, kThreads, 0, s>>>(a);
  } else {
    probe_kernel<64><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
