// The supermer send tensor: each destination's runs gathered from the
// rank's base codes and packed 2 bits a base straight into its segment of
// the exchange, with the runs' lengths (and, in extension mode, their read
// ids and in-read positions) beside them.
//
// No TPU kernel: the JAX package gathers the runs and packs the segments on
// the host (hysortk_tpu/io/supermer.py encode_supermer_streams[_ext], then
// parallel/supermer_route.py _pack_streams / _prepare_exchange_arrays), and
// so did the port until this kernel (io/supermer's encoders with the host
// library's hk_gather_runs, then supermer_route._segments). The result is
// the tensor `_segments` builds, bit for bit: (S, width) int32, width = nw +
// lmax (x3 in extension mode); row s holds destination s's runs, in
// ascending flat order, as
//   words [0, nw)            16 bases a word, big-endian (base b of the
//                            segment at shift 30 - 2 * (b % 16)), zero past
//                            the last run's last base;
//   [nw, nw + lmax)          each run's length in bases, then zeros;
//   [nw + lmax, + 2 lmax)    extension mode: each run's first read id;
//   [nw + 2 lmax, + 3 lmax)  extension mode: each run's first in-read
//                            position (uint32 bits).
// The per-destination bookkeeping (runs grouped by destination in flat
// order, each run's base offset in its segment, the segments' run bounds)
// comes from torch ops on the card (ops/supermer.segment_layout).
//
// One thread per output word, so every word is written exactly once and
// coalesced, the padding included: no memset. A packing thread finds the
// run holding its first base by a binary search over its destination's
// offsets, then walks its 16 bases, stepping to the next run where one
// ends (runs are contiguous in a segment).
//
// Bound on the H100: HBM bytes. In: the bases the runs cover, each once
// (1 B each; the k - 1 bases a run shares with the run before it come from
// cache), the per-run rows (src, off and length: 20 B a run; 28 B with the
// extension-mode headers) and the destinations' bounds. Out: the send
// tensor (1/4 B a base plus the columns).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Runs {
  const int64_t* src;    // first base of each run in the codes
  const int64_t* off;    // its first base in its destination's segment
  const int32_t* bases;  // its length in bases
  const int32_t* rid0;   // extension mode: its first read id, else null
  const int32_t* pos0;   // extension mode: its first in-read position
  const int64_t* dest_begin;  // (S + 1,) the runs of destination s
};

__global__ void __launch_bounds__(kThreads)
pack_segments(const int8_t* codes, Runs runs, int64_t num_dest, int64_t nw,
              int64_t lmax, int64_t width, int32_t* send) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= num_dest * width) return;
  const int64_t s = g / width;
  const int64_t c = g - s * width;
  const int64_t lo = runs.dest_begin[s];
  const int64_t hi = runs.dest_begin[s + 1];
  uint32_t word = 0;
  if (c < nw) {
    const int64_t p0 = c * 16;
    // The last run whose segment offset is <= p0 (offsets ascend from 0).
    int64_t a = lo, b = hi;
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if (runs.off[mid] <= p0) a = mid + 1; else b = mid;
    }
    int64_t j = a - 1;
    if (j >= lo) {
      int64_t run_off = runs.off[j];
      int64_t run_end = run_off + runs.bases[j];
      for (int k = 0; k < 16; ++k) {
        const int64_t p = p0 + k;
        while (p >= run_end) {
          if (++j >= hi) break;
          run_off = runs.off[j];
          run_end = run_off + runs.bases[j];
        }
        if (j >= hi) break;
        const uint32_t code =
            static_cast<uint32_t>(codes[runs.src[j] + (p - run_off)]) & 3u;
        word |= code << (30 - 2 * k);
      }
    }
  } else {
    const int64_t col = c - nw;
    const int64_t which = col / lmax;
    const int64_t r = lo + (col - which * lmax);
    if (r < hi) {
      const int32_t* row = which == 0 ? runs.bases : which == 1 ? runs.rid0 : runs.pos0;
      word = static_cast<uint32_t>(row[r]);
    }
  }
  send[g] = static_cast<int32_t>(word);
}

}  // namespace

// codes: (n,) int8; src, off: (R,) int64; bases, rid0, pos0: (R,) int32
// (rid0 and pos0 null unless extension mode); dest_begin: (S + 1,) int64;
// send: (S, width) int32 with width = nw + lmax * (ext ? 3 : 1). All device
// pointers. Returns cudaGetLastError().
extern "C" int hk_supermer_pack(const void* codes, const void* src, const void* off,
                                const void* bases, const void* rid0, const void* pos0,
                                const void* dest_begin, int64_t num_dest, int64_t nw,
                                int64_t lmax, int ext, void* send, void* stream) {
  const int64_t width = nw + lmax * (ext ? 3 : 1);
  if (num_dest < 1 || nw < 1 || lmax < 1 || (ext && (!rid0 || !pos0))) {
    return cudaErrorInvalidValue;
  }
  const Runs runs{static_cast<const int64_t*>(src), static_cast<const int64_t*>(off),
                  static_cast<const int32_t*>(bases), static_cast<const int32_t*>(rid0),
                  static_cast<const int32_t*>(pos0),
                  static_cast<const int64_t*>(dest_begin)};
  const int64_t total = num_dest * width;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads));
  pack_segments<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), runs, num_dest, nw, lmax, width,
      static_cast<int32_t*>(send));
  return static_cast<int>(cudaGetLastError());
}
