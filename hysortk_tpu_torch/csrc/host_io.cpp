// Host-side hot loops of hysortk_tpu_torch, a C ABI shared library bound with
// ctypes (io/native.py): the FASTA index scan, FASTA newline strip + 2-bit
// code, the 2-bit wire pack, packed-key decode, output formatting, the
// supermer encoder's run decomposition and run gather, and the one-shot
// result's host pages, mapped and faulted in by background workers while
// the card counts (hk_prefault_*; runtime/prefault.py).
//
// The port's own copy of native/host_io.cpp (the JAX package's library),
// with the same entry points and results, and one more (hk_fai_build). The
// loops run on std::thread workers instead of OpenMP, so the library needs nothing beyond the C++
// standard library and builds wherever a C++17 compiler does
// (hysortk_tpu_torch/_build.host_library_path). The worker count is the
// caller's (hk_set_threads; the loader passes torch.get_num_threads() before
// every call), so ranks that share a host's cores split them instead of each
// taking all. No result depends on the worker count.
//
// Reference loops: the .fai index (samtools faidx, which the reference reads,
// src/fastaindex.cpp:20-28), ASCII -> 2-bit (DnaSeq::compress, src/dnaseq.cpp:9-80),
// FASTA strip (FastaIndex::getmydna, src/fastaindex.cpp:248-293), key decode
// (Kmer::GetString, include/kmer.hpp:147-163), supermer boundaries
// (SupermerEncoder, src/kmerops.cpp:1096-1148), output lines
// (src/hysortk.cpp:138-164). Each has a numpy plain version in the package
// (io/fasta, io/supermer, io/writer, ops/kmer) that the tests hold it to.

#include <sys/mman.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <system_error>
#include <thread>
#include <vector>

#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23  // Linux 5.14 and later
#endif

namespace {

std::atomic<int> g_threads{1};

// body(lo, hi) over [0, n) in chunks of `chunk` items, taken in turn by up
// to g_threads workers (the caller's thread is one of them). Serial when one
// chunk covers everything. If the system refuses a thread, the workers that
// did start finish the chunks.
template <class Body>
void parallel_for(int64_t n, int64_t chunk, Body body) {
  if (n <= 0) return;
  chunk = std::max<int64_t>(chunk, 1);
  const int64_t chunks = (n + chunk - 1) / chunk;
  const int64_t workers =
      std::min<int64_t>(g_threads.load(std::memory_order_relaxed), chunks);
  if (workers <= 1) {
    body(0, n);
    return;
  }
  std::atomic<int64_t> next{0};
  auto work = [&]() {
    for (;;) {
      const int64_t c = next.fetch_add(1, std::memory_order_relaxed);
      if (c >= chunks) return;
      const int64_t lo = c * chunk;
      body(lo, std::min(lo + chunk, n));
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(workers - 1);
  for (int64_t t = 1; t < workers; ++t) {
    try {
      pool.emplace_back(work);
    } catch (const std::system_error &) {
      break;
    }
  }
  work();
  for (auto &th : pool) th.join();
}

// Contiguous chunks, about four a worker: static scheduling for loops whose
// items cost the same.
int64_t even_chunk(int64_t n) {
  const int64_t parts = 4 * (int64_t)g_threads.load(std::memory_order_relaxed);
  return std::max<int64_t>((n + parts - 1) / parts, 4096);
}

// ASCII -> 2-bit code, A/a=0 C/c=1 G/g=2 T/t=3, everything else 0.
struct CodeLut {
  uint8_t code[256];
  CodeLut() {
    std::memset(code, 0, sizeof(code));
    code['C'] = code['c'] = 1;
    code['G'] = code['g'] = 2;
    code['T'] = code['t'] = 3;
  }
};
const CodeLut g_lut;

const char kBases[4] = {'A', 'C', 'G', 'T'};

// ASCII whitespace as Python's bytes.split() takes it.
inline bool is_space(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' || c == '\f';
}

// Decimal digits of v >= 0.
inline int digits(int64_t v) {
  int d = 1;
  while (v >= 10) { v /= 10; ++d; }
  return d;
}

inline void put_decimal(uint8_t *&out, int64_t v) {
  char tmp[20];
  int len = 0;
  do { tmp[len++] = (char)('0' + v % 10); v /= 10; } while (v > 0);
  while (len > 0) *out++ = (uint8_t)tmp[--len];
}

// The end (exclusive of its '\n') of the line starting at pos.
inline int64_t line_end(const uint8_t *data, int64_t size, int64_t pos) {
  const void *q = std::memchr(data + pos, '\n', (size_t)(size - pos));
  return q ? (int64_t)((const uint8_t *)q - data) : size;
}

// The one-shot result's host pages (hk_prefault_*): two anonymous mappings
// of `rows` rows each (the keys and the counts, row_bytes[a] bytes a row),
// faulted in by background workers in chunks of chunk_rows rows, taken in
// ascending order across both arrays. Chunk c covers, in array a, the pages
// from fault_end(a, c) to fault_end(a, c + 1): the chunks partition each
// mapping, so when every claimed chunk is done the faulted pages are a
// prefix of each. stop() ends the faulting (each worker finishes its chunk)
// and hands the pages past the kept rows to one more thread, which releases
// them (MADV_DONTNEED, under the mm lock for reading) and then unmaps the
// tail; finish() joins that thread.
struct Prefault {
  uint8_t *base[2] = {nullptr, nullptr};
  int64_t row_bytes[2] = {0, 0};
  int64_t mapped[2] = {0, 0};
  int64_t rows = 0, chunk_rows = 1, chunks = 0, fault_chunks = 0, page = 4096;
  int32_t advice = -1;
  std::atomic<int32_t> populate{0};  // 1 while madvise(advice) serves
  std::atomic<bool> go{false}, stop{false};
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> failed{INT64_MAX};  // the first chunk that failed
  bool stopped = false;                     // hk_prefault_stop has run
  std::vector<std::thread> workers;
  std::thread tail;

  int64_t fault_end(int a, int64_t c) const {
    if (c >= chunks) return mapped[a];
    return c * chunk_rows * row_bytes[a] / page * page;
  }

  // Pages [lo, hi) of array a written: by madvise(advice) while the kernel
  // takes it, else one byte a page. false where the kernel refused them.
  bool fault(int a, int64_t lo, int64_t hi) {
    if (populate.load(std::memory_order_relaxed)) {
      for (;;) {
        if (madvise(base[a] + lo, (size_t)(hi - lo), advice) == 0) return true;
        if (errno == EINTR || errno == EAGAIN) continue;
        if (errno != EINVAL) return false;
        populate.store(0, std::memory_order_relaxed);  // advice unknown here
        break;
      }
    }
    volatile uint8_t *p = base[a];
    for (int64_t off = lo; off < hi; off += page) p[off] = 0;
    return true;
  }

  void work() {
    while (!stop.load(std::memory_order_relaxed)) {
      const int64_t c = next.fetch_add(1, std::memory_order_relaxed);
      if (c >= fault_chunks) return;
      for (int a = 0; a < 2; ++a) {
        const int64_t lo = fault_end(a, c), hi = fault_end(a, c + 1);
        if (hi > lo && !fault(a, lo, hi)) {
          int64_t f = failed.load();
          while (c < f && !failed.compare_exchange_weak(f, c)) {
          }
          stop.store(true);
          return;
        }
      }
    }
  }
};

int64_t page_bytes() {
  static const int64_t page = sysconf(_SC_PAGESIZE) > 0 ? sysconf(_SC_PAGESIZE) : 4096;
  return page;
}

int64_t page_ceil(int64_t bytes) {
  const int64_t p = page_bytes();
  return (bytes + p - 1) / p * p;
}

void *map_pages(int64_t bytes) {
  void *p = mmap(nullptr, (size_t)bytes, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  return p == MAP_FAILED ? nullptr : p;
}

}  // namespace

extern "C" {

// Worker count of the calls that follow (at least 1).
void hk_set_threads(int32_t n) {
  g_threads.store(n < 1 ? 1 : n, std::memory_order_relaxed);
}

// Strip line breaks of FASTA records and code them in one pass.
// raw: the byte range read from the file; record r's sequence starts at
// raw_off[r] (relative to raw) and has seq_len[r] bases laid out in lines of
// line_bases[r] bases every line_width[r] bytes. The output is the
// concatenated code stream; out_off[r] is each record's output offset.
void hk_strip_and_pack(const uint8_t *raw, const int64_t *raw_off,
                       const int64_t *seq_len, const int64_t *line_bases,
                       const int64_t *line_width, const int64_t *out_off,
                       int64_t nrecs, uint8_t *out) {
  // Records differ in length: small chunks, taken in turn.
  parallel_for(nrecs, 8, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const int64_t lb = line_bases[r] > 0 ? line_bases[r] : seq_len[r];
      const int64_t lw = line_width[r] > 0 ? line_width[r] : lb + 1;
      const uint8_t *src = raw + raw_off[r];
      uint8_t *dst = out + out_off[r];
      int64_t remaining = seq_len[r];
      while (remaining > 0) {
        const int64_t take = remaining < lb ? remaining : lb;
        for (int64_t i = 0; i < take; ++i) dst[i] = g_lut.code[src[i]];
        dst += take;
        src += lw;
        remaining -= take;
      }
    }
  });
}

// Packed canonical keys -> ASCII. keys is row-major (n, w) uint32; out gets
// n*k chars (no separators).
void hk_decode_keys(const uint32_t *keys, int64_t n, int32_t w, int32_t k,
                    char *out) {
  parallel_for(n, even_chunk(n), [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint32_t *key = keys + i * w;
      char *dst = out + i * k;
      for (int32_t j = 0; j < k; ++j) {
        const uint32_t word = key[j >> 4];
        dst[j] = kBases[(word >> (2 * (15 - (j & 15)))) & 3u];
      }
    }
  });
}

// 2-bit wire pack: 16 base codes per uint32 word, base b at bit shift
// 30 - 2*(b%16) (the host side of ops/wire.py; the density of the
// reference's supermer payload, src/kmerops.cpp:1096-1107). Packs the n
// codes into out[0, words) and zero-fills the words past them, a partial
// last word included; words >= ceil(n / 16).
void hk_pack_2bit(const uint8_t *codes, int64_t n, uint32_t *out, int64_t words) {
  parallel_for(words, even_chunk(words), [&](int64_t lo, int64_t hi) {
    for (int64_t wi = lo; wi < hi; ++wi) {
      const int64_t first = wi * 16;
      const uint8_t *c = codes + first;
      uint32_t v = 0;
      if (first + 16 <= n) {
        for (int j = 0; j < 16; ++j) v |= (uint32_t)(c[j] & 3u) << (30 - 2 * j);
      } else {
        for (int64_t j = 0; j < n - first; ++j)
          v |= (uint32_t)(c[j] & 3u) << (30 - 2 * j);
      }
      out[wi] = v;
    }
  });
}

// The .fai index of a FASTA held in data[0, size), by the rule of the JAX
// package's generate_fai (hysortk_tpu/io/fasta.py): a record is a line
// starting with '>' and the lines up to the next one (lines before the first
// are no record's); its length is the sum of its lines' lengths less a
// trailing '\r' each, its offset the first line's start, linebases the first
// line's length and linewidth the distance between the first two lines'
// starts, each at least 1, or length and length + 1 for a single line; a
// record without lines is (0, header end + 1, 0, 0). Its name is the
// header's first whitespace-separated field, [name_lo, name_hi) in data;
// name_lo == name_hi where there is none. The newline after the last line
// is optional.
//
// Returns the record count n; fills the outputs only where n <= cap (so a
// first call with cap 0 counts). cols holds four rows of cap: length,
// offset, linebases, linewidth. text receives the .fai file's bytes,
// "name\tlength\toffset\tlinebases\tlinewidth\n" a record, their count in
// *text_len; it must hold size + 85 * n bytes. The work is cut into
// contiguous chunks that start at header lines, about four a worker: three
// passes (count, columns, text) place each chunk's records and bytes after
// the chunks before it, so nothing depends on the worker count.
int64_t hk_fai_build(const uint8_t *data, int64_t size, int64_t cap,
                     int64_t *cols, int64_t *name_lo, int64_t *name_hi,
                     uint8_t *text, int64_t *text_len) {
  const int64_t workers = g_threads.load(std::memory_order_relaxed);
  int64_t nchunks = std::min<int64_t>(4 * workers, size / (1 << 20) + 1);
  std::vector<int64_t> bound(nchunks + 1, size);
  bound[0] = 0;
  for (int64_t c = 1; c < nchunks; ++c) {
    // The first header line starting at or after c * size / nchunks.
    int64_t p = std::max(c * size / nchunks, bound[c - 1]);
    while (p < size && !(p > 0 && data[p - 1] == '\n' && data[p] == '>')) {
      const void *q = std::memchr(data + p, '\n', (size_t)(size - p));
      p = q ? (int64_t)((const uint8_t *)q - data) + 1 : size;
    }
    bound[c] = p;
  }
  std::vector<int64_t> rec_off(nchunks + 1, 0), byte_off(nchunks + 1, 0);
  parallel_for(nchunks, 1, [&](int64_t c_lo, int64_t c_hi) {
    for (int64_t c = c_lo; c < c_hi; ++c) {
      int64_t n = 0;
      for (int64_t p = bound[c]; p < bound[c + 1];
           p = line_end(data, size, p) + 1) {
        n += data[p] == '>';
      }
      rec_off[c + 1] = n;
    }
  });
  for (int64_t c = 0; c < nchunks; ++c) rec_off[c + 1] += rec_off[c];
  const int64_t n = rec_off[nchunks];
  if (n > cap) return n;
  int64_t *length = cols, *offset = cols + cap, *linebases = cols + 2 * cap,
          *linewidth = cols + 3 * cap;
  parallel_for(nchunks, 1, [&](int64_t c_lo, int64_t c_hi) {
    for (int64_t c = c_lo; c < c_hi; ++c) {
      int64_t r = rec_off[c] - 1, n_seq = 0, total = 0, first = 0, first_len = 0,
              second = 0, bytes = 0;
      auto finish = [&]() {
        if (r < rec_off[c]) return;
        if (n_seq > 0) {
          length[r] = total;
          offset[r] = first;
          linebases[r] = std::max<int64_t>(n_seq > 1 ? first_len : total, 1);
          linewidth[r] = std::max<int64_t>(n_seq > 1 ? second - first : total + 1, 1);
        }
        bytes += name_hi[r] - name_lo[r] + 5 + digits(length[r]) + digits(offset[r]) +
                 digits(linebases[r]) + digits(linewidth[r]);
      };
      for (int64_t p = bound[c]; p < bound[c + 1];) {
        const int64_t e = line_end(data, size, p);
        if (data[p] == '>') {
          finish();
          ++r;
          n_seq = total = 0;
          length[r] = linebases[r] = linewidth[r] = 0;
          offset[r] = e + 1;
          int64_t a = p + 1;
          while (a < e && is_space(data[a])) ++a;
          int64_t b = a;
          while (b < e && !is_space(data[b])) ++b;
          name_lo[r] = a;
          name_hi[r] = b;
        } else if (r >= rec_off[c]) {
          const int64_t len = e - p - (e > 0 && data[e - 1] == '\r');
          if (n_seq == 0) {
            first = p;
            first_len = len;
          } else if (n_seq == 1) {
            second = p;
          }
          ++n_seq;
          total += len;
        }
        p = e + 1;
      }
      finish();
      byte_off[c + 1] = bytes;
    }
  });
  for (int64_t c = 0; c < nchunks; ++c) byte_off[c + 1] += byte_off[c];
  parallel_for(nchunks, 1, [&](int64_t c_lo, int64_t c_hi) {
    for (int64_t c = c_lo; c < c_hi; ++c) {
      uint8_t *out = text + byte_off[c];
      for (int64_t r = rec_off[c]; r < rec_off[c + 1]; ++r) {
        std::memcpy(out, data + name_lo[r], (size_t)(name_hi[r] - name_lo[r]));
        out += name_hi[r] - name_lo[r];
        for (const int64_t v : {length[r], offset[r], linebases[r], linewidth[r]}) {
          *out++ = '\t';
          put_decimal(out, v);
        }
        *out++ = '\n';
      }
    }
  });
  *text_len = byte_off[nchunks];
  return n;
}

// Render "kmer\tcount\n" lines for the output writer. counts are int32.
// Returns the number of bytes written; out must have n * (k + 12) capacity.
// Two passes over the same row chunks (four a worker): the first sums each
// chunk's bytes (the count's digits are the only variable width), a
// sequential scan places the chunks, the second fills them. The chunking
// moves only where a chunk starts, so the bytes are the same for any worker
// count.
int64_t hk_format_output(const uint32_t *keys, const int32_t *counts,
                         int64_t n, int32_t w, int32_t k, char *out) {
  if (n == 0) return 0;
  int64_t nchunks = 4 * (int64_t)g_threads.load(std::memory_order_relaxed);
  if (nchunks > n) nchunks = n;
  const int64_t rows_per = (n + nchunks - 1) / nchunks;
  nchunks = (n + rows_per - 1) / rows_per;
  std::vector<int64_t> chunk_off(nchunks + 1, 0);
  parallel_for(nchunks, 1, [&](int64_t c_lo, int64_t c_hi) {
    for (int64_t c = c_lo; c < c_hi; ++c) {
      const int64_t lo = c * rows_per;
      const int64_t hi = std::min(lo + rows_per, n);
      int64_t b = 0;
      for (int64_t i = lo; i < hi; ++i) {
        int32_t v = counts[i];
        int32_t d = 1;  // c <= 0 renders as the single digit '0'
        while (v >= 10) { v /= 10; ++d; }
        b += (int64_t)k + 2 + d;
      }
      chunk_off[c + 1] = b;
    }
  });
  for (int64_t c = 0; c < nchunks; ++c) chunk_off[c + 1] += chunk_off[c];
  parallel_for(nchunks, 1, [&](int64_t c_lo, int64_t c_hi) {
    for (int64_t c = c_lo; c < c_hi; ++c) {
      const int64_t lo = c * rows_per;
      const int64_t hi = std::min(lo + rows_per, n);
      int64_t pos = chunk_off[c];
      for (int64_t i = lo; i < hi; ++i) {
        const uint32_t *key = keys + i * w;
        for (int32_t j = 0; j < k; ++j) {
          const uint32_t word = key[j >> 4];
          out[pos++] = kBases[(word >> (2 * (15 - (j & 15)))) & 3u];
        }
        out[pos++] = '\t';
        char tmp[12];
        int32_t cval = counts[i], len = 0;
        if (cval <= 0) tmp[len++] = '0';
        while (cval > 0) { tmp[len++] = (char)('0' + cval % 10); cval /= 10; }
        while (len > 0) out[pos++] = tmp[--len];
        out[pos++] = '\n';
      }
    }
  });
  return chunk_off[nchunks];
}

// Supermer run decomposition of the flat k-mer stream (the reference's
// SupermerEncoder boundary rule, src/kmerops.cpp:1096-1148): a run is a
// maximal stretch of consecutive valid k-mer starts sharing a destination,
// split every max_kmers starts (the 250-base cap). One sequential pass, as
// each boundary depends on the previous position; fills out_start (flat
// index of the run's first k-mer), out_kmers and out_dest; returns the run
// count. The output buffers must hold one entry per valid position.
int64_t hk_run_boundaries(const uint8_t *valid, const int32_t *dest,
                          int64_t n, int64_t max_kmers,
                          int64_t *out_start, int64_t *out_kmers,
                          int32_t *out_dest) {
  int64_t runs = 0;
  int64_t prev = -2;        // last valid flat position
  int64_t run_pos = 0;      // k-mers since the UNCAPPED run's start
  int32_t cur_dest = -1;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    const int32_t d = dest[i];
    const bool new_run = (i != prev + 1) || (d != cur_dest);
    if (new_run) run_pos = 0;
    if (new_run || (run_pos % max_kmers) == 0) {
      out_start[runs] = i;
      out_kmers[runs] = 0;
      out_dest[runs] = d;
      ++runs;
    }
    ++out_kmers[runs - 1];
    ++run_pos;
    prev = i;
    cur_dest = d;
  }
  return runs;
}

// Concatenate the per-run code slices codes[start .. start+bases) at the
// given output offsets (the caller prefix-sums the lengths): the gather
// behind the per-destination supermer streams
// (io/supermer.encode_supermer_streams).
void hk_gather_runs(const int8_t *codes, const int64_t *starts,
                    const int64_t *bases, const int64_t *out_off,
                    int64_t n_runs, int8_t *out) {
  parallel_for(n_runs, 1024, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      std::memcpy(out + out_off[r], codes + starts[r], (size_t)bases[r]);
    }
  });
}

// Valid k-mer starts of reads of the given lengths: the sum of
// max(len - k + 1, 0).
int64_t hk_valid_kmers(const int64_t *lengths, int64_t n, int32_t k) {
  const int64_t parts = std::max<int64_t>(1, std::min<int64_t>(
      4 * (int64_t)g_threads.load(std::memory_order_relaxed), n / 65536 + 1));
  const int64_t per = (n + parts - 1) / parts;
  std::vector<int64_t> sums(parts, 0);
  parallel_for(parts, 1, [&](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      int64_t s = 0;
      for (int64_t i = c * per; i < std::min(n, (c + 1) * per); ++i)
        s += std::max<int64_t>(lengths[i] - k + 1, 0);
      sums[c] = s;
    }
  });
  int64_t total = 0;
  for (const int64_t s : sums) total += s;
  return total;
}

// Unmaps [p, p + bytes) (pages a job kept, hk_prefault_stop); 0, or the
// errno of munmap.
int32_t hk_unmap(void *p, int64_t bytes) {
  if (p == nullptr || bytes <= 0) return 0;
  return munmap(p, (size_t)bytes) == 0 ? 0 : errno;
}

// Maps the result's two arrays, rows rows of row_bytes0 and row_bytes1
// bytes (lazily: MAP_NORESERVE, so only touched pages take memory), and
// starts max(1, threads - 1) workers that fault in the pages of their first
// fault_rows rows (at most rows), chunk_rows rows a chunk, by
// madvise(advice) (MADV_POPULATE_WRITE; a negative advice, or one the
// kernel does not know, writes one byte a page instead). Returns at once:
// the job, or null where a mapping was refused (nothing is left mapped
// then) or rows < 1.
void *hk_prefault_start(int64_t rows, int64_t row_bytes0, int64_t row_bytes1,
                        int64_t chunk_rows, int32_t advice, int64_t fault_rows) {
  if (rows < 1 || row_bytes0 < 1 || row_bytes1 < 1) return nullptr;
  auto *job = new Prefault;
  job->rows = rows;
  job->page = page_bytes();
  job->chunk_rows = std::max<int64_t>(chunk_rows, 1);
  fault_rows = std::min(std::max<int64_t>(fault_rows, 0), rows);
  job->fault_chunks = (fault_rows + job->chunk_rows - 1) / job->chunk_rows;
  job->chunks = (rows + job->chunk_rows - 1) / job->chunk_rows;
  job->advice = advice;
  job->populate.store(advice >= 0 ? 1 : 0);
  const int64_t rb[2] = {row_bytes0, row_bytes1};
  for (int a = 0; a < 2; ++a) {
    job->row_bytes[a] = rb[a];
    job->mapped[a] = page_ceil(rows * rb[a]);
    job->base[a] = (uint8_t *)map_pages(job->mapped[a]);
    if (job->base[a] == nullptr) {
      if (a == 1) munmap(job->base[0], (size_t)job->mapped[0]);
      delete job;
      return nullptr;
    }
  }
  // The workers wait until all are made: a thread's stack is mapped under
  // the mm lock, which a worker's faults take for reading.
  const int64_t n = std::min<int64_t>(
      std::max<int64_t>(g_threads.load(std::memory_order_relaxed) - 1, 1), job->fault_chunks);
  for (int64_t t = 0; t < n; ++t) {
    try {
      job->workers.emplace_back([job] {
        while (!job->go.load(std::memory_order_acquire)) std::this_thread::yield();
        job->work();
      });
    } catch (const std::system_error &) {
      break;
    }
  }
  job->go.store(true, std::memory_order_release);
  return job;
}

// The base address of array a (0: keys, 1: counts) of a job.
void *hk_prefault_base(void *job, int32_t a) {
  return static_cast<Prefault *>(job)->base[a];
}

// Stops the job's workers and joins them (each finishes the chunk it
// holds), then keeps each array's pages up to its first keep_rows rows and
// hands the rest to a thread of its own: the faulted pages past them
// released (MADV_DONTNEED), then the tail unmapped. out[0..1]: the bytes
// faulted in each array (a prefix), out[2..3] the bytes released,
// out[4..5] the bytes each array keeps mapped, out[6] 1 where madvise
// faulted the pages, 0 where they were written a byte a page.
void hk_prefault_stop(void *handle, int64_t keep_rows, int64_t *out) {
  auto *job = static_cast<Prefault *>(handle);
  if (job->stopped) return;  // stopped once; out is left as it was
  job->stop.store(true);
  for (auto &w : job->workers) w.join();
  job->workers.clear();
  const int64_t done = std::min({job->next.load(), job->fault_chunks, job->failed.load()});
  keep_rows = std::min(std::max<int64_t>(keep_rows, 0), job->rows);
  int64_t keep[2], faulted[2];
  for (int a = 0; a < 2; ++a) {
    faulted[a] = job->fault_end(a, done);
    keep[a] = std::min(page_ceil(keep_rows * job->row_bytes[a]), job->mapped[a]);
    out[a] = faulted[a];
    out[2 + a] = std::max<int64_t>(faulted[a] - keep[a], 0);
    out[4 + a] = keep[a];
  }
  out[6] = job->populate.load();
  auto release = [job, keep, faulted] {
    for (int a = 0; a < 2; ++a) {
      if (faulted[a] > keep[a])
        madvise(job->base[a] + keep[a], (size_t)(faulted[a] - keep[a]), MADV_DONTNEED);
      if (job->mapped[a] > keep[a])
        munmap(job->base[a] + keep[a], (size_t)(job->mapped[a] - keep[a]));
    }
  };
  job->stopped = true;
  try {
    job->tail = std::thread(release);
  } catch (const std::system_error &) {
    release();  // no thread to be had: released here
  }
}

// Joins the job's release thread (stopping the job first, with no rows
// kept, where it was not stopped) and frees the job. The kept pages stay
// mapped: the caller unmaps them (hk_unmap).
void hk_prefault_finish(void *handle) {
  auto *job = static_cast<Prefault *>(handle);
  if (!job->stopped) {
    int64_t out[7];
    hk_prefault_stop(handle, 0, out);
  }
  if (job->tail.joinable()) job->tail.join();
  delete job;
}

}  // extern "C"
