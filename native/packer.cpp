// Native fast path for host-side packing of ASCII eBWT / document-array
// files into the device block layout (see ebwt2indel/ops/packing.py for the
// layout contract: 128-char blocks = 3 bitplanes x 4 LSB-first uint32 words +
// 4 absolute uint32 counters).
//
// This replaces the reference's streaming constructor + rank-support build
// (reference: internal/dna_string.hpp:55-110, 275-315) with a single
// multi-threaded pass suitable for multi-GB inputs. Exposed to Python via
// ctypes (build: make -C native).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int BLOCK = 128;
constexpr int WPB = 4;  // uint32 words per plane per block

// ASCII -> 3-bit code; 255 = forbidden
void build_table(uint8_t term, uint8_t* tbl) {
  memset(tbl, 255, 256);
  tbl['A'] = 0;
  tbl['C'] = 1;
  tbl['G'] = 2;
  tbl['T'] = 3;
  tbl[term] = 4;
}

struct ThreadResult {
  int64_t bad_pos = -1;
  uint64_t counts[4] = {0, 0, 0, 0};
};

void pack_range(const uint8_t* data, int64_t n, int64_t block_lo,
                int64_t block_hi, const uint8_t* tbl, uint32_t* blocks,
                int64_t* per_block_counts, ThreadResult* res) {
  for (int64_t b = block_lo; b < block_hi; ++b) {
    uint32_t planes[3][WPB] = {};
    int64_t cnt[4] = {0, 0, 0, 0};
    const int64_t base = b * BLOCK;
    const int64_t lim = n - base < BLOCK ? n - base : BLOCK;
    for (int64_t j = 0; j < lim; ++j) {
      uint8_t code = tbl[data[base + j]];
      if (code == 255) {
        if (res->bad_pos < 0) res->bad_pos = base + j;
        code = 0;
      }
      const int w = (int)(j >> 5);
      const uint32_t bit = 1u << (j & 31);
      if (code & 1) planes[0][w] |= bit;
      if (code & 2) planes[1][w] |= bit;
      if (code & 4) planes[2][w] |= bit;
      if (code < 4) cnt[code]++;
    }
    uint32_t* row = blocks + b * 16;
    for (int p = 0; p < 3; ++p)
      for (int w = 0; w < WPB; ++w) row[p * WPB + w] = planes[p][w];
    for (int c = 0; c < 4; ++c) {
      per_block_counts[b * 4 + c] = cnt[c];
      res->counts[c] += (uint64_t)cnt[c];
    }
  }
}

}  // namespace

extern "C" {

// Pack an in-memory ASCII string. blocks: (n_blocks,16) uint32 zeroed;
// block_counts: (n_blocks,4) int32; totals: int64[5] (A,C,G,T,TERM).
// Returns 0 on success, or 1+index of the first forbidden character.
int64_t pack_ascii(const uint8_t* data, int64_t n, uint8_t term,
                   uint32_t* blocks, int32_t* block_counts, int64_t* totals,
                   int n_threads) {
  const int64_t n_blocks = n / BLOCK + 1;
  uint8_t tbl[256];
  build_table(term, tbl);

  if (n_threads < 1) n_threads = 1;
  std::vector<int64_t> per_block(n_blocks * 4);
  std::vector<ThreadResult> results(n_threads);
  std::vector<std::thread> threads;
  const int64_t per_thread = (n_blocks + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per_thread;
    int64_t hi = lo + per_thread < n_blocks ? lo + per_thread : n_blocks;
    if (lo >= hi) break;
    threads.emplace_back(pack_range, data, n, lo, hi, tbl, blocks,
                         per_block.data(), &results[t]);
  }
  for (auto& th : threads) th.join();

  int64_t bad = -1;
  uint64_t tot[4] = {0, 0, 0, 0};
  for (auto& r : results) {
    if (r.bad_pos >= 0 && (bad < 0 || r.bad_pos < bad)) bad = r.bad_pos;
    for (int c = 0; c < 4; ++c) tot[c] += r.counts[c];
  }
  if (bad >= 0) return 1 + bad;

  // exclusive prefix sums -> absolute counters per block
  int64_t run[4] = {0, 0, 0, 0};
  for (int64_t b = 0; b < n_blocks; ++b) {
    uint32_t* row = blocks + b * 16;
    for (int c = 0; c < 4; ++c) {
      row[12 + c] = (uint32_t)run[c];
      block_counts[b * 4 + c] = (int32_t)run[c];
      run[c] += per_block[b * 4 + c];
    }
  }
  for (int c = 0; c < 4; ++c) totals[c] = (int64_t)tot[c];
  totals[4] = n - (int64_t)(tot[0] + tot[1] + tot[2] + tot[3]);
  return 0;
}

// Pack a 0/1 document array given as ASCII '0'/'1' bytes into rank-1 words.
// words: (n_blocks,4) uint32 zeroed; counts: (n_blocks,) int32.
int64_t pack_da(const uint8_t* data, int64_t n, uint32_t* words,
                int32_t* counts, uint8_t* bits_out) {
  const int64_t n_blocks = n / BLOCK + 1;
  int64_t run = 0;
  for (int64_t b = 0; b < n_blocks; ++b) {
    counts[b] = (int32_t)run;
    const int64_t base = b * BLOCK;
    const int64_t lim = n - base < BLOCK ? n - base : BLOCK;
    for (int64_t j = 0; j < lim; ++j) {
      const uint8_t one = data[base + j] == '1';
      bits_out[base + j] = one;
      if (one) {
        words[b * 4 + (j >> 5)] |= 1u << (j & 31);
        ++run;
      }
    }
  }
  return run;
}

}  // extern "C"
