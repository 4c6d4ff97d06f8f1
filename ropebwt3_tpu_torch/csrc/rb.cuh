// Rank on the run-block compressed occ rows (ops/runblock.py), as a layout
// for the shared routines of occ.cuh.
//
// Replaces the XLA decode of ropebwt3_tpu/ops/runblock.py:154-220
// (decode_row_counts and _dense_counts_keyed through
// RunBlockIndex._counts_and_inblock).  One 160-byte row per block of
// S = 2^block_shift symbols:
//   cols 0..5   counts before the block (as the dense rows' cols 6..11)
//   col  6      escape index, or -1 for a run-coded block
//   cols 8..39  64 uint16 run records (cumulative in-block end << 3) | KEY
// An escape block is S/128 sub-rows of 64 B (16 int32 words, 64-B aligned;
// ops/runblock.py pack_escapes builds them at upload from the cache's
// three keyed bit-planes):
//   words 0..2   six uint16 keyed counts of the block before the sub-row
//   word  3      pad
//   words 4..15  the four words of planes 0, 1, 2 over its 128 symbols
//
// Bound on the card: a rank is one thread's chain of loads, and the SMEM
// kernel chains its ranks trip after trip, so latency bounds it: two
// dependent rounds a rank.  Round 1 is the row's 32-B header (counts,
// escape index).  Round 2 is, for an escape block, the one sub-row that
// holds the offset, as four 16-B loads (96 B a rank); for a run-coded
// block, the 128 B of records as eight 16-B loads issued together, with
// no exit that depends on their data (32 + 128 B a rank).  The records'
// sum is then the run-coded rank's cost: it skips each group of eight
// records that starts at or past the offset (a branch on registers, not a
// load), and adds into 16-bit fields, not six counters.  Loading the
// records in the header's round (128 B more for an escape rank) and a sum
// over all 64 records without branches each measured slower on bench.py's
// index (PERF.md).  The TPU decode reads all 64 records and the
// whole escape row (3S/8 B: 3 KB at S = 8192) for every rank, because its
// lanes cannot stop early; a rank that popcounted the planes below its
// offset read ~1.5 KB in a loop of dependent trips.
//
// The reference's two faults are fixed here:
//   F1  k at a block boundary (k = n included) is ranked at offset S of block
//       (k-1) >> block_shift, k = 0 at block 0: no row past the table.
//   F4  a record end of 0 is S (8192 << 3 wraps to 0 in uint16).
#pragma once

#include "occ.cuh"

namespace rb3c {

template <typename TT>
struct Rb {
  using T = TT;
  Tables t;

  __device__ __forceinline__ T acc(int c) const { return __ldg(static_cast<const T*>(t.acc) + c); }

  __device__ __forceinline__ void rank6(T k, T occ[6]) const {
    const int64_t bi = k > 0 ? (int64_t)(k - 1) >> t.block_shift : 0;
    const int S = 1 << t.block_shift;
    const int off = (int)(k - (T)(bi << t.block_shift));  // [0, S]
    const int4* row = reinterpret_cast<const int4*>(t.rows + 40 * bi);  // 160 B: 32-B aligned
    const int4 h0 = __ldg(row), h1 = __ldg(row + 1);
    const int cols[6] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y};
    T base[6];
    row_base<T>(t, bi, cols, base);
    int cnt[6];  // in-block counts per KEYED symbol
    if (h1.z < 0) {
      uint4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __ldg(reinterpret_cast<const uint4*>(row + 2 + q));
      // a record covers [previous end, end), and c = min(off, end) never
      // decreases from one record to the next, so a record's count below
      // off is its c minus the c before it; a group that starts at or past
      // off adds nothing.  Keyed
      // counts <= S < 2^16 sum in 16-bit fields: keys 0..3 in lo, 4..5 in hi
      uint64_t lo = 0;
      unsigned hi = 0;
      int prev = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (prev < off) {
          const unsigned w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const unsigned e16 = (w[r >> 1] >> (16 * (r & 1))) & 0xffffu;
            const int c = min(off, (e16 >> 3) ? (int)(e16 >> 3) : S);  // F4
            const unsigned len = (unsigned)(c - prev);
            const int key = (int)(e16 & 7);
            lo += key < 4 ? (uint64_t)len << (16 * key) : 0;
            hi += key < 4 ? 0u : len << (16 * (key & 1));
            prev = c;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) cnt[s] = (int)((lo >> (16 * s)) & 0xffffu);
      cnt[4] = (int)(hi & 0xffffu);
      cnt[5] = (int)(hi >> 16);
    } else {
      const int W4 = S >> 7;
      const int j = min(off >> 7, W4 - 1);  // off = S: the last sub-row, whole
      const int rem = off - (j << 7);       // [0, 128]
      const uint4* p = reinterpret_cast<const uint4*>(t.esc) + ((int64_t)h1.z * W4 + j) * 4;
      const uint4 c = __ldg(p), a = __ldg(p + 1), b = __ldg(p + 2), d = __ldg(p + 3);
      const unsigned before[3] = {c.x, c.y, c.z};
      const unsigned av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int s = 0; s < 6; ++s) cnt[s] = (int)((before[s >> 1] >> (16 * (s & 1))) & 0xffffu);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = rem - 32 * h;  // >= 32: the full word
        const unsigned m = r <= 0 ? 0u : low_mask((unsigned)r);
#pragma unroll
        for (int s = 0; s < 6; ++s)
          cnt[s] += __popc(m & (s & 1 ? av[h] : ~av[h]) & (s & 2 ? bv[h] : ~bv[h]) & (s & 4 ? dv[h] : ~dv[h]));
      }
    }
#pragma unroll
    for (int s = 0; s < 6; ++s) occ[s] = base[s] + cnt[comp6(s)];
  }
};

}  // namespace rb3c

// X(name, layout type) for every layout, for the entry points of each kernel
#define RB3C_LAYOUTS(X)             \
  X(dense32, rb3c::Dense<int>)      \
  X(dense64, rb3c::Dense<int64_t>)  \
  X(rb32, rb3c::Rb<int>)            \
  X(rb64, rb3c::Rb<int64_t>)
