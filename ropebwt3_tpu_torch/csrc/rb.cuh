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
// The LF step (`lf_step`, K11's and K5's walks on rb rows) reads the symbol
// at k and its count below k in one decode of the same two rounds: B[k]
// lies in block k >> block_shift at offset k & (S - 1) (never F1's block
// before: k < n); a run-coded block's records are summed as rank6 sums
// them, and the one that covers the offset gives the key; an escape block's
// sub-row gives the key from its planes' bits at the offset, then that
// key's count below it.  Counting only the symbol the step reads is left
// to a later design (PERF.md).  The merge rank's step (`rank1`, and `rank2`
// while its two bounds differ) counts one symbol it knows beforehand.
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
    int off;
    const int64_t bi = block_of(k, off);
    const int S = 1 << t.block_shift;
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
            int end;
            const int key = record(w, r, S, end);
            const int c = min(off, end);
            const unsigned len = (unsigned)(c - prev);
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
#pragma unroll
      for (int s = 0; s < 6; ++s) cnt[s] = sub_row_count(c, a, b, d, rem, s);
    }
#pragma unroll
    for (int s = 0; s < 6; ++s) occ[s] = base[s] + cnt[comp6(s)];
  }

  // occ_c at both ends of an interval, 0 <= k <= l <= n, for ONE symbol c
  // (suffix_walk's step): one header fetch when both ends fall in one
  // block, one escape sub-row when both fall in one 128-symbol sub-row, a
  // run-coded block's records summed once for both offsets, symbol c's
  // records only; in int64 mode one 8-B megablock word an end, or one for
  // both.  Ends in two blocks fetch both headers, then both second rounds,
  // independently.
  __device__ __forceinline__ void rank2(T k, T l, int c, T& ok, T& ol) const {
    int offk, offl;
    const int64_t bk = block_of(k, offk), bl = block_of(l, offl);
    const int key = comp6(c);
    const int4* rk = reinterpret_cast<const int4*>(t.rows + 40 * bk);  // 160 B: 32-B aligned
    const int4* rl = reinterpret_cast<const int4*>(t.rows + 40 * bl);
    const int4 k0 = __ldg(rk), k1 = __ldg(rk + 1);
    int4 l0 = k0, l1 = k1;
    if (bl != bk) l0 = __ldg(rl), l1 = __ldg(rl + 1);
    T mk = 0, ml = 0;
    if constexpr (sizeof(T) == 8) {
      mk = __ldg(t.mega + 6 * (bk >> t.mega_shift) + c);
      ml = (bl >> t.mega_shift) == (bk >> t.mega_shift) ? mk : __ldg(t.mega + 6 * (bl >> t.mega_shift) + c);
    }
    int ck, cl, unused;
    if (bl == bk) {
      keyed2(rk, k1.z, offk, offl, key, ck, cl);
    } else {
      keyed2(rk, k1.z, offk, offk, key, ck, unused);
      keyed2(rl, l1.z, offl, offl, key, cl, unused);
    }
    ok = base_c(mk, k0, k1, c) + ck;
    ol = base_c(ml, l0, l1, c) + cl;
  }

  // occ_c(k) = |{i < k : B[i] = c}| for ONE known symbol c, 0 <= k <= n
  // (the merge rank's step, csrc/merge_rank.cu): rank2's one-end half.
  // Round 1 is k's header (F1's block), in int64 mode with c's megablock
  // word; round 2 the records (symbol c's summed) or the escape sub-row.
  __device__ __forceinline__ T rank1(T k, int c) const {
    int off;
    const int64_t bk = block_of(k, off);
    const int4* rk = reinterpret_cast<const int4*>(t.rows + 40 * bk);  // 160 B: 32-B aligned
    const int4 k0 = __ldg(rk), k1 = __ldg(rk + 1);
    T mk = 0;
    if constexpr (sizeof(T) == 8) mk = __ldg(t.mega + 6 * (bk >> t.mega_shift) + c);
    int ck, unused;
    keyed2(rk, k1.z, off, off, comp6(c), ck, unused);
    return base_c(mk, k0, k1, c) + ck;
  }

  // One LF step from k, 0 <= k < n: returns c = B[k] and sets nk = acc[c] +
  // occ_c(k), Dense<T>::lf_step's contract.  Round 1 is the row's header
  // (and, in int64 mode, its megablock's six bases); round 2 the records
  // or the escape sub-row, which give both the symbol and its count.
  __device__ __forceinline__ int lf_step(T k, T& nk) const {
    const int64_t bi = (int64_t)k >> t.block_shift;  // not block_of: k < n needs no F1 case
    const int off = (int)(k - (T)(bi << t.block_shift));
    const int4* row = reinterpret_cast<const int4*>(t.rows + 40 * bi);
    const int4 h0 = __ldg(row), h1 = __ldg(row + 1);
    const int cols[6] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y};
    T base[6];
    row_base<T>(t, bi, cols, base);
    int cnt;
    const int c = comp6(key_at(row, h1.z, off, cnt));
    // base[c] by selects: a dynamic index would put the bases in local memory
    const T b = c == 0 ? base[0] : c == 1 ? base[1] : c == 2 ? base[2] : c == 3 ? base[3] : c == 4 ? base[4] : base[5];
    nk = acc(c) + b + cnt;
    return c;
  }

  // The symbol at k, 0 <= k < n: lf_step's decode without the count's use
  __device__ __forceinline__ int sym_at(T k) const {
    const int64_t bi = (int64_t)k >> t.block_shift;
    const int4* row = reinterpret_cast<const int4*>(t.rows + 40 * bi);
    int cnt;
    return comp6(key_at(row, __ldg(row + 1).z, (int)(k - (T)(bi << t.block_shift)), cnt));
  }

  // The KEYED symbol at offset off (0..S-1) of the block whose row is `row`
  // and escape index `e`, and in cnt its count below off in the block.  A
  // run-coded block: the first record whose end passes off covers it; each
  // record adds min(off, end) - min(off, its start) to its key's 16-bit
  // field, as rank6 sums them, and a group of eight that starts past off is
  // skipped.  An escape block: the bits at off of the planes of its sub-row.
  __device__ __forceinline__ int key_at(const int4* row, int e, int off, int& cnt) const {
    const int S = 1 << t.block_shift;
    if (e < 0) {
      uint4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __ldg(reinterpret_cast<const uint4*>(row + 2 + q));
      uint64_t lo = 0;
      unsigned hi = 0;
      int start = 0, key = 0;  // start: the previous record's end, unclamped
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (start <= off) {
          const unsigned w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            int end;
            const int rk = record(w, r, S, end);
            const unsigned len = (unsigned)(min(off, end) - min(off, start));
            lo += rk < 4 ? (uint64_t)len << (16 * rk) : 0;
            hi += rk < 4 ? 0u : len << (16 * (rk & 1));
            if (start <= off && off < end) key = rk;  // one record: ends never decrease
            start = end;
          }
        }
      }
      cnt = (int)((key < 4 ? (unsigned)(lo >> (16 * key)) : hi >> (16 * (key & 1))) & 0xffffu);
      return key;
    }
    const uint4* p = reinterpret_cast<const uint4*>(t.esc) + ((int64_t)e * (S >> 7) + (off >> 7)) * 4;
    const uint4 h = __ldg(p), a = __ldg(p + 1), b = __ldg(p + 2), d = __ldg(p + 3);
    const int rem = off & 127, wi = rem >> 5;
    const unsigned sh = (unsigned)(rem & 31);
    const int key = (int)(((word(a, wi) >> sh) & 1u) | (((word(b, wi) >> sh) & 1u) << 1) | (((word(d, wi) >> sh) & 1u) << 2));
    cnt = sub_row_count(h, a, b, d, rem, key);
    return key;
  }

  // word i (0..3) of v, by selects
  __device__ __forceinline__ static unsigned word(const uint4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }

  // k's block (F1: a block boundary, k = n included, at offset S of the
  // block before; k = 0 at block 0) and its offset there, [0, S]
  __device__ __forceinline__ int64_t block_of(T k, int& off) const {
    const int64_t bi = k > 0 ? (int64_t)(k - 1) >> t.block_shift : 0;
    off = (int)(k - (T)(bi << t.block_shift));
    return bi;
  }

  // symbol c's count before a block, from its header (h0, h1) and, in
  // int64 mode, its megablock word m
  __device__ __forceinline__ static T base_c(T m, const int4& h0, const int4& h1, int c) {
    const int col = c == 0 ? h0.x : c == 1 ? h0.y : c == 2 ? h0.z : c == 3 ? h0.w : c == 4 ? h1.x : h1.y;
    if constexpr (sizeof(T) == 8) return m + (int64_t)(uint32_t)col;
    return col;
  }

  // c1, c2: the in-block counts of `key` below offsets o1 <= o2 of the
  // block whose row is `row` and escape index `e`.  A run-coded block: its
  // records, as rank6 sums them, for two offsets and one key; an escape
  // block: the sub-row of each offset, one fetch when both share it.
  __device__ __forceinline__ void keyed2(const int4* row, int e, int o1, int o2, int key, int& c1, int& c2) const {
    const int S = 1 << t.block_shift;
    if (e < 0) {
      uint4 v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = __ldg(reinterpret_cast<const uint4*>(row + 2 + q));
      int p1 = 0, p2 = 0;  // min(o, the previous record's end): p1 <= p2
      c1 = c2 = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (p2 < o2) {
          const unsigned w[4] = {v[q].x, v[q].y, v[q].z, v[q].w};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            int end;
            const bool is_key = record(w, r, S, end) == key;
            const int x1 = min(o1, end), x2 = min(o2, end);
            if (is_key) c1 += x1 - p1, c2 += x2 - p2;
            p1 = x1, p2 = x2;
          }
        }
      }
    } else {
      const int W4 = S >> 7;
      const int j1 = min(o1 >> 7, W4 - 1), j2 = min(o2 >> 7, W4 - 1);  // o = S: the last sub-row, whole
      const uint4* p = reinterpret_cast<const uint4*>(t.esc) + ((int64_t)e * W4 + j1) * 4;
      const uint4 s0 = __ldg(p), s1 = __ldg(p + 1), s2 = __ldg(p + 2), s3 = __ldg(p + 3);
      uint4 u0 = s0, u1 = s1, u2 = s2, u3 = s3;
      if (j2 != j1) {
        const uint4* q = p + (int64_t)(j2 - j1) * 4;
        u0 = __ldg(q), u1 = __ldg(q + 1), u2 = __ldg(q + 2), u3 = __ldg(q + 3);
      }
      c1 = sub_row_count(s0, s1, s2, s3, o1 - (j1 << 7), key);
      c2 = sub_row_count(u0, u1, u2, u3, o2 - (j2 << 7), key);
    }
  }

  // record r (0..7) of four words of a run-coded block's records: its key,
  // and its end in `end` (F4: a stored end of 0 is S, the block's end)
  __device__ __forceinline__ static int record(const unsigned w[4], int r, int S, int& end) {
    const unsigned e16 = (w[r >> 1] >> (16 * (r & 1))) & 0xffffu;
    end = (e16 >> 3) ? (int)(e16 >> 3) : S;
    return (int)(e16 & 7);
  }

  // `key`'s count below offset rem (0..128) of an escape sub-row: its keyed
  // count before the sub-row (h), then the planes (a, b, d) masked for key
  __device__ __forceinline__ static int sub_row_count(const uint4& h, const uint4& a, const uint4& b, const uint4& d,
                                                      int rem, int key) {
    const unsigned hw = (key >> 1) == 0 ? h.x : (key >> 1) == 1 ? h.y : h.z;
    int cnt = (int)((hw >> (16 * (key & 1))) & 0xffffu);
    const unsigned av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int r = rem - 32 * w;  // >= 32: the full word
      const unsigned m = r <= 0 ? 0u : low_mask((unsigned)r);
      cnt += __popc(m & (key & 1 ? av[w] : ~av[w]) & (key & 2 ? bv[w] : ~bv[w]) & (key & 4 ? dv[w] : ~dv[w]));
    }
    return cnt;
  }
};

}  // namespace rb3c

// X(name, layout type) for every layout, for the entry points of each kernel
#define RB3C_LAYOUTS(X)             \
  X(dense32, rb3c::Dense<int>)      \
  X(dense64, rb3c::Dense<int64_t>)  \
  X(rb32, rb3c::Rb<int>)            \
  X(rb64, rb3c::Rb<int64_t>)
