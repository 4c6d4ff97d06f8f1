// Rank on the run-block compressed occ rows (ops/runblock.py), as a layout
// for the shared routines of occ.cuh.
//
// Replaces the XLA decode of ropebwt3_tpu/ops/runblock.py (decode_row_counts
// and _dense_counts_keyed through RunBlockIndex._counts_and_inblock).  One
// 160-byte row per block of S = 2^block_shift symbols:
//   cols 0..5   counts before the block (as the dense rows' cols 6..11)
//   col  6      escape row index, or -1 for a run-coded block
//   cols 8..39  64 uint16 run records (cumulative in-block end << 3) | KEY
// An escape row holds three keyed bit-planes of S/32 words each.
//
// Bound on the card: one random 160-B row per rank (two 16-B loads for the
// header, then the records in 16-B loads) plus, on escape blocks, the plane
// words below the offset.  The TPU decode reads all 64 records and the whole
// escape row for every rank, because its lanes cannot stop early; here a
// thread stops at the first record that starts at or past the offset (the
// ends are cumulative, so the rest add nothing), and popcounts only the
// escape words below the offset, in 16-B loads of four words per plane: an
// 8192-symbol escape row is 3 KB, so an escape rank still reads ~1.5 KB on
// average, against 48 B for a dense row.
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
    const int4* row = reinterpret_cast<const int4*>(t.rows + 40 * bi);  // 160 B: 16-B aligned
    const int4 h0 = __ldg(row), h1 = __ldg(row + 1);
    const int cols[6] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y};
    T base[6];
    row_base<T>(t, bi, cols, base);
    int cnt[6] = {0, 0, 0, 0, 0, 0};  // in-block counts per KEYED symbol
    if (h1.z < 0) {
      int start = 0;
      for (int q = 0; q < 8 && start < off; ++q) {  // 8 loads of 8 records
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + 2 + q));
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const unsigned e16 = (w[r >> 1] >> (16 * (r & 1))) & 0xffffu;
          int end = (int)(e16 >> 3);
          if (end == 0) end = S;  // F4
          const int len = start < off ? min(off, end) - start : 0;
          const int key = (int)(e16 & 7);
#pragma unroll
          for (int s = 0; s < 6; ++s) cnt[s] += key == s ? len : 0;
          start = end;
        }
      }
    } else {  // three planes of W4 16-B groups each; a row is 12 W4 * 16 B, so every group is 16-B aligned
      const int W4 = S >> 7;
      const uint4* p = reinterpret_cast<const uint4*>(t.esc) + (int64_t)h1.z * 3 * W4;
      for (int q = 0; 128 * q < off; ++q) {  // off <= S: q < W4
        const uint4 a = __ldg(p + q), b = __ldg(p + W4 + q), c = __ldg(p + 2 * W4 + q);
        const unsigned av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int rem = off - 128 * q - 32 * h;  // >= 32: the full word
          const unsigned m = rem <= 0 ? 0u : low_mask((unsigned)rem);
#pragma unroll
          for (int s = 0; s < 6; ++s)
            cnt[s] += __popc(m & (s & 1 ? av[h] : ~av[h]) & (s & 2 ? bv[h] : ~bv[h]) & (s & 4 ? cv[h] : ~cv[h]));
        }
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
