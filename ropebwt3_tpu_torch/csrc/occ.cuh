// Rank and bidirectional extension on the fused occ row table, as __device__
// routines shared by the port's kernels.
//
// Replaces the XLA rank/extend of ropebwt3_tpu/ops/rank.py (_inblock_counts,
// rank1a, extend_c, set_intv) and the in-kernel _inblock6 of
// ops/smem_pallas.py.  Table layout (ops/rank.py build_occf, int32 mode): one
// 48-byte row per 64 BWT symbols,
//   cols 0..5  bit-planes [p0_lo, p0_hi, p1_lo, p1_hi, p2_lo, p2_hi] of
//              KEY[sym] (lo = positions 0..31 of the block, hi = 32..63),
//   cols 6..11 counts of symbols 0..5 before the block (absolute).
// KEY[sym] is sym's position in the complement order 0,4,3,2,1,5, which is
// also the nt6 complement: 0 and 5 are fixed, c <-> 5-c otherwise.
#pragma once

#include <stdint.h>

namespace rb3c {

struct Bi {
  int x0, x1, s;  // backward lo, forward lo, size
};

__device__ __forceinline__ int comp6(int c) { return (c == 0 || c == 5) ? c : 5 - c; }

// all ones below `off`; a shift by 32 is undefined in C, so off >= 32 is
// spelled out (ops/smem_pallas.py _inblock6 works around the same trap)
__device__ __forceinline__ unsigned low_mask(unsigned off) { return off >= 32 ? 0xffffffffu : (1u << off) - 1u; }

// occ[s] = |{i < k : B[i] = s}| for s = 0..5, 0 <= k <= n.  One row = three
// 16-byte read-only loads (rows are 48 B, so every row is 16-B aligned).
__device__ __forceinline__ void rank6(const int* __restrict__ occf, int k, int occ[6]) {
  const int4* row = reinterpret_cast<const int4*>(occf) + 3 * (size_t)(k >> 6);
  const int4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
  const unsigned off = k & 63;
  const unsigned m_lo = low_mask(off), m_hi = low_mask(off > 32 ? off - 32 : 0);
  const unsigned p[6] = {(unsigned)a.x, (unsigned)a.y, (unsigned)a.z, (unsigned)a.w, (unsigned)b.x, (unsigned)b.y};
  const int base[6] = {b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const int key = comp6(s);
    unsigned lo = m_lo, hi = m_hi;
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      const bool bit = (key >> pl) & 1;
      lo &= bit ? p[2 * pl] : ~p[2 * pl];
      hi &= bit ? p[2 * pl + 1] : ~p[2 * pl + 1];
    }
    occ[s] = base[s] + __popc(lo) + __popc(hi);
  }
}

// Initial bi-interval of one symbol (fm-index.h:90-93).
__device__ __forceinline__ Bi set_intv(const int* __restrict__ acc, int c) {
  const int lo = __ldg(acc + c);
  return Bi{lo, __ldg(acc + comp6(c)), __ldg(acc + c + 1) - lo};
}

// Extend bi-interval ik by symbol c (0..5), backward if is_back, else
// forward; the secondary coordinate sums the sizes of the symbols before c
// in the complement order (rld_extend, rld0.c:486-502).
__device__ __forceinline__ Bi extend_c(const int* __restrict__ occf, const int* __restrict__ acc, Bi ik, int c,
                                       bool is_back) {
  const int prim = is_back ? ik.x0 : ik.x1;
  const int sec = is_back ? ik.x1 : ik.x0;
  int tk[6], tl[6];
  rank6(occf, prim, tk);
  rank6(occf, prim + ik.s, tl);
  const int key = comp6(c);
  int szc = 0, tkc = 0, pre = 0;
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const int sz = tl[s] - tk[s];
    if (s == c) {
      szc = sz;
      tkc = tk[s];
    }
    if (comp6(s) < key) pre += sz;
  }
  const int prim_out = __ldg(acc + c) + tkc;
  return is_back ? Bi{prim_out, sec + pre, szc} : Bi{sec + pre, prim_out, szc};
}

}  // namespace rb3c
