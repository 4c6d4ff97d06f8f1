// Rank and bidirectional extension on the port's occ tables, as __device__
// routines shared by the port's kernels.
//
// Replaces the XLA rank/extend of ropebwt3_tpu/ops/rank.py (_inblock_counts,
// rank1a, extend_c, set_intv, DeviceIndex.bits_and_base) and the in-kernel
// _inblock6 of ops/smem_pallas.py, the dense layout's `lf_step` the LF
// step of ssa_ops.py ssa_gen_device (bwt[k], rank1a, acc), and its `rank1`
// the one-symbol rank of construct/merge.py's merge rank step.  A layout is a small struct with a
// position type T (int below 2^31 - 2^20 symbols, int64_t above), a
// `rank6(k, occ)`, a `rank2(k, l, c, ok, ol)` (one symbol at both ends of
// an interval) and an `acc(c)`; `set_intv` and `extend_c` below work on
// any layout.  This file has the dense fused rows; rb.cuh the run-block rows.
//
// Dense layout (ops/rank.py build_occf): one 48-byte row per 64 BWT symbols,
//   cols 0..5  bit-planes [p0_lo, p0_hi, p1_lo, p1_hi, p2_lo, p2_hi] of
//              KEY[sym] (lo = positions 0..31 of the block, hi = 32..63),
//   cols 6..11 counts of symbols 0..5 before the block: absolute in int32
//              mode; in int64 mode uint32 relative to the megablock of
//              2^mega_shift rows, whose int64 base row is mega[bi >> shift].
// KEY[sym] is sym's position in the complement order 0,4,3,2,1,5, which is
// also the nt6 complement: 0 and 5 are fixed, c <-> 5-c otherwise.
#pragma once

#include <stdint.h>

namespace rb3c {

// The tables of an index as the C entry points take them (kernels.py).
struct Tables {
  const int* rows;       // dense: (nb, 12) int32; rb: (nb, 40) int32
  const int* esc;        // rb escape sub-rows, (n_esc, S / 128, 16) int32 (rb.cuh)
  const int64_t* mega;   // int64 mode: (n_mega, 6) megablock bases
  const void* acc;       // (7,) T
  int mega_shift;        // log2 rows per megablock
  int block_shift;       // log2 symbols per row: 6 dense, log2 S rb
};

template <typename T>
struct Bi {
  T x0, x1, s;  // backward lo, forward lo, size
};

__device__ __forceinline__ int comp6(int c) { return (c == 0 || c == 5) ? c : 5 - c; }

// all ones below `off`; a shift by 32 is undefined in C, so off >= 32 is
// spelled out (ops/smem_pallas.py _inblock6 works around the same trap)
__device__ __forceinline__ unsigned low_mask(unsigned off) { return off >= 32 ? 0xffffffffu : (1u << off) - 1u; }

// base[s] = count of s before a row: cols as absolute int32, or as uint32
// plus the megablock base (reinterpreted, never sign-extended)
template <typename T>
__device__ __forceinline__ void row_base(const Tables& t, int64_t bi, const int c[6], T base[6]) {
  if constexpr (sizeof(T) == 8) {
    const longlong2* m = reinterpret_cast<const longlong2*>(t.mega + 6 * (bi >> t.mega_shift));  // 48 B, 16-B aligned
    const longlong2 a = __ldg(m), b = __ldg(m + 1), d = __ldg(m + 2);
    const int64_t mb[6] = {a.x, a.y, b.x, b.y, d.x, d.y};
#pragma unroll
    for (int s = 0; s < 6; ++s) base[s] = mb[s] + (int64_t)(uint32_t)c[s];
  } else {
#pragma unroll
    for (int s = 0; s < 6; ++s) base[s] = c[s];
  }
}

template <typename TT>
struct Dense {
  using T = TT;
  Tables t;

  __device__ __forceinline__ T acc(int c) const { return __ldg(static_cast<const T*>(t.acc) + c); }

  // Row bi as three 16-byte read-only loads (rows are 48 B, so every row is
  // 16-B aligned): a = planes 0..3, b = planes 4..5 and counts 0..1, c = counts 2..5.
  __device__ __forceinline__ void load_row(int64_t bi, int4& a, int4& b, int4& c) const {
    const int4* row = reinterpret_cast<const int4*>(t.rows) + 3 * bi;
    a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
  }

  // KEY of the symbol at offset off (0..63) of a row: bit off of each plane
  __device__ __forceinline__ static int key_at(const int4& a, const int4& b, unsigned off) {
    const bool hi = off >= 32;
    const unsigned sh = off & 31;
    const unsigned w0 = (unsigned)(hi ? a.y : a.x), w1 = (unsigned)(hi ? a.w : a.z), w2 = (unsigned)(hi ? b.y : b.x);
    return (int)(((w0 >> sh) & 1u) | (((w1 >> sh) & 1u) << 1) | (((w2 >> sh) & 1u) << 2));
  }

  // The symbol at k, 0 <= k < n.  The planes hold KEY[sym], and KEY is the
  // nt6 complement, so comp6 inverts it: the rows stand in for the BWT, and
  // the card holds no BWT array (n bytes saved).
  __device__ __forceinline__ int sym_at(T k) const {
    int4 a, b, c;
    load_row(k >> 6, a, b, c);
    return comp6(key_at(a, b, (unsigned)(k & 63)));
  }

  // One LF step from k, 0 <= k < n: returns c = B[k] and sets nk = acc[c] +
  // occ_c(k).  One 48-B row gives both the symbol and its count; int64 mode
  // adds one 8-B megablock base.
  __device__ __forceinline__ int lf_step(T k, T& nk) const {
    const int64_t bi = k >> 6;
    int4 a, b, c4;
    load_row(bi, a, b, c4);
    const unsigned off = (unsigned)(k & 63);
    const int key = key_at(a, b, off);
    const int c = comp6(key);
    unsigned lo = low_mask(off), hi = low_mask(off > 32 ? off - 32 : 0);
    const unsigned p[6] = {(unsigned)a.x, (unsigned)a.y, (unsigned)a.z, (unsigned)a.w, (unsigned)b.x, (unsigned)b.y};
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      const bool bit = (key >> pl) & 1;
      lo &= bit ? p[2 * pl] : ~p[2 * pl];
      hi &= bit ? p[2 * pl + 1] : ~p[2 * pl + 1];
    }
    // count column c, by selects: a dynamic index would put the row in local memory
    const int col = c == 0 ? b.z : c == 1 ? b.w : c == 2 ? c4.x : c == 3 ? c4.y : c == 4 ? c4.z : c4.w;
    T base;
    if constexpr (sizeof(T) == 8) {
      base = __ldg(t.mega + 6 * (bi >> t.mega_shift) + c) + (int64_t)(uint32_t)col;
    } else {
      base = col;
    }
    nk = acc(c) + base + __popc(lo) + __popc(hi);
    return c;
  }

  // occ_c(k) = |{i < k : B[i] = c}| for ONE symbol c, 0 <= k <= n, from k's
  // row (a, b, c4) as load_row gives it: the merge rank (merge_rank.cu)
  // issues the row load before the load that tells it c.  lf_step's count
  // for a symbol known beforehand.
  __device__ __forceinline__ T rank1(T k, int c, const int4& a, const int4& b, const int4& c4) const {
    return count_c(mega_word(k >> 6, c), c, (unsigned)(k & 63), a, b, c4);
  }

  // occ_c at both ends of an interval, 0 <= k <= l <= n, for ONE symbol c
  // (suffix_walk's step): one row fetch when both ends fall in one row, two
  // independent ones otherwise; in int64 mode one 8-B megablock word an end,
  // or one for both.  Nothing fetched depends on c but that word.
  __device__ __forceinline__ void rank2(T k, T l, int c, T& ok, T& ol) const {
    const int64_t bk = k >> 6, bl = l >> 6;
    int4 a, b, c4, la, lb, lc;
    load_row(bk, a, b, c4);
    if (bl != bk)
      load_row(bl, la, lb, lc);
    else
      la = a, lb = b, lc = c4;
    T mk = 0, ml = 0;
    if constexpr (sizeof(T) == 8) {
      mk = mega_word(bk, c);
      ml = (bl >> t.mega_shift) == (bk >> t.mega_shift) ? mk : mega_word(bl, c);
    }
    ok = count_c(mk, c, (unsigned)(k & 63), a, b, c4);
    ol = count_c(ml, c, (unsigned)(l & 63), la, lb, lc);
  }

  // symbol c's megablock base for row bi (int64 mode; 0 in int32 mode)
  __device__ __forceinline__ T mega_word(int64_t bi, int c) const {
    if constexpr (sizeof(T) == 8) return __ldg(t.mega + 6 * (bi >> t.mega_shift) + c);
    return 0;
  }

  // occ_c below offset off (0..63) of a row (a, b, c4), m its megablock
  // word: the planes masked for KEY[c] below the offset, and count column c
  // by selects (a dynamic index would put the row in local memory)
  __device__ __forceinline__ static T count_c(T m, int c, unsigned off, const int4& a, const int4& b, const int4& c4) {
    const int key = comp6(c);
    unsigned lo = low_mask(off), hi = low_mask(off > 32 ? off - 32 : 0);
    const unsigned p[6] = {(unsigned)a.x, (unsigned)a.y, (unsigned)a.z, (unsigned)a.w, (unsigned)b.x, (unsigned)b.y};
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      const bool bit = (key >> pl) & 1;
      lo &= bit ? p[2 * pl] : ~p[2 * pl];
      hi &= bit ? p[2 * pl + 1] : ~p[2 * pl + 1];
    }
    const int col = c == 0 ? b.z : c == 1 ? b.w : c == 2 ? c4.x : c == 3 ? c4.y : c == 4 ? c4.z : c4.w;
    T base;
    if constexpr (sizeof(T) == 8) {
      base = m + (int64_t)(uint32_t)col;
    } else {
      base = col;
    }
    return base + __popc(lo) + __popc(hi);
  }

  // occ[s] = |{i < k : B[i] = s}| for s = 0..5, 0 <= k <= n: one row.
  __device__ __forceinline__ void rank6(T k, T occ[6]) const {
    const int64_t bi = k >> 6;
    int4 a, b, c;
    load_row(bi, a, b, c);
    const unsigned off = (unsigned)(k & 63);
    const unsigned m_lo = low_mask(off), m_hi = low_mask(off > 32 ? off - 32 : 0);
    const unsigned p[6] = {(unsigned)a.x, (unsigned)a.y, (unsigned)a.z, (unsigned)a.w, (unsigned)b.x, (unsigned)b.y};
    const int cols[6] = {b.z, b.w, c.x, c.y, c.z, c.w};
    T base[6];
    row_base<T>(t, bi, cols, base);
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
};

// Initial bi-interval of one symbol (fm-index.h:90-93).
template <class L>
__device__ __forceinline__ Bi<typename L::T> set_intv(const L& ix, int c) {
  const typename L::T lo = ix.acc(c);
  return {lo, ix.acc(comp6(c)), ix.acc(c + 1) - lo};
}

// Extend bi-interval ik by symbol c (0..5), backward if is_back, else
// forward; the secondary coordinate sums the sizes of the symbols before c
// in the complement order (rld_extend, rld0.c:486-502).
template <class L>
__device__ __forceinline__ Bi<typename L::T> extend_c(const L& ix, Bi<typename L::T> ik, int c, bool is_back) {
  using T = typename L::T;
  const T prim = is_back ? ik.x0 : ik.x1;
  const T sec = is_back ? ik.x1 : ik.x0;
  T tk[6], tl[6];
  ix.rank6(prim, tk);
  ix.rank6(prim + ik.s, tl);
  const int key = comp6(c);
  T szc = 0, tkc = 0, pre = 0;
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const T sz = tl[s] - tk[s];
    if (s == c) {
      szc = sz;
      tkc = tk[s];
    }
    if (comp6(s) < key) pre += sz;
  }
  const T prim_out = ix.acc(c) + tkc;
  return is_back ? Bi<T>{prim_out, sec + pre, szc} : Bi<T>{sec + pre, prim_out, szc};
}

}  // namespace rb3c
