// Device routines that the BWA-SW DP kernels share: hapdiv (K8,
// hapdiv.cu) and sw (K9, sw.cu).  Moved here unchanged from hapdiv.cu:
// the khashl bucket hash and its linear probe, the backward extension of an
// interval by the five symbols, and the top-N selection of a node's row.
// The probe and the selection take any state with the khashl table's
// fields (tkey, tH, rowb, n_row) and any options with its geometry (n_best,
// nb, nb_bits).
#pragma once

#include <stdint.h>

#include "occ.cuh"

namespace rb3c {
namespace dp {

constexpr unsigned long long EMPTY = ~0ULL;  // an empty bucket's key

__device__ __forceinline__ uint32_t splitmix32(uint64_t x) {  // kh_hash_uint64
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return (uint32_t)x;
}

__device__ __forceinline__ int home_bucket(unsigned long long key, int nb_bits) {
  const uint32_t h = splitmix32(key >> 32) + splitmix32(key & 0xffffffffULL);
  return (int)((uint32_t)(h * 2654435769u) >> (32 - nb_bits));
}

template <typename T>
__device__ __forceinline__ unsigned long long key_of(T lo, T hi) {
  return ((unsigned long long)lo << 32) | (unsigned long long)hi;
}

// The bucket holding key, or the first empty one from its home (a linear
// probe; the table is never full: count < maxc < nb).
template <class S, class O>
__device__ __forceinline__ int probe(const S& s, unsigned long long key, const O& o) {
  int b = home_bucket(key, o.nb_bits);
  for (int i = 0; i < o.nb && s.tkey[b] != EMPTY && s.tkey[b] != key; ++i) b = (b + 1) & (o.nb - 1);
  return b;
}

// Backward extension of (lo, lorc, size) by every symbol c = 1..5: out
// (backward lo, forward lo, size) as ops/rank.py extend gives them.
template <class L>
__device__ __forceinline__ void extend5(const L& ix, typename L::T lo, typename L::T lorc, typename L::T size,
                                        typename L::T olo[5], typename L::T orc[5], typename L::T osz[5]) {
  using T = typename L::T;
  T tk[6], tl[6], sz[6];
  ix.rank6(lo, tk);
  ix.rank6(lo + size, tl);
#pragma unroll
  for (int c = 0; c < 6; ++c) sz[c] = tl[c] - tk[c];
#pragma unroll
  for (int c = 1; c < 6; ++c) {
    T pre = 0;
#pragma unroll
    for (int p = 0; p < 6; ++p)
      if (comp6(p) < comp6(c)) pre += sz[p];
    olo[c - 1] = ix.acc(c) + tk[c];
    orc[c - 1] = lorc + pre;
    osz[c - 1] = sz[c];
  }
}

// rowb[0..n_row) = the N best occupied buckets by (H << 32 | bucket),
// descending: a bucket's place is the number of occupied ones above it.
template <class S, class O>
__device__ void top_n(S& s, const O& o, int lane, int lanes) {
  int n = 0;
  for (int b = lane; b < o.nb; b += lanes) {
    if (s.tkey[b] == EMPTY) continue;
    const long long x = ((long long)s.tH[b] << 32) | b;
    int rank = 0;
    for (int b2 = 0; b2 < o.nb; ++b2)
      rank += s.tkey[b2] != EMPTY && (((long long)s.tH[b2] << 32) | b2) > x;
    if (rank < o.n_best) s.rowb[rank] = b;
  }
  for (int b = 0; b < o.nb; ++b) n += s.tkey[b] != EMPTY;
  if (lane == 0) s.n_row = n < o.n_best ? n : o.n_best;
}

}  // namespace dp
}  // namespace rb3c
