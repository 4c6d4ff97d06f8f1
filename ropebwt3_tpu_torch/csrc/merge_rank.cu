// Merge rank (K6): where each symbol of a partial BWT B2 lands in the
// merged BWT of B1 and B2 (rb3_mg_rank, fm-index.c:143-175).  Each B2
// sequence is walked backwards on B2's LF from its sentinel row j < m2:
//   ka = acc1[1], kb = j;
//   each step: r = rec[kb], c = r & 7; ins[kb] = ka;
//              stop if c == 0; else kb = r >> 3, ka = acc1[c] + occ1_c(ka)
// where rec[i] = (lf2[i] << 3) | B2[i] (construct/merge.py lf2_packed).
// ins[i] is the count of B1 symbols before B2[i] in the merged BWT.
//
// Replaces the XLA window step of ropebwt3_tpu/construct/merge.py:112-123
// (`window.step` of merge_rank_device), which advances all m2 lanes in
// lock-step, and its native twin rb3t_merge_rank_packed
// (native/bwasw_core.cpp:2004-2019).
//
// Bound on the card: dependent chains of row loads.  One thread per
// sequence (8 lanes of 2 M steps a merge of bench.py's genomes) is one
// chain as long as the longest sequence, with the card idle.  So the walks
// are cut into segments, one thread each (pass 1), that start at every
// sentinel row and at every B2 position kb >= m2 with kb % S == 0, and run
// to the next such start or to a `$`:
//   - a sentinel segment is exact from step 0 (ka = acc1[1]);
//   - a strided segment does not know ka, only that ka lies in [0, n1].
//     ka -> acc1[c] + occ1_c(ka) is monotone, so a lower walk lo (from 0)
//     and an upper walk hi (from n1) keep the true ka between them; after
//     k steps [lo, hi) is the backward-search interval in B1 of the k
//     symbols walked, so they meet once that string is absent from B1, and
//     from there on ka = lo is exact.  Until then the lane writes nothing.
// Pass 2 (hand-over): each segment whose end is exact walks on from its
// successor's start, writing ins through the successor's unmet prefix, and
// stops where the successor met (or goes through a successor that never
// met into the one after).  Every position has one writer, no atomics.  A
// B2 sequence that repeats a B1 sequence never meets: its hand-over is the
// whole walk, one thread's chain, whose steps cost ~1.7x those of a walk
// that writes ins over the records (PERF.md; not the row load's place).
// With S > n2 only the sentinel segments exist and pass 1 is the
// one-thread-per-sequence walk.  The starts are strided in BWT order, not
// along the walks (so no suffix array is needed): along a walk a segment's
// length is geometric with mean S, and pass 1's chain is the longest,
// ~S ln(segments); pass 2's is the longest hand-over.
//
// Per segment g (seg, 5 rows of n_seg int64): meet (the step from which g
// writes; kNever if it did not meet), len (its positions), end_pos (its
// successor's start, -1 after a `$`), end_ka (the exact ka there, -1 if
// unknown) and hand (the positions pass 2's lane g wrote).
//
// ins is written apart from the records: the native walk writes it over
// them, but on the card a write to the line just read runs ~5x slower
// (PERF.md).
// Instantiated for the dense rows, int32 and int64 (occ.cuh Dense<T>).

#include <cuda_runtime.h>
#include <stdint.h>

#include "occ.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int64_t kNever = INT64_MAX;

struct Seg {
  int64_t *meet, *len, *end_pos, *end_ka, *hand;
};

struct Walk {
  const int64_t* __restrict__ rec;  // records, read only
  int64_t* __restrict__ ins;        // out
  int64_t m2, first, n_seg;
  int shift;  // S = 2^shift: a mask and a shift, not an int64 division, in each step's chain

  __device__ __forceinline__ int64_t load(int64_t kb) const { return __ldg(rec + kb); }
  __device__ __forceinline__ bool is_start(int64_t kb) const {
    return kb >= m2 && (kb & ((int64_t(1) << shift) - 1)) == 0;
  }
  __device__ __forceinline__ int64_t seg_of(int64_t kb) const { return m2 + (kb >> shift) - first; }
};

template <class L>
__global__ void merge_walk(const L ix, const Walk w, const Seg seg) {
  using T = typename L::T;
  const int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (g >= w.n_seg) return;
  const bool sentinel = g < w.m2;
  int64_t kb = sentinel ? g : (w.first + (g - w.m2)) << w.shift;
  T lo = sentinel ? ix.acc(1) : (T)0, hi = sentinel ? lo : ix.acc(6);  // acc1[6] = n1
  int64_t t = 0, meet = lo == hi ? 0 : kNever;
  for (;;) {
    // both rows and the record issued before any is used; lo, hi <= n1:
    // the extra row covers k = n1
    const bool met = lo == hi;
    int4 a, b, c4, ha, hb, hc;
    ix.load_row(lo >> 6, a, b, c4);
    if (!met) ix.load_row(hi >> 6, ha, hb, hc);
    const int64_t r = w.load(kb);
    const int c = (int)(r & 7);
    if (met) w.ins[kb] = (int64_t)lo;
    ++t;
    if (c == 0) {
      kb = -1;
      break;
    }
    kb = r >> 3;
    lo = ix.acc(c) + ix.rank1(lo, c, a, b, c4);
    if (met) {
      hi = lo;
    } else {
      hi = ix.acc(c) + ix.rank1(hi, c, ha, hb, hc);
      if (lo == hi) meet = t;
    }
    if (w.is_start(kb)) break;
  }
  seg.meet[g] = meet;
  seg.len[g] = t;
  seg.end_pos[g] = kb;
  seg.end_ka[g] = kb >= 0 && lo == hi ? (int64_t)lo : -1;
  seg.hand[g] = 0;  // pass 2, if it runs, counts its writes here
}

template <class L>
__global__ void merge_hand_over(const L ix, const Walk w, const Seg seg) {
  using T = typename L::T;
  const int64_t g = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (g >= w.n_seg) return;
  int64_t kb = seg.end_pos[g], steps = 0;
  const int64_t ka0 = seg.end_ka[g];
  if (kb >= 0 && ka0 >= 0) {
    T ka = (T)ka0;
    int64_t meet = seg.meet[w.seg_of(kb)], t = 0;
    while (t != meet) {  // the segment's own lane writes from its meeting step on
      int4 a, b, c4;
      ix.load_row(ka >> 6, a, b, c4);
      const int64_t r = w.load(kb);
      const int c = (int)(r & 7);
      w.ins[kb] = (int64_t)ka;
      ++steps, ++t;
      if (c == 0) break;
      kb = r >> 3;
      ka = ix.acc(c) + ix.rank1(ka, c, a, b, c4);
      if (w.is_start(kb)) {
        if (t == meet) break;  // met on its last step: its own lane hands over
        meet = seg.meet[w.seg_of(kb)], t = 0;
      }
    }
  }
  seg.hand[g] = steps;
}

template <class L>
int merge_rank(const L& ix, const Walk& w, const Seg& seg, cudaStream_t stream) {
  const unsigned grid = (unsigned)((w.n_seg + kThreads - 1) / kThreads);
  merge_walk<L><<<grid, kThreads, 0, stream>>>(ix, w, seg);
  if (w.n_seg > w.m2) merge_hand_over<L><<<grid, kThreads, 0, stream>>>(ix, w, seg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rec (n2,) int64 records; ins (n2,) int64 out, apart from rec.
// Segments: the m2 sentinel rows, then the multiples of S = 2^shift from
// first * S (first = ceil(m2 / S)) below n2; seg (5, n_seg) int64 out.
// m2 >= 1 (the wrapper launches nothing for m2 == 0).
#define RB3C_MERGE_RANK(name, L)                                                                                    \
  int rb3c_merge_rank_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift, \
                             int block_shift, const int64_t* rec, int64_t* ins, int64_t m2, int shift,               \
                             int64_t first, int64_t n_seg, int64_t* seg, void* stream) {                            \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                        \
    const Walk w{rec, ins, m2, first, n_seg, shift};                                                                 \
    const Seg s{seg, seg + n_seg, seg + 2 * n_seg, seg + 3 * n_seg, seg + 4 * n_seg};                                \
    return merge_rank<L>(ix, w, s, (cudaStream_t)stream);                                                           \
  }
RB3C_MERGE_RANK(dense32, rb3c::Dense<int>)
RB3C_MERGE_RANK(dense64, rb3c::Dense<int64_t>)

}  // extern "C"
