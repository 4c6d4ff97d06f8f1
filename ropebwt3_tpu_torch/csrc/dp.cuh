// The warp-cooperative core of the BWA-SW DP kernels: hapdiv (K8,
// hapdiv.cu) and sw (K9, sw.cu), one warp a window or read.
//
// Both kernels replay the host's sw_update_candset (bwa-sw.c:265-284) into
// a khashl table (kh_resize(n_best * 4): nb buckets, linear probing, a
// resize at maxc keys flagged) and its F-closure (bwa-sw.c:445-483), as the
// JAX bodies do (hapdiv_jax.py hapdiv_device, sw_jax.py sw_device).  Here
// the 32 lanes share that work:
//
// - The merge: a row's candidates are written as slot records (cell x 6:
//   c = 1..5, then the E slot), then taken 32 consecutive slots a round.
//   __match_any_sync groups equal keys; each group's leader folds its
//   members in slot order with strict `>` running maxes (H with its From
//   and pos, E with its, q, rl), probes the table, and merges into the key's
//   bucket; new keys take buckets in slot order from an occupancy bitmask
//   (`place`: the first free bit at or after the probe's end, cyclically),
//   which is where a sequential linear probe puts them (hapdiv_jax.py
//   bucket_scan).  The head flag and the E-type H_from_pos flag come from
//   the same groups.
// - top-N: a bitonic sort of the nb (H << 9 | bucket) keys over the warp's
//   registers (`sort_desc`); the keys are unique, so the order is the one
//   of the host's bounded heap.  sw's prune takes its k-th largest H from
//   the same sort, (H, slot) keys.
// - The closure: pops stay one at a time (each pop's heap minimum gates the
//   next), but a pop's stack scan is a ballot, its five children are probed
//   by five lanes, absent ones placed in c order, the fpar entries, heap
//   inserts (all a pop's inserts share one value) and stack pushes take their
//   places from ballots and popc.  fpar keeps the parent's bucket, and the
//   archive turns it into a column through the final row's bucket -> column
//   map.
//
// The collectives sit behind the wrappers below; the host build (one lane,
// LANES = 1) defines the CUDA names for one lane (tests/test_torch_runblock.py
// HOST_SHIM), so the routines compile with g++ and run on the host.
#pragma once

#include <stdint.h>

#include "occ.cuh"

namespace rb3c {
namespace dp {

constexpr unsigned long long EMPTY = ~0ULL;  // an empty bucket's key
constexpr unsigned FULL = 0xffffffffu;
constexpr int NMAX = 48;    // n_best limit (SCAP: the stack starts with the row's cells)
constexpr int SCAP = 48;    // F-closure stack slots
constexpr int FCAP = 64;    // fpar entries a node
constexpr int ROUND_CAP = 1024;
constexpr int PNONE = 0xFFFF;
constexpr int FROM_H = 0, FROM_E = 1, FROM_F = 2, FROM_OPEN = 0, FROM_EXT = 1;
constexpr uint8_t UNSET8 = 0xFF;  // no fpar entry; no column
constexpr int HEAD = 1 << 4;      // a bucket's flag byte: Hf | Ef << 2 | Ff << 3 | head << 4
constexpr uint32_t HEAP_NEW = 0x1FF;  // the low field of a closure's heap insert (above any bucket)

// ---- the collectives, one warp (the host build: one lane) ----------------
__device__ __forceinline__ unsigned ballot(bool p) { return __ballot_sync(FULL, p); }
__device__ __forceinline__ bool any(bool p) { return __ballot_sync(FULL, p) != 0; }
template <typename V>
__device__ __forceinline__ V shfl(V v, int src) { return __shfl_sync(FULL, v, src); }
template <typename V>
__device__ __forceinline__ V shfl_xor(V v, int m) { return __shfl_xor_sync(FULL, v, m); }
template <typename V>
__device__ __forceinline__ unsigned match_any(V v) { return __match_any_sync(FULL, v); }
__device__ __forceinline__ void sync() { __syncwarp(); }
__device__ __forceinline__ int popc(unsigned v) { return __popc(v); }
__device__ __forceinline__ int first_bit(unsigned v) { return __ffs(v) - 1; }  // v != 0
__device__ __forceinline__ int last_bit(unsigned v) { return 31 - __clz(v); }  // v != 0
__device__ __forceinline__ unsigned below(int lane) { return (1u << lane) - 1u; }
__device__ __forceinline__ void set_bit(uint32_t* occ, int b) { atomicOr(occ + (b >> 5), 1u << (b & 31)); }

// ---- timing-only instantiations: lane 0's clock64 laps by phase ---------
enum { PH_EXT, PH_MERGE, PH_SCAN, PH_TOP1, PH_CLX, PH_CL, PH_TOP2, PH_ARCH, PH_TAIL, NPH };
__device__ __forceinline__ long long now() {
#ifdef __CUDACC__
  return clock64();
#else
  return 0;
#endif
}
template <bool ON>
struct Clk {
  long long t = 0, acc[NPH] = {};
  __device__ __forceinline__ void start() {
    if (ON) t = now();
  }
  __device__ __forceinline__ void lap(int ph) {
    if (ON) {
      const long long u = now();
      acc[ph] += u - t;
      t = u;
    }
  }
  __device__ __forceinline__ void write(long long* out, int lane) const {
    if (ON && lane == 0)
      for (int i = 0; i < NPH; ++i) out[i] = acc[i];
  }
};

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

// A bitonic sort of the LANES x E keys v (key i = lane * E + e), descending.
template <int LANES, int E>
__device__ __forceinline__ void sort_desc(uint32_t (&v)[E], int lane) {
  constexpr int n = LANES * E;
#pragma unroll
  for (int k = 2; k <= n; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= E) {  // the partner is in lane ^ j / E, at the same e
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = lane * E + e;
          const uint32_t o = shfl_xor(v[e], j / E);
          const bool hi = ((i & j) == 0) == ((i & k) == 0);  // keep the larger
          v[e] = hi ? (v[e] > o ? v[e] : o) : (v[e] < o ? v[e] : o);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int pe = e ^ j;
          if (pe > e) {
            const uint32_t a = v[e], b = v[pe];
            const bool swap = ((lane * E + e) & k) == 0 ? a < b : a > b;
            v[e] = swap ? b : a;
            v[pe] = swap ? a : b;
          }
        }
      }
    }
  }
}

// The first free bucket at or after b, cyclically, in the occupancy bitmask
// of nb buckets (words past nb's are never read; below 32 buckets the word's
// high bits are kept set).  The table always has a free bucket.
__device__ __forceinline__ int first_free(const uint32_t* occ, int nb, int b) {
  const int nw = nb >= 32 ? nb >> 5 : 1;
  int w = b >> 5;
  unsigned bits = ~occ[w] & (0xffffffffu << (b & 31));
  while (!bits) {
    w = (w + 1) & (nw - 1);
    bits = ~occ[w];
  }
  return (w << 5) + first_bit(bits);
}

// New keys of the lanes in `nm`, in lane order (slot order), each from the
// empty bucket `b` where its probe ended: the bucket a sequential linear
// probe gives it, now marked in occ.  Distinct probe ends are the buckets
// themselves; if two lanes share one, the lanes walk the bitmask in turn.
template <int LANES>
__device__ __forceinline__ int place(uint32_t* occ, int nb, unsigned nm, int b, int lane) {
  if (!nm) return b;
  const bool mine = (nm >> lane) & 1;
  const unsigned same = match_any(mine ? b : -1 - lane);
  if (!any(mine && popc(same) > 1)) {
    if (mine) set_bit(occ, b);
    sync();
    return b;
  }
  int got = b;
  for (unsigned m = nm; m; m &= m - 1) {
    const int l = first_bit(m);
    const int fb = first_free(occ, nb, shfl(b, l));
    sync();
    if (lane == 0) occ[fb >> 5] |= 1u << (fb & 31);
    if (lane == l) got = fb;
    sync();
  }
  return got;
}

// The khashl table of one node with its row (the N best buckets), the
// candidates' slot records and the closure's state, sized for nb <= NB
// buckets (n_best <= NB / 4): the nb of kh_resize(n_best * 4) is the power of
// two >= 4 n_best.  RL: the cells carry rlen (sw).
template <typename T, int NB, bool RL>
struct Table {
  static constexpr int NBUCKETS = NB;
  static constexpr int N_MAX = NB / 4 < NMAX ? NB / 4 : NMAX;
  static constexpr int S_MAX = 6 * N_MAX;  // a row's candidate slots
  static constexpr int PRUNE = NB * 2;     // sw's prune keys: P_MAX x N_MAX cells, a power of two above
  unsigned long long key[NB];
  T lorc[NB];
  int16_t H[NB], E[NB], F[NB], q[NB], rl[RL ? NB : 1];
  uint32_t pos[NB];  // Hpos | Epos << 16
  uint8_t fl[NB];    // Hf | Ef << 2 | Ff << 3 | head << 4 (the archive word's low bits, and the head)
  uint8_t foff[NB];  // the node's fpar index, UNSET8
  uint8_t col[NB];   // the bucket's column in the final row, UNSET8
  uint32_t occ[NB / 32];
  uint8_t rowb[N_MAX];  // the N best buckets, best first
  union {
    struct {  // a row's candidates: cell x (c = 1..5, E)
      unsigned long long key[S_MAX];
      T lorc[S_MAX];
      uint32_t pay[S_MAX];  // H | q << 12 | rl << 21 | is_e << 30 | Ef << 31; 0: no candidate
    } slot;
    struct {  // the F-closure
      unsigned long long st[SCAP];  // bucket | H << 8 | F << 21 | q << 34 | rl << 44
      uint32_t heap[N_MAX];         // the bounded min-heap, ascending: H << 9 | bucket; 0 empty
      uint8_t fpar[FCAP];           // the popped cell's bucket
    } cl;
    struct {
      int16_t ed[N_MAX];
      uint8_t sel[N_MAX], left[N_MAX];
    } fin;  // K8's final row: dedup and backtrack
  } u;
};

__device__ __forceinline__ uint32_t pack_pay(int H, int q, int rl, int is_e, int ef) {
  return (uint32_t)H | (uint32_t)q << 12 | (uint32_t)rl << 21 | (uint32_t)is_e << 30 | (uint32_t)ef << 31;
}

// Node start: every bucket empty (nb below 32: the word's high bits set).
template <int LANES, class Tb>
__device__ __forceinline__ void clear(Tb& t, int nb, int lane) {
  for (int b = lane; b < Tb::NBUCKETS; b += LANES) t.key[b] = EMPTY;
  for (int w = lane; w < Tb::NBUCKETS / 32; w += LANES) t.occ[w] = nb < 32 ? 0xffffffffu << nb : 0u;
}

// The bucket holding key, or the empty one where a linear probe from its
// home stops (the table is never full: count < maxc < nb).
template <class Tb>
__device__ __forceinline__ int probe(const Tb& t, unsigned long long key, int nb, int nb_bits) {
  int b = home_bucket(key, nb_bits);
  for (int i = 0; i < nb && t.key[b] != EMPTY && t.key[b] != key; ++i) b = (b + 1) & (nb - 1);
  return b;
}

// Slots [0, n) of t.u.slot into the table in slot order (sw_update_candset
// of each), 32 a round; the slot's cell column is slot / 6, its position
// pos_base + that.  count: the node's keys so far.  False when a key count
// reaches maxc (khashl would resize mid-node).
template <int LANES, bool RL, class Tb, class O>
__device__ bool merge(Tb& t, const O& o, int n, int pos_base, int& count, int lane) {
  for (int r = 0; r < n; r += LANES) {
    const int slot = r + lane;
    const uint32_t pay = slot < n ? t.u.slot.pay[slot] : 0u;
    const unsigned long long key = t.u.slot.key[slot < n ? slot : 0];
    const unsigned grp = match_any(key) & ballot(pay != 0);
    const bool lead = pay != 0 && first_bit(grp) == lane;
    int b = 0, found = 0;
    if (lead) {
      b = probe(t, key, o.nb, o.nb_bits);
      found = t.key[b] == key;
    }
    const unsigned nm = ballot(lead && !found);
    if (count + popc(nm) >= o.maxc) return false;
    count += popc(nm);
    b = place<LANES>(t.occ, o.nb, nm, b, lane);
    if (lead) {
      // the group's running maxes in slot order: the first attainment wins
      int H = pay & 0xFFF, hs = slot, q = (pay >> 12) & 0x1FF, rl = (pay >> 21) & 0x1FF;
      int E = (pay >> 30) & 1 ? H : 0, es = slot;
      uint32_t hp = pay, ep = pay;
      for (unsigned m = grp & (grp - 1); m; m &= m - 1) {
        const int s2 = r + first_bit(m);
        const uint32_t p2 = t.u.slot.pay[s2];
        const int H2 = p2 & 0xFFF, E2 = (p2 >> 30) & 1 ? H2 : 0;
        if (H2 > H) H = H2, hs = s2, hp = p2;
        if (E2 > E) E = E2, es = s2, ep = p2;
        q = max(q, (int)((p2 >> 12) & 0x1FF));
        rl = max(rl, (int)((p2 >> 21) & 0x1FF));
      }
      const int hf = (hp >> 30) & 1 ? FROM_E : FROM_H, hpos = hf == FROM_E ? PNONE : pos_base + hs / 6;
      const int ef = (ep >> 30) & 1 ? (int)(ep >> 31) : 0, epos = (ep >> 30) & 1 ? pos_base + es / 6 : PNONE;
      if (!found) {
        t.key[b] = key, t.lorc[b] = t.u.slot.lorc[slot];
        t.H[b] = (int16_t)H, t.E[b] = (int16_t)E, t.F[b] = 0, t.q[b] = (int16_t)q;
        if (RL) t.rl[b] = (int16_t)rl;
        t.pos[b] = (uint32_t)hpos | (uint32_t)epos << 16;
        t.fl[b] = (uint8_t)(hf | ef << 2 | (hs == slot ? HEAD : 0));
        t.foff[b] = UNSET8;
      } else {
        uint32_t ps = t.pos[b];
        uint8_t fl = t.fl[b];
        if (H > t.H[b]) t.H[b] = (int16_t)H, fl = (uint8_t)((fl & ~(3 | HEAD)) | hf), ps = (ps & 0xFFFF0000u) | hpos;
        if (E > t.E[b]) t.E[b] = (int16_t)E, fl = (uint8_t)((fl & ~4) | ef << 2), ps = (ps & 0xFFFFu) | (uint32_t)epos << 16;
        t.pos[b] = ps, t.fl[b] = fl;
        if (q > t.q[b]) t.q[b] = (int16_t)q;
        if (RL && rl > t.rl[b]) t.rl[b] = (int16_t)rl;
      }
    }
    sync();
  }
  return true;
}

// rowb[0..n_row) = the N best occupied buckets by (H << 32 | bucket),
// descending, as the host's bounded heap keeps them; returns n_row.  With
// `first`, false when a key's H was first attained past its head by an E
// candidate (the host's H_from_pos would need the event chain); with
// `final`, col = each bucket's column in the row.
template <int LANES, class Tb>
__device__ bool top_n(Tb& t, int N, int count, bool first, bool final, int& n_row, int lane) {
  constexpr int E = Tb::NBUCKETS / LANES;
  uint32_t v[E];
  bool e_corner = false;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int b = lane * E + e;
    const bool on = t.key[b] != EMPTY;
    v[e] = on ? (uint32_t)t.H[b] << 9 | b : (uint32_t)b;
    e_corner |= first && on && (t.fl[b] & (3 | HEAD)) == FROM_E;
  }
  if (first && any(e_corner)) return false;
  sort_desc<LANES, E>(v, lane);
  n_row = count < N ? count : N;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e, b = v[e] & 0x1FF;
    if (i < n_row) t.rowb[i] = (uint8_t)b;
    if (final) t.col[b] = i < n_row ? (uint8_t)i : UNSET8;
  }
  sync();
  return true;
}

// v's heap: `m` inserts of x (all a pop's inserts share x = rH << 9 |
// HEAP_NEW): each drops the minimum and keeps the array ascending while the
// minimum is below x (an empty 0 while the heap grows).
template <int LANES>
__device__ __forceinline__ void heap_insert(uint32_t* heap, int N, uint32_t x, int m, int lane) {
  int below_x = 0;
  for (int i0 = 0; i0 < N; i0 += LANES) below_x += popc(ballot(i0 + lane < N && heap[i0 + lane] < x));
  const int k = m < below_x ? m : below_x;
  if (!k) return;
  for (int i0 = 0; i0 < N; i0 += LANES) {
    const int i = i0 + lane;
    const uint32_t nv = i >= N ? 0 : i < below_x - k ? heap[i + k] : i < below_x ? x : heap[i];
    sync();
    if (i < N) heap[i] = nv;
    sync();
  }
}

__device__ __forceinline__ unsigned long long stack_entry(int b, int H, int F, int q, int rl) {
  return (unsigned long long)b | (unsigned long long)H << 8 | (unsigned long long)F << 21 |
         (unsigned long long)q << 34 | (unsigned long long)rl << 44;
}

// The F-closure (bwa-sw.c:445-483) of one node as the JAX bodies' cl_body
// runs it, over the row rowb[0..n_row): pops one at a time, each an extend
// (trips), its five children over five lanes.  RL: the cells carry rlen and
// a child's rlen past max_len flags.  False when the window or read goes
// bad.
template <int LANES, bool RL, class L, class Tb, class O, class C>
__device__ bool closure(const L& ix, Tb& t, const O& o, bool gate_f, int n_row, int max_len, int& count,
                        int& trips, C& ck, int lane) {
  using T = typename L::T;
  const int N = o.n_best;
  uint32_t* heap = t.u.cl.heap;
  unsigned long long* st = t.u.cl.st;
  for (int i = lane; i < N; i += LANES) {
    const int j = N - 1 - i;  // ascending: the worst kept cell first, empties (0) before
    heap[i] = j < n_row ? (uint32_t)t.H[t.rowb[j]] << 9 | t.rowb[j] : 0u;
  }
  // the stack: the row's cells that may open an F, the best on top
  int sp = 0;
  for (int j0 = 0; j0 < n_row; j0 += LANES) sp += popc(ballot(j0 + lane < n_row && gate_f && t.H[t.rowb[j0 + lane]] > o.gap_open + o.gap_ext));
  for (int j0 = 0, seen = 0; j0 < n_row; j0 += LANES) {
    const int j = j0 + lane;
    const int b = j < n_row ? t.rowb[j] : 0;
    const bool el = j < n_row && gate_f && t.H[b] > o.gap_open + o.gap_ext;
    const unsigned m = ballot(el);
    if (el) st[sp - 1 - seen - popc(m & below(lane))] = stack_entry(b, t.H[b], t.F[b], t.q[b], RL ? t.rl[b] : 0);
    seen += popc(m);
  }
  sync();
  int nfp = 0;
  for (int round = 0; round < ROUND_CAP && sp > 0; ++round) {
    // every entry above the topmost one that beats the heap's min goes at
    // once: each would have been popped against this same min
    const int minv = (int)(heap[0] >> 9);
    int at = -1;
    for (int i0 = (sp - 1) / LANES * LANES; i0 >= 0 && at < 0; i0 -= LANES) {
      const int i = i0 + lane;
      bool pass = false;
      if (i < sp) {
        const unsigned long long z = st[i];
        const int zH = (int)(z >> 8) & 0x1FFF, zF = (int)(z >> 21) & 0x1FFF;
        pass = (zH - o.gap_open > zF ? zH - o.gap_open : zF) - o.gap_ext > minv;
      }
      const unsigned m = ballot(pass);
      if (m) at = i0 + last_bit(m);
    }
    if (at < 0) {
      sp = 0;
      break;
    }
    sp = at;
    ++trips;
    const unsigned long long z = st[at];
    const int zb = (int)(z & 0xFF), zH = (int)(z >> 8) & 0x1FFF, zF = (int)(z >> 21) & 0x1FFF;
    const int zq = (int)(z >> 34) & 0x3FF, zrl = (int)(z >> 44) & 0x3FF;
    const bool f_open = zH - o.gap_open > zF;
    const int rH = (f_open ? zH - o.gap_open : zF) - o.gap_ext;
    const unsigned long long zkey = t.key[zb];
    const T zlo = (T)(zkey >> 32), zhi = (T)(zkey & 0xffffffffULL);
    ck.lap(PH_CL);
    T olo[5], orc[5], osz[5];
    extend5(ix, zlo, t.lorc[zb], zhi - zlo, olo, orc, osz);
    const uint32_t x = (uint32_t)rH << 9 | HEAP_NEW;
    const bool push = rH - o.gap_ext > minv;
    for (int c0 = 0; c0 < 5; c0 += LANES) {
      const int c = c0 + lane;  // child c + 1
      T lo_c = 0, rc_c = 0, sz_c = 0;
#pragma unroll
      for (int cc = 0; cc < 5; ++cc)
        if (cc == c) lo_c = olo[cc], rc_c = orc[cc], sz_c = osz[cc];
      const bool valid = c < 5 && sz_c > 0;
      const unsigned long long key = key_of(lo_c, (T)(lo_c + sz_c));
      if (c0 == 0) ck.lap(PH_CLX);
      int b = valid ? probe(t, key, o.nb, o.nb_bits) : 0;
      const bool absent = valid && t.key[b] == EMPTY;
      const unsigned am = ballot(absent);
      if (any(valid && count + popc(am & below(lane)) >= o.maxc)) return false;
      count += popc(am);
      b = place<LANES>(t.occ, o.nb, am, b, lane);
      // sw_update_candset of an F candidate: its H and F are rH
      const bool chF = valid && (absent || t.F[b] < rH);
      bool over = false;
      if (valid) {
        if (absent) {
          t.key[b] = key, t.lorc[b] = rc_c;
          t.H[b] = (int16_t)rH, t.E[b] = 0, t.F[b] = 0, t.q[b] = (int16_t)zq;
          if (RL) t.rl[b] = (int16_t)(zrl + 1);
          t.pos[b] = (uint32_t)PNONE | (uint32_t)PNONE << 16;
          t.fl[b] = FROM_F, t.foff[b] = UNSET8;
        } else {
          if (t.H[b] < rH) t.H[b] = (int16_t)rH, t.fl[b] = (uint8_t)((t.fl[b] & ~3) | FROM_F);
          if (zq > t.q[b]) t.q[b] = (int16_t)zq;
          if (RL && zrl + 1 > t.rl[b]) t.rl[b] = (int16_t)(zrl + 1);
        }
        over = RL && t.rl[b] > max_len;
      }
      const unsigned fm = ballot(chF);
      const int fi = nfp + popc(fm & below(lane)), si = sp + popc(fm & below(lane));
      if (any(over || (chF && fi >= FCAP) || (chF && push && si >= SCAP))) return false;
      if (chF) {
        t.F[b] = (int16_t)rH, t.fl[b] = (uint8_t)((t.fl[b] & ~8) | (f_open ? FROM_OPEN : FROM_EXT) << 3);
        t.foff[b] = (uint8_t)fi, t.u.cl.fpar[fi] = (uint8_t)zb;
        if (push) st[si] = stack_entry(b, t.H[b], rH, t.q[b], RL ? t.rl[b] : 0);
      }
      nfp += popc(fm);
      if (push) sp += popc(fm);
      sync();
      heap_insert<LANES>(heap, N, x, popc(fm), lane);
    }
    sync();
  }
  return sp == 0;  // cells left after the round cap: inexact
}

}  // namespace dp
}  // namespace rb3c
