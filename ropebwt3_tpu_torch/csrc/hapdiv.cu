// The hapdiv DP (K8): the anno BWA-SW DP of sw_core (bwa-sw.c:329-526) over
// the linear DAWG of each window, one warp a window.  Per window of K nt6
// symbols it gives n_al, max_ed, n_hap[0..6] and the `bad` flag of
// ropebwt3_tpu_torch/align/hapdiv.py (hapdiv_plain is its plain version).
//
// Replaces the XLA body of ropebwt3_tpu/align/hapdiv_jax.py hapdiv_device
// (:401-1026): node_body (:447) scanned over K nodes, the final row's
// containment dedup (:953-970), the anno backtrack (:973-1017) and the
// counts (:1019-1026).
//
// Bound on the card: each window is a chain of about K x (1 + closure
// rounds) dependent extends (a node's row extends, then one extend a
// closure pop), each two 48-B row loads at the probe's ns a step; between
// them a few hundred instructions of candidate merge, khashl replay and
// heap upkeep.  The TPU body ran all windows in lock-step: sorts and scans
// stood in for the sequential khashl replay, one-hot reductions for
// scatters, and every window waited for the slowest window's closure.  Here
// a window is one warp with its whole state in shared memory (~6-23 KB by
// n_best and the index width): the row's cells spread over the lanes, so a
// node's extends issue together, and lane 0 replays the host's order
// itself: candidates in insert order (cell k, c = 1..5, then the E slot)
// merged into the khashl table as sw_update_candset does (running maxes,
// the first attainment keeping the From fields), the F-closure's pops, the
// bounded heap as a sorted array.  Windows run independently: the closure's
// round cap and the backtrack's step cap count per window, which gives the
// lock-step body's flags (a window's rounds there are its own).  The rows of
// the backtrack's archive (two words a cell a node) go to device memory.
// Every `bad` condition of hapdiv_device is raised in the same order of
// work; once raised the window stops.
//
// The khashl probe, the extends and the top-N selection are csrc/dp.cuh's,
// shared with sw.cu.  The text up to the kernel compiles with g++ given a
// header that defines the CUDA keywords: `hapdiv_window` then runs one
// window on the host with one lane (lanes = 1).

#include <stdint.h>

#include "dp.cuh"

namespace rb3c {
namespace hapdiv {

using dp::EMPTY;
using dp::extend5;
using dp::key_of;
using dp::probe;
using dp::top_n;

constexpr int NMAX = 48;    // n_best limit (SCAP: the stack starts with the row's cells)
constexpr int NBMAX = 256;  // khashl buckets at n_best 48 (nb_params)
constexpr int SCAP = 48;    // F-closure stack slots
constexpr int FCAP = 64;    // fpar entries a node
constexpr int ROUND_CAP = 1024;
constexpr int UNSET = 0x3FFFFFF;
constexpr int PNONE = 0xFFFF;
constexpr int FROM_H = 0, FROM_E = 1, FROM_F = 2, FROM_OPEN = 0, FROM_EXT = 1;

struct Opt {
  int n_best, min_sc, end_len, match, mis, gap_open, gap_ext;
  int nb_bits, nb, maxc;  // kh_resize(n_best * 4) geometry (nb_params)
};

// One window's state.
template <typename T>
struct State {
  // the row (cells 0..n_row-1 valid)
  T lo[NMAX], hi[NMAX], lorc[NMAX];
  int H[NMAX], E[NMAX], qlen[NMAX], Hf[NMAX];
  // the row's extends, c = 1..5: backward lo, forward lo, size
  T xlo[NMAX][5], xrc[NMAX][5], xsz[NMAX][5];
  // the khashl candidate table
  unsigned long long tkey[NBMAX];
  T tlorc[NBMAX];
  int tH[NBMAX], tE[NBMAX], tF[NBMAX], tq[NBMAX], tHpos[NBMAX], tEpos[NBMAX], tFoff[NBMAX];
  unsigned char tHf[NBMAX], tEf[NBMAX], tFf[NBMAX], thead[NBMAX];
  int rowb[NMAX];         // the N best buckets, best first
  long long heap[NMAX];   // the bounded min-heap's values, ascending, -1 empty
  T slo[SCAP], shi[SCAP], slorc[SCAP];
  int sH[SCAP], sF[SCAP], sq[SCAP];
  unsigned long long fpar[FCAP];
  int ed[NMAX], left[NMAX];
  unsigned char sel[NMAX];
  int n_row, count, bad, trips;  // trips: dependent extend rounds (a node's row, each closure pop)
};

// A row candidate into the table (sw_update_candset, bwa-sw.c:265-284): a
// new key takes the next bucket of the probe; an old one keeps its running
// maxes, the From fields of the first attainment.  False when the window
// goes bad.
template <typename T>
__device__ bool add_cand(State<T>& s, const Opt& o, unsigned long long key, T lorc, int H, int E, int q, int Hf,
                         int Ef, int Hpos, int Epos) {
  if (H > 4095) return false;  // the 12-bit score field of hapdiv_device
  const int b = probe(s, key, o);
  if (s.tkey[b] == EMPTY) {
    if (++s.count >= o.maxc) return false;  // khashl would resize mid-node
    s.tkey[b] = key;
    s.tlorc[b] = lorc;
    s.tH[b] = H, s.tE[b] = E, s.tF[b] = 0, s.tq[b] = q;
    s.tHpos[b] = Hpos, s.tEpos[b] = Epos, s.tFoff[b] = UNSET;
    s.tHf[b] = (unsigned char)Hf, s.tEf[b] = (unsigned char)Ef, s.tFf[b] = 0, s.thead[b] = 1;
    return true;
  }
  if (H > s.tH[b]) s.tH[b] = H, s.tHf[b] = (unsigned char)Hf, s.tHpos[b] = Hpos, s.thead[b] = 0;
  if (E > s.tE[b]) s.tE[b] = E, s.tEf[b] = (unsigned char)Ef, s.tEpos[b] = Epos;
  if (q > s.tq[b]) s.tq[b] = q;
  return true;
}

// The F-closure (bwa-sw.c:445-483) of one node on lane 0, as
// hapdiv_device's cl_body runs it.  False when the window goes bad.
template <class L>
__device__ bool closure(const L& ix, State<typename L::T>& s, const Opt& o, bool gate_f) {
  using T = typename L::T;
  const int N = o.n_best;
  int hlen = s.n_row;
  for (int i = 0; i < N; ++i) {
    const int j = N - 1 - i;  // ascending: the worst kept cell first, empties (-1) before
    s.heap[i] = j < s.n_row ? (((long long)s.tH[s.rowb[j]] << 32) | s.rowb[j]) : -1;
  }
  int sp = 0;
  for (int j = s.n_row - 1; j >= 0; --j) {  // the row's cells, the best on top
    const int b = s.rowb[j];
    if (!(gate_f && s.tH[b] > o.gap_open + o.gap_ext)) continue;
    s.slo[sp] = (T)(s.tkey[b] >> 32), s.shi[sp] = (T)(s.tkey[b] & 0xffffffffULL), s.slorc[sp] = s.tlorc[b];
    s.sH[sp] = s.tH[b], s.sF[sp] = s.tF[b], s.sq[sp] = s.tq[b];
    ++sp;
  }
  int nfp = 0;
  for (int round = 0; round < ROUND_CAP && sp > 0; ++round) {
    // every entry above the topmost one that beats the heap's min goes at
    // once: each would have been popped against this same min
    const int minv = hlen < N ? 0 : (int)(s.heap[0] >> 32);
    int at = -1, rH = 0, f_open = 0;
    for (int i = sp - 1; i >= 0; --i) {
      const int open = s.sH[i] - o.gap_open > s.sF[i];
      const int F2 = (open ? s.sH[i] - o.gap_open : s.sF[i]) - o.gap_ext;
      if (F2 > minv) {
        at = i, rH = F2, f_open = open;
        break;
      }
    }
    if (at < 0) {
      sp = 0;
      break;
    }
    sp = at;
    ++s.trips;
    const T zlo = s.slo[at], zhi = s.shi[at], zlorc = s.slorc[at];
    const int zq = s.sq[at];
    const unsigned long long zkey = key_of(zlo, zhi);
    T olo[5], orc[5], osz[5];
    extend5(ix, zlo, zlorc, zhi - zlo, olo, orc, osz);
    for (int c = 1; c <= 5; ++c) {
      if (osz[c - 1] <= 0) continue;
      const T lo_c = olo[c - 1], hi_c = olo[c - 1] + osz[c - 1];
      const unsigned long long key = key_of(lo_c, hi_c);
      const int b = probe(s, key, o);
      const bool absent = s.tkey[b] == EMPTY;
      if (s.count >= o.maxc) return false;
      s.count += absent;
      // sw_update_candset of an F candidate: its H and F are rH
      const bool chF = absent || s.tF[b] < rH;
      if (absent) {
        s.tkey[b] = key;
        s.tlorc[b] = orc[c - 1];
        s.tH[b] = rH, s.tHf[b] = FROM_F, s.tHpos[b] = PNONE;
        s.tE[b] = 0, s.tEf[b] = 0, s.tEpos[b] = PNONE;
        s.tq[b] = zq;
      } else {
        if (s.tH[b] < rH) s.tH[b] = rH, s.tHf[b] = FROM_F;
        if (zq > s.tq[b]) s.tq[b] = zq;
      }
      if (!chF) continue;
      s.tF[b] = rH, s.tFf[b] = (unsigned char)(f_open ? FROM_OPEN : FROM_EXT), s.tFoff[b] = nfp;
      if (nfp >= FCAP) return false;
      s.fpar[nfp++] = zkey;
      // heap insert of (rH << 32 | UINT32_MAX): replace the min (an empty
      // while it grows), keeping the array sorted
      const long long x = ((long long)rH << 32) | 0xffffffffLL;
      const bool grow = hlen < N;
      if (grow || x > s.heap[0]) {
        int p = 0;
        while (p < N && s.heap[p] < x) ++p;
        for (int i = 0; i + 1 < p; ++i) s.heap[i] = s.heap[i + 1];
        s.heap[p - 1] = x;
        hlen += grow;
      }
      if (rH - o.gap_ext > minv) {
        if (sp >= SCAP) return false;
        s.slo[sp] = lo_c, s.shi[sp] = hi_c, s.slorc[sp] = s.tlorc[b];
        s.sH[sp] = s.tH[b], s.sF[sp] = s.tF[b], s.sq[sp] = s.tq[b];
        ++sp;
      }
    }
  }
  return sp == 0;  // cells left after the round cap: inexact
}

#ifdef __CUDACC__
#define WARP_SYNC() __syncwarp()
#else
#define WARP_SYNC()
#endif

// One window: seq (K,) nt6, arch (K, n_best, 2) int32 out; n_hap (7,);
// trips_out (may be null) the window's dependent extend rounds, up to the
// one that made it bad.
template <class L>
__device__ void hapdiv_window(const L& ix, State<typename L::T>& s, const int* seq, int K, const Opt& o, int* arch,
                              int* n_al, int* max_ed, int64_t* n_hap, uint8_t* bad_out, int* trips_out, int lane,
                              int lanes) {
  using T = typename L::T;
  const int N = o.n_best;
  if (lane == 0) {
    s.lo[0] = 0, s.hi[0] = ix.acc(6), s.lorc[0] = 0;
    s.H[0] = s.E[0] = s.qlen[0] = s.Hf[0] = 0;
    s.n_row = 1, s.bad = 0, s.trips = 0;
  }
  WARP_SYNC();
  for (int node = 1; node <= K && !s.bad; ++node) {
    const int n_prev = s.n_row;
    const int cn = seq[K - node];  // node i consumes seq[K - i] (dawg.c:230-250)
    const int pos_base = (node - 1) * N;
    const bool gate_f = n_prev > 0 && s.qlen[n_prev - 1] >= o.end_len;
    for (int k = lane; k < n_prev; k += lanes) extend5(ix, s.lo[k], s.lorc[k], s.hi[k] - s.lo[k], s.xlo[k], s.xrc[k], s.xsz[k]);
    for (int b = lane; b < o.nb; b += lanes) s.tkey[b] = EMPTY;
    WARP_SYNC();
    if (lane == 0) {
      ++s.trips;
      // candidates in the reference's insert order: cell k, c = 1..5, E
      bool ok = true;
      s.count = 0;
      for (int k = 0; k < n_prev && ok; ++k) {
        const int pH = s.H[k], pE = s.E[k], pq = s.qlen[k];
        T last_rc = 0;  // the E slot's stale lo_rc (bwa-sw.c:418): the last passing H-cand's
        for (int c = 1; c <= 5 && ok; ++c) {
          const int sc = (c == cn && c != 5) ? o.match : -o.mis;
          const T sz = s.xsz[k][c - 1];
          if (!(sz > 0 && pH + sc > 0 && (c == cn || pq >= o.end_len))) continue;
          last_rc = s.xrc[k][c - 1];
          ok = add_cand(s, o, key_of(s.xlo[k][c - 1], (T)(s.xlo[k][c - 1] + sz)), last_rc, pH + sc, 0, pq + 1, FROM_H, 0,
                        pos_base + k, PNONE);
        }
        const bool e_open = pH - o.gap_open > pE;
        const int e_val = (e_open ? pH - o.gap_open : pE) - o.gap_ext;
        if (ok && e_val > 0 && pq >= o.end_len)
          ok = add_cand(s, o, key_of(s.lo[k], s.hi[k]), last_rc, e_val, e_val, pq + 1, FROM_E,
                        e_open ? FROM_OPEN : FROM_EXT, PNONE, pos_base + k);
      }
      // the first attainment of a key's H by an E candidate past its first
      // one: the host's H_from_pos would need the event chain
      for (int b = 0; b < o.nb && ok; ++b) ok = !(s.tkey[b] != EMPTY && !s.thead[b] && s.tHf[b] == FROM_E);
      s.bad = !ok;
    }
    WARP_SYNC();
    if (s.bad) break;
    top_n(s, o, lane, lanes);
    WARP_SYNC();
    if (lane == 0) s.bad = !closure(ix, s, o, gate_f);
    WARP_SYNC();
    if (s.bad) break;
    top_n(s, o, lane, lanes);
    WARP_SYNC();
    // the new row, and its archive words; sw_track_F turns the fpar index
    // into the column of that key in the row
    const int n_row = s.n_row;
    for (int j = lane; j < N; j += lanes) {
      int w0 = 31 << 8, w1 = -1;  // an empty cell: no walk reads it
      if (j < n_row) {
        const int b = s.rowb[j];
        int foff = -1;
        if (s.tF[b] > 0 && s.tFoff[b] != UNSET) {
          const unsigned long long fk = s.fpar[s.tFoff[b] < FCAP ? s.tFoff[b] : FCAP - 1];
          for (int j2 = 0; j2 < n_row && foff < 0; ++j2)
            if (s.tkey[s.rowb[j2]] == fk) foff = j2;
        }
        const T lo = (T)(s.tkey[b] >> 32);
        int refc = 0;
        for (int c = 1; c < 7; ++c) refc += ix.acc(c) <= lo;
        w0 = s.tHf[b] | s.tEf[b] << 2 | s.tFf[b] << 3 | (foff >= 0) << 4 | refc << 5 | (foff >= 0 && foff < 31 ? foff : 31) << 8;
        w1 = (int)((unsigned)s.tHpos[b] | (unsigned)s.tEpos[b] << 16);
        s.lo[j] = lo, s.hi[j] = (T)(s.tkey[b] & 0xffffffffULL), s.lorc[j] = s.tlorc[b];
        s.H[j] = s.tH[b], s.E[j] = s.tE[b], s.qlen[j] = s.tq[b], s.Hf[j] = s.tHf[b];
      }
      arch[((int64_t)(node - 1) * N + j) * 2] = w0;
      arch[((int64_t)(node - 1) * N + j) * 2 + 1] = w1;
    }
    WARP_SYNC();
  }
  if (lane == 0 && trips_out) *trips_out = s.trips;
  if (s.bad) {
    if (lane == 0) {
      *n_al = *max_ed = 0;
      for (int e = 0; e < 7; ++e) n_hap[e] = 0;
      *bad_out = 1;
    }
    return;
  }
  // the final row: containment dedup (sw_cell_dedup, bwa-sw.c:197-216)
  if (lane == 0) {
    bool kept[NMAX];
    for (int i = 0; i < s.n_row; ++i) {
      bool flt = false;
      const T szi = s.hi[i] - s.lo[i];
      for (int j = 0; j < i && !flt; ++j) {
        const T szj = s.hi[j] - s.lo[j];
        flt = kept[j] && ((s.lorc[j] <= s.lorc[i] && s.lorc[j] + szj >= s.lorc[i] + szi) ||
                          (s.lo[j] <= s.lo[i] && s.hi[j] >= s.hi[i]));
      }
      kept[i] = !flt;
      s.sel[i] = !flt && s.Hf[i] == FROM_H && s.H[i] >= o.min_sc;  // e2e_drop < 0: no drop filter
    }
  }
  WARP_SYNC();
  // the anno backtrack: one walker a selected cell, at most 4K + 64 steps
  for (int j = lane; j < s.n_row; j += lanes) {
    int pos = s.sel[j] ? K * N + j : 0, last = 0, ed = 0;
    for (int step = 0; step < 4 * K + 64 && pos > 0; ++step) {
      const int r = pos / N, col = pos % N;
      int ai = (r - 1) * N + col;
      ai = ai < 0 ? 0 : ai > K * N - 1 ? K * N - 1 : ai;
      const int w0 = arch[(int64_t)ai * 2], w1 = arch[(int64_t)ai * 2 + 1];
      const int x = w0 & 0xF;
      const int state = last == 0 ? (x & 3) : last;
      const bool gap = state == FROM_E || state == FROM_F;
      const int ext = gap ? (x >> (state + 1)) & 1 : 0;
      const int rn = r - 1 < 0 ? 0 : r - 1 > K - 1 ? K - 1 : r - 1;
      if (state == FROM_H) {
        ed += ((w0 >> 5) & 7) != seq[K - 1 - rn];
        pos = w1 & 0xFFFF;
      } else {
        ed += 1;
        pos = state == FROM_E ? (w1 >> 16) & 0xFFFF : r * N + ((w0 >> 8) & 0x1F);
      }
      last = gap && ext ? state : 0;
    }
    s.ed[j] = ed;
    s.left[j] = s.sel[j] && pos > 0;
  }
  WARP_SYNC();
  if (lane == 0) {
    int na = 0, me = 0, left = 0;
    int64_t hap[7] = {0, 0, 0, 0, 0, 0, 0};
    for (int j = 0; j < s.n_row; ++j) {
      if (!s.sel[j]) continue;
      ++na;
      left |= s.left[j];
      me = s.ed[j] > me ? s.ed[j] : me;
      hap[s.ed[j] < 6 ? s.ed[j] : 6] += (int64_t)(s.hi[j] - s.lo[j]);
    }
    *n_al = left ? 0 : na;
    *max_ed = left ? 0 : me;
    for (int e = 0; e < 7; ++e) n_hap[e] = left ? 0 : hap[e];
    *bad_out = (uint8_t)left;  // walkers left after the step cap
  }
}

}  // namespace hapdiv
}  // namespace rb3c

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using rb3c::hapdiv::Opt;
using rb3c::hapdiv::State;

template <class L>
__global__ void __launch_bounds__(32) hapdiv_kernel(const L ix, const int* __restrict__ seqs, int64_t W, int K,
                                                    const Opt o, int* __restrict__ arch, int* __restrict__ n_al,
                                                    int* __restrict__ max_ed, int64_t* __restrict__ n_hap,
                                                    uint8_t* __restrict__ bad, int* __restrict__ trips) {
  __shared__ State<typename L::T> s;
  const int64_t w = blockIdx.x;
  if (w >= W) return;
  rb3c::hapdiv::hapdiv_window(ix, s, seqs + w * K, K, o, arch + w * (int64_t)K * o.n_best * 2, n_al + w, max_ed + w,
                              n_hap + w * 7, bad + w, trips ? trips + w : nullptr, (int)threadIdx.x, 32);
}

Opt make_opt(int n_best, int min_sc, int end_len, int match, int mis, int gap_open, int gap_ext) {
  int nb_bits = 2;
  while ((1 << nb_bits) < 4 * n_best) ++nb_bits;  // nb_params: the power of two >= 4 n_best
  const int nb = 1 << nb_bits;
  return Opt{n_best, min_sc, end_len, match, mis, gap_open, gap_ext, nb_bits, nb, (nb >> 1) + (nb >> 2)};
}

}  // namespace

extern "C" {

// W windows seqs (W, K) int32 nt6, 1 <= K <= 509, 2 <= n_best <= 48, the
// index below 2^32 symbols (the wrapper checks): arch (W, K, n_best, 2)
// int32 scratch; n_al, max_ed (W,) int32, n_hap (W, 7) int64 and bad (W,)
// uint8 out, and trips (W,) int32 unless null.  One block of one warp a
// window.
#define RB3C_HAPDIV(name, L)                                                                                         \
  int rb3c_hapdiv_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift,      \
                         int block_shift, const int* seqs, int64_t W, int K, int n_best, int min_sc, int end_len,   \
                         int match, int mis, int gap_open, int gap_ext, int* arch, int* n_al, int* max_ed,           \
                         int64_t* n_hap, uint8_t* bad, int* trips, void* stream) {                                  \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    const Opt o = make_opt(n_best, min_sc, end_len, match, mis, gap_open, gap_ext);                                 \
    hapdiv_kernel<L><<<(unsigned)W, 32, 0, (cudaStream_t)stream>>>(ix, seqs, W, K, o, arch, n_al, max_ed, n_hap,    \
                                                                   bad, trips);                                     \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_HAPDIV(dense32, rb3c::Dense<int>)
RB3C_HAPDIV(dense64, rb3c::Dense<int64_t>)

}  // extern "C"

#endif  // __CUDACC__
