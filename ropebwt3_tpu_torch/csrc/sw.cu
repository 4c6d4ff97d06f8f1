// The sw scoring DP (K9): the BWA-SW DP of sw_core (bwa-sw.c:329-526) over
// each read's prefix DAWG, one warp a read.  Per read it gives every node's
// top-n_best row as archive words, best_sc, best_pos and the `bad` flag of
// ropebwt3_tpu_torch/align/sw.py (sw_plain is its plain version).
//
// Replaces the XLA body of ropebwt3_tpu/align/sw_jax.py sw_device (:122-606):
// node_body (:161) scanned over the DAWG's nodes with its F-closure
// (cl_body, :415) and the root row (:592-601).
//
// A read is one warp; its state for the node at hand is in shared memory
// (~19-25 KB by index width), the rows of all its nodes in device memory
// (`scratch`, four words a cell), since a later node may name any earlier
// one as a predecessor (up to P of them).  Per node: the prune's k-th
// largest H over the predecessor cells (sw_jax.py:185-192) by rank counting
// over the lanes; then for each predecessor in order, its cells are loaded
// and extended over the lanes, and lane 0 merges their candidates into the
// khashl table in the reference's insert order (predecessor, cell, c =
// 1..5, then the E slot), as sw_update_candset does: running maxes, the
// first attainment keeping the From fields.  The F-closure runs on lane 0
// with the bounded heap as a sorted array, as hapdiv.cu's.  The lock-step
// body's sorts and scans become these sequential inserts (hapdiv.cu says
// why the two agree); its caps are replayed, so its flags are: a key count
// that would resize the table, stack and fpar overflow, the E-type
// H_from_pos corner, 12-bit scores and 9-bit lengths, 1024 closure rounds a
// node; and, the port's own, an F offset past the archive's 5 bits.  Once
// flagged a read stops; its best_sc and best_pos are 0.
//
// The khashl probe, the extends and the top-N selection are csrc/dp.cuh's.
// The text up to the kernel compiles with g++ given a header that defines
// the CUDA keywords: `sw_read` then runs one read on the host with one lane.

#include <stdint.h>

#include "dp.cuh"

namespace rb3c {
namespace sw {

using dp::EMPTY;
using dp::extend5;
using dp::key_of;
using dp::probe;
using dp::top_n;

constexpr int NMAX = 48;    // n_best limit (SCAP: the stack starts with the row's cells)
constexpr int NBMAX = 256;  // khashl buckets at n_best 48 (nb_params)
constexpr int PMAX = 6;     // DAWG in-degree limit (sw_jax.py P_MAX)
constexpr int NCMAX = 384;  // DAWG node limit (sw_jax.py NC_BUCKETS[-1])
constexpr int SCAP = 48;    // F-closure stack slots
constexpr int FCAP = 64;    // fpar entries a node
constexpr int ROUND_CAP = 1024;
constexpr int UNSET = 0x3FFFFFF;
constexpr int PNONE = 0xFFFF;
constexpr int MAX_SCORE = 4095, MAX_LEN = 510;  // the 12-bit score and 9-bit length fields
constexpr int FROM_H = 0, FROM_E = 1, FROM_F = 2, FROM_OPEN = 0, FROM_EXT = 1;
// the root row's archive word: valid, H 0, Foffr 31, Hpos 0, Epos unset
constexpr long long ROOT_WORD = 1LL | 31LL << 18 | (long long)PNONE << 39;

struct Opt {
  int n_best, end_len, match, mis, gap_open, gap_ext;
  int nb_bits, nb, maxc;  // kh_resize(n_best * 4) geometry (nb_params)
  int maxpen;             // max(gap_open + gap_ext, mis): the prune's margin
};

// One read's state for the node at hand.
template <typename T>
struct State {
  // one predecessor row's cells and their extends, c = 1..5: backward lo,
  // forward lo, size
  T lo[NMAX], hi[NMAX], lorc[NMAX];
  int H[NMAX], E[NMAX], q[NMAX], rl[NMAX];
  T xlo[NMAX][5], xrc[NMAX][5], xsz[NMAX][5];
  int pH[PMAX * NMAX];  // the H of every predecessor cell, for the prune
  // the khashl candidate table
  unsigned long long tkey[NBMAX];
  T tlorc[NBMAX];
  int tH[NBMAX], tE[NBMAX], tF[NBMAX], tq[NBMAX], trl[NBMAX], tHpos[NBMAX], tEpos[NBMAX], tFoff[NBMAX];
  unsigned char tHf[NBMAX], tEf[NBMAX], tFf[NBMAX], thead[NBMAX];
  int rowb[NMAX];        // the N best buckets, best first
  long long heap[NMAX];  // the bounded min-heap's values, ascending, -1 empty
  T slo[SCAP], shi[SCAP], slorc[SCAP];
  int sH[SCAP], sF[SCAP], sq[SCAP], srl[SCAP];
  unsigned long long fpar[FCAP];
  int pre[PMAX];
  unsigned char nrow[NCMAX];  // cells in each node's row
  int n_row, count, bad, kth, lastp_q, best_sc, best_pos, trips;  // trips: a node, then each closure pop
};

// A carried cell in device memory: key (lo << 32 | hi), lorc, H | E << 32,
// rlen | qlen << 32.
constexpr int CELL_WORDS = 4;

// A row candidate into the table (sw_update_candset, bwa-sw.c:265-284): a
// new key takes the next bucket of the probe; an old one keeps its running
// maxes, the From fields of the first attainment.  False when the read goes
// bad.
template <typename T>
__device__ bool add_cand(State<T>& s, const Opt& o, unsigned long long key, T lorc, int H, int E, int q, int rl, int Hf,
                         int Ef, int Hpos, int Epos) {
  if (H > MAX_SCORE || q > MAX_LEN || rl > MAX_LEN) return false;  // the packed words' fields
  const int b = probe(s, key, o);
  if (s.tkey[b] == EMPTY) {
    if (++s.count >= o.maxc) return false;  // khashl would resize mid-node
    s.tkey[b] = key;
    s.tlorc[b] = lorc;
    s.tH[b] = H, s.tE[b] = E, s.tF[b] = 0, s.tq[b] = q, s.trl[b] = rl;
    s.tHpos[b] = Hpos, s.tEpos[b] = Epos, s.tFoff[b] = UNSET;
    s.tHf[b] = (unsigned char)Hf, s.tEf[b] = (unsigned char)Ef, s.tFf[b] = 0, s.thead[b] = 1;
    return true;
  }
  if (H > s.tH[b]) s.tH[b] = H, s.tHf[b] = (unsigned char)Hf, s.tHpos[b] = Hpos, s.thead[b] = 0;
  if (E > s.tE[b]) s.tE[b] = E, s.tEf[b] = (unsigned char)Ef, s.tEpos[b] = Epos;
  if (q > s.tq[b]) s.tq[b] = q;
  if (rl > s.trl[b]) s.trl[b] = rl;
  return true;
}

// The F-closure (bwa-sw.c:445-483) of one node on lane 0, as sw_device's
// cl_body runs it.  False when the read goes bad.
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
    s.sH[sp] = s.tH[b], s.sF[sp] = s.tF[b], s.sq[sp] = s.tq[b], s.srl[sp] = s.trl[b];
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
    const int zq = s.sq[at], zrl = s.srl[at];
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
      // sw_update_candset of an F candidate: its H and F are rH, its rlen
      // one past the popped cell's
      const bool chF = absent || s.tF[b] < rH;
      if (absent) {
        s.tkey[b] = key;
        s.tlorc[b] = orc[c - 1];
        s.tH[b] = rH, s.tHf[b] = FROM_F, s.tHpos[b] = PNONE;
        s.tE[b] = 0, s.tEf[b] = 0, s.tEpos[b] = PNONE;
        s.tq[b] = zq, s.trl[b] = zrl + 1;
        s.tF[b] = 0, s.tFf[b] = 0, s.tFoff[b] = UNSET;
      } else {
        if (s.tH[b] < rH) s.tH[b] = rH, s.tHf[b] = FROM_F;
        if (zq > s.tq[b]) s.tq[b] = zq;
        if (zrl + 1 > s.trl[b]) s.trl[b] = zrl + 1;
      }
      if (s.trl[b] > MAX_LEN) return false;
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
        s.sH[sp] = s.tH[b], s.sF[sp] = s.tF[b], s.sq[sp] = s.tq[b], s.srl[sp] = s.trl[b];
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

// One read: its DAWG node_c (NC,), pre (NC, P) (-1 after the last
// predecessor), n_node nodes; its rows from row 0 of scratch (n_node,
// n_best, 4) int64 and of the archive alo, ahi, arc (n_node, n_best) int32
// and aw (n_node, n_best) int64; best_sc, best_pos, bad_out and (unless
// null) trips_out: the read's dependent extend rounds, up to the one that
// made it bad.
template <class L>
__device__ void sw_read(const L& ix, State<typename L::T>& s, const int* node_c, const int* pre, int n_node, int P,
                        const Opt& o, long long* scratch, int* alo, int* ahi, int* arc, long long* aw, int* best_sc,
                        int* best_pos, uint8_t* bad_out, int* trips_out, int lane, int lanes) {
  using T = typename L::T;
  const int N = o.n_best;
  const T n_all = ix.acc(6);
  for (int j = lane; j < N; j += lanes) {  // the root row: one cell, the whole BWT
    alo[j] = 0, ahi[j] = j == 0 ? (int)(uint32_t)n_all : 0, arc[j] = 0, aw[j] = j == 0 ? ROOT_WORD : 0;
  }
  if (lane == 0) {
    long long* c0 = scratch;
    c0[0] = (long long)key_of((T)0, n_all), c0[1] = 0, c0[2] = 0, c0[3] = 0;
    s.nrow[0] = 1;
    s.bad = 0, s.lastp_q = 0, s.best_sc = 0, s.best_pos = 0, s.trips = 0;
  }
  WARP_SYNC();
  for (int node = 1; node < n_node && !s.bad; ++node) {
    const int cn = node_c[node];
    for (int p = lane; p < P; p += lanes) s.pre[p] = pre[node * P + p];
    for (int b = lane; b < o.nb; b += lanes) s.tkey[b] = EMPTY;
    WARP_SYNC();
    // the predecessor cells, slot order pre x cell
    int n_pre = 0, n_cell = 0, last = -1;
    for (int p = 0; p < P; ++p) {
      if (s.pre[p] < 0) continue;
      ++n_pre;
      n_cell += s.nrow[s.pre[p]];
      if (s.nrow[s.pre[p]]) last = p;
    }
    // w.last_p: the last visited cell (visited even when pruned)
    if (lane == 0 && last >= 0) {
      const int id = s.pre[last];
      s.lastp_q = (int)(scratch[((long long)id * N + s.nrow[id] - 1) * CELL_WORDS + 3] >> 32);
    }
    // the ks_ksmall prune (bwa-sw.c:366-376): the H of rank N, descending
    int mms = 0;
    if (n_pre > 1) {
      if (n_cell > N) {
        for (int p = 0, base = 0; p < P; ++p) {
          if (s.pre[p] < 0) continue;
          const int id = s.pre[p], nr = s.nrow[id];
          for (int j = lane; j < nr; j += lanes)
            s.pH[base + j] = (int)(scratch[((long long)id * N + j) * CELL_WORDS + 2] & 0xffffffffLL);
          base += nr;
        }
        WARP_SYNC();
        for (int k = lane; k < n_cell; k += lanes) {
          int rank = 0;
          for (int k2 = 0; k2 < n_cell; ++k2) rank += s.pH[k2] > s.pH[k] || (s.pH[k2] == s.pH[k] && k2 < k);
          if (rank == N) s.kth = s.pH[k];
        }
        WARP_SYNC();
        mms = s.kth;
      }
      mms = mms - o.maxpen > 0 ? mms - o.maxpen : 0;
    }
    if (lane == 0) s.count = 0, ++s.trips;
    // each predecessor row: its cells extended over the lanes, then merged
    // by lane 0 in insert order
    for (int p = 0; p < P; ++p) {
      const int id = s.pre[p];
      if (id < 0 || !s.nrow[id]) continue;
      const int nr = s.nrow[id];
      for (int j = lane; j < nr; j += lanes) {
        const long long* c = scratch + ((long long)id * N + j) * CELL_WORDS;
        const unsigned long long key = (unsigned long long)c[0];
        s.lo[j] = (T)(key >> 32), s.hi[j] = (T)(key & 0xffffffffULL), s.lorc[j] = (T)c[1];
        s.H[j] = (int)(c[2] & 0xffffffffLL), s.E[j] = (int)(c[2] >> 32);
        s.rl[j] = (int)(c[3] & 0xffffffffLL), s.q[j] = (int)(c[3] >> 32);
        if (s.H[j] + o.match >= mms) extend5(ix, s.lo[j], s.lorc[j], s.hi[j] - s.lo[j], s.xlo[j], s.xrc[j], s.xsz[j]);
      }
      WARP_SYNC();
      if (lane == 0) {
        bool ok = !s.bad;
        for (int j = 0; j < nr && ok; ++j) {
          const int pH = s.H[j], pE = s.E[j], pq = s.q[j], prl = s.rl[j];
          if (pH + o.match < mms) continue;
          const int gpos = id * N + j;  // the cell's global position (bwa-sw.c:393)
          T last_rc = 0;  // the E slot's stale lo_rc (bwa-sw.c:418): the last passing H-cand's
          for (int c = 1; c <= 5 && ok; ++c) {
            const int sc = (c == cn && c != 5) ? o.match : -o.mis;
            const T sz = s.xsz[j][c - 1];
            if (!(sz > 0 && pH + sc > 0 && pH + sc >= mms && (c == cn || pq >= o.end_len))) continue;
            last_rc = s.xrc[j][c - 1];
            ok = add_cand(s, o, key_of(s.xlo[j][c - 1], (T)(s.xlo[j][c - 1] + sz)), last_rc, pH + sc, 0, pq + 1,
                          prl + 1, FROM_H, 0, gpos, PNONE);
          }
          const bool e_open = pH - o.gap_open > pE;
          const int e_val = (e_open ? pH - o.gap_open : pE) - o.gap_ext;
          if (ok && e_val > 0 && e_val >= mms && pq >= o.end_len)
            ok = add_cand(s, o, key_of(s.lo[j], s.hi[j]), last_rc, e_val, e_val, pq + 1, prl, FROM_E,
                          e_open ? FROM_OPEN : FROM_EXT, PNONE, gpos);
        }
        s.bad = !ok;
      }
      WARP_SYNC();
      if (s.bad) break;
    }
    if (lane == 0 && !s.bad) {
      // the first attainment of a key's H by an E candidate past its first
      // one: the host's H_from_pos would need the event chain
      for (int b = 0; b < o.nb; ++b) s.bad |= s.tkey[b] != EMPTY && !s.thead[b] && s.tHf[b] == FROM_E;
    }
    WARP_SYNC();
    if (s.bad) break;
    top_n(s, o, lane, lanes);
    WARP_SYNC();
    if (lane == 0) s.bad = !closure(ix, s, o, s.lastp_q >= o.end_len);
    WARP_SYNC();
    if (s.bad) break;
    top_n(s, o, lane, lanes);
    WARP_SYNC();
    // the new row, carried and archived; sw_track_F turns the fpar index
    // into the column of that key in the row
    const int n_row = s.n_row;
    const long long row0 = (long long)node * N;
    for (int j = lane; j < N; j += lanes) {
      int lo32 = 0, hi32 = 0, rc32 = 0;
      long long w = 0;
      if (j < n_row) {
        const int b = s.rowb[j];
        int foff = -1;
        if (s.tF[b] > 0 && s.tFoff[b] != UNSET) {
          const unsigned long long fk = s.fpar[s.tFoff[b] < FCAP ? s.tFoff[b] : FCAP - 1];
          for (int j2 = 0; j2 < n_row && foff < 0; ++j2)
            if (s.tkey[s.rowb[j2]] == fk) foff = j2;
        }
        if (foff > 31) s.bad = 1;  // past the archive word's 5-bit field (n_best > 32)
        const unsigned long long key = s.tkey[b];
        lo32 = (int)(uint32_t)(key >> 32), hi32 = (int)(uint32_t)key, rc32 = (int)(uint32_t)s.tlorc[b];
        w = 1LL | (long long)s.tH[b] << 1 | (long long)s.tHf[b] << 13 | (long long)s.tEf[b] << 15 |
            (long long)s.tFf[b] << 16 | (long long)(foff >= 0) << 17 | (long long)(foff >= 0 ? foff & 31 : 31) << 18 |
            (long long)(s.tHpos[b] & 0xFFFF) << 23 | (long long)(s.tEpos[b] & 0xFFFF) << 39;
        long long* c = scratch + (row0 + j) * CELL_WORDS;
        c[0] = (long long)key, c[1] = (long long)s.tlorc[b];
        c[2] = (long long)(uint32_t)s.tH[b] | (long long)s.tE[b] << 32;
        c[3] = (long long)(uint32_t)s.trl[b] | (long long)s.tq[b] << 32;
      }
      alo[row0 + j] = lo32, ahi[row0 + j] = hi32, arc[row0 + j] = rc32, aw[row0 + j] = w;
    }
    if (lane == 0) {
      s.nrow[node] = (unsigned char)n_row;
      if (n_row > 0 && s.tH[s.rowb[0]] > s.best_sc) s.best_sc = s.tH[s.rowb[0]], s.best_pos = node * N;
    }
    WARP_SYNC();
  }
  if (lane == 0) {
    *best_sc = s.bad ? 0 : s.best_sc;
    *best_pos = s.bad ? 0 : s.best_pos;
    *bad_out = (uint8_t)(s.bad != 0);
    if (trips_out) *trips_out = s.trips;
  }
}

}  // namespace sw
}  // namespace rb3c

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using rb3c::sw::Opt;
using rb3c::sw::State;

template <class L>
__global__ void __launch_bounds__(32) sw_kernel(const L ix, const int* __restrict__ node_c, const int* __restrict__ pre,
                                                const int* __restrict__ n_node, const int64_t* __restrict__ rows,
                                                int64_t W, int NC, int P, const Opt o, long long* __restrict__ scratch,
                                                int* __restrict__ alo, int* __restrict__ ahi, int* __restrict__ arc,
                                                long long* __restrict__ aw, int* __restrict__ best_sc,
                                                int* __restrict__ best_pos, uint8_t* __restrict__ bad,
                                                int* __restrict__ trips) {
  __shared__ State<typename L::T> s;
  const int64_t w = blockIdx.x;
  if (w >= W) return;
  const int64_t r0 = rows[w] * o.n_best;
  rb3c::sw::sw_read(ix, s, node_c + w * NC, pre + w * NC * P, n_node[w], P, o,
                    scratch + r0 * rb3c::sw::CELL_WORDS, alo + r0, ahi + r0, arc + r0, aw + r0, best_sc + w,
                    best_pos + w, bad + w, trips ? trips + w : nullptr, (int)threadIdx.x, 32);
}

Opt make_opt(int n_best, int end_len, int match, int mis, int gap_open, int gap_ext) {
  int nb_bits = 2;
  while ((1 << nb_bits) < 4 * n_best) ++nb_bits;  // nb_params: the power of two >= 4 n_best
  const int nb = 1 << nb_bits;
  const int maxpen = gap_open + gap_ext > mis ? gap_open + gap_ext : mis;
  return Opt{n_best, end_len, match, mis, gap_open, gap_ext, nb_bits, nb, (nb >> 1) + (nb >> 2), maxpen};
}

}  // namespace

extern "C" {

// W reads' DAWGs node_c (W, NC), pre (W, NC, P) int32 (-1 pads), n_node (W,)
// int32 with 1 <= n_node <= NC <= 384, 1 <= P <= 6, 2 <= n_best <= 48 and
// the index below 2^32 symbols (the wrapper checks); rows (W + 1,) int64:
// read w's rows are [rows[w], rows[w + 1]) of scratch (T, n_best, 4) int64
// and of the archive alo, ahi, arc (T, n_best) int32 and aw (T, n_best)
// int64 (out); best_sc, best_pos (W,) int32, bad (W,) uint8 out, and trips
// (W,) int32 unless null.  One block of one warp a read.
#define RB3C_SW(name, L)                                                                                             \
  int rb3c_sw_##name(const int* rows_t, const int* esc, const int64_t* mega, const void* acc, int mega_shift,        \
                     int block_shift, const int* node_c, const int* pre, const int* n_node, const int64_t* rows,    \
                     int64_t W, int NC, int P, int n_best, int end_len, int match, int mis, int gap_open,           \
                     int gap_ext, long long* scratch, int* alo, int* ahi, int* arc, long long* aw, int* best_sc,    \
                     int* best_pos, uint8_t* bad, int* trips, void* stream) {                                       \
    const L ix{rb3c::Tables{rows_t, esc, mega, acc, mega_shift, block_shift}};                                     \
    const Opt o = make_opt(n_best, end_len, match, mis, gap_open, gap_ext);                                         \
    sw_kernel<L><<<(unsigned)W, 32, 0, (cudaStream_t)stream>>>(ix, node_c, pre, n_node, rows, W, NC, P, o,         \
                                                               scratch, alo, ahi, arc, aw, best_sc, best_pos, bad,  \
                                                               trips);                                              \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_SW(dense32, rb3c::Dense<int>)
RB3C_SW(dense64, rb3c::Dense<int64_t>)

}  // extern "C"

#endif  // __CUDACC__
