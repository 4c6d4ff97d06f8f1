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
// them the candidate merge, the two top-N selections and the closure's
// bookkeeping.  The TPU body ran all windows in lock-step: sorts and scans
// stood in for the sequential khashl replay, one-hot reductions for
// scatters, and every window waited for the slowest window's closure.  Here
// a window is one warp with its state in shared memory, sized by the
// khashl geometry (csrc/dp.cuh Table: nb 128 up to n_best 32, 256 above),
// and the 32 lanes share each step (dp.cuh says how): the row's cells are
// extended side by side and written as candidate slots (cell k, c = 1..5,
// then the E slot), merged 32 slots a round with equal keys grouped by
// __match_any_sync, the top N taken by a warp bitonic sort, and the
// F-closure's pops probe and place their children over five lanes.
// Windows run independently: the closure's round cap and the backtrack's
// step cap count per window, which gives the lock-step body's flags (a
// window's rounds there are its own).  The rows of the backtrack's archive
// (two words a cell a node) go to device memory.  Every `bad` condition of
// hapdiv_device is raised; once raised the window stops.
//
// The text up to `#ifdef __CUDACC__` compiles with g++ given a header that
// defines the CUDA keywords and collectives for one lane
// (tests/test_torch_runblock.py HOST_SHIM): `hapdiv_window<1>` then runs
// one window on the host.

#include <stdint.h>

#include "dp.cuh"

namespace rb3c {
namespace hapdiv {

using namespace dp;

constexpr int MAX_SCORE = 4095;  // the 12-bit score field of hapdiv_device

struct Opt {
  int n_best, min_sc, end_len, match, mis, gap_open, gap_ext;
  int nb_bits, nb, maxc;  // kh_resize(n_best * 4) geometry (nb_params)
};

inline Opt make_opt(int n_best, int min_sc, int end_len, int match, int mis, int gap_open, int gap_ext) {
  int nb_bits = 2;
  while ((1 << nb_bits) < 4 * n_best) ++nb_bits;  // nb_params: the power of two >= 4 n_best
  const int nb = 1 << nb_bits;
  return Opt{n_best, min_sc, end_len, match, mis, gap_open, gap_ext, nb_bits, nb, (nb >> 1) + (nb >> 2)};
}

// One window's state: the node's table, and the row it extends.
template <typename T, int NB>
struct State {
  using Tb = Table<T, NB, false>;
  static constexpr int N_MAX = Tb::N_MAX;
  Tb t;
  T lo[N_MAX], hi[N_MAX], lorc[N_MAX];
  int16_t H[N_MAX], E[N_MAX], q[N_MAX];
  uint8_t Hf[N_MAX];
};

// One window: seq (K,) nt6, arch (K, n_best, 2) int32 out; n_hap (7,);
// trips_out (may be null) the window's dependent extend rounds (one a node,
// one a closure pop), up to the one that made it bad.  TM: clk gets lane
// 0's phase clocks (NPH).
template <int LANES, bool TM, class L, int NB>
__device__ void hapdiv_window(const L& ix, State<typename L::T, NB>& s, const int* seq, int K, const Opt& o, int* arch,
                              int* n_al, int* max_ed, int64_t* n_hap, uint8_t* bad_out, int* trips_out, int lane,
                              long long* clk) {
  using T = typename L::T;
  auto& t = s.t;
  const int N = o.n_best;
  Clk<TM> ck;
  ck.start();
  if (lane == 0) {
    s.lo[0] = 0, s.hi[0] = ix.acc(6), s.lorc[0] = 0;
    s.H[0] = s.E[0] = s.q[0] = 0, s.Hf[0] = 0;
  }
  sync();
  int n_row = 1, trips = 0;
  bool bad = false;
  for (int node = 1; node <= K; ++node) {
    const int n_prev = n_row;
    const int cn = seq[K - node];  // node i consumes seq[K - i] (dawg.c:230-250)
    const int pos_base = (node - 1) * N;
    const bool gate_f = n_prev > 0 && s.q[n_prev - 1] >= o.end_len;
    ++trips;
    clear<LANES>(t, o.nb, lane);
    // the candidates in the reference's insert order: cell k, c = 1..5, E
    bool over = false;
    for (int k = lane; k < n_prev; k += LANES) {
      T olo[5], orc[5], osz[5];
      extend5(ix, s.lo[k], s.lorc[k], s.hi[k] - s.lo[k], olo, orc, osz);
      const int pH = s.H[k], pE = s.E[k], pq = s.q[k];
      T last_rc = 0;  // the E slot's stale lo_rc (bwa-sw.c:418): the last passing H-cand's
#pragma unroll
      for (int c = 1; c <= 5; ++c) {
        const int sc = (c == cn && c != 5) ? o.match : -o.mis, slot = 6 * k + c - 1;
        const bool pass = osz[c - 1] > 0 && pH + sc > 0 && (c == cn || pq >= o.end_len);
        if (pass) last_rc = orc[c - 1];
        over |= pass && pH + sc > MAX_SCORE;
        t.u.slot.key[slot] = key_of(olo[c - 1], (T)(olo[c - 1] + osz[c - 1]));
        t.u.slot.lorc[slot] = orc[c - 1];
        t.u.slot.pay[slot] = pass ? pack_pay(pH + sc, pq + 1, 0, 0, 0) : 0u;
      }
      const bool e_open = pH - o.gap_open > pE;
      const int e_val = (e_open ? pH - o.gap_open : pE) - o.gap_ext;
      const bool pass = e_val > 0 && pq >= o.end_len;
      over |= pass && e_val > MAX_SCORE;
      t.u.slot.key[6 * k + 5] = key_of(s.lo[k], s.hi[k]);
      t.u.slot.lorc[6 * k + 5] = last_rc;
      t.u.slot.pay[6 * k + 5] = pass ? pack_pay(e_val, pq + 1, 0, 1, e_open ? FROM_OPEN : FROM_EXT) : 0u;
    }
    sync();
    ck.lap(PH_EXT);
    int count = 0;
    if (any(over) || !merge<LANES, false>(t, o, 6 * n_prev, pos_base, count, lane)) {
      bad = true;
      break;
    }
    ck.lap(PH_MERGE);
    if (!top_n<LANES>(t, N, count, true, false, n_row, lane)) {
      bad = true;
      break;
    }
    ck.lap(PH_TOP1);
    if (!closure<LANES, false>(ix, t, o, gate_f, n_row, 0, count, trips, ck, lane)) {
      bad = true;
      break;
    }
    ck.lap(PH_CL);
    top_n<LANES>(t, N, count, false, true, n_row, lane);
    ck.lap(PH_TOP2);
    // the new row, and its archive words; sw_track_F turns the fpar entry
    // (the parent's bucket) into its column in the row
    for (int j = lane; j < N; j += LANES) {
      int w0 = 31 << 8, w1 = -1;  // an empty cell: no walk reads it
      if (j < n_row) {
        const int b = t.rowb[j];
        const int foff = t.F[b] > 0 && t.foff[b] != UNSET8 ? t.col[t.u.cl.fpar[t.foff[b]]] : UNSET8;
        const bool fos = foff != UNSET8;
        const T lo = (T)(t.key[b] >> 32);
        int refc = 0;
        for (int c = 1; c < 7; ++c) refc += ix.acc(c) <= lo;
        w0 = (t.fl[b] & 0xF) | fos << 4 | refc << 5 | (fos && foff < 31 ? foff : 31) << 8;
        w1 = (int)t.pos[b];
        s.lo[j] = lo, s.hi[j] = (T)(t.key[b] & 0xffffffffULL), s.lorc[j] = t.lorc[b];
        s.H[j] = t.H[b], s.E[j] = t.E[b], s.q[j] = t.q[b], s.Hf[j] = t.fl[b] & 3;
      }
      arch[((int64_t)(node - 1) * N + j) * 2] = w0;
      arch[((int64_t)(node - 1) * N + j) * 2 + 1] = w1;
    }
    sync();
    ck.lap(PH_ARCH);
  }
  if (lane == 0 && trips_out) *trips_out = trips;
  if (bad) {
    if (lane == 0) {
      *n_al = *max_ed = 0;
      for (int e = 0; e < 7; ++e) n_hap[e] = 0;
      *bad_out = 1;
    }
    return;
  }
  // the final row: containment dedup (sw_cell_dedup, bwa-sw.c:197-216)
  uint8_t* sel = t.u.fin.sel;
  if (lane == 0) {
    bool kept[State<T, NB>::N_MAX];
    for (int i = 0; i < n_row; ++i) {
      bool flt = false;
      const T szi = s.hi[i] - s.lo[i];
      for (int j = 0; j < i && !flt; ++j) {
        const T szj = s.hi[j] - s.lo[j];
        flt = kept[j] && ((s.lorc[j] <= s.lorc[i] && s.lorc[j] + szj >= s.lorc[i] + szi) ||
                          (s.lo[j] <= s.lo[i] && s.hi[j] >= s.hi[i]));
      }
      kept[i] = !flt;
      sel[i] = !flt && s.Hf[i] == FROM_H && s.H[i] >= o.min_sc;  // e2e_drop < 0: no drop filter
    }
  }
  sync();
  // the anno backtrack: one walker a selected cell, at most 4K + 64 steps
  for (int j = lane; j < n_row; j += LANES) {
    int pos = sel[j] ? K * N + j : 0, last = 0, ed = 0;
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
    t.u.fin.ed[j] = (int16_t)ed;
    t.u.fin.left[j] = sel[j] && pos > 0;
  }
  sync();
  if (lane == 0) {
    int na = 0, me = 0, left = 0;
    int64_t hap[7] = {0, 0, 0, 0, 0, 0, 0};
    for (int j = 0; j < n_row; ++j) {
      if (!sel[j]) continue;
      const int ed = t.u.fin.ed[j];
      ++na;
      left |= t.u.fin.left[j];
      me = ed > me ? ed : me;
      hap[ed < 6 ? ed : 6] += (int64_t)(s.hi[j] - s.lo[j]);
    }
    *n_al = left ? 0 : na;
    *max_ed = left ? 0 : me;
    for (int e = 0; e < 7; ++e) n_hap[e] = left ? 0 : hap[e];
    *bad_out = (uint8_t)left;  // walkers left after the step cap
  }
  ck.lap(PH_TAIL);
  ck.write(clk, lane);
}

}  // namespace hapdiv
}  // namespace rb3c

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using rb3c::hapdiv::Opt;
using rb3c::hapdiv::State;

constexpr int MIN_BLOCKS = 20;  // one-warp blocks an SM: caps the registers at 96 a thread

template <class L, int NB, bool TM>
__global__ void __launch_bounds__(32, MIN_BLOCKS)
    hapdiv_kernel(const L ix, const int* __restrict__ seqs, int64_t W, int K, const Opt o, int* __restrict__ arch,
                  int* __restrict__ n_al, int* __restrict__ max_ed, int64_t* __restrict__ n_hap,
                  uint8_t* __restrict__ bad, int* __restrict__ trips, long long* __restrict__ clk) {
  __shared__ State<typename L::T, NB> s;
  const int64_t w = blockIdx.x;
  if (w >= W) return;
  rb3c::hapdiv::hapdiv_window<32, TM>(ix, s, seqs + w * K, K, o, arch + w * (int64_t)K * o.n_best * 2, n_al + w,
                                      max_ed + w, n_hap + w * 7, bad + w, trips ? trips + w : nullptr,
                                      (int)threadIdx.x, TM ? clk + w * rb3c::dp::NPH : nullptr);
}

// The kernel of n_best's geometry: nb 128 takes n_best up to 32.
template <class L, bool TM>
auto pick(int n_best) {
  return n_best <= 32 ? hapdiv_kernel<L, 128, TM> : hapdiv_kernel<L, 256, TM>;
}

template <class L, bool TM>
int launch(const rb3c::Tables& tb, const int* seqs, int64_t W, int K, const Opt& o, int* arch, int* n_al, int* max_ed,
           int64_t* n_hap, uint8_t* bad, int* trips, long long* clk, void* stream) {
  const L ix{tb};
  pick<L, TM>(o.n_best)<<<(unsigned)W, 32, 0, (cudaStream_t)stream>>>(ix, seqs, W, K, o, arch, n_al, max_ed, n_hap,
                                                                      bad, trips, clk);
  return (int)cudaGetLastError();
}

template <class L>
int occupancy(int n_best, int* blocks, int* smem, int* regs) {
  const auto k = pick<L, false>(n_best);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  *smem = (int)a.sharedSizeBytes, *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, 32, 0);
}

}  // namespace

extern "C" {

// W windows seqs (W, K) int32 nt6, 1 <= K <= 509, 2 <= n_best <= 48, the
// index below 2^32 symbols (the wrapper checks): arch (W, K, n_best, 2)
// int32 scratch; n_al, max_ed (W,) int32, n_hap (W, 7) int64 and bad (W,)
// uint8 out, and trips (W,) int32 unless null.  One block of one warp a
// window.  The _timed_ twin also writes lane 0's phase clocks, clk (W, NPH)
// int64 (csrc/dp.cuh PH_*); _occupancy_ gives the kernel's resident blocks
// an SM, static shared bytes and registers a thread at n_best.
#define RB3C_HAPDIV(name, L)                                                                                         \
  int rb3c_hapdiv_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift,      \
                         int block_shift, const int* seqs, int64_t W, int K, int n_best, int min_sc, int end_len,   \
                         int match, int mis, int gap_open, int gap_ext, int* arch, int* n_al, int* max_ed,           \
                         int64_t* n_hap, uint8_t* bad, int* trips, void* stream) {                                  \
    return launch<L, false>(rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}, seqs, W, K,               \
                            rb3c::hapdiv::make_opt(n_best, min_sc, end_len, match, mis, gap_open, gap_ext), arch,  \
                            n_al, max_ed, n_hap, bad, trips, nullptr, stream);                                      \
  }                                                                                                                 \
  int rb3c_timed_hapdiv_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc,               \
                               int mega_shift, int block_shift, const int* seqs, int64_t W, int K, int n_best,      \
                               int min_sc, int end_len, int match, int mis, int gap_open, int gap_ext, int* arch,   \
                               int* n_al, int* max_ed, int64_t* n_hap, uint8_t* bad, int* trips, long long* clk,    \
                               void* stream) {                                                                      \
    return launch<L, true>(rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}, seqs, W, K,                \
                           rb3c::hapdiv::make_opt(n_best, min_sc, end_len, match, mis, gap_open, gap_ext), arch,   \
                           n_al, max_ed, n_hap, bad, trips, clk, stream);                                           \
  }                                                                                                                 \
  int rb3c_occupancy_hapdiv_##name(int n_best, int* blocks, int* smem, int* regs) {                                 \
    return occupancy<L>(n_best, blocks, smem, regs);                                                                \
  }
RB3C_HAPDIV(dense32, rb3c::Dense<int>)
RB3C_HAPDIV(dense64, rb3c::Dense<int64_t>)

}  // extern "C"

#endif  // __CUDACC__
