// The sw scoring DP (K9): the BWA-SW DP of sw_core (bwa-sw.c:329-526) over
// each read's prefix DAWG, one warp a read.  Per read it gives every node's
// top-n_best row as archive words, best_sc, best_pos and the `bad` flag of
// ropebwt3_tpu_torch/align/sw.py (sw_plain is its plain version).
//
// Replaces the XLA body of ropebwt3_tpu/align/sw_jax.py sw_device (:122-606):
// node_body (:161) scanned over the DAWG's nodes with its F-closure
// (cl_body, :415) and the root row (:592-601).
//
// A read is one warp; its state for the node at hand is in shared memory,
// sized by the khashl geometry as hapdiv.cu's (csrc/dp.cuh Table), the rows
// of all its nodes in device memory (`scratch`, four words a cell), since a
// later node may name any earlier one as a predecessor (up to P of them).
// Per node: the prune's k-th largest H over the predecessor cells
// (sw_jax.py:185-192) from a warp sort of their (H, slot) keys; then for
// each predecessor in order, its cells are loaded and extended over the
// lanes and written as candidate slots (cell, c = 1..5, then the E slot),
// and the warp merges them into the khashl table 32 slots a round in the
// reference's insert order (predecessor, cell, c), as sw_update_candset
// does; then the top N by a warp sort and the F-closure, both dp.cuh's as
// hapdiv.cu runs them, with rlen carried.  The lock-step body's sorts and
// scans become these ordered inserts (hapdiv.cu says why the two agree);
// its caps are replayed, so its flags are: a key count that would resize
// the table, stack and fpar overflow, the E-type H_from_pos corner, 12-bit
// scores and 9-bit lengths, 1024 closure rounds a node; and, the port's
// own, an F offset past the archive's 5 bits.  Once flagged a read stops;
// its best_sc and best_pos are 0.
//
// The text up to `#ifdef __CUDACC__` compiles with g++ given a header that
// defines the CUDA keywords and collectives for one lane
// (tests/test_torch_runblock.py HOST_SHIM): `sw_read<1>` then runs one read
// on the host.

#include <stdint.h>

#include "dp.cuh"

namespace rb3c {
namespace sw {

using namespace dp;

constexpr int PMAX = 6;     // DAWG in-degree limit (sw_jax.py P_MAX)
constexpr int NCMAX = 384;  // DAWG node limit (sw_jax.py NC_BUCKETS[-1])
constexpr int MAX_SCORE = 4095, MAX_LEN = 510;  // the 12-bit score and 9-bit length fields
// the root row's archive word: valid, H 0, Foffr 31, Hpos 0, Epos unset
constexpr long long ROOT_WORD = 1LL | 31LL << 18 | (long long)PNONE << 39;
// A carried cell in device memory: key (lo << 32 | hi), lorc, H | E << 32,
// rlen | qlen << 32.
constexpr int CELL_WORDS = 4;

struct Opt {
  int n_best, end_len, match, mis, gap_open, gap_ext;
  int nb_bits, nb, maxc;  // kh_resize(n_best * 4) geometry (nb_params)
  int maxpen;             // max(gap_open + gap_ext, mis): the prune's margin
};

inline Opt make_opt(int n_best, int end_len, int match, int mis, int gap_open, int gap_ext) {
  int nb_bits = 2;
  while ((1 << nb_bits) < 4 * n_best) ++nb_bits;  // nb_params: the power of two >= 4 n_best
  const int nb = 1 << nb_bits;
  const int maxpen = gap_open + gap_ext > mis ? gap_open + gap_ext : mis;
  return Opt{n_best, end_len, match, mis, gap_open, gap_ext, nb_bits, nb, (nb >> 1) + (nb >> 2), maxpen};
}

// One read's state for the node at hand.
template <typename T, int NB>
struct State {
  using Tb = Table<T, NB, true>;
  Tb t;
  uint8_t nrow[NCMAX];  // cells in each node's row
};

// The ks_ksmall prune (bwa-sw.c:366-376): the H of rank N, descending, of
// the n_cell predecessor cells (slot order pre x cell), from a sort of their
// (H + 1) << 9 | (511 - slot) keys.
template <int LANES, int E, class S>
__device__ int kth_h(const S& s, const int pid[PMAX], int P, int n_cell, int N, const long long* scratch, int lane) {
  uint32_t v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    v[e] = 0;
    if (i < n_cell) {
      int id = 0, j = i;
      for (int p = 0, base = 0; p < PMAX; ++p) {
        if (p >= P || pid[p] < 0) continue;
        const int nr = s.nrow[pid[p]];
        if (i >= base && i < base + nr) id = pid[p], j = i - base;
        base += nr;
      }
      const int H = (int)(scratch[((long long)id * N + j) * CELL_WORDS + 2] & 0xffffffffLL);
      v[e] = (uint32_t)(H + 1) << 9 | (uint32_t)(511 - i);
    }
  }
  sort_desc<LANES, E>(v, lane);
  uint32_t at_n = 0;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane * E + e == N) at_n = v[e];
  return (int)(shfl(at_n, N / E) >> 9) - 1;
}

// One read: its DAWG node_c (NC,), pre (NC, P) (-1 after the last
// predecessor), n_node nodes; its rows from row 0 of scratch (n_node,
// n_best, 4) int64 and of the archive alo, ahi, arc (n_node, n_best) int32
// and aw (n_node, n_best) int64; best_sc, best_pos, bad_out and (unless
// null) trips_out: the read's dependent extend rounds (one a node, one a
// closure pop), up to the one that made it bad.  TM: clk gets lane 0's
// phase clocks (NPH).
template <int LANES, bool TM, class L, int NB>
__device__ void sw_read(const L& ix, State<typename L::T, NB>& s, const int* node_c, const int* pre, int n_node, int P,
                        const Opt& o, long long* scratch, int* alo, int* ahi, int* arc, long long* aw, int* best_sc,
                        int* best_pos, uint8_t* bad_out, int* trips_out, int lane, long long* clk) {
  using T = typename L::T;
  auto& t = s.t;
  const int N = o.n_best;
  const T n_all = ix.acc(6);
  Clk<TM> ck;
  ck.start();
  for (int j = lane; j < N; j += LANES) {  // the root row: one cell, the whole BWT
    alo[j] = 0, ahi[j] = j == 0 ? (int)(uint32_t)n_all : 0, arc[j] = 0, aw[j] = j == 0 ? ROOT_WORD : 0;
  }
  if (lane == 0) {
    long long* c0 = scratch;
    c0[0] = (long long)key_of((T)0, n_all), c0[1] = 0, c0[2] = 0, c0[3] = 0;
    s.nrow[0] = 1;
  }
  sync();
  int trips = 0, lastp_q = 0, best = 0, best_at = 0;  // w.last_p dangles across nodes
  bool bad = false;
  for (int node = 1; node < n_node && !bad; ++node) {
    const int cn = node_c[node];
    int pid[PMAX], n_pre = 0, n_cell = 0, last = -1;
#pragma unroll
    for (int p = 0; p < PMAX; ++p) {
      pid[p] = p < P ? pre[node * P + p] : -1;
      if (pid[p] < 0) continue;
      ++n_pre;
      n_cell += s.nrow[pid[p]];
      if (s.nrow[pid[p]]) last = pid[p];
    }
    // w.last_p: the last visited cell (visited even when pruned)
    if (last >= 0) lastp_q = (int)(scratch[((long long)last * N + s.nrow[last] - 1) * CELL_WORDS + 3] >> 32);
    int mms = 0;
    if (n_pre > 1) {
      if (n_cell > N) mms = kth_h<LANES, State<T, NB>::Tb::PRUNE / LANES>(s, pid, P, n_cell, N, scratch, lane);
      mms = mms - o.maxpen > 0 ? mms - o.maxpen : 0;
    }
    ck.lap(PH_TAIL);
    ++trips;
    clear<LANES>(t, o.nb, lane);
    int count = 0;
    // each predecessor row: its cells extended over the lanes as candidate
    // slots, then merged by the warp in insert order
#pragma unroll 1
    for (int p = 0; p < PMAX && !bad; ++p) {
      const int id = pid[p];
      if (id < 0 || !s.nrow[id]) continue;
      const int nr = s.nrow[id], gpos = id * N;  // a cell's global position (bwa-sw.c:393)
      bool over = false;
      for (int j = lane; j < nr; j += LANES) {
        const long long* c = scratch + ((long long)gpos + j) * CELL_WORDS;
        const unsigned long long key = (unsigned long long)c[0];
        const T lo = (T)(key >> 32), hi = (T)(key & 0xffffffffULL);
        const int pH = (int)(c[2] & 0xffffffffLL), pE = (int)(c[2] >> 32);
        const int prl = (int)(c[3] & 0xffffffffLL), pq = (int)(c[3] >> 32);
        uint32_t* pay = t.u.slot.pay + 6 * j;
        if (pH + o.match < mms) {
#pragma unroll
          for (int c6 = 0; c6 < 6; ++c6) pay[c6] = 0u;
          continue;
        }
        T olo[5], orc[5], osz[5];
        extend5(ix, lo, (T)c[1], hi - lo, olo, orc, osz);
        T last_rc = 0;  // the E slot's stale lo_rc (bwa-sw.c:418): the last passing H-cand's
#pragma unroll
        for (int cc = 1; cc <= 5; ++cc) {
          const int sc = (cc == cn && cc != 5) ? o.match : -o.mis, H = pH + sc;
          const bool pass = osz[cc - 1] > 0 && H > 0 && H >= mms && (cc == cn || pq >= o.end_len);
          if (pass) last_rc = orc[cc - 1];
          over |= pass && (H > MAX_SCORE || pq + 1 > MAX_LEN || prl + 1 > MAX_LEN);
          t.u.slot.key[6 * j + cc - 1] = key_of(olo[cc - 1], (T)(olo[cc - 1] + osz[cc - 1]));
          t.u.slot.lorc[6 * j + cc - 1] = orc[cc - 1];
          pay[cc - 1] = pass ? pack_pay(H, pq + 1, prl + 1, 0, 0) : 0u;
        }
        const bool e_open = pH - o.gap_open > pE;
        const int e_val = (e_open ? pH - o.gap_open : pE) - o.gap_ext;
        const bool pass = e_val > 0 && e_val >= mms && pq >= o.end_len;
        over |= pass && (e_val > MAX_SCORE || pq + 1 > MAX_LEN || prl > MAX_LEN);
        t.u.slot.key[6 * j + 5] = key;
        t.u.slot.lorc[6 * j + 5] = last_rc;
        pay[5] = pass ? pack_pay(e_val, pq + 1, prl, 1, e_open ? FROM_OPEN : FROM_EXT) : 0u;
      }
      sync();
      ck.lap(PH_EXT);
      bad = any(over) || !merge<LANES, true>(t, o, 6 * nr, gpos, count, lane);
      ck.lap(PH_MERGE);
    }
    if (bad) break;
    int n_row = 0;
    if (!top_n<LANES>(t, N, count, true, false, n_row, lane)) {
      bad = true;
      break;
    }
    ck.lap(PH_TOP1);
    if (!closure<LANES, true>(ix, t, o, lastp_q >= o.end_len, n_row, MAX_LEN, count, trips, ck, lane)) {
      bad = true;
      break;
    }
    ck.lap(PH_CL);
    top_n<LANES>(t, N, count, false, true, n_row, lane);
    ck.lap(PH_TOP2);
    // the new row, carried and archived; sw_track_F turns the fpar entry
    // (the parent's bucket) into its column in the row
    const long long row0 = (long long)node * N;
    bool wide = false;
    for (int j = lane; j < N; j += LANES) {
      int lo32 = 0, hi32 = 0, rc32 = 0;
      long long w = 0;
      if (j < n_row) {
        const int b = t.rowb[j];
        const int foff = t.F[b] > 0 && t.foff[b] != UNSET8 ? t.col[t.u.cl.fpar[t.foff[b]]] : UNSET8;
        const bool fos = foff != UNSET8;
        wide |= fos && foff > 31;  // past the archive word's 5-bit field (n_best > 32)
        const unsigned long long key = t.key[b];
        const int fl = t.fl[b];
        const uint32_t ps = t.pos[b];
        lo32 = (int)(uint32_t)(key >> 32), hi32 = (int)(uint32_t)key, rc32 = (int)(uint32_t)t.lorc[b];
        w = 1LL | (long long)t.H[b] << 1 | (long long)(fl & 3) << 13 | (long long)((fl >> 2) & 1) << 15 |
            (long long)((fl >> 3) & 1) << 16 | (long long)fos << 17 | (long long)(fos ? foff & 31 : 31) << 18 |
            (long long)(ps & 0xFFFF) << 23 | (long long)(ps >> 16) << 39;
        long long* c = scratch + (row0 + j) * CELL_WORDS;
        c[0] = (long long)key, c[1] = (long long)t.lorc[b];
        c[2] = (long long)(uint32_t)t.H[b] | (long long)t.E[b] << 32;
        c[3] = (long long)(uint32_t)t.rl[b] | (long long)t.q[b] << 32;
      }
      alo[row0 + j] = lo32, ahi[row0 + j] = hi32, arc[row0 + j] = rc32, aw[row0 + j] = w;
    }
    if (lane == 0) s.nrow[node] = (uint8_t)n_row;
    if (n_row > 0 && t.H[t.rowb[0]] > best) best = t.H[t.rowb[0]], best_at = node * N;
    bad = any(wide);
    sync();
    ck.lap(PH_ARCH);
  }
  if (lane == 0) {
    *best_sc = bad ? 0 : best;
    *best_pos = bad ? 0 : best_at;
    *bad_out = (uint8_t)bad;
    if (trips_out) *trips_out = trips;
  }
  ck.write(clk, lane);
}

}  // namespace sw
}  // namespace rb3c

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using rb3c::sw::Opt;
using rb3c::sw::State;

constexpr int MIN_BLOCKS = 16;  // one-warp blocks an SM: caps the registers at 128 a thread

template <class L, int NB, bool TM>
__global__ void __launch_bounds__(32, MIN_BLOCKS)
    sw_kernel(const L ix, const int* __restrict__ node_c, const int* __restrict__ pre, const int* __restrict__ n_node,
              const int64_t* __restrict__ rows, int64_t W, int NC, int P, const Opt o, long long* __restrict__ scratch,
              int* __restrict__ alo, int* __restrict__ ahi, int* __restrict__ arc, long long* __restrict__ aw,
              int* __restrict__ best_sc, int* __restrict__ best_pos, uint8_t* __restrict__ bad,
              int* __restrict__ trips, long long* __restrict__ clk) {
  __shared__ State<typename L::T, NB> s;
  const int64_t w = blockIdx.x;
  if (w >= W) return;
  const int64_t r0 = rows[w] * o.n_best;
  rb3c::sw::sw_read<32, TM>(ix, s, node_c + w * NC, pre + w * NC * P, n_node[w], P, o,
                            scratch + r0 * rb3c::sw::CELL_WORDS, alo + r0, ahi + r0, arc + r0, aw + r0, best_sc + w,
                            best_pos + w, bad + w, trips ? trips + w : nullptr, (int)threadIdx.x,
                            TM ? clk + w * rb3c::dp::NPH : nullptr);
}

// The kernel of n_best's geometry: nb 128 takes n_best up to 32.
template <class L, bool TM>
auto pick(int n_best) {
  return n_best <= 32 ? sw_kernel<L, 128, TM> : sw_kernel<L, 256, TM>;
}

template <class L, bool TM>
int launch(const rb3c::Tables& tb, const int* node_c, const int* pre, const int* n_node, const int64_t* rows,
           int64_t W, int NC, int P, const Opt& o, long long* scratch, int* alo, int* ahi, int* arc, long long* aw,
           int* best_sc, int* best_pos, uint8_t* bad, int* trips, long long* clk, void* stream) {
  const L ix{tb};
  pick<L, TM>(o.n_best)<<<(unsigned)W, 32, 0, (cudaStream_t)stream>>>(ix, node_c, pre, n_node, rows, W, NC, P, o,
                                                                      scratch, alo, ahi, arc, aw, best_sc, best_pos,
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

// W reads' DAWGs node_c (W, NC), pre (W, NC, P) int32 (-1 pads), n_node (W,)
// int32 with 1 <= n_node <= NC <= 384, 1 <= P <= 6, 2 <= n_best <= 48 and
// the index below 2^32 symbols (the wrapper checks); rows (W + 1,) int64:
// read w's rows are [rows[w], rows[w + 1]) of scratch (T, n_best, 4) int64
// and of the archive alo, ahi, arc (T, n_best) int32 and aw (T, n_best)
// int64 (out); best_sc, best_pos (W,) int32, bad (W,) uint8 out, and trips
// (W,) int32 unless null.  One block of one warp a read.  The _timed_ twin
// also writes lane 0's phase clocks, clk (W, NPH) int64 (csrc/dp.cuh PH_*);
// _occupancy_ gives the kernel's resident blocks an SM, static shared bytes
// and registers a thread at n_best.
#define RB3C_SW(name, L)                                                                                             \
  int rb3c_sw_##name(const int* rows_t, const int* esc, const int64_t* mega, const void* acc, int mega_shift,        \
                     int block_shift, const int* node_c, const int* pre, const int* n_node, const int64_t* rows,    \
                     int64_t W, int NC, int P, int n_best, int end_len, int match, int mis, int gap_open,           \
                     int gap_ext, long long* scratch, int* alo, int* ahi, int* arc, long long* aw, int* best_sc,    \
                     int* best_pos, uint8_t* bad, int* trips, void* stream) {                                       \
    return launch<L, false>(rb3c::Tables{rows_t, esc, mega, acc, mega_shift, block_shift}, node_c, pre, n_node,    \
                            rows, W, NC, P, rb3c::sw::make_opt(n_best, end_len, match, mis, gap_open, gap_ext),     \
                            scratch, alo, ahi, arc, aw, best_sc, best_pos, bad, trips, nullptr, stream);            \
  }                                                                                                                 \
  int rb3c_timed_sw_##name(const int* rows_t, const int* esc, const int64_t* mega, const void* acc, int mega_shift,  \
                           int block_shift, const int* node_c, const int* pre, const int* n_node,                   \
                           const int64_t* rows, int64_t W, int NC, int P, int n_best, int end_len, int match,       \
                           int mis, int gap_open, int gap_ext, long long* scratch, int* alo, int* ahi, int* arc,    \
                           long long* aw, int* best_sc, int* best_pos, uint8_t* bad, int* trips, long long* clk,    \
                           void* stream) {                                                                          \
    return launch<L, true>(rb3c::Tables{rows_t, esc, mega, acc, mega_shift, block_shift}, node_c, pre, n_node,     \
                           rows, W, NC, P, rb3c::sw::make_opt(n_best, end_len, match, mis, gap_open, gap_ext),      \
                           scratch, alo, ahi, arc, aw, best_sc, best_pos, bad, trips, clk, stream);                 \
  }                                                                                                                 \
  int rb3c_occupancy_sw_##name(int n_best, int* blocks, int* smem, int* regs) {                                     \
    return occupancy<L>(n_best, blocks, smem, regs);                                                                \
  }
RB3C_SW(dense32, rb3c::Dense<int>)
RB3C_SW(dense64, rb3c::Dense<int64_t>)

}  // extern "C"

#endif  // __CUDACC__
