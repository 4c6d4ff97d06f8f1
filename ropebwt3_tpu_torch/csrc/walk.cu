// The two host walks of the JAX package, on the card: `get`'s LF walk
// (K11) and `suffix`'s lock-step backward search (K12).  Neither has a TPU
// kernel: the JAX package runs them as host code (ropebwt3_tpu/index/
// dense.py DenseFMIndex.retrieve, :244-278, the native rb3t_retrieve walk
// behind it; ropebwt3_tpu/cli.py main_suffix's flush, :799-829, over
// rank1a_fast).  The plain PyTorch versions are ops/walk.py's.
//
// K11 retrieve_seg (every layout: Dense<T>::lf_step of occ.cuh, Rb<T>::
// lf_step of rb.cuh, where dense rows do not fit the card).  A walk from
// k reads B[k], steps k = LF(k), and so on until it reads symbol 0 (the
// sentinel); it prints what it read, reversed, and the row that holds the
// sentinel (fm-index.c:552-567).  On a `$`-free LF cycle (a BWT string
// given to plain2fmd can have one) the reference stops after n symbols
// (rb3t_retrieve's max_len), so the walk prints the cycle's symbols from k,
// repeated, and ends at LF^n(k).  Bound on the card: a walk is a chain of
// dependent 48-B row loads (~0.53 us each at a 48 MB table); one thread a
// walk leaves a pangenome's few 2 M-step walks at one chain each with the
// card idle.  So, as K5 (ssa_gen.cu) does, the walks are cut into
// segments and the cut is mended by list ranking; with q heads (the queried
// ks) and m = acc[1] (S below is the segment stride, 2^shift, not an rb
// row's block size, 2^block_shift):
//   pass 1 (retrieve_seg_walk): one thread per segment.  Segments 0..q-1
//     start at the ks; segment q + j at row m + j S.  A
//     segment walks LF until it reads a `$` (term = that row, nxt = -1), or
//     steps onto a start row m + j S (nxt = q + j), or, a head only, back
//     onto its own start (nxt = itself: a cycle with no start row on it).
//     d = len = the symbols it read.  Every walk stops within n steps.
//   pass 2 (ssa_gen.cu's rb3c_ssa_jump, reused as it is): pointer jumping
//     over (d, nxt, term); then d is each segment's symbols up to its walk's
//     `$` and term that `$`'s row.  A head still with nxt >= 0 lies on a
//     `$`-free cycle.
//   pass 3 (retrieve_seg_write): a walk's symbols, forward, are its
//     sequence's from the start, so a segment's step t lands at d - 1 - t
//     whichever head reaches it.  The host gives each distinct end row of
//     the heads one buffer, sized to its longest head (terms sorted, with
//     lmax and base); each segment whose term is one of them, and whose
//     symbols reach below lmax, walks again and writes those below lmax.
//     Overlapping writes (heads on a start row, nested ks) write one byte.
//   pass 4 (retrieve_seg_cycle, for cycle heads only): one thread a cycle
//     head walks one lap (P steps) writing the last P bytes of its n-byte
//     buffer, then n mod P steps more to its end row LF^n(k); a grid-stride
//     copy tiles the lap over the rest.  One thread a lap: a cycle of P rows
//     is a P-step chain, and the lap is walked twice (passes 1 and 4) when
//     no start row lies on it.  `build` never writes such an index.
// The starts are strided in BWT order, so a segment's length is geometric
// with mean S and passes 1 and 3 take ~S ln(segments) steps each.  With no
// strided starts (the wrapper's S > n - m) pass 1 is the one-thread-per-
// walk design, and pass 2 has no round.
//
// K12 suffix_walk (every layout): one thread per read, from its last
// symbol down (a read's backward search is one dependent chain).  A step
// ranks its one symbol c at both ends of the interval with the layout's
// rank2: one row fetch (rb: one header, one escape sub-row, one set of
// records) where k and l share it, two independent fetches otherwise,
// symbol c's count alone; then k = acc[c] + occ_c(k), l = acc[c] +
// occ_c(l).  The next step's symbol is loaded beside this step's rows, so
// only the rows lie on the chain.  The lane stops at the first empty
// interval or the read's start, and writes i + 1 (where the longest
// matching suffix starts) and the last non-empty interval's size.
// What bounds it, measured on `suffix`'s 100,200 reads of bench.py's
// index (H100; walk_time, PERF.md): all the reads at once, ~92 steps each,
// then the long reads' tail, the longest a chain of 518 steps.  Both ends
// fall in one row on 74% of the steps once the interval narrows; ranking
// all six counts at each end fetched 18.4 M rows a launch, rank2
// fetches 11.5 M.  dense32 took 0.49 ms, now 0.44: the short reads' loaded
// phase ~0.26 ms (it fell 11%, not with its sectors' 37%) and the longest
// chain ~0.23 ms (~430 ns a step against ~520).  Holding the rows in a
// persisting L2 window for the launch was tried and taken back: it cost
// 4-6% more on dense32 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rb.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kTileBlocks = 132 * 16;  // the tile's grid-stride blocks

unsigned grid_of(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

__device__ __forceinline__ int64_t thread_id() { return blockIdx.x * (int64_t)blockDim.x + threadIdx.x; }

// Segment g's start row: a head's k, or the strided row m + (g - q) S
__device__ __forceinline__ int64_t seg_start(const int64_t* ks, int64_t q, int64_t m, int shift, int64_t g) {
  return g < q ? ks[g] : m + ((g - q) << shift);
}

template <class L>
__global__ void retrieve_seg_walk(const L ix, const int64_t* __restrict__ ks, int64_t q, int64_t m, int shift,
                                  int64_t n_seg, int64_t* __restrict__ seg, int64_t* __restrict__ len) {
  using T = typename L::T;
  const int64_t g = thread_id();
  if (g >= n_seg) return;
  const int64_t smask = (int64_t(1) << shift) - 1;
  const bool strided = n_seg > q;
  const T k0 = (T)seg_start(ks, q, m, shift, g);
  T k = k0, nk = 0;
  int64_t t = 0, nxt = -1, term = -1;
  for (;;) {
    if (ix.lf_step(k, nk) == 0) {  // k holds the sentinel
      term = (int64_t)k;
      break;
    }
    ++t;
    const int64_t r = (int64_t)nk - m;  // >= 0: nk >= acc[1] = m for c != 0
    if (strided && (r & smask) == 0) {
      nxt = q + (r >> shift);
      break;
    }
    if (nk == k0) {  // a head back at its start: a cycle with no start row
      nxt = g;
      break;
    }
    k = nk;
  }
  seg[g] = t;
  seg[n_seg + g] = nxt;
  seg[2 * n_seg + g] = term;
  len[g] = t;
}

// Pass 3 over pass 2's records seg (3, n_seg): the heads' end rows terms (u,)
// ascending, each with its buffer's length lmax and offset base in out.
template <class L>
__global__ void retrieve_seg_write(const L ix, const int64_t* __restrict__ ks, int64_t q, int64_t m, int shift,
                                   int64_t n_seg, const int64_t* __restrict__ seg, const int64_t* __restrict__ len,
                                   const int64_t* __restrict__ terms, const int64_t* __restrict__ lmax,
                                   const int64_t* __restrict__ base, int64_t u, uint8_t* __restrict__ out) {
  using T = typename L::T;
  const int64_t g = thread_id();
  if (g >= n_seg || seg[n_seg + g] >= 0) return;  // on a `$`-free cycle
  const int64_t term = seg[2 * n_seg + g];
  int64_t lo = 0, hi = u;  // the first terms[i] >= term
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (terms[mid] < term)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo == u || terms[lo] != term) return;  // no head ends there
  const int64_t d = seg[g], n_sym = len[g], cap = lmax[lo];
  if (d - n_sym >= cap) return;  // every symbol past the longest head
  uint8_t* o = out + base[lo];
  T k = (T)seg_start(ks, q, m, shift, g), nk = 0;
  for (int64_t t = 0; t < n_sym; ++t) {
    const int c = ix.lf_step(k, nk);
    const int64_t pos = d - 1 - t;
    if (pos < cap) o[pos] = (uint8_t)c;
    k = nk;
  }
}

// Pass 4, walk: cycle head heads[i] writes its lap into out[i n + n - P ..
// i n + n) and records P and its end row LF^n(k).
template <class L>
__global__ void retrieve_seg_cycle(const L ix, const int64_t* __restrict__ ks, const int64_t* __restrict__ heads,
                                   int64_t n_cyc, int64_t n, uint8_t* __restrict__ out, int64_t* __restrict__ period,
                                   int64_t* __restrict__ end) {
  using T = typename L::T;
  const int64_t i = thread_id();
  if (i >= n_cyc) return;
  uint8_t* o = out + i * n + n - 1;
  const T k0 = (T)ks[heads[i]];
  T k = k0, nk = 0;
  int64_t p = 0;
  do {
    o[-p] = (uint8_t)ix.lf_step(k, nk);
    ++p;
    k = nk;
  } while (k != k0);
  for (int64_t s = n % p; s > 0; --s) {
    ix.lf_step(k, nk);
    k = nk;
  }
  period[i] = p;
  end[i] = (int64_t)k;
}

// Pass 4, tile: position x < n - P of a cycle buffer copies the lap's byte
// at the same phase, n - 1 - (n - 1 - x) mod P.
__global__ void retrieve_seg_tile(int64_t n_cyc, int64_t n, uint8_t* __restrict__ out,
                                  const int64_t* __restrict__ period) {
  const int64_t total = n_cyc * n;
  for (int64_t j = thread_id(); j < total; j += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = j / n, x = j - i * n, p = period[i];
    if (x < n - p) out[j] = out[i * n + n - 1 - (n - 1 - x) % p];
  }
}

template <class L>
__global__ void suffix_walk(const L ix, const uint8_t* __restrict__ q, const int64_t* __restrict__ off, int64_t R,
                            int64_t* __restrict__ start, int64_t* __restrict__ last) {
  using T = typename L::T;
  const int64_t r = thread_id();
  if (r >= R) return;
  const uint8_t* s = q + off[r];
  int64_t i = off[r + 1] - off[r] - 1;
  T k = 0, l = ix.acc(6), size = 0;
  int c = i >= 0 ? s[i] : 0;
  while (i >= 0) {
    const int next = i > 0 ? s[i - 1] : 0;  // the next step's symbol, loaded beside this step's rows
    const T a = ix.acc(c);
    T ok, ol;
    ix.rank2(k, l, c, ok, ol);
    k = a + ok;
    l = a + ol;
    if (l - k <= 0) break;
    size = l - k;
    --i;
    c = next;
  }
  start[r] = i + 1;
  last[r] = (int64_t)size;
}

}  // namespace

extern "C" {

// K11 pass 1: ks (q,) int64 in [0, n); segments the q heads, then (n_seg >
// q) the rows m + j 2^shift; seg (3, n_seg) int64 out (d, nxt, term: buffer
// 0 of rb3c_ssa_jump's pair) and len (n_seg,) int64 (pass 1's d).
#define RB3C_RETRIEVE_SEG_WALK(name, L)                                                                             \
  int rb3c_retrieve_seg_walk_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc,         \
                                    int mega_shift, int block_shift, const int64_t* ks, int64_t q, int64_t m,     \
                                    int shift, int64_t n_seg, int64_t* seg, int64_t* len, void* stream) {         \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    retrieve_seg_walk<L><<<grid_of(n_seg), kThreads, 0, (cudaStream_t)stream>>>(ix, ks, q, m, shift, n_seg, seg,  \
                                                                                len);                             \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_LAYOUTS(RB3C_RETRIEVE_SEG_WALK)

// K11 pass 3: seg (3, n_seg) pass 2's result, len pass 1's; terms, lmax and
// base (u,) int64 (terms ascending); out the symbol buffer.
#define RB3C_RETRIEVE_SEG_WRITE(name, L)                                                                            \
  int rb3c_retrieve_seg_write_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc,        \
                                     int mega_shift, int block_shift, const int64_t* ks, int64_t q, int64_t m,    \
                                     int shift, int64_t n_seg, const int64_t* seg, const int64_t* len,            \
                                     const int64_t* terms, const int64_t* lmax, const int64_t* base, int64_t u,   \
                                     uint8_t* out, void* stream) {                                                \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    retrieve_seg_write<L><<<grid_of(n_seg), kThreads, 0, (cudaStream_t)stream>>>(ix, ks, q, m, shift, n_seg, seg, \
                                                                                 len, terms, lmax, base, u, out); \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_LAYOUTS(RB3C_RETRIEVE_SEG_WRITE)

// K11 pass 4: heads (n_cyc,) int64 the cycle heads' segment ids; out (n_cyc,
// n) uint8, period and end (n_cyc,) int64 out.  Two launches: the laps, then
// the tile.
#define RB3C_RETRIEVE_SEG_CYCLE(name, L)                                                                            \
  int rb3c_retrieve_seg_cycle_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc,        \
                                     int mega_shift, int block_shift, const int64_t* ks, const int64_t* heads,     \
                                     int64_t n_cyc, int64_t n, uint8_t* out, int64_t* period, int64_t* end,       \
                                     void* stream) {                                                               \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    retrieve_seg_cycle<L><<<grid_of(n_cyc), kThreads, 0, (cudaStream_t)stream>>>(ix, ks, heads, n_cyc, n, out,    \
                                                                                 period, end);                    \
    const cudaError_t err = cudaGetLastError();                                                                     \
    if (err != cudaSuccess) return (int)err;                                                                        \
    const int64_t blocks = (n_cyc * n + kThreads - 1) / kThreads;                                                   \
    retrieve_seg_tile<<<(unsigned)(blocks < kTileBlocks ? blocks : kTileBlocks), kThreads, 0,                      \
                        (cudaStream_t)stream>>>(n_cyc, n, out, period);                                             \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_LAYOUTS(RB3C_RETRIEVE_SEG_CYCLE)

// K12: reads q (flat uint8 nt6 codes 0..5) at off (R + 1,) int64; start and
// last (R,) int64 out.  _occupancy_ gives the kernel's resident blocks an
// SM, local bytes and registers a thread.
#define RB3C_SUFFIX_WALK(name, L)                                                                                    \
  int rb3c_suffix_walk_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift, \
                              int block_shift, const uint8_t* q, const int64_t* off, int64_t R, int64_t* start,     \
                              int64_t* last, void* stream) {                                                        \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    suffix_walk<L><<<grid_of(R), kThreads, 0, (cudaStream_t)stream>>>(ix, q, off, R, start, last);                 \
    return (int)cudaGetLastError();                                                                                 \
  }                                                                                                                 \
  int rb3c_occupancy_suffix_walk_##name(int* blocks, int* local, int* regs) {                                      \
    cudaFuncAttributes a;                                                                                           \
    const cudaError_t e = cudaFuncGetAttributes(&a, suffix_walk<L>);                                                \
    if (e != cudaSuccess) return (int)e;                                                                            \
    *local = (int)a.localSizeBytes, *regs = a.numRegs;                                                              \
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, suffix_walk<L>, kThreads, 0);                 \
  }
RB3C_LAYOUTS(RB3C_SUFFIX_WALK)

}  // extern "C"
