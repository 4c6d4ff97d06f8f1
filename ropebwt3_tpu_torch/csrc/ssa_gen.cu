// Sampled suffix array generation (K5; rb3_ssa_gen, ssa.c:54-81): every
// sequence LF-walks from its sentinel row (lanes 0..m-1) to the sentinel
// that ends it; each row r it reaches with a non-sentinel step, sampled when
// (r - m) & (2^ss - 1) == 0, gets slot (r - m) >> ss: the step at which the
// lane reached it and the lane.
//
// Replaces the XLA loop body of ropebwt3_tpu/ssa_ops.py ssa_gen_device
// (`mk_body` -> `body`, :127-147), which advances all m lanes in lock-step.
// The host assembles the SSA from (ssa_l, ssa_lane, death_l, final_k) as
// ssa_ops.py:200-207 does.
//
// Bound on the card: dependent chains of 48-B row loads, one per LF step
// (occ.cuh lf_step: the symbol comes from the same row's planes).  One
// thread per sequence leaves a pangenome's few long walks (bench.py's
// index: m = 32 walks of ~2 M steps) at one chain each, with the card idle.
// So the walks are cut, and the cut is mended by list ranking:
//   pass 1 (ssa_walk): one thread per segment.  Segments start at the m
//     sentinel rows and, S = 2^shift, at every row r >= m with
//     (r - m) % S == 0 (segment m + (r - m) / S).  A segment walks LF from
//     its start row (step t = 0) until a `$` step (term = the sentinel
//     rank, nxt = -1) or a start row (nxt = that row's segment, whose own
//     thread writes its slot); d = its steps.  At its start row (strided
//     segments) and every row reached before it stops, a sampled slot gets
//     the segment id in ssa_lane and t in ssa_l: one writer a slot, no
//     atomics.
//   pass 2 (ssa_jump): pointer jumping (Wyllie) over (d, nxt, term),
//     double-buffered, one launch a round, bit_length(n_seg - m) rounds (a
//     walk's chain is its head and at most n_seg - m segments): then d
//     is each reached segment's distance from its start to its walk's `$`
//     step and term its walk's sentinel rank.  A segment still with
//     nxt >= 0 lies on an LF cycle without `$` (a BWT string given to
//     DenseFMIndex.from_bwt can have one): no lane reaches it, and its slots
//     are cleared, as the lock-step walk leaves them.
//   pass 3 (ssa_finish): lane i has death_l = d[i], final_k = term[i], and
//     lane_of[term[i]] = i (LF is a bijection: each walk ends on its own
//     sentinel rank); then a slot of segment g at step t takes lane
//     lane_of[term[g]] and step death_l[lane] - (d[g] - t).
// The starts are strided in BWT order, so along a walk a segment's length is
// geometric with mean S and pass 1's chain is the longest, ~S ln(segments).
// With no strided starts (the wrapper's S > n - m) pass 1 is the
// one-thread-per-sequence walk, and pass 2 has no round.
//
// On a mesh (the mesh branch of ropebwt3_tpu/ssa_ops.py ssa_gen_device,
// :163-199: lanes over `dp`, the tables replicated, the slots merged by a
// pmax) pass 1 runs over a range [g0, g1) of the segments on each device
// of the mesh, each with its own slots and records; every slot and record
// has one writer globally, so the shares merge by a max (ssa_lane -1 and
// the records INT64_MIN where unwritten), and passes 2 and 3 run once,
// on the mesh's first device, over the merged ones (ssa_ops.py walk_mesh).
//
// Pass 1 is instantiated for every layout (rb rows: Rb<T>::lf_step of
// rb.cuh, where dense rows do not fit the card); passes 2 and 3 read no
// rows, and pass 3 comes in each layout's width.  ssa_l, death_l and final_k
// are in the layout's T; ssa_lane and lane_of int32 (segment ids below
// 2^31: the wrapper checks); the segment records int64.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rb.cuh"

namespace {

constexpr int kThreads = 128;

// One buffer of the segment records: three rows of n_seg int64.
struct Segs {
  int64_t *d, *nxt, *term;
};

__host__ __device__ inline Segs segs_at(int64_t* seg, int64_t n_seg) { return Segs{seg, seg + n_seg, seg + 2 * n_seg}; }

__device__ __forceinline__ int64_t thread_id() { return blockIdx.x * (int64_t)blockDim.x + threadIdx.x; }

unsigned grid_of(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <class L>
__global__ void ssa_walk(const L ix, int64_t m, int ss, int shift, int64_t n_seg, int64_t g0, int64_t g1,
                         typename L::T* __restrict__ ssa_l, int* __restrict__ ssa_lane, const Segs s) {
  using T = typename L::T;
  const int64_t g = g0 + thread_id();
  if (g >= g1) return;
  const int64_t mask = (int64_t(1) << ss) - 1;
  const int64_t smask = (int64_t(1) << shift) - 1;
  const bool strided = n_seg > m;
  const int64_t r0 = g < m ? -1 : (g - m) << shift;  // a strided start: row m + r0
  T k = (T)(g < m ? g : m + r0), nk = 0;
  if (r0 >= 0 && (r0 & mask) == 0) {  // sampled at t = 0
    ssa_l[r0 >> ss] = 0;
    ssa_lane[r0 >> ss] = (int)g;
  }
  int64_t t = 0, nxt = -1, term = -1;
  for (;;) {
    ++t;
    if (ix.lf_step(k, nk) == 0) {  // the sentinel: nk < m is its rank
      term = (int64_t)nk;
      break;
    }
    const int64_t r = (int64_t)nk - m;  // >= 0: nk >= acc[1] = m for c != 0
    if (strided && (r & smask) == 0) {
      nxt = m + (r >> shift);
      break;
    }
    if ((r & mask) == 0) {
      ssa_l[r >> ss] = (T)t;
      ssa_lane[r >> ss] = (int)g;
    }
    k = nk;
  }
  s.d[g] = t;
  s.nxt[g] = nxt;
  s.term[g] = term;
}

// One round of pointer jumping, a -> b.  d of a segment on a `$`-free cycle
// grows without bound and wraps (unsigned: defined); nothing reads it.
__global__ void ssa_jump_round(const Segs a, const Segs b, int64_t n_seg) {
  const int64_t g = thread_id();
  if (g >= n_seg) return;
  const int64_t nx = a.nxt[g];
  if (nx >= 0) {
    b.d[g] = (int64_t)((uint64_t)a.d[g] + (uint64_t)a.d[nx]);
    b.nxt[g] = a.nxt[nx];
    b.term[g] = a.term[nx];
  } else {
    b.d[g] = a.d[g];
    b.nxt[g] = -1;
    b.term[g] = a.term[g];
  }
}

template <class T>
__global__ void ssa_finish_lanes(const Segs s, int64_t m, T* __restrict__ death_l, T* __restrict__ final_k,
                                 int* __restrict__ lane_of) {
  const int64_t lane = thread_id();
  if (lane >= m) return;
  const int64_t term = s.term[lane];  // every lane's walk ends: 0 <= term < m
  death_l[lane] = (T)s.d[lane];
  final_k[lane] = (T)term;
  lane_of[term] = (int)lane;
}

template <class T>
__global__ void ssa_finish_slots(const Segs s, const int* __restrict__ lane_of, int64_t n_ssa, T* __restrict__ ssa_l,
                                 int* __restrict__ ssa_lane) {
  const int64_t x = thread_id();
  if (x >= n_ssa) return;
  const int g = ssa_lane[x];
  if (g < 0) return;
  if (s.nxt[g] >= 0) {  // on a cycle no lane walks
    ssa_lane[x] = -1;
    ssa_l[x] = 0;
    return;
  }
  const int lane = lane_of[s.term[g]];
  ssa_lane[x] = lane;
  ssa_l[x] = (T)(s.d[lane] - (s.d[g] - (int64_t)ssa_l[x]));
}

}  // namespace

extern "C" {

// Pass 1 over the segments [g0, g1) of n_seg (a walk: 0, n_seg; a mesh
// gives each device a range, ssa_ops.py walk_mesh, and merges the shares).
// Segments: the m sentinel rows, then (n_seg > m) the rows m + j * 2^shift;
// seg (3, n_seg) int64 out in the range's columns: d, nxt, term.  ssa_l
// (n_ssa,) T and ssa_lane (n_ssa,) int32, as the caller initialises them (0
// and -1): a sampled slot gets its step and segment.  m >= 1.
#define RB3C_SSA_WALK(name, L)                                                                                       \
  int rb3c_ssa_walk_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift,    \
                           int block_shift, int64_t m, int ss, int shift, int64_t n_seg, int64_t g0, int64_t g1,    \
                           void* ssa_l, int* ssa_lane, int64_t* seg, void* stream) {                                \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    if (g1 > g0)                                                                                                    \
      ssa_walk<L><<<grid_of(g1 - g0), kThreads, 0, (cudaStream_t)stream>>>(ix, m, ss, shift, n_seg, g0, g1,        \
                                                                          static_cast<L::T*>(ssa_l), ssa_lane,     \
                                                                          segs_at(seg, n_seg));                    \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_LAYOUTS(RB3C_SSA_WALK)

// Pass 2: `rounds` rounds over seg (2, 3, n_seg) int64, pass 1's records in
// buffer 0; the result lies in buffer rounds % 2.
int rb3c_ssa_jump(int64_t* seg, int64_t n_seg, int rounds, void* stream) {
  for (int i = 0; i < rounds; ++i) {
    const Segs a = segs_at(seg + (i % 2) * 3 * n_seg, n_seg), b = segs_at(seg + (1 - i % 2) * 3 * n_seg, n_seg);
    ssa_jump_round<<<grid_of(n_seg), kThreads, 0, (cudaStream_t)stream>>>(a, b, n_seg);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Pass 3 over pass 2's records seg (3, n_seg): death_l and final_k (m,) T
// out, lane_of (m,) int32 scratch, ssa_l / ssa_lane rewritten from segment
// steps to lane steps.
#define RB3C_SSA_FINISH(name, T)                                                                                     \
  int rb3c_ssa_finish_##name(const int64_t* seg, int64_t n_seg, int64_t m, int64_t n_ssa, void* ssa_l,             \
                             int* ssa_lane, void* death_l, void* final_k, int* lane_of, void* stream) {            \
    const Segs s = segs_at(const_cast<int64_t*>(seg), n_seg);                                                       \
    ssa_finish_lanes<T><<<grid_of(m), kThreads, 0, (cudaStream_t)stream>>>(s, m, static_cast<T*>(death_l),         \
                                                                           static_cast<T*>(final_k), lane_of);     \
    const cudaError_t err = cudaGetLastError();                                                                     \
    if (err != cudaSuccess) return (int)err;                                                                        \
    if (n_ssa)                                                                                                      \
      ssa_finish_slots<T><<<grid_of(n_ssa), kThreads, 0, (cudaStream_t)stream>>>(s, lane_of, n_ssa,                \
                                                                                  static_cast<T*>(ssa_l), ssa_lane); \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_SSA_FINISH(dense32, int)
RB3C_SSA_FINISH(dense64, int64_t)
RB3C_SSA_FINISH(rb32, int)
RB3C_SSA_FINISH(rb64, int64_t)

}  // extern "C"
