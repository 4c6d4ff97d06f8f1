// Sampled suffix array generation (rb3_ssa_gen, ssa.c:54-81): one thread per
// sequence lane, each LF-walking its sequence from its sentinel row back to
// the sentinel that ends the walk.
//
// Replaces the XLA loop body of ropebwt3_tpu/ssa_ops.py ssa_gen_device
// (`mk_body` -> `body`, :127-147), which advances all m lanes in lock-step and
// scatters every lane's step into the SSA slots each trip.  A GPU thread can
// branch, so each lane walks to its own end: its step count is the lock-step
// `l` (every lane starts at step 0), and it writes only its hits.  Every slot
// has exactly one writer (ssa_ops.py:102-106), so there are no atomics and
// no dummy slot.  The host assembles the SSA from (ssa_l, ssa_lane, death_l,
// final_k) as ssa_ops.py:200-207 does.
//
// Bound on the card: a chain of dependent 48-B row loads, one per LF step
// (occ.cuh lf_step: the symbol comes from the same row's planes).  Each lane
// is one chain; with few sequences (bench.py's index: m = 32 chains of ~2 M
// steps) the card is latency-bound and nearly idle, with many short
// sequences it has enough chains in flight to be bound by the rate of row
// loads.  Nothing here hides latency within one chain; that is later work.
//
// Instantiated for the dense layouts only (rb rows: later work).  Positions
// and step counts are in the layout's T; lane ids are int32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "occ.cuh"

namespace {

constexpr int kThreads = 128;

template <class L>
__global__ void ssa_gen_kernel(const L ix, int64_t m, int ss, typename L::T* __restrict__ ssa_l,
                               int* __restrict__ ssa_lane, typename L::T* __restrict__ death_l,
                               typename L::T* __restrict__ final_k) {
  using T = typename L::T;
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= m) return;
  const int64_t mask = (int64_t(1) << ss) - 1;
  T k = (T)lane, nk = 0, l = 0;
  for (;;) {
    ++l;
    if (ix.lf_step(k, nk) == 0) break;  // the sentinel: nk < m is its rank
    const int64_t r = (int64_t)nk - m;  // >= 0: nk >= acc[1] = m for c != 0
    if ((r & mask) == 0) {
      ssa_l[r >> ss] = l;
      ssa_lane[r >> ss] = (int)lane;
    }
    k = nk;
  }
  death_l[lane] = l;
  final_k[lane] = nk;
}

}  // namespace

extern "C" {

// For lanes 0..m-1 of the index (m = acc[1] sequences): ssa_l (n_ssa,) T and
// ssa_lane (n_ssa,) int32 at each sampled slot (ssa_lane -1 where no lane
// hit, as the caller initialises it), death_l (m,) T the step at which the
// lane met its sentinel and final_k (m,) T that sentinel's rank.
#define RB3C_SSA_GEN(name, L)                                                                                        \
  int rb3c_ssa_gen_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift,    \
                          int block_shift, int64_t m, int ss, void* ssa_l, int* ssa_lane, void* death_l,          \
                          void* final_k, void* stream) {                                                           \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    const unsigned grid = (unsigned)((m + kThreads - 1) / kThreads);                                                \
    ssa_gen_kernel<L><<<grid, kThreads, 0, (cudaStream_t)stream>>>(ix, m, ss, static_cast<L::T*>(ssa_l), ssa_lane, \
                                                                   static_cast<L::T*>(death_l),                    \
                                                                   static_cast<L::T*>(final_k));                   \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_SSA_GEN(dense32, rb3c::Dense<int>)
RB3C_SSA_GEN(dense64, rb3c::Dense<int64_t>)

}  // extern "C"
