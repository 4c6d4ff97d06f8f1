// Merge rank (K6): where each symbol of a partial BWT B2 lands in the
// merged BWT of B1 and B2 (rb3_mg_rank, fm-index.c:143-175).  One thread per
// B2 sequence (lane j < m2), walking that sequence backwards from its
// sentinel row j:
//   ka = acc1[1], kb = j;
//   each step: r = rec[kb], c = r & 7; rec[kb] = ka (ins, in place);
//              stop if c == 0; else kb = r >> 3, ka = acc1[c] + occ1_c(ka)
// where rec[i] = (lf2[i] << 3) | B2[i] (construct/merge.py lf2_packed).
// ins[i] is the count of B1 symbols before B2[i] in the merged BWT.
//
// Replaces the XLA window step of ropebwt3_tpu/construct/merge.py:107-127
// (`window.step` of merge_rank_device), which advances all m2 lanes in
// lock-step and records (kb, ka) into (W, m2) window buffers because a
// per-step TPU scatter serializes (merge.py:137-140), and its native twin
// rb3t_merge_rank_packed (native/bwasw_core.cpp:2004-2019), whose in-place
// record this kernel keeps.  Each B2 position is visited by exactly one lane,
// exactly once, so a lane writes ins where it reads rec: no atomics, no
// window buffers, and each lane walks to its own end.
//
// Bound on the card: a chain of dependent steps per lane.  A step's two
// loads, B1's 48-B row at ka and rec[kb], depend only on the previous step,
// so the row load is issued before rec's value is needed: a step costs about
// one dependent row load (int64 mode adds the megablock base, a load that
// waits on c but hits the cache, the bases being few).  Few long sequences
// (bench.py's genomes: 8 lanes of ~2 M steps a merge) leave the card idle
// and latency-bound; many short ones (reads) fill it.  Instantiated for the
// dense rows, int32 and int64 (occ.cuh Dense<T>).

#include <cuda_runtime.h>
#include <stdint.h>

#include "occ.cuh"

namespace {

constexpr int kThreads = 128;

template <class L>
__global__ void merge_rank_kernel(const L ix, int64_t* __restrict__ rec, int64_t m2) {
  using T = typename L::T;
  const int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (lane >= m2) return;
  T ka = ix.acc(1);
  int64_t kb = lane;
  for (;;) {
    int4 a, b, c4;
    ix.load_row(ka >> 6, a, b, c4);  // ka <= n1: the extra row covers k = n1
    const int64_t r = rec[kb];
    const int c = (int)(r & 7);
    rec[kb] = (int64_t)ka;
    if (c == 0) break;
    kb = r >> 3;
    ka = ix.acc(c) + ix.rank1(ka, c, a, b, c4);
  }
}

}  // namespace

extern "C" {

// rec (n2,) int64 in, ins out, in place; lanes 0..m2-1 (m2 = B2's sentinels).
#define RB3C_MERGE_RANK(name, L)                                                                                    \
  int rb3c_merge_rank_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift, \
                             int block_shift, int64_t* rec, int64_t m2, void* stream) {                             \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                        \
    const unsigned grid = (unsigned)((m2 + kThreads - 1) / kThreads);                                                \
    merge_rank_kernel<L><<<grid, kThreads, 0, (cudaStream_t)stream>>>(ix, rec, m2);                                   \
    return (int)cudaGetLastError();                                                                                  \
  }
RB3C_MERGE_RANK(dense32, rb3c::Dense<int>)
RB3C_MERGE_RANK(dense64, rb3c::Dense<int64_t>)

}  // extern "C"
