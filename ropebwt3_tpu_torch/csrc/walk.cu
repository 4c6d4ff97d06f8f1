// The two host walks of the JAX package, on the card: `get`'s LF walk
// (K11) and `suffix`'s lock-step backward search (K12).  Neither has a TPU
// kernel: the JAX package runs them as host code (ropebwt3_tpu/index/
// dense.py DenseFMIndex.retrieve, :244-278, the native rb3t_retrieve walk
// behind it; ropebwt3_tpu/cli.py main_suffix's flush, :799-829, over
// rank1a_fast).  The plain PyTorch versions are ops/walk.py's.
//
// K11 retrieve_walk (dense rows, Dense<T>::lf_step of occ.cuh): one thread
// per queried k.  A lane steps LF from its k, writing each symbol it reads,
// until it reads symbol 0 (the sentinel); k then stays at the row that holds
// it, as the reference leaves it (fm-index.c:552-567).  The walk is
// resumable: a launch takes at most `steps` steps a lane into out (steps,
// m) (step s of lane t at s * m + t, so the lanes of a warp write
// neighbouring bytes), writes the count it took, and keeps each lane's k
// and a done flag for the next launch; the host appends the chunks and
// reverses them.  Bound on the card: a walk is a chain of dependent 48-B
// row loads (one LF step each: the symbol and its count come from one
// row), so a 2 Mbp sequence takes ~2 M x the card's dependent-load latency
// (~0.5 us at a 48 MB table) whatever the lanes around it do; a few walks
// leave the card idle.  This kernel is the simple, right one; cutting a
// walk into segments that meet, as K5 (ssa_gen.cu) does, is rework.
//
// K12 suffix_walk (every layout): one thread per read, from its last
// symbol down.  A step ranks both ends of the interval, k and l, with all
// six counts (rank6: the two rows' loads are independent, so a step costs
// one dependent round of loads), then k = acc[c] + occ_c(k), l = acc[c] +
// occ_c(l); the lane stops at the first empty interval or the read's
// start.  It writes i + 1 (where the longest matching suffix starts) and
// the last non-empty interval's size.  Bound on the card: the longest
// read's chain of steps; the rows are read at random.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rb.cuh"

namespace {

constexpr int kThreads = 256;

unsigned grid_of(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// v[c] by selects: a dynamic index would put the array in local memory
template <typename T>
__device__ __forceinline__ T pick6(const T v[6], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : c == 3 ? v[3] : c == 4 ? v[4] : v[5];
}

template <class L>
__global__ void retrieve_walk(const L ix, int64_t* __restrict__ k, uint8_t* __restrict__ done, int64_t m, int steps,
                              uint8_t* __restrict__ out, int* __restrict__ n_out) {
  using T = typename L::T;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= m) return;
  int s = 0;
  if (!done[t]) {
    T kk = (T)k[t];
    for (; s < steps; ++s) {
      T nk;
      const int c = ix.lf_step(kk, nk);
      if (c == 0) {
        done[t] = 1;
        break;
      }
      out[(int64_t)s * m + t] = (uint8_t)c;
      kk = nk;
    }
    k[t] = kk;
  }
  n_out[t] = s;
}

template <class L>
__global__ void suffix_walk(const L ix, const uint8_t* __restrict__ q, const int64_t* __restrict__ off, int64_t R,
                            int64_t* __restrict__ start, int64_t* __restrict__ last) {
  using T = typename L::T;
  const int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t o = off[r];
  int64_t i = off[r + 1] - o - 1;
  T k = 0, l = ix.acc(6), size = 0;
  while (i >= 0) {
    const int c = q[o + i];
    T ok[6], ol[6];
    ix.rank6(k, ok);
    ix.rank6(l, ol);
    const T a = ix.acc(c);
    k = a + pick6(ok, c);
    l = a + pick6(ol, c);
    if (l - k <= 0) break;
    size = l - k;
    --i;
  }
  start[r] = i + 1;
  last[r] = (int64_t)size;
}

}  // namespace

extern "C" {

// K11: k (m,) int64 in [0, n) and done (m,) uint8 in and out; out (steps,
// m) uint8 and n_out (m,) int32 out (a done lane writes 0 steps).
#define RB3C_RETRIEVE_WALK(name, L)                                                                                  \
  int rb3c_retrieve_walk_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc,             \
                                int mega_shift, int block_shift, int64_t* k, uint8_t* done, int64_t m, int steps,  \
                                uint8_t* out, int* n_out, void* stream) {                                          \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    retrieve_walk<L><<<grid_of(m), kThreads, 0, (cudaStream_t)stream>>>(ix, k, done, m, steps, out, n_out);        \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_RETRIEVE_WALK(dense32, rb3c::Dense<int>)
RB3C_RETRIEVE_WALK(dense64, rb3c::Dense<int64_t>)

// K12: reads q (flat uint8 nt6 codes 0..5) at off (R + 1,) int64; start and
// last (R,) int64 out.
#define RB3C_SUFFIX_WALK(name, L)                                                                                    \
  int rb3c_suffix_walk_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift, \
                              int block_shift, const uint8_t* q, const int64_t* off, int64_t R, int64_t* start,     \
                              int64_t* last, void* stream) {                                                        \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    suffix_walk<L><<<grid_of(R), kThreads, 0, (cudaStream_t)stream>>>(ix, q, off, R, start, last);                 \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_LAYOUTS(RB3C_SUFFIX_WALK)

}  // extern "C"
