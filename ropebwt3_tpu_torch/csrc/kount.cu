// kount_rank: one level of `kount`'s trie, ranked on the card.  Every node
// of the level is a BWT interval [k, l) of the index; its children are the
// intervals acc[a] + occ_a(k) .. acc[a] + occ_a(l) for a = A, C, G, T, and
// a child lives when its size occ_a(l) - occ_a(k) reaches -m.  The kernel
// gives ok[a][t] = occ_a(k_t) and size[a][t] = occ_a(l_t) - occ_a(k_t) for
// the four bases (rows 0..3: nt6 1..4); `$` and N never branch.
//
// Replaces no TPU kernel: the JAX package ranks kount's frontier on the
// host (ropebwt3_tpu/cli.py main_kount over rank1a_fast); it replaces the
// port's earlier use of the rank6 test kernel occ_rank1a (occ_rank.cu) on
// `cat([k, l])`.  The plain PyTorch version is ops/kount.py
// kount_rank_plain.
//
// Bound on the card: bytes.  A level's rows are read once in the best case
// (48 B a row, 64 symbols), its k and l once, its counts written once.  The
// design follows the frontier's order: cli.main_kount keeps each level
// symbol-major (all A-children, then C, G, T, each group in parent order),
// and in that order an index's intervals are sorted and disjoint, so the
// nodes of a warp read neighbouring rows, and a node's k and l, about one
// row apart at the widest levels, share a row or its neighbour.  One thread
// ranks both ends of its node: it issues both rows' loads (three 16-B
// loads each) before the arithmetic of either, so a node costs one round
// of loads, and a row that holds both ends is fetched from L1 the second
// time.  It counts the four bases only (rank6's planes and count columns,
// occ.cuh), and writes ok and size symbol-major: each store instruction of
// a warp writes 32 consecutive words.  The answer does not depend on the
// order of the nodes; only the speed does.
//
// On rb rows (rb.cuh; where dense rows do not fit the card) a node ranks
// each end with Rb<T>::rank6, the two ends' loads independent: a header,
// then a block's records or one escape sub-row, each end.  Both ends in one
// block fetch the same sectors twice, the second time from L1; a rank2-
// style share of one decode for both ends is left to a later design.
//
// The text up to `#ifdef __CUDACC__` compiles with g++ given a header that
// defines the CUDA keywords (tests/test_torch_runblock.py HOST_SHIM):
// `kount_node` then runs one node on the host, on either layout.

#include <stdint.h>

#include "rb.cuh"

namespace rb3c {
namespace kount {

// occ of nt6 1..4 at k, from k's row (a, b, c) as Dense::load_row gives it:
// rank6 of occ.cuh for those four symbols
template <typename T>
__device__ __forceinline__ void rank_acgt(const Tables& t, T k, const int4& a, const int4& b, const int4& c, T occ[4]) {
  const int64_t bi = k >> 6;
  const unsigned off = (unsigned)(k & 63);
  const unsigned m_lo = low_mask(off), m_hi = low_mask(off > 32 ? off - 32 : 0);
  const unsigned p[6] = {(unsigned)a.x, (unsigned)a.y, (unsigned)a.z, (unsigned)a.w, (unsigned)b.x, (unsigned)b.y};
  const int cols[6] = {b.z, b.w, c.x, c.y, c.z, c.w};
  T base[6];
  row_base<T>(t, bi, cols, base);
#pragma unroll
  for (int s = 1; s <= 4; ++s) {
    const int key = comp6(s);
    unsigned lo = m_lo, hi = m_hi;
#pragma unroll
    for (int pl = 0; pl < 3; ++pl) {
      const bool bit = (key >> pl) & 1;
      lo &= bit ? p[2 * pl] : ~p[2 * pl];
      hi &= bit ? p[2 * pl + 1] : ~p[2 * pl + 1];
    }
    occ[s - 1] = base[s] + __popc(lo) + __popc(hi);
  }
}

// Node t of n: 0 <= k[t] <= l[t] <= n_bwt.  ok and size are (4, n).
template <typename T>
__device__ __forceinline__ void kount_node(const Dense<T>& ix, const T* __restrict__ k, const T* __restrict__ l,
                                           int64_t n, int64_t t, T* __restrict__ ok, T* __restrict__ size) {
  const T kt = __ldg(k + t), lt = __ldg(l + t);
  int4 ka, kb, kc, la, lb, lc;
  ix.load_row(kt >> 6, ka, kb, kc);
  ix.load_row(lt >> 6, la, lb, lc);
  T ck[4], cl[4];
  rank_acgt<T>(ix.t, kt, ka, kb, kc, ck);
  rank_acgt<T>(ix.t, lt, la, lb, lc, cl);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    ok[s * n + t] = ck[s];
    size[s * n + t] = cl[s] - ck[s];
  }
}

// the same on rb rows: rank6 at each end, the four bases kept
template <typename T>
__device__ __forceinline__ void kount_node(const Rb<T>& ix, const T* __restrict__ k, const T* __restrict__ l, int64_t n,
                                           int64_t t, T* __restrict__ ok, T* __restrict__ size) {
  const T kt = __ldg(k + t), lt = __ldg(l + t);
  T ck[6], cl[6];
  ix.rank6(kt, ck);
  ix.rank6(lt, cl);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    ok[s * n + t] = ck[s + 1];
    size[s * n + t] = cl[s + 1] - ck[s + 1];
  }
}

}  // namespace kount
}  // namespace rb3c

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <class L>
__global__ void kount_rank_kernel(const L ix, const typename L::T* __restrict__ k, const typename L::T* __restrict__ l,
                                  int64_t n, typename L::T* __restrict__ ok, typename L::T* __restrict__ size) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t < n) rb3c::kount::kount_node<typename L::T>(ix, k, l, n, t, ok, size);
}

}  // namespace

extern "C" {

// ok (4, n) T = occ_a(k), size (4, n) T = occ_a(l) - occ_a(k) for a = nt6
// 1..4, from k, l (n,) T with 0 <= k <= l <= n_bwt (the wrapper checks);
// one entry point per layout
#define RB3C_KOUNT_RANK(name, L)                                                                                    \
  int rb3c_kount_rank_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift, \
                             int block_shift, const void* k, const void* l, int64_t n, void* ok, void* size,       \
                             void* stream) {                                                                       \
    using T = L::T;                                                                                                \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                      \
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);                                             \
    kount_rank_kernel<L><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(                                           \
        ix, static_cast<const T*>(k), static_cast<const T*>(l), n, static_cast<T*>(ok), static_cast<T*>(size));    \
    return (int)cudaGetLastError();                                                                                \
  }
RB3C_LAYOUTS(RB3C_KOUNT_RANK)

}  // extern "C"

#endif  // __CUDACC__
