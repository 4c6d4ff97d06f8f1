// Batched rank, single-symbol extension and LF step over the occ tables:
// three thin kernels around the layouts of occ.cuh and rb.cuh, one thread
// per element, instantiated for every layout.  They exist so the device
// routines the SMEM kernel and the walks (K5, K11) inline can be held
// against the plain PyTorch rank1a / extend_c / lf (ropebwt3_tpu_torch/
// ops/rank.py, ops/runblock.py) in isolation.
//
// Replaces the XLA rank1a / extend_c of ropebwt3_tpu/ops/rank.py:233-381 and
// RunBlockIndex.rank1a / extend_c of ops/runblock.py:81-145; occ_lf has no
// TPU kernel to replace (the JAX package's LF step is host numpy,
// ropebwt3_tpu/index/dense.py:237 DenseFMIndex.lf).
// Bound on the card: one (rank, LF step) or two (extend) random row loads
// per element, all independent, so the card keeps many in flight; nothing
// else to hide.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rb.cuh"

namespace {

constexpr int kThreads = 256;

template <class L>
__global__ void occ_rank1a_kernel(const L ix, const int64_t* __restrict__ k, int64_t n, typename L::T* __restrict__ out) {
  using T = typename L::T;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n) return;
  T occ[6];
  ix.rank6((T)k[t], occ);
#pragma unroll
  for (int s = 0; s < 6; ++s) out[t * 6 + s] = occ[s];
}

template <class L>
__global__ void occ_extend_c_kernel(const L ix, const typename L::T* __restrict__ ik, const int* __restrict__ c,
                                    const uint8_t* __restrict__ is_back, int64_t n, typename L::T* __restrict__ out) {
  using T = typename L::T;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n) return;
  const rb3c::Bi<T> r = rb3c::extend_c(ix, rb3c::Bi<T>{ik[t * 3], ik[t * 3 + 1], ik[t * 3 + 2]}, c[t], is_back[t] != 0);
  out[t * 3] = r.x0;
  out[t * 3 + 1] = r.x1;
  out[t * 3 + 2] = r.s;
}

template <class L>
__global__ void occ_lf_kernel(const L ix, const int64_t* __restrict__ k, int64_t n, int* __restrict__ c,
                              typename L::T* __restrict__ nk) {
  using T = typename L::T;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n) return;
  T x;
  c[t] = ix.lf_step((T)k[t], x);
  nk[t] = x;
}

unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// out (n, 6) T = rank1a(k) for k (n,) int64 in [0, n_bwt]; out (n, 3) T =
// extend_c(ik (n, 3) T, c (n,) int32 in 0..5, is_back (n,) bool); c (n,)
// int32 = B[k] and nk (n,) T = LF(k) for k (n,) int64 in [0, n_bwt); three
// entry points per layout
#define RB3C_OCC_RANK(name, L)                                                                                       \
  int rb3c_occ_rank1a_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift, \
                             int block_shift, const int64_t* k, int64_t n, void* out, void* stream) {              \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    occ_rank1a_kernel<L><<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(ix, k, n, static_cast<L::T*>(out));     \
    return (int)cudaGetLastError();                                                                                 \
  }                                                                                                                 \
  int rb3c_occ_extend_c_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc,              \
                               int mega_shift, int block_shift, const void* ik, const int* c,                       \
                               const uint8_t* is_back, int64_t n, void* out, void* stream) {                        \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    occ_extend_c_kernel<L><<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(                                      \
        ix, static_cast<const L::T*>(ik), c, is_back, n, static_cast<L::T*>(out));                                  \
    return (int)cudaGetLastError();                                                                                 \
  }                                                                                                                 \
  int rb3c_occ_lf_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift,     \
                         int block_shift, const int64_t* k, int64_t n, int* c, void* nk, void* stream) {           \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                       \
    occ_lf_kernel<L><<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(ix, k, n, c, static_cast<L::T*>(nk));       \
    return (int)cudaGetLastError();                                                                                 \
  }
RB3C_LAYOUTS(RB3C_OCC_RANK)

const char* rb3c_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
