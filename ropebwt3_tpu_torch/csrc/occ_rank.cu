// Batched rank and single-symbol extension over the fused occ rows: two
// thin kernels around occ.cuh, one thread per element.  They exist so the
// device routine the SMEM kernel inlines can be held against the plain
// PyTorch rank1a / extend_c (ropebwt3_tpu_torch/ops/rank.py) in isolation.
//
// Replaces the XLA rank1a / extend_c of ropebwt3_tpu/ops/rank.py:233-381.
// Bound on the card: one (rank) or two (extend) random 48-B row loads per
// element, all independent, so the card keeps many in flight; nothing else
// to hide.

#include <cuda_runtime.h>
#include <stdint.h>

#include "occ.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void occ_rank1a_kernel(const int* __restrict__ occf, const int64_t* __restrict__ k, int64_t n,
                                  int* __restrict__ out) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n) return;
  int occ[6];
  rb3c::rank6(occf, (int)k[t], occ);
#pragma unroll
  for (int s = 0; s < 6; ++s) out[t * 6 + s] = occ[s];
}

__global__ void occ_extend_c_kernel(const int* __restrict__ occf, const int* __restrict__ acc,
                                    const int* __restrict__ ik, const int* __restrict__ c,
                                    const uint8_t* __restrict__ is_back, int64_t n, int* __restrict__ out) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= n) return;
  const rb3c::Bi r = rb3c::extend_c(occf, acc, rb3c::Bi{ik[t * 3], ik[t * 3 + 1], ik[t * 3 + 2]}, c[t], is_back[t] != 0);
  out[t * 3] = r.x0;
  out[t * 3 + 1] = r.x1;
  out[t * 3 + 2] = r.s;
}

unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// out (n, 6) int32 = rank1a(k) for k (n,) int64 in [0, n_bwt]
int rb3c_occ_rank1a(const int* occf, const int64_t* k, int64_t n, int* out, void* stream) {
  occ_rank1a_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(occf, k, n, out);
  return (int)cudaGetLastError();
}

// out (n, 3) int32 = extend_c(ik (n, 3), c (n,) in 0..5, is_back (n,) bool)
int rb3c_occ_extend_c(const int* occf, const int* acc, const int* ik, const int* c, const uint8_t* is_back, int64_t n,
                      int* out, void* stream) {
  occ_extend_c_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(occf, acc, ik, c, is_back, n, out);
  return (int)cudaGetLastError();
}

const char* rb3c_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
