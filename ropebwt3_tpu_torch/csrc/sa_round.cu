// The elementwise passes of one prefix-doubling round of the generalized
// suffix sort (K7; construct/sa.py).  A round at offset k sorts the suffixes
// by (rank[i], rank[i + k]) and renumbers them:
//   sa_keys     key[i] = rank[i] << shift | r2[i] (packed, n < 2^31 - 1:
//               int32 ranks, 32- or 64-bit keys over the round's live bits)
//               or key[i] = r2[i] (wide, int64: the caller sorts by r2, then
//               by rank), r2[i] = rank[i + k] + 1, or 0 past the end
//   (the sort of the keys gives the permutation sa)
//   sa_flags    neq[j] = 1 where sorted key j differs from key j - 1 (in
//               either of two arrays, wide), 0 at j = 0
//   (torch.cumsum of neq gives the new ranks nr, inclusive)
//   sa_scatter  rank[sa[j]] = nr[j]
// and after the last round (every rank distinct)
//   sa_bwt      bwt[j] = seq[sa[j] - 1], seq[n - 1] where sa[j] = 0.
//
// Replaces the XLA bodies of ropebwt3_tpu/construct/sa_jax.py:23-48
// (`_round`, `_initial`) around their library sort and scan: the JAX round
// is a stable 2-key lax.sort, a cumsum of key changes and an inverting sort
// (new_rank[sa] = nr as a second sort, since a TPU scatter serializes).  On
// the card a scatter of a permutation does not serialize, so the inverting
// sort is one pass here; the scan is torch.cumsum, as cumsum was XLA's.
//
// Bound on the card: bytes.  Each pass reads and writes 5-17 B a symbol,
// coalesced but for the scatter (one random 4-B write a symbol, packed) and
// the final gather (one random byte read a symbol).  Keys are unsigned
// words (the caller's int32 / int64 tensors hold their bits).  Grid-stride
// loops over int64 indexes, 256 threads a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // enough blocks to fill the card's 132 SMs

unsigned grid_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

// shift < 0: key = r2 alone
template <typename R, typename K>
__global__ void sa_keys_kernel(const R* __restrict__ rank, int64_t n, int64_t k, int shift, K* __restrict__ key) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n; i += (int64_t)gridDim.x * blockDim.x) {
    const K r2 = i < n - k ? (K)rank[i + k] + 1 : 0;
    key[i] = shift < 0 ? r2 : ((K)rank[i] << shift | r2);
  }
}

template <typename K, typename F>
__global__ void sa_flags_kernel(const K* __restrict__ a, const K* __restrict__ b, int64_t n, F* __restrict__ neq) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n; j += (int64_t)gridDim.x * blockDim.x) {
    neq[j] = j > 0 && (a[j] != a[j - 1] || (b != nullptr && b[j] != b[j - 1]));
  }
}

template <typename I, typename R>
__global__ void sa_scatter_kernel(const I* __restrict__ sa, const R* __restrict__ nr, int64_t n, R* __restrict__ rank) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n; j += (int64_t)gridDim.x * blockDim.x) {
    rank[sa[j]] = nr[j];
  }
}

template <typename I>
__global__ void sa_bwt_kernel(const uint8_t* __restrict__ seq, const I* __restrict__ sa, int64_t n,
                              uint8_t* __restrict__ bwt) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n; j += (int64_t)gridDim.x * blockDim.x) {
    const int64_t s = sa[j];
    bwt[j] = seq[s == 0 ? n - 1 : s - 1];
  }
}

}  // namespace

extern "C" {

// Each takes n >= 1 symbols and PyTorch's current stream, and returns
// cudaGetLastError() after its launch.  The wide path's entry points take
// int64 arrays; the packed path's (`*_packed`) int32 ranks, neq and sa, and
// keys of 4 B (key64 = 0) or 8 B.
int rb3c_sa_keys(const int64_t* rank, int64_t n, int64_t k, int64_t* key, void* stream) {
  sa_keys_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(rank, n, k, -1, key);
  return (int)cudaGetLastError();
}

int rb3c_sa_keys_packed(const int32_t* rank, int64_t n, int64_t k, int shift, int key64, void* key, void* stream) {
  if (key64)
    sa_keys_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(rank, n, k, shift, (uint64_t*)key);
  else
    sa_keys_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(rank, n, k, shift, (uint32_t*)key);
  return (int)cudaGetLastError();
}

int rb3c_sa_flags(const int64_t* a, const int64_t* b, int64_t n, int64_t* neq, void* stream) {
  sa_flags_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, b, n, neq);
  return (int)cudaGetLastError();
}

int rb3c_sa_flags_packed(const void* key, int64_t n, int key64, int32_t* neq, void* stream) {
  if (key64)
    sa_flags_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>((const uint64_t*)key, (const uint64_t*)nullptr,
                                                                         n, neq);
  else
    sa_flags_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>((const uint32_t*)key, (const uint32_t*)nullptr,
                                                                         n, neq);
  return (int)cudaGetLastError();
}

int rb3c_sa_scatter(const int64_t* sa, const int64_t* nr, int64_t n, int64_t* rank, void* stream) {
  sa_scatter_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(sa, nr, n, rank);
  return (int)cudaGetLastError();
}

int rb3c_sa_scatter_packed(const int32_t* sa, const int32_t* nr, int64_t n, int32_t* rank, void* stream) {
  sa_scatter_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(sa, nr, n, rank);
  return (int)cudaGetLastError();
}

int rb3c_sa_bwt(const uint8_t* seq, const int64_t* sa, int64_t n, uint8_t* bwt, void* stream) {
  sa_bwt_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(seq, sa, n, bwt);
  return (int)cudaGetLastError();
}

int rb3c_sa_bwt_packed(const uint8_t* seq, const int32_t* sa, int64_t n, uint8_t* bwt, void* stream) {
  sa_bwt_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(seq, sa, n, bwt);
  return (int)cudaGetLastError();
}

}  // extern "C"
