// The elementwise passes of one prefix-doubling round of the generalized
// suffix sort (K7; construct/sa.py).  A round at offset k sorts the suffixes
// by (rank[i], rank[i + k]) and renumbers them:
//   sa_keys     key[i] = rank[i] << 32 | r2[i] (packed, n < 2^31 - 1) or
//               key[i] = r2[i] (wide: the caller sorts by r2, then by rank),
//               r2[i] = rank[i + k] + 1, or 0 past the end
//   (torch.sort of the keys gives the permutation sa)
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
// sort is one pass here; the sort and the scan are torch.sort (CUB's radix
// sort) and torch.cumsum, as lax.sort and cumsum were XLA's.
//
// Bound on the card: bytes.  Each pass reads and writes 8-17 B a symbol,
// coalesced but for the scatter (one 8-B random write a symbol) and the
// final gather (one random byte read a symbol); the radix sort of 16 B a
// symbol (key and index) in 8 passes over the data dominates a round.
// Grid-stride loops over int64 indexes, 256 threads a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // enough blocks to fill the card's 132 SMs

unsigned grid_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void sa_keys_kernel(const int64_t* __restrict__ rank, int64_t n, int64_t k, int packed,
                               int64_t* __restrict__ key) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r2 = i < n - k ? rank[i + k] + 1 : 0;
    key[i] = packed ? (rank[i] << 32 | r2) : r2;
  }
}

__global__ void sa_flags_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b, int64_t n,
                                int64_t* __restrict__ neq) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n; j += (int64_t)gridDim.x * blockDim.x) {
    neq[j] = j > 0 && (a[j] != a[j - 1] || (b != nullptr && b[j] != b[j - 1]));
  }
}

__global__ void sa_scatter_kernel(const int64_t* __restrict__ sa, const int64_t* __restrict__ nr, int64_t n,
                                  int64_t* __restrict__ rank) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n; j += (int64_t)gridDim.x * blockDim.x) {
    rank[sa[j]] = nr[j];
  }
}

__global__ void sa_bwt_kernel(const uint8_t* __restrict__ seq, const int64_t* __restrict__ sa, int64_t n,
                              uint8_t* __restrict__ bwt) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n; j += (int64_t)gridDim.x * blockDim.x) {
    const int64_t s = sa[j];
    bwt[j] = seq[s == 0 ? n - 1 : s - 1];
  }
}

}  // namespace

extern "C" {

// Each takes n >= 1 symbols and PyTorch's current stream, and returns
// cudaGetLastError() after its launch.
int rb3c_sa_keys(const int64_t* rank, int64_t n, int64_t k, int packed, int64_t* key, void* stream) {
  sa_keys_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(rank, n, k, packed, key);
  return (int)cudaGetLastError();
}

// b may be NULL (packed keys: one array)
int rb3c_sa_flags(const int64_t* a, const int64_t* b, int64_t n, int64_t* neq, void* stream) {
  sa_flags_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, b, n, neq);
  return (int)cudaGetLastError();
}

int rb3c_sa_scatter(const int64_t* sa, const int64_t* nr, int64_t n, int64_t* rank, void* stream) {
  sa_scatter_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(sa, nr, n, rank);
  return (int)cudaGetLastError();
}

int rb3c_sa_bwt(const uint8_t* seq, const int64_t* sa, int64_t n, uint8_t* bwt, void* stream) {
  sa_bwt_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(seq, sa, n, bwt);
  return (int)cudaGetLastError();
}

}  // extern "C"
