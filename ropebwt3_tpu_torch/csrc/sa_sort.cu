// K7's sort (construct/sa.py `sa_sort_cuda`): a stable LSD radix sort of
// 32- or 64-bit keys over their `bits` live low bits, one pass an 8-bit
// digit, carrying int32 values (the suffix array's indices; the first pass
// makes them itself, 0..n-1).  Keys are unsigned words.
//
// Replaces the lax.sort of ropebwt3_tpu/construct/sa_jax.py:23-48 (`_round`,
// an XLA body), which the port had handed to torch.sort (CUB): that sort
// cannot be told how many bits are live, so it ran 8 passes over 64-bit
// keys with int64 indices every round.  A prefix-doubling round's key is
// rank << b2 | r2 over b1 + b2 live bits (construct/sa.py `live_bits`), so
// this sort runs ceil(bits / 8) passes and moves 4-B keys where they fit.
//
// Bound on the card: bytes.  Each digit pass reads a key and a value and
// writes both (24 B a pair for 64-bit keys, 16 for 32-bit; the first pass
// reads no value); the histogram reads the keys once more.  The design is
// onesweep's (Adinets and Merrill 2022), one kernel a pass:
//   hist   every digit's 256-bin histogram from one read of the keys, in
//          shared memory, added into global counts; `scan` turns each into
//          the digit's exclusive starts.
//   pass   a block takes the next tile of 3,840 keys (its id from an atomic
//          counter, so a tile waits only on tiles already running: no
//          deadlock), loads them coalesced (warp-striped), ranks them
//          stably in the tile (per-warp digit counters updated by the
//          leader of each `__match_any_sync` group, in index order),
//          publishes its digit counts, and finds its global offsets by
//          decoupled look-back over the pass's status words (2 flag bits
//          and a 62-bit count: an inclusive prefix reaches n, above 2^30);
//          it then stages the keys, and after them the values, through
//          shared memory in digit order, so each digit's run is written
//          contiguously.
// The status words are zeroed with one cudaMemsetAsync a pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadix = 256;
constexpr int kThreads = 256;  // one thread a digit in the tile's bookkeeping
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 15;  // keys a thread
// resident pass blocks an SM: caps registers at 80 a thread (uncapped the
// pass takes 95, and two blocks fit an SM); chosen, with loading the values
// beside the keys, from trials on the H100
constexpr int kPassBlocks = 3;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxDigits = 8;
constexpr int kHistBlocks = 132 * 4;
constexpr unsigned long long kAggregate = 1ull << 62, kInclusive = 2ull << 62, kCount = kAggregate - 1;
static_assert(kThreads == kRadix, "a thread a digit");

template <typename K>
__device__ __forceinline__ uint32_t digit(K k, int shift) {
  return (uint32_t)(k >> shift) & (kRadix - 1);
}

// exclusive prefix sum of v over the block's 256 threads; tmp holds kWarps words
__device__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t t = lane < kWarps ? tmp[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kWarps) tmp[lane] = t;
  }
  __syncthreads();
  const uint32_t r = x - v + (warp ? tmp[warp - 1] : 0);
  __syncthreads();  // tmp free again
  return r;
}

template <typename K>
__global__ void __launch_bounds__(kThreads) hist_kernel(const K* __restrict__ key, int64_t n, int digits,
                                                         uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[kMaxDigits * kRadix];
  for (int i = threadIdx.x; i < digits * kRadix; i += kThreads) h[i] = 0;
  __syncthreads();
  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n; i += (int64_t)gridDim.x * kThreads) {
    const K k = key[i];
    for (int d = 0; d < digits; ++d) atomicAdd(&h[d * kRadix + digit(k, 8 * d)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < digits * kRadix; i += kThreads)
    if (h[i]) atomicAdd(&hist[i], h[i]);
}

// one block a digit: its 256 counts to exclusive starts, in place
__global__ void __launch_bounds__(kThreads) scan_kernel(uint32_t* __restrict__ hist) {
  __shared__ uint32_t tmp[kWarps];
  uint32_t* h = hist + blockIdx.x * kRadix;
  const uint32_t v = h[threadIdx.x];
  h[threadIdx.x] = block_exclusive_scan(v, tmp);
}

template <typename K, bool kFirst>
__global__ void __launch_bounds__(kThreads, kPassBlocks)
    pass_kernel(const K* __restrict__ kin, const uint32_t* __restrict__ vin, K* __restrict__ kout,
                uint32_t* __restrict__ vout, uint32_t n, int shift, const uint32_t* __restrict__ starts,
                unsigned long long* status, uint32_t* tile_counter) {
  __shared__ K s_stage[kTile];  // keys, then values, in the tile's digit order
  __shared__ uint32_t s_warp[kWarps][kRadix];
  __shared__ uint32_t s_start[kRadix];  // the tile's first position of each digit
  __shared__ int32_t s_delta[kRadix];   // global position less tile position, a digit
  __shared__ uint32_t s_tmp[kWarps];
  __shared__ uint32_t s_tile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < kWarps * kRadix; i += kThreads) (&s_warp[0][0])[i] = 0;
  if (t == 0) s_tile = atomicAdd(tile_counter, 1u);
  __syncthreads();
  const uint32_t tile = s_tile;
  const uint32_t base = tile * kTile;
  const uint32_t first = base + warp * 32 * kItems + lane;  // item i at first + 32 i
  const uint32_t in_tile = min((uint32_t)kTile, n - base);

  // rank each key among the warp's keys of its digit, in index order
  K k[kItems];
  uint32_t pos[kItems], val[kItems];
  const unsigned lt = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t idx = first + 32 * i;
    const bool ok = idx < n;
    k[i] = ok ? kin[idx] : K(0);
    val[i] = ok ? (kFirst ? idx : vin[idx]) : 0u;  // loaded with the keys, in flight early
    const uint32_t d = ok ? digit(k[i], shift) : kRadix;  // kRadix: no digit, no count
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(peers) - 1;
    uint32_t old = 0;
    if (lane == leader && ok) {
      old = s_warp[warp][d];
      s_warp[warp][d] = old + __popc(peers);
    }
    pos[i] = __shfl_sync(0xffffffffu, old, leader) + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();

  // thread t owns digit t: the warps' exclusive offsets, the tile's count
  uint32_t count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_warp[w][t];
    s_warp[w][t] = count;
    count += c;
  }
  volatile unsigned long long* st = status + (size_t)tile * kRadix + t;
  *st = (tile == 0 ? kInclusive : kAggregate) | count;
  s_start[t] = block_exclusive_scan(count, s_tmp);
  unsigned long long before = 0;  // digit t's keys in the tiles before this one
  if (tile > 0) {
    volatile unsigned long long* p = status + (size_t)(tile - 1) * kRadix + t;
    while (true) {
      const unsigned long long s = *p;
      if (s == 0) continue;  // that tile has not published yet
      before += s & kCount;
      if (s & kInclusive) break;
      p -= kRadix;
    }
    *st = kInclusive | (before + count);
  }
  s_delta[t] = (int32_t)(starts[t] + before) - (int32_t)s_start[t];
  __syncthreads();

  // keys to shared memory in digit order, then out: each digit's run contiguous
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + 32 * i < n) {
      const uint32_t d = digit(k[i], shift);
      pos[i] += s_start[d] + s_warp[warp][d];
      s_stage[pos[i]] = k[i];
    }
  }
  __syncthreads();
  uint32_t dst[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t p = j * kThreads + t;
    if (p < in_tile) {
      const K key = s_stage[p];
      dst[j] = (uint32_t)(s_delta[digit(key, shift)] + (int32_t)p);
      kout[dst[j]] = key;
    }
  }
  __syncthreads();
  uint32_t* s_val = reinterpret_cast<uint32_t*>(s_stage);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + 32 * i < n) s_val[pos[i]] = val[i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t p = j * kThreads + t;
    if (p < in_tile) vout[dst[j]] = s_val[p];
  }
}

template <typename K>
int sort(const K* key_in, K* k0, K* k1, uint32_t* v0, uint32_t* v1, int64_t n, int bits, uint32_t* hist,
         unsigned long long* status, cudaStream_t s) {
  const int digits = (bits + 7) / 8;
  const int64_t tiles = (n + kTile - 1) / kTile;
  cudaError_t err = cudaMemsetAsync(hist, 0, (kMaxDigits * kRadix + kMaxDigits) * sizeof(uint32_t), s);
  if (err != cudaSuccess) return (int)err;
  const int64_t hb = (n + kThreads - 1) / kThreads;
  hist_kernel<<<(unsigned)(hb < kHistBlocks ? hb : kHistBlocks), kThreads, 0, s>>>(key_in, n, digits, hist);
  scan_kernel<<<digits, kThreads, 0, s>>>(hist);
  K* kb[2] = {k0, k1};
  uint32_t* vb[2] = {v0, v1};
  uint32_t* counters = hist + kMaxDigits * kRadix;
  for (int d = 0; d < digits; ++d) {
    err = cudaMemsetAsync(status, 0, tiles * kRadix * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    K* kout = kb[(d + 1) & 1];
    uint32_t* vout = vb[(d + 1) & 1];
    if (d == 0)
      pass_kernel<K, true><<<(unsigned)tiles, kThreads, 0, s>>>(key_in, nullptr, kout, vout, (uint32_t)n, 0, hist,
                                                              status, counters);
    else
      pass_kernel<K, false><<<(unsigned)tiles, kThreads, 0, s>>>(kb[d & 1], vb[d & 1], kout, vout, (uint32_t)n,
                                                               8 * d, hist + d * kRadix, status, counters + d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The look-back status words a sort of n keys needs: 256 a tile of kTile keys.
int64_t rb3c_sa_sort_status_len(int64_t n) { return (n + kTile - 1) / kTile * kRadix; }

// Keys of the pass before the first in key_in (4 B words if key64 = 0, else
// 8 B), n in [1, 2^31 - 1), bits in [1, word bits]; digit pass p writes keys
// and values into buffer (p + 1) % 2 of (k0, k1) and (v0, v1), so the
// sorted keys and their permutation land in buffer ceil(bits / 8) % 2 (key_in
// may be k0).  hist holds 8 x 256 + 8 words, status status_len (at least
// rb3c_sa_sort_status_len(n)).  Returns cudaGetLastError() after the last
// launch, or cudaErrorInvalidValue for arguments out of range.
int rb3c_sa_sort(const void* key_in, void* k0, void* k1, int32_t* v0, int32_t* v1, int64_t n, int bits, int key64,
                 uint32_t* hist, unsigned long long* status, int64_t status_len, void* stream) {
  if (n < 1 || n >= INT32_MAX || bits < 1 || bits > (key64 ? 64 : 32) ||
      rb3c_sa_sort_status_len(n) > status_len)
    return (int)cudaErrorInvalidValue;
  if (key64)
    return sort((const uint64_t*)key_in, (uint64_t*)k0, (uint64_t*)k1, (uint32_t*)v0, (uint32_t*)v1, n, bits, hist,
                status, (cudaStream_t)stream);
  return sort((const uint32_t*)key_in, (uint32_t*)k0, (uint32_t*)k1, (uint32_t*)v0, (uint32_t*)v1, n, bits, hist,
              status, (cudaStream_t)stream);
}

}  // extern "C"
