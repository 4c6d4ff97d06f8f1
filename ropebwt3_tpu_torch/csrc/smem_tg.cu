// SMEM-TG: the Travis-Gagie long-MEM algorithm (fm-index.c:483-528,
// ropebwt3_tpu/ops/smem_ref.py smem_tg) as chains of one thread each.
//
// Replaces the TPU kernel ropebwt3_tpu/ops/smem_pallas.py `_make_kernel` ->
// `kernel` (launched by `smem_tg_pallas` inside a lax.while_loop) together
// with its XLA twin ops/smem_fsm.py `smem_fsm`, with the rank/extend of
// ops/rank.py inlined from occ.cuh, or the run-block decode of
// ops/runblock.py from rb.cuh.  A GPU thread can branch, so the lock-step
// lane machinery of the TPU versions (phase selects, the one-iteration
// offset, the PH_B2INIT deferral, query-symbol prefetch slots) is gone: each
// loop trip resolves the cheap transitions and then does exactly ONE
// extension, from one call site, so the threads of a warp stay converged on
// the loads.
//
// Bound on the card: a chain of dependent occ-row loads (one trip = one
// extension = two independent ranks), some three trips a base.  A read run
// by one thread costs its length in dependent steps: a 20 kb read ~60,000
// steps of ~0.5 us, ~30 ms, while 100,000 short reads in parallel take ~1 ms.
// So there are two kernels over one chain routine:
//   smem_tg   one thread per read, from x = 0 to the read's end (the path
//             of a read that cannot be split, below);
//   smem_tgc  one chain per LANE: a lane runs read r's state machine from a
//             START at x0 until the first START x >= x_stop, or the read's
//             end, and logs every START x it passes.  ops/smem.py cuts a long
//             read into chunks of C symbols, one lane each, that overrun the
//             next chunk's start by a margin W, and stitches their emits:
//             the state at START is a function of x alone and x strictly
//             increases, so two chains that meet at one START x coincide
//             from there on.  Lanes of short reads are whole reads.
// smem_tgc's time is its longest lane's: on bench.py's batch 5,307 trips of
// ~0.79 us (~0.70 us with the long reads' lanes alone) against the 48 MB
// rows' ~0.53 us dependent row step; the rest of a trip is its arithmetic
// (two rank6's popcounts, the extend's sums, the phase logic), which no
// load moves: holding acc and a 16-B word of the read in registers and one
// row load where both ranks share a row each measured slower (PERF.md).
// Its schedule: a grid of at most the blocks the card holds at once, whose
// threads take the lanes in the wrapper's order (heaviest first, by span)
// from a global counter (`run_queue`), so when the lanes outnumber the
// resident threads (rb rows: 2 blocks an SM) the long reads' lanes start at
// once and never wait behind a wave of short reads; a thread takes its next
// lane when its warp's lanes have all ended, and warps of neighbours in that
// order hold lanes of one span.
//
// The kernels are instantiated once per occ layout (rb.cuh RB3C_LAYOUTS):
// dense or rb rows, int32 or int64 positions.  Output per chain: at most
// max_mems rows (start, end, size, lo, lo_rc) in the index's width (int64
// mode: lo exceeds 2^31) in emit order, plus the TRUE emit count, which may
// exceed max_mems; on overflow the last slot holds the latest emit, as
// ops/smem_fsm.py `emit` does, and the caller reruns the read with a buffer
// of the true count.  A lane also writes its START log (at most log_len
// entries, the true count beside it; END = n + 1 once the chain finishes)
// and, where asked, its trip count.  Every output of lane l is written at
// index l, whichever thread ran it.
//
// The text up to `#ifdef __CUDACC__` compiles with g++ given a header that
// defines the CUDA keywords (tests/test_torch_runblock.py HOST_SHIM) and
// atomicAdd: `run_queue` then runs every lane of a launch on one host thread.

#include <stdint.h>

#include "rb.cuh"

namespace {

enum Phase { kStart, kBack1, kFwd, kBack2 };

template <class L>
__device__ __forceinline__ void put_mem(typename L::T* out, int cnt, int max_mems, int st, int en,
                                        const rb3c::Bi<typename L::T>& ik) {
  typename L::T* o = out + 5 * (cnt < max_mems ? cnt : max_mems - 1);
  o[0] = st, o[1] = en, o[2] = ik.s, o[3] = ik.x0, o[4] = ik.x1;
}

// One chain over q[0:n) from START x until the first START x >= x_stop or
// the read's end.  kLog: write every START x passed (and END = n + 1 at the
// end) to log[0:log_len), counting them all in *n_log.  Returns the emit
// count; *trips gets the number of extensions.
template <class L, bool kLog>
__device__ __forceinline__ int run_chain(const L& ix, const uint8_t* __restrict__ q, int n, int x, int x_stop,
                                         int min_occ, int min_len, int max_mems, typename L::T* __restrict__ out,
                                         int* __restrict__ log, int log_len, int* n_log, int* trips) {
  using T = typename L::T;
  int cnt = 0, nl = 0, tr = 0;
  int i = 0, j = 0;
  int ph = kStart;
  rb3c::Bi<T> ik{0, 0, 0};
  auto note = [&](int v) {
    if (kLog && nl < log_len) log[nl] = v;
    ++nl;
  };
  for (;;) {
    if (ph == kBack2 && i <= x) {  // backward re-extension reached x
      x = i + 1;
      ph = kStart;
    }
    if (ph == kStart) {  // new window [x, x + min_len)
      if (n - x < min_len) {
        note(n + 1);
        break;
      }
      note(x);
      if (x >= x_stop) break;
      ik = rb3c::set_intv(ix, q[x + min_len - 1]);
      i = x + min_len - 2;
      ph = kBack1;
      if (i < x) {  // min_len == 1: nothing to extend backward
        j = x + min_len;
        ph = kFwd;
      }
    }
    if (ph == kFwd && j >= n) {  // forward extension reached the read end
      put_mem<L>(out, cnt++, max_mems, x, n, ik);
      note(n + 1);
      break;
    }
    const bool back = ph != kFwd;
    const int c = q[back ? i : j];
    const rb3c::Bi<T> ok = rb3c::extend_c(ix, ik, back ? c : rb3c::comp6(c), back);
    ++tr;
    const bool succ = ok.s >= min_occ;
    if (ph == kBack1) {
      if (succ) {
        ik = ok;
        if (--i < x) {
          j = x + min_len;
          ph = kFwd;
        }
      } else {
        x = i + 1;
        ph = kStart;
      }
    } else if (ph == kFwd) {
      if (succ) {
        ik = ok;
        ++j;
      } else {  // emit the MEM [x, j), then re-extend backward from j
        put_mem<L>(out, cnt++, max_mems, x, j, ik);
        ik = rb3c::set_intv(ix, q[j]);
        i = j - 1;
        ph = kBack2;
      }
    } else {  // kBack2
      if (succ) {
        ik = ok;
        --i;
      } else {
        x = i + 1;
        ph = kStart;
      }
    }
  }
  if (kLog) *n_log = nl;
  if (trips) *trips = tr;
  return cnt;
}

// The lanes (n_lanes, 3) int64 (read, x0, x_stop) that one thread takes
// from the queue `order` (a permutation of the lanes): first the one at
// position pos, then, while stride < n_lanes, the one at stride + the next
// value of *next, until the queue is empty.
template <class L>
__device__ __forceinline__ void run_queue(const L& ix, const uint8_t* __restrict__ flat,
                                          const int64_t* __restrict__ seq_off, const int64_t* __restrict__ lanes,
                                          const int64_t* __restrict__ order, int64_t n_lanes, int min_occ,
                                          int min_len, int max_mems, int log_len, typename L::T* __restrict__ mems,
                                          int* __restrict__ n_mem, int* __restrict__ log, int* __restrict__ n_log,
                                          int* __restrict__ trips, int64_t pos, int64_t stride,
                                          unsigned long long* next) {
  while (pos < n_lanes) {
    const int64_t l = order[pos];
    const int64_t r = lanes[l * 3];
    const int n = (int)(seq_off[r + 1] - seq_off[r]);
    n_mem[l] = run_chain<L, true>(ix, flat + seq_off[r], n, (int)lanes[l * 3 + 1], (int)lanes[l * 3 + 2], min_occ,
                                  min_len, max_mems, mems + l * (int64_t)max_mems * 5, log + l * (int64_t)log_len,
                                  log_len, n_log + l, trips ? trips + l : nullptr);
    pos = stride < n_lanes ? stride + (int64_t)atomicAdd(next, 1ull) : n_lanes;
  }
}

}  // namespace

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <class L>
__global__ void smem_tg_kernel(const L ix, const uint8_t* __restrict__ flat, const int64_t* __restrict__ seq_off,
                               int64_t n_reads, int min_occ, int min_len, int max_mems,
                               typename L::T* __restrict__ mems, int* __restrict__ n_mem, int* __restrict__ trips) {
  const int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (r >= n_reads) return;
  const int n = (int)(seq_off[r + 1] - seq_off[r]);
  n_mem[r] = run_chain<L, false>(ix, flat + seq_off[r], n, 0, n + 1, min_occ, min_len, max_mems,
                                 mems + r * (int64_t)max_mems * 5, nullptr, 0, nullptr, trips ? trips + r : nullptr);
}

template <class L>
__global__ void smem_tgc_kernel(const L ix, const uint8_t* __restrict__ flat, const int64_t* __restrict__ seq_off,
                                const int64_t* __restrict__ lanes, const int64_t* __restrict__ order, int64_t n_lanes,
                                int min_occ, int min_len, int max_mems, int log_len, typename L::T* __restrict__ mems,
                                int* __restrict__ n_mem, int* __restrict__ log, int* __restrict__ n_log,
                                int* __restrict__ trips, unsigned long long* next) {
  run_queue(ix, flat, seq_off, lanes, order, n_lanes, min_occ, min_len, max_mems, log_len, mems, n_mem, log, n_log,
            trips, blockIdx.x * (int64_t)blockDim.x + threadIdx.x, (int64_t)gridDim.x * blockDim.x, next);
}

unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// resident blocks an SM, local (stack and spill) bytes and registers a thread of a kernel
template <typename K>
int occupancy(K k, int* blocks, int* local, int* regs) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  *local = (int)a.localSizeBytes, *regs = a.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, 0);
}

// smem_tgc's grid: at most the blocks resident on the card at once, and one
// block per kThreads lanes
template <class L>
cudaError_t queue_grid(int64_t n_lanes, unsigned* grid) {
  static int resident = 0;  // blocks an SM x SMs, once a process
  if (resident == 0) {
    int dev, sms, per_sm, local, regs;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = (cudaError_t)occupancy(smem_tgc_kernel<L>, &per_sm, &local, &regs);
    if (e != cudaSuccess) return e;
    resident = per_sm * sms;
  }
  const unsigned need = blocks(n_lanes);
  *grid = need < (unsigned)resident ? need : (unsigned)resident;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// smem_tg: mems (n_reads, max_mems, 5) T and n_mem (n_reads,) int32 for the
// reads flat[seq_off[r]:seq_off[r+1]] (nt6 codes 0..5); trips (n_reads,)
// int32 or NULL.  smem_tgc: the same per lane, plus log (n_lanes, log_len)
// and n_log (n_lanes,) int32; the lanes are taken in `order`, and `next` is
// one uint64 of scratch (the queue's counter, zeroed here).  _occupancy_
// gives smem_tgc's (chunked) or smem_tg's resident blocks an SM, local
// bytes and registers a thread.  One entry point per layout.
#define RB3C_SMEM_TG(name, L)                                                                                       \
  int rb3c_smem_tg_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift,   \
                          int block_shift, const uint8_t* flat, const int64_t* seq_off, int64_t n_reads,          \
                          int min_occ, int min_len, int max_mems, void* mems, int* n_mem, int* trips,             \
                          void* stream) {                                                                         \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                      \
    smem_tg_kernel<L><<<blocks(n_reads), kThreads, 0, (cudaStream_t)stream>>>(                                    \
        ix, flat, seq_off, n_reads, min_occ, min_len, max_mems, static_cast<L::T*>(mems), n_mem, trips);          \
    return (int)cudaGetLastError();                                                                                \
  }                                                                                                                \
  int rb3c_smem_tgc_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift,  \
                           int block_shift, const uint8_t* flat, const int64_t* seq_off, const int64_t* lanes,   \
                           const int64_t* order, int64_t n_lanes, int min_occ, int min_len, int max_mems,        \
                           int log_len, void* mems, int* n_mem, int* log, int* n_log, int* trips,                \
                           unsigned long long* next, void* stream) {                                             \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                      \
    unsigned grid;                                                                                                 \
    cudaError_t e = queue_grid<L>(n_lanes, &grid);                                                                 \
    if (e == cudaSuccess) e = cudaMemsetAsync(next, 0, sizeof(*next), (cudaStream_t)stream);                      \
    if (e != cudaSuccess) return (int)e;                                                                           \
    smem_tgc_kernel<L><<<grid, kThreads, 0, (cudaStream_t)stream>>>(ix, flat, seq_off, lanes, order, n_lanes,      \
                                                                   min_occ, min_len, max_mems, log_len,           \
                                                                   static_cast<L::T*>(mems), n_mem, log, n_log,   \
                                                                   trips, next);                                   \
    return (int)cudaGetLastError();                                                                                \
  }                                                                                                                \
  int rb3c_occupancy_smem_tg_##name(int chunked, int* blocks, int* local, int* regs) {                            \
    return chunked ? occupancy(smem_tgc_kernel<L>, blocks, local, regs)                                            \
                   : occupancy(smem_tg_kernel<L>, blocks, local, regs);                                            \
  }
RB3C_LAYOUTS(RB3C_SMEM_TG)

}  // extern "C"

#endif  // __CUDACC__
