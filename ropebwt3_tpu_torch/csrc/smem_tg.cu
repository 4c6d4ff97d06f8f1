// SMEM-TG: the Travis-Gagie long-MEM algorithm (fm-index.c:483-528,
// ropebwt3_tpu/ops/smem_ref.py smem_tg), one thread per read, each thread
// running its read's state machine to the end.
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
// Bound on the card: a dependent chain of random occ-row loads, two
// independent ranks per extension step and some 300-600 steps per 150 bp
// read.  Dense rows (48 B per 64 symbols, 0.75 B/sym) stay L2-resident up to
// ~50 MB of table; rb rows (160 B per S symbols) cost more loads and a short
// record scan per rank but hold a pangenome in a fraction of the bytes.
// The design's answer is occupancy: one read per thread and 256-thread blocks
// keep tens of thousands of chains in flight.  Warp-cooperative or
// latency-hiding versions are later work.
//
// The kernel is instantiated once per occ layout (rb.cuh RB3C_LAYOUTS):
// dense or rb rows, int32 or int64 positions.  Output: per read at most
// max_mems rows (start, end, size, lo, lo_rc) in the index's width (int64
// mode: lo exceeds 2^31) in emit order, plus the TRUE emit count, which may exceed max_mems; on
// overflow the last slot holds the latest emit, as ops/smem_fsm.py `emit`
// does, and the caller reruns that read on the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rb.cuh"

namespace {

constexpr int kThreads = 256;
enum Phase { kStart, kBack1, kFwd, kBack2 };

template <class L>
__global__ void smem_tg_kernel(const L ix, const uint8_t* __restrict__ flat, const int64_t* __restrict__ seq_off,
                               int64_t n_reads, int min_occ, int min_len, int max_mems,
                               typename L::T* __restrict__ mems, int* __restrict__ n_mem) {
  using T = typename L::T;
  const int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (r >= n_reads) return;
  const uint8_t* q = flat + seq_off[r];
  const int n = (int)(seq_off[r + 1] - seq_off[r]);
  T* out = mems + r * (int64_t)max_mems * 5;
  int cnt = 0;
  int x = 0, i = 0, j = 0;
  int ph = kStart;
  rb3c::Bi<T> ik{0, 0, 0};
  for (;;) {
    if (ph == kBack2 && i <= x) {  // backward re-extension reached x
      x = i + 1;
      ph = kStart;
    }
    if (ph == kStart) {  // new window [x, x + min_len)
      if (n - x < min_len) break;
      ik = rb3c::set_intv(ix, q[x + min_len - 1]);
      i = x + min_len - 2;
      ph = kBack1;
      if (i < x) {  // min_len == 1: nothing to extend backward
        j = x + min_len;
        ph = kFwd;
      }
    }
    if (ph == kFwd && j >= n) {  // forward extension reached the read end
      T* o = out + 5 * (cnt < max_mems ? cnt : max_mems - 1);
      o[0] = x, o[1] = n, o[2] = ik.s, o[3] = ik.x0, o[4] = ik.x1;
      ++cnt;
      break;
    }
    const bool back = ph != kFwd;
    const int c = q[back ? i : j];
    const rb3c::Bi<T> ok = rb3c::extend_c(ix, ik, back ? c : rb3c::comp6(c), back);
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
        T* o = out + 5 * (cnt < max_mems ? cnt : max_mems - 1);
        o[0] = x, o[1] = j, o[2] = ik.s, o[3] = ik.x0, o[4] = ik.x1;
        ++cnt;
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
  n_mem[r] = cnt;
}

}  // namespace

extern "C" {

// mems (n_reads, max_mems, 5) T and n_mem (n_reads,) int32 for the reads
// flat[seq_off[r]:seq_off[r+1]] (nt6 codes 0..5), one entry point per layout
#define RB3C_SMEM_TG(name, L)                                                                                       \
  int rb3c_smem_tg_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift,   \
                          int block_shift, const uint8_t* flat, const int64_t* seq_off, int64_t n_reads,          \
                          int min_occ, int min_len, int max_mems, void* mems, int* n_mem, void* stream) {         \
    const L ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};                                      \
    const unsigned grid = (unsigned)((n_reads + kThreads - 1) / kThreads);                                         \
    smem_tg_kernel<L><<<grid, kThreads, 0, (cudaStream_t)stream>>>(ix, flat, seq_off, n_reads, min_occ, min_len,  \
                                                                    max_mems, static_cast<L::T*>(mems), n_mem);   \
    return (int)cudaGetLastError();                                                                                \
  }
RB3C_LAYOUTS(RB3C_SMEM_TG)

}  // extern "C"
