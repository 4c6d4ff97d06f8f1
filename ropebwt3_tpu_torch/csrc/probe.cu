// Probes of the occ-row access pattern on the card: how much shared memory a
// block gets, and what a row gather costs from shared memory and from device
// memory, in dependent chains (each row folded into the next index, as an
// LF step or an extension is) and in independent streams.
//
// Replaces the TPU probes of scripts/fused_probe*.py, which sized VMEM and
// timed scalar-loop and per-row DMA gathers for a fused SMEM kernel:
//   probe_smem_capacity  P1 fused_probe.py vmem_probe (:43), P4
//                        fused_probe2.py vmem_probe (:42)
//   probe_smem_gather    P2 fused_probe.py pallas_vmem_gather (:100), P5
//                        fused_probe2.py pallas_vmem_gather (:75)
//   probe_hbm_gather     P3 fused_probe.py pallas_hbm_dma_gather (:146), P6
//                        fused_probe2.py pallas_hbm_dma_gather (:116), P7
//                        fused_probe3.py dma_gather (:44), and the XLA
//                        chains gather_chain / gather_chain_full
// On the TPU a table lived in VMEM (tens of MB) or was fetched row by row by
// DMA with semaphores.  On the card shared memory is at most ~227 KB a block,
// so the staged table is a few thousand rows, and a row from device memory
// is a plain load (dependent modes: one in flight per lane by construction)
// or a cp.async copy into shared memory, at most kSlots in flight per thread
// as P7 kept 8 DMA semaphores (the independent mode).
//
// Modes (the index a lane gathers next; int32 arithmetic wraps, % floors as
// JAX's does, so the multiply is done in uint32 and reinterpreted):
//   kDep        idx <- (idx * 1103515245 + row[6]) mod nb          (P2, P3)
//   kChain      idx <- (idx * 1103515245 + row[6] + 12345) mod nb  (gather_chain)
//   kChainFull  idx <- (idx * 1103515245 + sum(row) + 12345) mod nb (gather_chain_full)
//   kIndep      idx <- (idx + 1) mod nb, i.e. row (idx0 + it) mod nb (P5, P6, P7)
// Every mode writes, per lane, the index after `iters` steps, the index of
// the last row gathered and a wrapping int32 sum of col 6 of every gathered
// row, so the plain version checks every gather and no load can be dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kDep = 0, kChain = 1, kChainFull = 2, kIndep = 3 };
constexpr uint32_t kMul = 1103515245u;
constexpr int kSlots = 8;  // cp.async rows in flight per thread (P7's NSEM)

__device__ __forceinline__ int floor_mod(uint32_t v, int nb) {
  const int r = (int)v % nb;
  return r < 0 ? r + nb : r;
}

// the next index of lane state idx after gathering `row`
template <int MODE, int COLS>
__device__ __forceinline__ int next_index(int idx, const int* row, int nb) {
  if (MODE == kIndep) return idx + 1 == nb ? 0 : idx + 1;
  uint32_t s = 0;
  if (MODE == kChainFull) {
    const int4* r4 = reinterpret_cast<const int4*>(row);  // rows are 48 or 512 B: 16-B aligned
#pragma unroll
    for (int j = 0; j < COLS / 4; ++j) {
      const int4 v = r4[j];
      s += (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
    }
  } else {
    s = (uint32_t)row[6];
  }
  return floor_mod((uint32_t)idx * kMul + s + (MODE == kDep ? 0u : 12345u), nb);
}

// Dependent or independent gathers by plain loads, from the table in device
// memory or, with SMEM, from a copy of it that each block stages in shared
// memory first (the TPU's VMEM-resident table).
template <int MODE, int COLS, bool SMEM>
__global__ void gather_kernel(const int* __restrict__ tab, int nb, const int* __restrict__ idx0, int q, int iters,
                              int* __restrict__ out) {
  extern __shared__ int4 stage[];
  const int* t = tab;
  if (SMEM) {
    const int4* src = reinterpret_cast<const int4*>(tab);
    for (int i = threadIdx.x; i < nb * (COLS / 4); i += blockDim.x) stage[i] = src[i];
    __syncthreads();
    t = reinterpret_cast<const int*>(stage);
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= q) return;
  int idx = idx0[lane], last = idx;
  uint32_t csum = 0;
  for (int it = 0; it < iters; ++it) {
    const int* row = t + (int64_t)idx * COLS;
    csum += (uint32_t)row[6];
    last = idx;
    idx = next_index<MODE, COLS>(idx, row, nb);
  }
  out[lane] = idx;
  out[q + lane] = last;
  out[2 * q + lane] = (int)csum;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The independent stream from device memory: each thread keeps kSlots rows
// in flight as cp.async copies into its own ring in shared memory.  One
// commit group per step, empty past the end, so `wait_group kSlots - 1`
// always means "the row of this step has landed".
template <int COLS>
__global__ void stream_kernel(const int* __restrict__ tab, int nb, const int* __restrict__ idx0, int q, int iters,
                              int* __restrict__ out) {
  constexpr int R16 = COLS / 4;  // 16-B pieces per row
  extern __shared__ int4 ring[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= q) return;  // no block barrier below
  int4* mine = ring + (int64_t)threadIdx.x * kSlots * R16;
  int idx = idx0[lane], ahead = idx, last = idx;
  uint32_t csum = 0;
  for (int s = 0; s < kSlots; ++s) {
    if (s < iters) {
      const int4* src = reinterpret_cast<const int4*>(tab + (int64_t)ahead * COLS);
      for (int j = 0; j < R16; ++j) cp_async16(mine + s * R16 + j, src + j);
      ahead = ahead + 1 == nb ? 0 : ahead + 1;
    }
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kSlots - 1>();
    int4* slot = mine + (it % kSlots) * R16;
    csum += (uint32_t)reinterpret_cast<const int*>(slot)[6];
    last = idx;
    idx = idx + 1 == nb ? 0 : idx + 1;
    if (it + kSlots < iters) {  // refill the slot just read
      const int4* src = reinterpret_cast<const int4*>(tab + (int64_t)ahead * COLS);
      for (int j = 0; j < R16; ++j) cp_async16(slot + j, src + j);
      ahead = ahead + 1 == nb ? 0 : ahead + 1;
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  out[lane] = idx;
  out[q + lane] = last;
  out[2 * q + lane] = (int)csum;
}

// P1 / P4: a block with `bytes` of dynamic shared memory (rows of 512 B)
// stores row 0 = 1 and the last row = 2 and returns their sum (128 int32).
__global__ void smem_capacity_kernel(int rows, int* __restrict__ out) {
  extern __shared__ int scratch[];
  const int j = threadIdx.x;
  scratch[j] = 1;
  scratch[(rows - 1) * 128 + j] = 2;
  __syncthreads();
  out[j] = scratch[j] + scratch[(rows - 1) * 128 + j];
}

template <class K>
int launch_smem(K kernel, unsigned grid, unsigned block, size_t smem, cudaStream_t stream, const int* tab, int nb,
                const int* idx0, int q, int iters, int* out) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // reset: report the attribute's refusal, not a later one
      return (int)e;
    }
  }
  kernel<<<grid, block, smem, stream>>>(tab, nb, idx0, q, iters, out);
  return (int)cudaGetLastError();
}

template <int MODE, int COLS>
int gather(bool smem, const int* tab, int nb, const int* idx0, int q, int iters, int* out, cudaStream_t stream) {
  if (smem) {  // one block per SM holds the whole table: big blocks
    const unsigned block = (unsigned)(q < 1024 ? (q + 31) / 32 * 32 : 1024);
    return launch_smem(gather_kernel<MODE, COLS, true>, (unsigned)((q + block - 1) / block), block,
                       (size_t)nb * COLS * 4, stream, tab, nb, idx0, q, iters, out);
  }
  if (MODE == kIndep) {  // 48-B rows: 256 threads x 8 x 48 B = 96 KB; 512-B rows: 32 x 8 x 512 B = 128 KB
    const unsigned block = COLS == 12 ? 256 : 32;
    return launch_smem(stream_kernel<COLS>, (unsigned)((q + block - 1) / block), block,
                       (size_t)block * kSlots * COLS * 4, stream, tab, nb, idx0, q, iters, out);
  }
  gather_kernel<MODE, COLS, false><<<(unsigned)((q + 255) / 256), 256, 0, stream>>>(tab, nb, idx0, q, iters, out);
  return (int)cudaGetLastError();
}

template <int COLS>
int gather_cols(bool smem, int mode, const int* tab, int nb, const int* idx0, int q, int iters, int* out,
                cudaStream_t stream) {
  switch (mode) {
    case kDep: return gather<kDep, COLS>(smem, tab, nb, idx0, q, iters, out, stream);
    case kChain: return gather<kChain, COLS>(smem, tab, nb, idx0, q, iters, out, stream);
    case kChainFull: return gather<kChainFull, COLS>(smem, tab, nb, idx0, q, iters, out, stream);
    case kIndep: return gather<kIndep, COLS>(smem, tab, nb, idx0, q, iters, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int gather_entry(bool smem, const int* tab, int nb, int cols, int mode, const int* idx0, int q, int iters, int* out,
                 void* stream) {
  if (cols == 12) return gather_cols<12>(smem, mode, tab, nb, idx0, q, iters, out, (cudaStream_t)stream);
  if (cols == 128) return gather_cols<128>(smem, mode, tab, nb, idx0, q, iters, out, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// tab (nb, cols) int32 with cols 12 (48-B rows) or 128 (512-B rows), idx0
// (q,) int32 in [0, nb), q >= 1, iters >= 0; out (3, q) int32: index after
// `iters` steps, index of the last row gathered, col-6 checksum.
int rb3c_probe_smem_gather(const int* tab, int nb, int cols, int mode, const int* idx0, int q, int iters, int* out,
                           void* stream) {
  return gather_entry(true, tab, nb, cols, mode, idx0, q, iters, out, stream);
}

int rb3c_probe_hbm_gather(const int* tab, int nb, int cols, int mode, const int* idx0, int q, int iters, int* out,
                          void* stream) {
  return gather_entry(false, tab, nb, cols, mode, idx0, q, iters, out, stream);
}

// One block of 128 threads with `bytes` (a multiple of 512) of dynamic
// shared memory; out (128,) int32.  Returns the CUDA error of the attribute
// or the launch, after reading and resetting it: a size past the card's
// opt-in limit is refused, and that refusal is the measurement.
int rb3c_probe_smem_capacity(int bytes, int* out, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(smem_capacity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  smem_capacity_kernel<<<1, 128, (size_t)bytes, (cudaStream_t)stream>>>(bytes / 512, out);
  const cudaError_t l = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : l);
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device`, or -(CUDA error)
int rb3c_smem_optin(int device) {
  int v = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? v : -(int)e;
}

}  // extern "C"
