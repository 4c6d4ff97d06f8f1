// Native sampled-suffix-array multi-locate of the port (`mem -p`): the
// batched rb3_ssa_multi (ssa.c:138-192) over the dense host index, copied
// from ropebwt3_tpu/native/bwasw_core.cpp `rb3t_ssa_multi_batch` with the
// rank it calls.  The JAX package's optional packed-record ("pline") and
// fused layouts are left out: they change speed only, never a position.
//
// Exact transcription of ropebwt3_tpu/ssa_ops.py `ssa_multi_py`, including
// the klib max-heap's swap sequence, so the reported positions and their
// order match the reference byte for byte.  Requests are independent: each
// thread interleaves G of them as resumable state machines and prefetches
// the rank rows of each one's next heap pop, hiding the DRAM latency of the
// walk.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__) || defined(__AVX512BW__)
#include <immintrin.h>
#endif

namespace {

constexpr int BLOCK_SHIFT = 6;   // index/dense.py BLOCK = 64
constexpr int SUPER_SHIFT = 16;  // index/dense.py SUPER = 1 << 16

struct Fmi {
  const uint8_t* bwt;         // zero-padded one full block past n
  const uint16_t* occ_block;  // [n_blocks+1][6] counts in [super_start, block_start)
  const int64_t* occ_super;   // [n_supers+1][6] counts before superblock
  const int64_t* acc;         // [7]
  int64_t n;
};

static inline uint32_t kh_hash_u64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return (uint32_t)x;
}

struct RankCache {  // direct-mapped pos -> occ[6]; speed only, no output effect
  static constexpr int kBits = 16;
  uint32_t mask = (1u << kBits) - 1;
  std::vector<int64_t> pos = std::vector<int64_t>((size_t)1 << kBits, -1);
  std::vector<int64_t> occ = std::vector<int64_t>(((size_t)1 << kBits) * 6, 0);
};

// in-block symbol counts over positions < off of a 64-byte block
static inline void inblock_add(const uint8_t* blk, int off, int64_t out[6]) {
#if defined(__AVX512BW__)
  __m512i v = _mm512_loadu_si512((const void*)blk);
  __mmask64 m = off >= 64 ? ~(__mmask64)0 : (((__mmask64)1 << off) - 1);
  for (int c = 0; c < 6; ++c)
    out[c] += (int64_t)_mm_popcnt_u64(_mm512_mask_cmpeq_epi8_mask(m, v, _mm512_set1_epi8((char)c)));
#elif defined(__AVX2__)
  __m256i v0 = _mm256_loadu_si256((const __m256i*)blk);
  __m256i v1 = _mm256_loadu_si256((const __m256i*)(blk + 32));
  uint64_t m = off >= 64 ? ~(uint64_t)0 : (((uint64_t)1 << off) - 1);
  for (int c = 0; c < 6; ++c) {
    __m256i t = _mm256_set1_epi8((char)c);
    uint64_t bits = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v0, t)) |
                    ((uint64_t)(uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v1, t)) << 32);
    out[c] += (int64_t)__builtin_popcountll(bits & m);
  }
#else
  for (int i = 0; i < off; ++i) ++out[blk[i]];
#endif
}

static void rank1a(const Fmi& f, int64_t k, int64_t out[6], RankCache& rc) {
  if (k > f.n) k = f.n;
  uint32_t slot = kh_hash_u64((uint64_t)k) & rc.mask;
  if (rc.pos[slot] == k) {
    std::memcpy(out, &rc.occ[(size_t)slot * 6], 6 * sizeof(int64_t));
    return;
  }
  const int64_t* sup = f.occ_super + (size_t)(k >> SUPER_SHIFT) * 6;
  const uint16_t* blk = f.occ_block + (size_t)(k >> BLOCK_SHIFT) * 6;
  for (int c = 0; c < 6; ++c) out[c] = sup[c] + blk[c];
  inblock_add(f.bwt + ((k >> BLOCK_SHIFT) << BLOCK_SHIFT), (int)(k & ((1 << BLOCK_SHIFT) - 1)), out);
  rc.pos[slot] = k;
  std::memcpy(&rc.occ[(size_t)slot * 6], out, 6 * sizeof(int64_t));
}

// the cache lines rank1a(k) will touch
static inline void prefetch_rank(const Fmi& f, int64_t k) {
  if (k > f.n) k = f.n;
  __builtin_prefetch(f.occ_super + (size_t)(k >> SUPER_SHIFT) * 6);
  __builtin_prefetch(f.occ_block + (size_t)(k >> BLOCK_SHIFT) * 6);
  const uint8_t* b = f.bwt + ((k >> BLOCK_SHIFT) << BLOCK_SHIFT);
  __builtin_prefetch(b);
  __builtin_prefetch(b + 63);  // 64-byte blocks may straddle two lines
}

struct Intv {
  int64_t lo, hi, off;
};

static inline bool intv_lt(const Intv& a, const Intv& b) { return a.hi - a.lo < b.hi - b.lo; }

static void iheapup(std::vector<Intv>& h) {
  size_t k = h.size() - 1;
  Intv tmp = h[k];
  while (k) {
    size_t i = (k - 1) >> 1;
    if (intv_lt(tmp, h[i])) break;
    h[k] = h[i];
    k = i;
  }
  h[k] = tmp;
}

static void iheapdown(std::vector<Intv>& h, size_t i, size_t n) {
  size_t k = i;
  Intv tmp = h[i];
  for (;;) {
    k = (k << 1) + 1;
    if (k >= n) break;
    if (k != n - 1 && intv_lt(h[k], h[k + 1])) ++k;
    if (intv_lt(h[k], tmp)) break;
    h[i] = h[k];
    i = k;
  }
  h[i] = tmp;
}

struct Ctx {
  int32_t ss, ms;
  const uint64_t* ssa;
  int64_t n0;
  uint64_t msk_sid;
  std::vector<Intv> heap;
  int64_t* out_sid;
  int64_t* out_pos;
  int64_t n_out, max_sa;

  // harvest the sampled entries inside [lo, hi), push the leftover
  // subintervals; false once the output is full (ssa_add_intv, ssa.c:138-156)
  bool add_intv(int64_t lo, int64_t hi, int64_t off) {
    if (n_out == max_sa) return false;
    int64_t k = (((lo - n0) >> ss) << ss) + n0;
    while (k < hi) {
      if (k >= lo) {
        uint64_t e = ssa[(k - n0) >> ss];
        out_sid[n_out] = (int64_t)(e & msk_sid);
        out_pos[n_out] = off + (int64_t)(e >> ms);
        if (++n_out == max_sa) return false;
        if (lo < k) {
          heap.push_back(Intv{lo, k, off});
          iheapup(heap);
        }
        lo = k + 1;
      }
      k += (int64_t)1 << ss;
    }
    heap.push_back(Intv{lo, hi, off});
    iheapup(heap);
    return true;
  }
};

// one request as a resumable state machine
struct SM {
  Ctx c;
  Intv cur;
  const uint64_t* r2i;
  bool live = false;
  int64_t* n_fin = nullptr;

  void finish() {
    *n_fin = c.n_out;
    live = false;
  }

  void pop_next(const Fmi& f) {
    if (c.heap.empty() || c.n_out >= c.max_sa) {
      finish();
      return;
    }
    cur = c.heap[0];
    Intv last = c.heap.back();
    c.heap.pop_back();
    if (!c.heap.empty()) {
      c.heap[0] = last;
      iheapdown(c.heap, 0, c.heap.size());
    }
    prefetch_rank(f, cur.lo);
    prefetch_rank(f, cur.hi);
  }

  void start(const Fmi& f, int32_t ss, int32_t ms, const uint64_t* r2i_, const uint64_t* ssa, int64_t lo, int64_t hi,
             int64_t max_sa, int64_t* out_sid, int64_t* out_pos, int64_t* n_out) {
    n_fin = n_out;
    *n_out = 0;
    if (max_sa == 0 || lo >= hi) {
      live = false;
      return;
    }
    live = true;
    r2i = r2i_;
    c.heap.clear();
    c.ss = ss;
    c.ms = ms;
    c.ssa = ssa;
    c.n0 = f.acc[1];
    c.msk_sid = ((uint64_t)1 << ms) - 1;
    c.out_sid = out_sid;
    c.out_pos = out_pos;
    c.n_out = 0;
    c.max_sa = max_sa < hi - lo ? max_sa : hi - lo;
    if (!c.add_intv(lo, hi, 0)) {
      finish();
      return;
    }
    pop_next(f);
  }

  void step(const Fmi& f, RankCache& rc) {
    int64_t ok[6], ol[6];
    rank1a(f, cur.lo, ok, rc);
    rank1a(f, cur.hi, ol, rc);
    for (int64_t l = ok[0]; l < ol[0]; ++l) {  // sentinels reached
      c.out_sid[c.n_out] = (int64_t)r2i[l];
      c.out_pos[c.n_out] = cur.off;
      if (++c.n_out == c.max_sa) {
        finish();
        return;
      }
    }
    for (int cc = 1; cc < 6; ++cc)
      if (ok[cc] < ol[cc])
        if (!c.add_intv(f.acc[cc] + ok[cc], f.acc[cc] + ol[cc], cur.off + 1)) {
          finish();
          return;
        }
    pop_next(f);
  }
};

}  // namespace

extern "C" {

// Request r = (lo[r], hi[r], max_sa[r]) writes up to max_sa[r] (sid, pos)
// pairs at out_off[r] and their number to n_out[r].
void rb3t_ssa_multi_batch(const uint8_t* bwt, const uint16_t* occ_block, const int64_t* occ_super,
                          const int64_t* acc, int64_t n, int32_t ss, int32_t ms, const uint64_t* r2i,
                          const uint64_t* ssa, int64_t n_req, const int64_t* lo, const int64_t* hi,
                          const int64_t* max_sa, const int64_t* out_off, int64_t* out_sid, int64_t* out_pos,
                          int64_t* n_out, int32_t n_threads) {
  Fmi f{bwt, occ_block, occ_super, acc, n};
  if (n_threads < 1) n_threads = 1;
  // dynamic per-request claiming: outputs go to out_off[r], so the schedule
  // cannot reorder any result
  std::atomic<int64_t> cursor(0);
  auto work = [&]() {
    RankCache rc;
    constexpr int G = 16;  // requests interleaved per thread
    SM sm[G];
    for (;;) {
      bool any = false;
      for (int i = 0; i < G; ++i) {
        while (!sm[i].live) {
          int64_t r = cursor.fetch_add(1, std::memory_order_relaxed);
          if (r >= n_req) break;
          sm[i].start(f, ss, ms, r2i, ssa, lo[r], hi[r], max_sa[r], out_sid + out_off[r], out_pos + out_off[r],
                      &n_out[r]);
        }
        if (sm[i].live) {
          any = true;
          sm[i].step(f, rc);
        }
      }
      if (!any) break;
    }
  };
  if (n_threads == 1 || n_req < 64) {
    work();
    return;
  }
  std::vector<std::thread> th;
  for (int32_t t = 0; t < n_threads && t < n_req; ++t) th.emplace_back(work);
  for (auto& x : th) x.join();
}

}  // extern "C"
