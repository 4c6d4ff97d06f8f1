// The port's native BWA-SW engine: the DP core over the dense host index
// (index/dense.py), copied from ropebwt3_tpu/native/bwasw_core.cpp: lines
// 1-927 (the rank, the khashl candidate set, the klib heap, the DP engine
// and the hapdiv annotation), the query BWT and prefix DAWG with the -j
// prefilter (:929-1244), the full backtrack, sw_read and the hit blobs
// (:1532-1724), and the entry points rb3t_hapdiv_batch, rb3t_sw_batch and
// rb3t_buf_free.  The native `mem` engine (ops/smem_native.py) is copied
// too: MemRec, smem1_tg, smem_tg_read and the interleaved SmemSM
// (:1246-1308, 1382-1531) with rb3t_pline_build and rb3t_smem_batch
// (:2335-2466), without the k-mer seed table (RB3T_SMEM_SEED) and the fused
// 128-B records (rb3t_fused_build), both measured losses there and off by
// default.  The DP entry points pass no packed one-line records ("pline"):
// they change speed only, never a count.  Two entry points are the port's
// own, built from the copied code: rb3t_sw_stage and rb3t_sw_finish, the
// host halves of the device sw engine (align/sw.py).
//
// Exact re-implementation of the reference bwa-sw.c:329-526, including
// khashl bucket iteration order, klib heap semantics and quickselect, so the
// hapdiv counts and the PAF stay byte-identical to the reference binary.
// The port's device engines (align/hapdiv.py, align/sw.py) rerun here the
// windows and reads their kernels flag.
//
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif
#include <x86intrin.h>  // __rdtsc for the env-gated DP phase profile

namespace {

constexpr int BLOCK_SHIFT = 6;   // index/dense.py BLOCK = 64
constexpr int SUPER_SHIFT = 16;  // index/dense.py SUPER = 1 << 16
constexpr uint32_t SW_F_UNSET = 0x3FFFFFFu;
constexpr uint32_t U32MAX = 0xFFFFFFFFu;
constexpr int SW_FROM_H = 0, SW_FROM_E = 1, SW_FROM_F = 2;
constexpr int SW_FROM_OPEN = 0, SW_FROM_EXT = 1;

struct Opt {
  int32_t flag, n_best, min_sc, end_len, match, mis, e2e_drop, gap_open, gap_ext, min_mem_len;
};

static Opt opt_from(const int32_t* o) {
  return Opt{o[0], o[1], o[2], o[3], o[4], o[5], o[6], o[7], o[8], o[9]};
}

constexpr int RB3_SWF_E2E = 1;

// ---- packed one-line rank record ("pline") -------------------------------
// ONE 64-byte record covering 128 symbols: three 128-bit symbol bit-planes
// (48 B; plane words p[0..1]=bit0, p[2..3]=bit1, p[4..5]=bit2 of each nt6
// symbol) + six uint16 within-super counts at the record start (12 B) + pad.
// rank1a then touches a SINGLE random cache line (plus the L3-resident
// occ_super row) instead of the two-to-three lines of the split/fused
// layouts — the random-line footprint that bounds every LF-walk at >=640M
// indexes is halved, and same-block pair ranks double their hit range
// (128 vs 64 symbols).  Pure layout change: every count is identical to the
// split layout, so outputs cannot move.  (Round-4 lever; the reference's
// analog is rld0's small delta-coded blocks, rld0.c:107-204.)
struct PlRec {
  uint64_t p[6];
  uint16_t cnt[6];
  uint32_t pad;
};
static_assert(sizeof(PlRec) == 64, "pline record must be one cache line");
constexpr int PL_SHIFT = 7;  // 128 symbols per record

struct Fmi {
  const uint8_t* bwt;
  const uint16_t* occ_block;  // [n_blocks+1][6] counts in [super_start, block_start)
  const int64_t* occ_super;   // [n_supers+1][6] counts before superblock
  const int64_t* acc;         // [7]
  int64_t n;
  // optional fused layout: per block one 128-byte record [64B symbols |
  // 12B uint16 within-super counts | pad] — rank touches ONE random memory
  // region instead of two (bwt line + occ row); occ_super stays separate
  // (tiny, cache-resident).  Built by rb3t_fused_build.
  const uint8_t* fused = nullptr;
  // optional pline layout (PlRec above), preferred over `fused` when set.
  const PlRec* pline = nullptr;
};

static inline void pl_masks(int off, uint64_t& m0, uint64_t& m1) {
  m0 = off >= 64 ? ~0ull : ((1ull << off) - 1);
  m1 = off <= 64 ? 0ull : (off >= 128 ? ~0ull : ((1ull << (off - 64)) - 1));
}

// add counts of symbols 0..5 over the first `off` positions of the record
static inline void pl_add(const PlRec* r, int off, int64_t out[6]) {
  uint64_t m0, m1;
  pl_masks(off, m0, m1);
  for (int w = 0; w < 2; ++w) {
    uint64_t m = w ? m1 : m0;
    if (!m) break;
    uint64_t p0 = r->p[w], p1 = r->p[2 + w], p2 = r->p[4 + w];
    uint64_t n2 = ~p2 & m, y2 = p2 & m, n1 = ~p1, n0 = ~p0;
    out[0] += (int64_t)__builtin_popcountll(n2 & n1 & n0);
    out[1] += (int64_t)__builtin_popcountll(n2 & n1 & p0);
    out[2] += (int64_t)__builtin_popcountll(n2 & p1 & n0);
    out[3] += (int64_t)__builtin_popcountll(n2 & p1 & p0);
    out[4] += (int64_t)__builtin_popcountll(y2 & n1 & n0);
    out[5] += (int64_t)__builtin_popcountll(y2 & n1 & p0);  // 6/7 never occur
  }
}

// count of one symbol c over the first `off` positions of the record
static inline int64_t pl_count1(const PlRec* r, int off, int c) {
  uint64_t m0, m1;
  pl_masks(off, m0, m1);
  int64_t out = 0;
  for (int w = 0; w < 2; ++w) {
    uint64_t m = w ? m1 : m0;
    if (!m) break;
    uint64_t e = (c & 1 ? r->p[w] : ~r->p[w]) & (c & 2 ? r->p[2 + w] : ~r->p[2 + w]) &
                 (c & 4 ? r->p[4 + w] : ~r->p[4 + w]);
    out += (int64_t)__builtin_popcountll(e & m);
  }
  return out;
}

// the symbol stored at record offset `off` (LF walks: symbol + rank from the
// SAME cache line)
static inline int pl_sym(const PlRec* r, int off) {
  int w = off >> 6, b = off & 63;
  return (int)(((r->p[w] >> b) & 1) | (((r->p[2 + w] >> b) & 1) << 1) |
               (((r->p[4 + w] >> b) & 1) << 2));
}

struct Cell {  // bwa-sw.c:39-45 sw_cell_t analog (align/bwasw.py Cell)
  int64_t lo, hi, lo_rc;
  int32_t H, E, F, rlen, qlen;
  uint32_t H_from_pos, E_from_pos, F_from_off;
  uint8_t H_from, E_from, F_from, F_off_set, flt;
};

static inline Cell cell_zero() {
  Cell c;
  std::memset(&c, 0, sizeof(c));
  return c;
}

// ---- khashl semantics (align/khashl_compat.py) ---------------------------

static inline uint32_t kh_hash_u64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return (uint32_t)x;
}
static inline uint32_t cell_hash(const Cell& c) {
  return kh_hash_u64((uint64_t)c.lo) + kh_hash_u64((uint64_t)c.hi);
}
static inline bool cell_eq(const Cell& a, const Cell& b) { return a.lo == b.lo && a.hi == b.hi; }
static inline uint32_t h2b(uint32_t h, int bits) { return (h * 2654435769u) >> (32 - bits); }
static inline uint32_t kh_max_count(uint32_t cap) { return (cap >> 1) + (cap >> 2); }

struct CellSet {
  int bits = 0;
  uint32_t count = 0;
  std::vector<Cell> keys;
  std::vector<uint8_t> used;
  // occupied bucket ids, any order.  The top-n/rebuild phases only need the
  // MULTISET of (H<<32|bucket) packed keys — selection and sort are by
  // value, so iteration order here is unobservable; keeping the list saves
  // the full-table scan per node (topn was ~16% of sw).  Rebuilt on resize
  // (rehash reassigns bucket ids).
  std::vector<uint32_t> live;

  uint32_t n_buckets() const { return keys.empty() ? 0u : (1u << bits); }
  uint32_t end() const { return n_buckets(); }

  void clear() {
    count = 0;
    live.clear();
    std::fill(used.begin(), used.end(), 0);
  }

  // Reset to the same geometry a fresh `CellSet(); resize(want)` would
  // produce, but WITHOUT freeing the buffers.  The bucket count (and so
  // the tie-breaking iteration order) is bit-identical: bits is computed
  // exactly like resize() on an empty set; only heap reuse differs.
  void reset(uint32_t want_buckets) {
    uint32_t x = want_buckets;
    int j = 0;
    while (x >> 1) {
      x >>= 1;
      ++j;
    }
    if (want_buckets & (want_buckets - 1)) ++j;
    bits = j > 2 ? j : 2;
    uint32_t new_n = 1u << bits;
    keys.resize(new_n);  // vector::resize keeps capacity on shrink
    used.assign(new_n, 0);
    live.clear();
    count = 0;
  }

  void resize(uint32_t new_n_buckets) {
    uint32_t x = new_n_buckets;
    int j = 0;
    while (x >> 1) {
      x >>= 1;
      ++j;
    }
    if (new_n_buckets & (new_n_buckets - 1)) ++j;
    int new_bits = j > 2 ? j : 2;
    uint32_t new_n = 1u << new_bits;
    if (count > kh_max_count(new_n)) return;
    std::vector<uint8_t> new_used(new_n, 0);
    uint32_t nb = n_buckets();
    if (nb < new_n) keys.resize(new_n);
    uint32_t mask = new_n - 1;
    for (uint32_t j2 = 0; j2 < nb; ++j2) {
      if (!used[j2]) continue;
      Cell key = keys[j2];
      used[j2] = 0;
      for (;;) {  // kick-out rehash
        uint32_t i = h2b(cell_hash(key), new_bits);
        while (new_used[i]) i = (i + 1) & mask;
        new_used[i] = 1;
        if (i < nb && used[i]) {
          std::swap(keys[i], key);
          used[i] = 0;
        } else {
          keys[i] = key;
          break;
        }
      }
    }
    if (nb > new_n) keys.resize(new_n);
    used.swap(new_used);
    bits = new_bits;
    live.clear();
    for (uint32_t j2 = 0; j2 < new_n; ++j2)
      if (used[j2]) live.push_back(j2);
  }

  // returns (bucket, absent); on absent the key is stored
  std::pair<uint32_t, bool> put(const Cell& key) {
    uint32_t nb = n_buckets();
    if (count >= kh_max_count(nb)) {
      resize(nb + 1);
      nb = 1u << bits;
    }
    uint32_t mask = nb - 1;
    uint32_t i = h2b(cell_hash(key), bits), last = i;
    while (used[i] && !cell_eq(keys[i], key)) {
      i = (i + 1) & mask;
      if (i == last) break;
    }
    if (!used[i]) {
      keys[i] = key;
      used[i] = 1;
      ++count;
      live.push_back(i);
      return {i, true};
    }
    return {i, false};
  }

  uint32_t get(const Cell& key) const {
    uint32_t nb = n_buckets();
    if (nb == 0) return 0;
    uint32_t mask = nb - 1;
    uint32_t i = h2b(cell_hash(key), bits), last = i;
    while (used[i] && !cell_eq(keys[i], key)) {
      i = (i + 1) & mask;
      if (i == last) return nb;
    }
    return used[i] ? i : nb;
  }
};

// ---- klib heap on (score<<32 | id) with reversed comparator --------------
// (ks_heap* of khashl_compat.py; heap[0] is the MIN packed value)

static void heapup(std::vector<uint64_t>& h) {
  size_t k = h.size() - 1;
  uint64_t tmp = h[k];
  while (k) {
    size_t i = (k - 1) >> 1;
    if (tmp > h[i]) break;
    h[k] = h[i];
    k = i;
  }
  h[k] = tmp;
}

static void heapdown(std::vector<uint64_t>& h, size_t i, size_t n) {
  size_t k = i;
  uint64_t tmp = h[i];
  for (;;) {
    k = (k << 1) + 1;
    if (k >= n) break;
    if (k != n - 1 && h[k] > h[k + 1]) ++k;
    if (h[k] > tmp) break;
    h[i] = h[k];
    i = k;
  }
  h[i] = tmp;
}

static void heapsort_desc(std::vector<uint64_t>& h) {  // descending by packed value
  for (size_t i = h.size(); i-- > 1;) {
    std::swap(h[0], h[i]);
    heapdown(h, 0, i);
  }
}

static int heap_insert1(std::vector<uint64_t>& h, uint32_t maxn, int64_t score, uint32_t id) {
  uint64_t x = ((uint64_t)score << 32) | id;
  if (h.size() < maxn) {
    h.push_back(x);
    heapup(h);
    return 1;
  }
  if (x > h[0]) {
    h[0] = x;
    heapdown(h, 0, h.size());
    return 1;
  }
  return 0;
}

// klib ks_ksmall with lt = (a > b): k-th LARGEST (quickselect); signed
// indices so `high = hh - 1` can go negative exactly like the Python spec.
static int32_t ksmall_gt(std::vector<int32_t>& a, int64_t kk) {
  int64_t low = 0, high = (int64_t)a.size() - 1, k = kk;
  for (;;) {
    if (high <= low) return a[k];
    if (high == low + 1) {
      if (a[high] > a[low]) std::swap(a[low], a[high]);
      return a[k];
    }
    int64_t mid = low + (high - low) / 2;
    if (a[high] > a[mid]) std::swap(a[mid], a[high]);
    if (a[high] > a[low]) std::swap(a[low], a[high]);
    if (a[low] > a[mid]) std::swap(a[mid], a[low]);
    std::swap(a[mid], a[low + 1]);
    int64_t ll = low + 1, hh = high;
    for (;;) {
      do ++ll; while (a[ll] > a[low]);
      do --hh; while (a[low] > a[hh]);
      if (hh < ll) break;
      std::swap(a[ll], a[hh]);
    }
    std::swap(a[low], a[hh]);
    if (hh <= k) low = ll;
    if (hh >= k) high = hh - 1;
  }
}

// ---- dense rank / bidirectional extend (index/dense.py semantics) --------

struct RankCache {  // direct-mapped pos -> occ[6]; pure speed, no output effect
  // 2^16 entries/thread (3.5 MB) by default; RB3T_RANK_CBITS overrides
  // (read per construction so A/B harnesses can vary it within a process).
  // Interleaved best-of-5 at 640M/100k reads: 14:1.93s 16:1.87s 18:2.46s
  // 20:2.24s — 16 optimal, larger caches lose to their own misses.
  uint32_t mask;
  bool pair_rank;  // same-block fused rank2a (RB3T_NO_PAIR_RANK disables)
  std::vector<int64_t> pos;
  std::vector<int64_t> occ;
  // default_bits is per-engine: the sw/hapdiv DP row extends hit a small
  // working set and a 2^12-entry (L2-resident) cache measures 19% faster
  // than 2^16 at 1.34G (round 4); the SMEM walk still wants 2^16
  // (round-3 sweep).  RB3T_RANK_CBITS overrides both.
  explicit RankCache(int default_bits = 16) {
    pair_rank = getenv("RB3T_NO_PAIR_RANK") == nullptr;
    rebits(default_bits);
  }

  // re-size to a new per-workload default; an explicit RB3T_RANK_CBITS
  // still wins (the A/B-harness contract).  Round-5 sweep: hapdiv's DP
  // optimum is 2^13 (1.64 vs 1.68 s at 2^12 on 10k@1.34G) while sw
  // prefers 2^12 — rb3t_hapdiv_batch calls rebits(13) per engine.
  void rebits(int default_bits) {
    const char* e = getenv("RB3T_RANK_CBITS");
    int b = e ? atoi(e) : default_bits;
    b = b < 10 ? 10 : (b > 22 ? 22 : b);
    mask = (1u << b) - 1;
    pos.assign((size_t)1 << b, -1);
    occ.assign(((size_t)1 << b) * 6, 0);
  }
};

// In-block symbol counts over positions < off of a 64-byte block (the bwt
// buffer is zero-padded one full block past n, index/dense.py:43-49, so the
// full-width load never runs off the end).
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
    out[c] += (int64_t)_mm_popcnt_u64(bits & m);
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
  if (f.pline) {
    const PlRec* rec = f.pline + (size_t)(k >> PL_SHIFT);
    for (int c = 0; c < 6; ++c) out[c] = sup[c] + rec->cnt[c];
    pl_add(rec, (int)(k & ((1 << PL_SHIFT) - 1)), out);
  } else if (f.fused) {
    const uint8_t* rec = f.fused + ((size_t)(k >> BLOCK_SHIFT) << 7);
    const uint16_t* blk = (const uint16_t*)(rec + 64);
    for (int c = 0; c < 6; ++c) out[c] = sup[c] + blk[c];
    inblock_add(rec, (int)(k & ((1 << BLOCK_SHIFT) - 1)), out);
  } else {
    const uint16_t* blk = f.occ_block + (size_t)(k >> BLOCK_SHIFT) * 6;
    for (int c = 0; c < 6; ++c) out[c] = sup[c] + blk[c];
    inblock_add(f.bwt + ((k >> BLOCK_SHIFT) << BLOCK_SHIFT), (int)(k & ((1 << BLOCK_SHIFT) - 1)), out);
  }
  rc.pos[slot] = k;
  std::memcpy(&rc.occ[(size_t)slot * 6], out, 6 * sizeof(int64_t));
}

// Prefetch the cache-line streams rank1a(k) will touch.
static inline void prefetch_rank(const Fmi& f, int64_t k) {
  if (k > f.n) k = f.n;
  __builtin_prefetch(f.occ_super + (size_t)(k >> SUPER_SHIFT) * 6);
  if (f.pline) {
    __builtin_prefetch(f.pline + (size_t)(k >> PL_SHIFT));  // one line total
    return;
  }
  if (f.fused) {
    const uint8_t* rec = f.fused + ((size_t)(k >> BLOCK_SHIFT) << 7);
    __builtin_prefetch(rec);
    __builtin_prefetch(rec + 64);  // symbols tail + counts
    return;
  }
  __builtin_prefetch(f.occ_block + (size_t)(k >> BLOCK_SHIFT) * 6);
  const uint8_t* b = f.bwt + ((k >> BLOCK_SHIFT) << BLOCK_SHIFT);
  __builtin_prefetch(b);
  __builtin_prefetch(b + 63);  // 64-byte blocks may straddle two lines
}

struct Ext {
  int64_t lo[6], rc[6], sz[6];
};

// backward extend with the exact complement-order prefix sums of rld_extend
// (rld0.c:486-502; index/dense.py DenseFMIndex.extend with is_back=True)
// rank1a at two positions in the SAME block: one base fetch (super + block
// row), two in-block counts — small intervals (the deep extends that
// dominate SMEM/sw) put both endpoints in one 64-symbol block most of the
// time, halving the random memory traffic of the extend.  Bit-identical.
static void rank1a_pair_sameblk(const Fmi& f, int64_t k1, int64_t k2, int64_t* o1, int64_t* o2, RankCache& rc) {
  uint32_t s1 = kh_hash_u64((uint64_t)k1) & rc.mask;
  uint32_t s2 = kh_hash_u64((uint64_t)k2) & rc.mask;
  bool h1 = rc.pos[s1] == k1, h2 = rc.pos[s2] == k2;
  if (h1 && h2) {
    std::memcpy(o1, &rc.occ[(size_t)s1 * 6], 6 * sizeof(int64_t));
    std::memcpy(o2, &rc.occ[(size_t)s2 * 6], 6 * sizeof(int64_t));
    return;
  }
  const int64_t* sup = f.occ_super + (size_t)(k1 >> SUPER_SHIFT) * 6;
  int64_t base[6];
  const uint8_t* blk_sym;
  if (f.pline) {
    const PlRec* rec = f.pline + (size_t)(k1 >> PL_SHIFT);
    for (int c = 0; c < 6; ++c) base[c] = sup[c] + rec->cnt[c];
    std::memcpy(o1, base, sizeof(base));
    pl_add(rec, (int)(k1 & ((1 << PL_SHIFT) - 1)), o1);
    std::memcpy(o2, base, sizeof(base));
    pl_add(rec, (int)(k2 & ((1 << PL_SHIFT) - 1)), o2);
    rc.pos[s1] = k1;
    std::memcpy(&rc.occ[(size_t)s1 * 6], o1, 6 * sizeof(int64_t));
    rc.pos[s2] = k2;
    std::memcpy(&rc.occ[(size_t)s2 * 6], o2, 6 * sizeof(int64_t));
    return;
  }
  if (f.fused) {
    const uint8_t* rec = f.fused + ((size_t)(k1 >> BLOCK_SHIFT) << 7);
    const uint16_t* blk = (const uint16_t*)(rec + 64);
    for (int c = 0; c < 6; ++c) base[c] = sup[c] + blk[c];
    blk_sym = rec;
  } else {
    const uint16_t* blk = f.occ_block + (size_t)(k1 >> BLOCK_SHIFT) * 6;
    for (int c = 0; c < 6; ++c) base[c] = sup[c] + blk[c];
    blk_sym = f.bwt + ((k1 >> BLOCK_SHIFT) << BLOCK_SHIFT);
  }
  std::memcpy(o1, base, sizeof(base));
  inblock_add(blk_sym, (int)(k1 & ((1 << BLOCK_SHIFT) - 1)), o1);
  std::memcpy(o2, base, sizeof(base));
  inblock_add(blk_sym, (int)(k2 & ((1 << BLOCK_SHIFT) - 1)), o2);
  rc.pos[s1] = k1;
  std::memcpy(&rc.occ[(size_t)s1 * 6], o1, 6 * sizeof(int64_t));
  rc.pos[s2] = k2;
  std::memcpy(&rc.occ[(size_t)s2 * 6], o2, 6 * sizeof(int64_t));
}

static void extend_back(const Fmi& f, int64_t lo, int64_t lo_rc, int64_t size, Ext& e, RankCache& rc) {
  int64_t tk[6], tl[6];
  int64_t hi = lo + size;
  int64_t k1 = lo > f.n ? f.n : lo, k2 = hi > f.n ? f.n : hi;
  const int bs = f.pline ? PL_SHIFT : BLOCK_SHIFT;  // pline doubles the pair range
  if (rc.pair_rank && (k1 >> bs) == (k2 >> bs)) {
    rank1a_pair_sameblk(f, k1, k2, tk, tl, rc);
    goto have_ranks;
  }
  rank1a(f, lo, tk, rc);
  rank1a(f, lo + size, tl, rc);
have_ranks:
  for (int c = 0; c < 6; ++c) {
    e.sz[c] = tl[c] - tk[c];
    e.lo[c] = f.acc[c] + tk[c];
  }
  int64_t o = lo_rc;
  e.rc[0] = o;
  o += e.sz[0]; e.rc[4] = o;
  o += e.sz[4]; e.rc[3] = o;
  o += e.sz[3]; e.rc[2] = o;
  o += e.sz[2]; e.rc[1] = o;
  o += e.sz[1]; e.rc[5] = o;
}

// ---- DP engine (align/bwasw.py sw_core_multi, one window) ----------------

struct Dawg {
  int32_t n_node;
  const int32_t* c;        // edge symbol into node (root: unused)
  const int32_t* pre_off;  // [n_node+1]
  const int32_t* pre;      // flattened predecessor ids
};

struct Engine {
  Fmi f;
  Opt o;
  // A/B knob for the DP rank prefetch-ahead (RB3T_DP_PREFETCH=0 disables)
  bool dp_prefetch = [] { const char* e = getenv("RB3T_DP_PREFETCH"); return !e || atoi(e) != 0; }();
  // RB3T_DP_STATS=1: rdtsc cycle counters per DP phase, printed by the batch
  // entry points — profiling aid only (gprofng misses our worker threads)
  static inline bool stats_on() { static bool v = [] { const char* e = getenv("RB3T_DP_STATS"); return e && atoi(e) != 0; }(); return v; }
  uint64_t cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // HE-loop (incl. extends), prune, topn, closure, rebuild, extends, dawggen, backtrack
  CellSet h;
  std::vector<std::vector<Cell>> rows;
  std::vector<std::pair<int64_t, int64_t>> fpar;
  std::vector<uint64_t> heap;
  std::vector<Cell> fstack;
  std::vector<Cell> row0;
  std::vector<int32_t> ks_a;  // pruning-bound scratch (pooled: per-node realloc was ~2% of sw)
  RankCache cache{12};
  int64_t best_pos = 0;
  int32_t best_score = 0;

  std::pair<uint32_t, int> update_candset(const Cell& p) {  // bwa-sw.c:265-284
    auto pr = h.put(p);
    uint32_t itr = pr.first;
    if (!pr.second) {
      Cell& q = h.keys[itr];
      q.rlen = std::max(q.rlen, p.rlen);
      q.qlen = std::max(q.qlen, p.qlen);
      int changed = 0;
      if (q.E < p.E) {
        q.E = p.E;
        q.E_from = p.E_from;
        q.E_from_pos = p.E_from_pos;
        changed |= 1 << 1;
      }
      if (q.F < p.F) {
        q.F = p.F;
        q.F_from = p.F_from;
        changed |= 1 << 2;
      }
      if (q.H < p.H) {
        q.H = p.H;
        q.H_from = p.H_from;
        changed |= 1 << 0;
        if (p.H_from == SW_FROM_H) q.H_from_pos = p.H_from_pos;
      }
      return {itr, changed};
    }
    return {itr, 7};
  }

  void track_F(std::vector<Cell>& row) {  // bwa-sw.c:301-324
    h.clear();
    for (size_t j = 0; j < row.size(); ++j) {
      Cell r = row[j];
      r.H = (int32_t)j;  // reuse H as index
      h.put(r);
    }
    for (Cell& p : row) {
      if (p.F == 0 || p.F_from_off == SW_F_UNSET) continue;
      Cell key = cell_zero();
      key.lo = fpar[p.F_from_off].first;
      key.hi = fpar[p.F_from_off].second;
      uint32_t k = h.get(key);
      if (k != h.end()) {
        p.F_from_off = (uint32_t)h.keys[k].H;
        p.F_off_set = 1;
      } else {
        p.F_from_off = SW_F_UNSET;
      }
    }
  }

  static void cell_dedup(std::vector<Cell>& row) {  // bwa-sw.c:197-216
    if (row.size() <= 1) return;
    std::vector<size_t> a = {0};
    for (size_t i = 1; i < row.size(); ++i) {
      Cell& p = row[i];
      bool contained = false;
      for (size_t j : a) {
        const Cell& q = row[j];
        if (q.lo_rc <= p.lo_rc && q.lo_rc + (q.hi - q.lo) >= p.lo_rc + (p.hi - p.lo)) {
          contained = true;
          break;
        }
        if (q.lo <= p.lo && q.hi >= p.hi) {
          contained = true;
          break;
        }
      }
      if (!contained) a.push_back(i);
      else p.flt = 1;
    }
  }

  void run(const Dawg& g) {
    int n_col = o.n_best;
    // capacity-preserving resets: rows.assign(n_node, {}) freed every row's
    // buffer per window (1M+ reallocs over a 10k-window batch) and the
    // fresh CellSet freed its table; geometry (and so tie-break order) is
    // unchanged — only the heap traffic goes away
    if ((int32_t)rows.size() < g.n_node) rows.resize(g.n_node);
    for (int32_t ri = 0; ri < g.n_node; ++ri) rows[ri].clear();
    fpar.clear();
    h.reset((uint32_t)o.n_best * 4);
    best_pos = 0;
    best_score = 0;
    Cell root = cell_zero();
    root.hi = f.acc[6];
    rows[0].push_back(root);
    Cell last_p = root;  // reference keeps the last visited predecessor cell

    const bool st = stats_on();
    uint64_t t0 = 0;
    for (int32_t i = 1; i < g.n_node; ++i) {
      if (st) t0 = __rdtsc();
      h.clear();
      int32_t max_min_sc = 0;
      int32_t np = g.pre_off[i + 1] - g.pre_off[i];
      const int32_t* pre = g.pre + g.pre_off[i];
      if (np > 1) {  // k-smallest pruning bound (bwa-sw.c:368-386)
        size_t n_cell = 0;
        for (int32_t pj = 0; pj < np; ++pj) n_cell += rows[pre[pj]].size();
        if (n_cell > (size_t)o.n_best) {
          ks_a.clear();
          for (int32_t pj = 0; pj < np; ++pj)
            for (const Cell& cc : rows[pre[pj]]) ks_a.push_back(cc.H);
          max_min_sc = ksmall_gt(ks_a, o.n_best);
        }
        max_min_sc -= std::max(o.gap_open + o.gap_ext, o.mis);
        if (max_min_sc < 0) max_min_sc = 0;
      }
      if (st) cyc[1] += __rdtsc() - t0;
      int32_t tc = g.c[i];

      // H and E from predecessor rows (bwa-sw.c:388-426)
      if (st) t0 = __rdtsc();
      for (int32_t pj = 0; pj < np; ++pj) {
        int32_t pid = pre[pj];
        std::vector<Cell>& prow = rows[pid];
        if (dp_prefetch)
          for (size_t k2 = 0; k2 < prow.size(); ++k2) {
            // overlap ALL the row's extend rank misses up front: cells
            // extend independently, so their lines can stream while the
            // hash/heap work of earlier cells runs (distance-1 lookahead
            // measured only +5%; whole-row gives the LFBs real depth).
            // Pure speed, no ordering effect.
            prefetch_rank(f, prow[k2].lo > f.n ? f.n : prow[k2].lo);
            int64_t nh = prow[k2].hi > f.n ? f.n : prow[k2].hi;
            prefetch_rank(f, nh);
          }
        for (size_t k = 0; k < prow.size(); ++k) {
          const Cell p = prow[k];
          last_p = p;
          if (p.H + o.match < max_min_sc) continue;
          Ext e;
          uint64_t te = st ? __rdtsc() : 0;
          extend_back(f, p.lo, p.lo_rc, p.hi - p.lo, e, cache);
          if (st) cyc[5] += __rdtsc() - te;
          Cell r = cell_zero();
          r.F_from_off = SW_F_UNSET;
          r.H_from = SW_FROM_H;
          r.H_from_pos = (uint32_t)((int64_t)pid * n_col + (int64_t)k);
          r.E_from_pos = U32MAX;
          for (int c = 1; c < 6; ++c) {
            int32_t sc = (c == tc && c != 5) ? o.match : -o.mis;
            if (e.sz[c] == 0) continue;
            if (p.H + sc <= 0 || p.H + sc < max_min_sc) continue;
            if (c != tc && p.qlen < o.end_len) continue;
            r.lo = e.lo[c];
            r.hi = e.lo[c] + e.sz[c];
            r.lo_rc = e.rc[c];
            r.H = p.H + sc;
            r.rlen = p.rlen + 1;
            r.qlen = p.qlen + 1;
            update_candset(r);
          }
          if (p.H - o.gap_open > p.E) {
            r.E_from = SW_FROM_OPEN;
            r.E = p.H - o.gap_open;
          } else {
            r.E_from = SW_FROM_EXT;
            r.E = p.E;
          }
          r.E -= o.gap_ext;
          if (r.E > 0 && r.E >= max_min_sc && p.qlen >= o.end_len) {
            // only lo/hi updated; lo_rc keeps the stale value (bwa-sw.c:418)
            r.lo = p.lo;
            r.hi = p.hi;
            r.H = r.E;
            r.H_from = SW_FROM_E;
            r.E_from_pos = (uint32_t)((int64_t)pid * n_col + (int64_t)k);
            r.H_from_pos = U32MAX;
            r.rlen = p.rlen;
            r.qlen = p.qlen + 1;
            update_candset(r);
          }
        }
      }

      if (st) cyc[0] += __rdtsc() - t0;
      if (h.count == 0) {
        rows[i].clear();
        continue;
      }

      // top-n selection (bwa-sw.c:428-443).  The klib heap kept the top
      // n_best packed keys (H<<32 | bucket) — keys are UNIQUE (bucket ids
      // distinct), so the kept set and its heapsort_desc order equal a
      // plain descending sort of the top n_best keys; the heap layout
      // itself is unobservable (only heap[0] = min and the final sorted
      // order are read).  nth_element + sort replaces per-insert sifting.
      if (st) t0 = __rdtsc();
      heap.clear();
      for (uint32_t itr : h.live) heap.push_back(((uint64_t)(uint32_t)h.keys[itr].H << 32) | itr);
      if ((int64_t)heap.size() > (int64_t)o.n_best) {
        std::nth_element(heap.begin(), heap.begin() + o.n_best, heap.end(), std::greater<uint64_t>());
        heap.resize(o.n_best);
      }
      std::sort(heap.begin(), heap.end(), std::greater<uint64_t>());
      row0.clear();
      for (uint64_t x : heap) row0.push_back(h.keys[(uint32_t)x]);
      std::reverse(heap.begin(), heap.end());  // sorted ascending = valid heap
      if (st) { cyc[2] += __rdtsc() - t0; t0 = __rdtsc(); }

      // F (deletion) closure DFS (bwa-sw.c:445-483)
      size_t fpar_base = fpar.size();
      uint32_t n_fpar = 0;
      bool closure_changed = false;  // any candset mutation (incl. rlen/qlen max-merge)
      fstack.clear();
      if (last_p.qlen >= o.end_len)
        for (size_t j = row0.size(); j-- > 0;)
          if (row0[j].H > o.gap_open + o.gap_ext) fstack.push_back(row0[j]);
      if (dp_prefetch)
        for (size_t fi = fstack.size(); fi-- > 0;) {  // seed prefetch: stack pops right-to-left
          prefetch_rank(f, fstack[fi].lo > f.n ? f.n : fstack[fi].lo);
          if (fstack.size() - fi >= 4) break;
        }
      while (!fstack.empty()) {
        Cell z = fstack.back();
        fstack.pop_back();
        if (dp_prefetch && !fstack.empty()) {
          const Cell& nz = fstack.back();
          prefetch_rank(f, nz.lo > f.n ? f.n : nz.lo);
          int64_t nh = nz.hi > f.n ? f.n : nz.hi;
          prefetch_rank(f, nh);
        }
        int64_t minv = heap.size() < (size_t)o.n_best ? 0 : (int64_t)(heap[0] >> 32);
        Cell r = cell_zero();
        r.H_from_pos = r.E_from_pos = U32MAX;
        r.F_from_off = SW_F_UNSET;
        if (z.H - o.gap_open > z.F) {
          r.F_from = SW_FROM_OPEN;
          r.F = z.H - o.gap_open;
        } else {
          r.F_from = SW_FROM_EXT;
          r.F = z.F;
        }
        r.F -= o.gap_ext;
        r.H = r.F;
        r.H_from = SW_FROM_F;
        r.rlen = z.rlen + 1;
        r.qlen = z.qlen;
        if (r.H <= minv) continue;
        Ext e;
        extend_back(f, z.lo, z.lo_rc, z.hi - z.lo, e, cache);
        closure_changed = true;  // update_candset below may mutate rlen/qlen even when scores don't move
        for (int c = 1; c < 6; ++c) {
          if (e.sz[c] == 0) continue;
          r.lo = e.lo[c];
          r.hi = e.lo[c] + e.sz[c];
          r.lo_rc = e.rc[c];
          auto uc = update_candset(r);
          if (uc.second & (1 << 2)) {  // q->F updated
            heap_insert1(heap, o.n_best, r.H, U32MAX);
            fpar.emplace_back(z.lo, z.hi);
            h.keys[uc.first].F_from = r.F_from;
            h.keys[uc.first].F_from_off = (uint32_t)(fpar_base + n_fpar);
            ++n_fpar;
            // compares against the heap min captured at pop time (bwa-sw.c:453,476)
            if (r.H - o.gap_ext > minv) fstack.push_back(h.keys[uc.first]);
          }
        }
      }

      if (st) { cyc[3] += __rdtsc() - t0; t0 = __rdtsc(); }
      // rebuild heap/row, track F, best, dedup.  If the closure never
      // reached a candset update, h is untouched since the selection and
      // the rebuild would reproduce row0 exactly — skip it (common case:
      // score spreads under gap_open+2*gap_ext leave the closure empty).
      if (!closure_changed) {
        rows[i].swap(row0);
      } else {
        heap.clear();
        for (uint32_t itr : h.live) heap.push_back(((uint64_t)(uint32_t)h.keys[itr].H << 32) | itr);
        if ((int64_t)heap.size() > (int64_t)o.n_best) {
          std::nth_element(heap.begin(), heap.begin() + o.n_best, heap.end(), std::greater<uint64_t>());
          heap.resize(o.n_best);
        }
        std::sort(heap.begin(), heap.end(), std::greater<uint64_t>());
        rows[i].clear();
        for (uint64_t x : heap) rows[i].push_back(h.keys[(uint32_t)x]);
      }
      if (n_fpar > 0) track_F(rows[i]);
      if (rows[i][0].H > best_score) {
        best_score = rows[i][0].H;
        best_pos = (int64_t)i * n_col;
      }
      if (i == g.n_node - 1) cell_dedup(rows[i]);
      if (st) cyc[4] += __rdtsc() - t0;
    }
  }
};

// ---- hapdiv annotation (sw_backtrack want_anno; bwa-sw.c:218-259) --------

static int ref_base(const int64_t* acc, int64_t lo) {
  for (int c = 1; c < 7; ++c)
    if (acc[c] > lo) return c - 1;
  return 5;
}

// length-only backtrack returning the edit distance (bwa-sw.c:60-115 walk)
static int backtrack_ed(const Opt& o, const Fmi& f, const Dawg& g,
                        const std::vector<std::vector<Cell>>& rows, int64_t pos) {
  int n_col = o.n_best;
  int last = 0, ed = 0;
  while (pos > 0) {
    int64_t r = pos / n_col;
    const Cell& p = rows[r][pos % n_col];
    int x = p.H_from | (p.E_from << 2) | (p.F_from << 3);
    int state = last == 0 ? (x & 3) : last;
    int ext = (state == 1 || state == 2) ? (x >> (state + 1)) & 1 : 0;
    int c = ref_base(f.acc, p.lo);
    if (state == SW_FROM_H) {
      pos = p.H_from_pos;
      ed += (c != g.c[r]);
    } else if (state == SW_FROM_E) {
      pos = p.E_from_pos;
      ++ed;
    } else {
      pos = r * n_col + p.F_from_off;
      ++ed;
    }
    last = ((state == 1 || state == 2) && ext) ? state : 0;
  }
  return ed;
}

// one hapdiv window over its linear-chain DAWG (dawg.c:230-250 layout:
// node j>=1 carries seq[k-j], single predecessor j-1)
static void hapdiv_one(Engine& eng, const uint8_t* seq, int64_t k, int64_t* out10) {
  std::vector<int32_t> cbuf((size_t)k + 1), pre((size_t)k), pre_off((size_t)k + 2);
  cbuf[0] = -1;
  pre_off[0] = pre_off[1] = 0;
  for (int64_t j = 1; j <= k; ++j) {
    cbuf[j] = seq[k - j];
    pre[j - 1] = (int32_t)(j - 1);
    pre_off[j + 1] = (int32_t)j;
  }
  Dawg g{(int32_t)(k + 1), cbuf.data(), pre_off.data(), pre.data()};
  eng.run(g);
  out10[0] = eng.best_score;
  int64_t n_al = 0, max_ed = 0;
  int64_t n_hap[7] = {0, 0, 0, 0, 0, 0, 0};
  const std::vector<Cell>& prow = eng.rows[k];
  if (!prow.empty()) {
    int32_t H0 = prow[0].H;
    for (size_t idx = 0; idx < prow.size(); ++idx) {
      const Cell& q = prow[idx];
      if (q.flt || q.H_from != SW_FROM_H || q.H < eng.o.min_sc) continue;
      if (eng.o.e2e_drop >= 0 && H0 - q.H > eng.o.e2e_drop) continue;
      ++n_al;
      uint64_t tb = Engine::stats_on() ? __rdtsc() : 0;
      int ed = backtrack_ed(eng.o, eng.f, g, eng.rows, (int64_t)k * eng.o.n_best + (int64_t)idx);
      if (Engine::stats_on()) eng.cyc[7] += __rdtsc() - tb;
      if (ed > max_ed) max_ed = ed;
      n_hap[ed < 6 ? ed : 6] += q.hi - q.lo;
    }
  }
  out10[1] = n_al;
  out10[2] = max_ed;
  for (int i = 0; i < 7; ++i) out10[3 + i] = n_hap[i];
}

// ---- query BWT + prefix DAWG (align/bwtl.py; dawg.c:15-255) --------------

// ---- pooled scratch for query-BWT/DAWG construction ----------------------
// dawg_gen was ~9% of sw e2e (round-5 phase profile): the comparator-sort
// prefix doubling plus three unordered_maps (a node allocation per insert)
// plus a vector-of-vectors predecessor build.  All replaced with pooled
// buffers, counting-radix doubling, and one open-addressing map with a
// packed (deg, cnt, id) value.  Output-invariant: the SA of a string is
// unique, and the map is only ever addressed by key (never iterated).
struct DawgPools {
  std::vector<int32_t> sa, rnk, tmp, cnt, sa2;
  std::vector<uint8_t> s8, sbuf;
  // map: key = lo<<32|hi, value = deg<<42 | cnt<<21 | id (each < 2^21;
  // node counts cap at ~2x the 32 KB max read length)
  std::vector<uint64_t> mk;
  std::vector<int64_t> mv;
  std::vector<uint8_t> mu;
  uint32_t mmask = 0;
  size_t mn = 0;
  std::vector<uint64_t> stack, edges;
  std::vector<int32_t> cur;

  void map_reset(size_t expect) {
    size_t cap = 64;
    while (cap < expect * 2) cap <<= 1;
    if (mk.size() < cap) {
      mk.resize(cap);
      mv.resize(cap);
      mu.assign(cap, 0);
    } else {
      cap = mk.size();
      std::fill(mu.begin(), mu.end(), 0);
    }
    mmask = (uint32_t)cap - 1;
    mn = 0;
  }

  void map_grow() {
    size_t cap = mk.size() * 2;
    std::vector<uint64_t> ok;
    ok.swap(mk);
    std::vector<int64_t> ov;
    ov.swap(mv);
    std::vector<uint8_t> ou;
    ou.swap(mu);
    mk.resize(cap);
    mv.resize(cap);
    mu.assign(cap, 0);
    mmask = (uint32_t)cap - 1;
    for (size_t j = 0; j < ok.size(); ++j) {
      if (!ou[j]) continue;
      uint32_t i = (uint32_t)kh_hash_u64(ok[j]) & mmask;
      while (mu[i]) i = (i + 1) & mmask;
      mu[i] = 1;
      mk[i] = ok[j];
      mv[i] = ov[j];
    }
  }

  int64_t* map_find(uint64_t k) {
    uint32_t i = (uint32_t)kh_hash_u64(k) & mmask;
    while (mu[i]) {
      if (mk[i] == k) return &mv[i];
      i = (i + 1) & mmask;
    }
    return nullptr;
  }

  int64_t& map_get(uint64_t k, bool& absent) {
    if (mn * 4 >= mk.size() * 3) map_grow();
    uint32_t i = (uint32_t)kh_hash_u64(k) & mmask;
    while (mu[i]) {
      if (mk[i] == k) {
        absent = false;
        return mv[i];
      }
      i = (i + 1) & mmask;
    }
    mu[i] = 1;
    mk[i] = k;
    mv[i] = 0;
    ++mn;
    absent = true;
    return mv[i];
  }
};

static DawgPools& dpool() {
  static thread_local DawgPools p;
  return p;
}

// counting-radix prefix doubling into P.sa; the SA of a string is unique,
// so this matches the previous comparator-sort version (and
// construct/sa.suffix_array_doubling) exactly
static void suffix_array_pooled(const uint8_t* s, int32_t n, DawgPools& P) {
  P.sa.resize(n);
  P.rnk.resize(n);
  P.tmp.resize(n);
  P.sa2.resize(n);
  P.cnt.assign((size_t)std::max(n + 1, 257), 0);
  for (int32_t i = 0; i < n; ++i) ++P.cnt[s[i] + 1];
  for (int32_t v = 1; v < 257; ++v) P.cnt[v] += P.cnt[v - 1];
  for (int32_t i = 0; i < n; ++i) P.sa[P.cnt[s[i]]++] = i;
  P.rnk[P.sa[0]] = 0;
  for (int32_t i = 1; i < n; ++i) P.rnk[P.sa[i]] = P.rnk[P.sa[i - 1]] + (s[P.sa[i]] != s[P.sa[i - 1]] ? 1 : 0);
  for (int32_t k = 1; P.rnk[P.sa[n - 1]] != n - 1; k <<= 1) {
    // order by second key (rank[i+k]; absent ranks smallest)
    int32_t p2 = 0;
    for (int32_t i = n - k; i < n; ++i)
      if (i >= 0) P.sa2[p2++] = i;
    for (int32_t i = 0; i < n; ++i)
      if (P.sa[i] >= k) P.sa2[p2++] = P.sa[i] - k;
    // stable counting sort by first key
    std::fill(P.cnt.begin(), P.cnt.begin() + n + 1, 0);
    for (int32_t i = 0; i < n; ++i) ++P.cnt[P.rnk[i] + 1];
    for (int32_t v = 1; v <= n; ++v) P.cnt[v] += P.cnt[v - 1];
    for (int32_t i = 0; i < n; ++i) P.sa[P.cnt[P.rnk[P.sa2[i]]]++] = P.sa2[i];
    P.tmp[P.sa[0]] = 0;
    for (int32_t i = 1; i < n; ++i) {
      int32_t a = P.sa[i - 1], b = P.sa[i];
      int32_t ra = a + k < n ? P.rnk[a + k] : -1;
      int32_t rb = b + k < n ? P.rnk[b + k] : -1;
      P.tmp[b] = P.tmp[a] + ((P.rnk[a] != P.rnk[b] || ra != rb) ? 1 : 0);
    }
    std::copy(P.tmp.begin(), P.tmp.begin() + n, P.rnk.begin());
  }
}

struct Bwtl {  // align/bwtl.py Bwtl (dawg.c:15-103 rb3_bwtl_t)
  int32_t seq_len = 0;
  std::vector<int32_t> sa;   // [n+1], sa[0] = n
  std::vector<uint8_t> bwt;  // [n] 2-bit symbols, $ removed
  std::vector<int32_t> occ;  // checkpoints every 16
  int32_t acc[5] = {0, 0, 0, 0, 0};
  int32_t primary = 0;

  void rank1a(int32_t k, int32_t cnt[4]) const {
    if (k > primary) --k;  // $ is not in bwt
    int32_t blk = k >> 4;
    for (int c = 0; c < 4; ++c) cnt[c] = occ[blk * 4 + c];
    for (int32_t i = blk << 4; i < k; ++i) ++cnt[bwt[i]];
  }
};

static void bwtl_gen_cpp(const uint8_t* seq, int32_t n, Bwtl& q) {
  DawgPools& P = dpool();
  P.s8.resize(n);
  uint8_t* s8 = P.s8.data();
  for (int32_t i = 0; i < n; ++i) s8[i] = seq[i] == 5 ? 1 : seq[i];  // ambiguous -> A
  q.seq_len = n;
  q.sa.assign(n + 1, 0);
  q.sa[0] = n;
  if (n > 0) {
    suffix_array_pooled(s8, n, P);
    for (int32_t i = 0; i < n; ++i) q.sa[i + 1] = P.sa[i];
  }
  q.primary = 0;
  for (int32_t i = 0; i <= n; ++i)
    if (q.sa[i] == 0) {
      q.primary = i;
      break;
    }
  P.sbuf.assign(n + 1, 0);
  std::vector<uint8_t>& s = P.sbuf;
  for (int32_t i = 0; i <= n; ++i)
    if (q.sa[i] != 0) s[i] = s8[q.sa[i] - 1] - 1;
  s.erase(s.begin() + q.primary);  // drop the $ column
  q.bwt.assign(s.begin(), s.begin() + n);
  int32_t occ_len = (n + 16) / 16 * 4;
  q.occ.assign(occ_len, 0);
  int32_t c[4] = {0, 0, 0, 0};
  for (int32_t i = 0; i < n; ++i) {
    if (i % 16 == 0)
      for (int j = 0; j < 4; ++j) q.occ[(i / 16) * 4 + j] = c[j];
    ++c[s[i]];
  }
  if (n % 16 == 0 && (n / 16) * 4 < occ_len)
    for (int j = 0; j < 4; ++j) q.occ[(n / 16) * 4 + j] = c[j];
  q.acc[0] = 1;
  for (int j = 0; j < 4; ++j) q.acc[j + 1] = q.acc[j] + c[j];
}

struct DawgOwned {
  int32_t n_node = 0;
  std::vector<int32_t> c;
  std::vector<int32_t> lo, hi;  // query SA interval per node; hi = -1 for linear
  std::vector<int32_t> pre_off, pre;
  Dawg view() const { return Dawg{n_node, c.data(), pre_off.data(), pre.data()}; }
};

static void dawg_gen_cpp(const Bwtl& q, DawgOwned& g) {  // dawg.c:109-228
  // same three passes as before, on the pooled packed map (deg/cnt/id in
  // one value; see DawgPools) — the map is only addressed by key, so the
  // emitted node order and predecessor order are unchanged
  DawgPools& P = dpool();
  const uint64_t root_key = (uint64_t)(uint32_t)(q.seq_len + 1);  // lo=0, hi=len+1
  P.map_reset((size_t)q.seq_len * 2 + 16);
  {
    bool ab;
    P.map_get(root_key, ab);  // deg 0
  }
  P.stack.assign(1, root_key);
  int32_t rlo4[4], rhi4[4];
  const int64_t DEG1 = (int64_t)1 << 42, CNT1 = (int64_t)1 << 21;
  const int64_t MASK21 = ((int64_t)1 << 21) - 1;
  // pass 1: in-degrees via DFS over distinct SA intervals
  while (!P.stack.empty()) {
    uint64_t x = P.stack.back();
    P.stack.pop_back();
    q.rank1a((int32_t)(x >> 32), rlo4);
    q.rank1a((int32_t)(x & 0xFFFFFFFFu), rhi4);
    for (int c = 3; c >= 0; --c) {
      int32_t lo = q.acc[c] + rlo4[c], hi = q.acc[c] + rhi4[c];
      if (lo == hi) continue;
      uint64_t key = ((uint64_t)(uint32_t)lo << 32) | (uint32_t)hi;
      bool absent;
      int64_t& v = P.map_get(key, absent);
      v += DEG1;
      if (absent) P.stack.push_back(key);
    }
  }
  // pass 2: emit nodes in topological order
  g.c.assign(1, 0);
  g.lo.assign(1, 0);
  g.hi.assign(1, q.seq_len + 1);
  P.stack.assign(1, root_key);
  while (!P.stack.empty()) {
    uint64_t x = P.stack.back();
    P.stack.pop_back();
    q.rank1a((int32_t)(x >> 32), rlo4);
    q.rank1a((int32_t)(x & 0xFFFFFFFFu), rhi4);
    for (int c = 3; c >= 0; --c) {
      int32_t lo = q.acc[c] + rlo4[c], hi = q.acc[c] + rhi4[c];
      if (lo == hi) continue;
      uint64_t key = ((uint64_t)(uint32_t)lo << 32) | (uint32_t)hi;
      int64_t& v = *P.map_find(key);
      v += CNT1;
      if (((v >> 21) & MASK21) == (v >> 42)) {
        v = (v & ~MASK21) | (int64_t)g.c.size();
        g.lo.push_back(lo);
        g.hi.push_back(hi);
        g.c.push_back(c + 1);
        P.stack.push_back(key);
      }
    }
  }
  g.n_node = (int32_t)g.c.size();
  // pass 3: predecessors, in (node, symbol) scan order like the Python
  // spec — collect (target, source) pairs in scan order, then a counting
  // fill reproduces pres[target].push_back(source) exactly
  P.edges.clear();
  g.pre_off.assign(g.n_node + 1, 0);
  for (int32_t i = 0; i < g.n_node; ++i) {
    q.rank1a(g.lo[i], rlo4);
    q.rank1a(g.hi[i], rhi4);
    for (int c = 0; c < 4; ++c) {
      int32_t lo = q.acc[c] + rlo4[c], hi = q.acc[c] + rhi4[c];
      if (lo == hi) continue;
      uint64_t key = ((uint64_t)(uint32_t)lo << 32) | (uint32_t)hi;
      int32_t t = (int32_t)(*P.map_find(key) & MASK21);
      P.edges.push_back(((uint64_t)(uint32_t)t << 32) | (uint32_t)i);
      ++g.pre_off[t + 1];
    }
  }
  for (int32_t t = 1; t <= g.n_node; ++t) g.pre_off[t] += g.pre_off[t - 1];
  g.pre.resize(P.edges.size());
  P.cur.assign(g.pre_off.begin(), g.pre_off.begin() + g.n_node);
  for (uint64_t e : P.edges) g.pre[P.cur[(int32_t)(e >> 32)]++] = (int32_t)(uint32_t)e;
}

static void dawg_linear(const uint8_t* seq, int32_t n, DawgOwned& g) {  // dawg.c:230-250
  g.n_node = n + 1;
  g.c.assign(n + 1, 0);
  g.c[0] = -1;
  g.lo.assign(n + 1, 0);
  g.hi.assign(n + 1, -1);
  g.lo[0] = n;
  g.pre_off.assign(n + 2, 0);
  g.pre.assign(n > 0 ? n : 0, 0);
  for (int32_t j = 1; j <= n; ++j) {
    g.lo[j] = n - j;
    g.c[j] = seq[n - j];
    g.pre[j - 1] = j - 1;
    g.pre_off[j + 1] = j;
  }
}

// ---- SMEM-present prefilter (fm-index.c:530-538; ops/smem_ref.py) --------

static bool smem_present_cpp(const Fmi& f, RankCache& rc, const uint8_t* q, int32_t n, int32_t min_len) {
  int32_t x = 0;
  while (x < n) {
    if (n - x < min_len) return false;
    int c0 = q[x + min_len - 1];
    int comp0 = (c0 >= 1 && c0 <= 4) ? 5 - c0 : c0;
    int64_t ik_lo = f.acc[c0], ik_rc = f.acc[comp0], ik_sz = f.acc[c0 + 1] - f.acc[c0];
    int32_t i = x + min_len - 2;
    Ext e;
    while (i >= x) {
      extend_back(f, ik_lo, ik_rc, ik_sz, e, rc);
      int c = q[i];
      if (e.sz[c] < 1) break;
      ik_lo = e.lo[c];
      ik_rc = e.rc[c];
      ik_sz = e.sz[c];
      --i;
    }
    if (i >= x) {
      x = i + 1;
      continue;
    }
    return true;
  }
  return false;
}

// ---- SMEM-TG per read (fm-index.c:483-528; ops/smem_ref.py smem_tg) ------
// The native `mem` engine (ops/smem_native.py).  smem1_tg is the serial
// form; rb3t_smem_batch runs SmemSM, whose transitions follow it step for
// step.

struct MemRec {
  int64_t st, en, size, lo, lo_rc;
};

static int32_t smem1_tg(const Fmi& f, RankCache& rc, const uint8_t* q, int32_t n, int32_t x,
                        int64_t min_occ, int32_t min_len, std::vector<MemRec>& mems) {
  if (n - x < min_len) return n;
  int c0 = q[x + min_len - 1];
  int comp0 = (c0 >= 1 && c0 <= 4) ? 5 - c0 : c0;
  int64_t ik_lo = f.acc[c0], ik_rc = f.acc[comp0], ik_sz = f.acc[c0 + 1] - f.acc[c0];
  int32_t i = x + min_len - 2;
  Ext e;
  while (i >= x) {
    extend_back(f, ik_lo, ik_rc, ik_sz, e, rc);
    int c = q[i];
    if (e.sz[c] < min_occ) break;
    ik_lo = e.lo[c];
    ik_rc = e.rc[c];
    ik_sz = e.sz[c];
    --i;
  }
  if (i >= x) return i + 1;  // the min_len window does not fully match
  int32_t j = x + min_len;
  static const int COMP[6] = {0, 4, 3, 2, 1, 5};
  while (j < n) {
    int c = COMP[q[j]];
    // forward extend = backward extend on the other strand: swap coordinates
    extend_back(f, ik_rc, ik_lo, ik_sz, e, rc);
    if (e.sz[c] < min_occ) break;
    ik_rc = e.lo[c];
    ik_lo = e.rc[c];
    ik_sz = e.sz[c];
    ++j;
  }
  mems.push_back({x, j, ik_sz, ik_lo, ik_rc});
  if (j == n) return n;
  c0 = q[j];
  comp0 = (c0 >= 1 && c0 <= 4) ? 5 - c0 : c0;
  ik_lo = f.acc[c0];
  ik_rc = f.acc[comp0];
  ik_sz = f.acc[c0 + 1] - f.acc[c0];
  i = j - 1;
  while (i > x) {
    extend_back(f, ik_lo, ik_rc, ik_sz, e, rc);
    int c = q[i];
    if (e.sz[c] < min_occ) break;
    ik_lo = e.lo[c];
    ik_rc = e.rc[c];
    ik_sz = e.sz[c];
    --i;
  }
  return i + 1;
}

static void smem_tg_read(const Fmi& f, RankCache& rc, const uint8_t* q, int32_t n,
                         int64_t min_occ, int32_t min_len, std::vector<MemRec>& mems) {
  mems.clear();
  int32_t x = 0;
  while (x < n) x = smem1_tg(f, rc, q, n, x, min_occ, min_len, mems);
}

// smem_tg_read as a resumable state machine: one extend_back (= two rank1a)
// per step, with the NEXT extend's rank streams prefetched as soon as its
// interval is known, so a thread can interleave G independent reads and hide
// the random-access DRAM latency of the dependent LF chain.  Transition
// order is exactly smem1_tg's, so per-read output is bit-identical.
struct SmemSM {
  static constexpr int PH_B1 = 1, PH_FWD = 2, PH_B2 = 3;
  const uint8_t* q = nullptr;
  int32_t n = 0, x = 0, i = 0, j = 0;
  int64_t ik_lo = 0, ik_rc = 0, ik_sz = 0;
  int phase = 0;
  bool live = false;
  std::vector<MemRec>* mems = nullptr;

  void init_ik(const Fmi& f, int c0) {
    int comp0 = (c0 >= 1 && c0 <= 4) ? 5 - c0 : c0;
    ik_lo = f.acc[c0];
    ik_rc = f.acc[comp0];
    ik_sz = f.acc[c0 + 1] - f.acc[c0];
  }
  void pf_back(const Fmi& f) {
    prefetch_rank(f, ik_lo);
    prefetch_rank(f, ik_lo + ik_sz);
  }
  void pf_fwd(const Fmi& f) {
    prefetch_rank(f, ik_rc);
    prefetch_rank(f, ik_rc + ik_sz);
  }

  // Enter the TG window at x0 (smem1_tg preamble, rank-free): leaves either
  // an extend pending (live) or the read finished (!live).
  void start_window(const Fmi& f, int32_t min_len, int32_t x0) {
    x = x0;
    live = true;
    if (n - x < min_len) {
      live = false;
      return;
    }
    init_ik(f, q[x + min_len - 1]);
    i = x + min_len - 2;
    if (i >= x) {
      phase = PH_B1;
      pf_back(f);
      return;
    }
    j = x + min_len;  // min_len == 1: BACK1 loop is empty
    if (j < n) {
      phase = PH_FWD;
      pf_fwd(f);
      return;
    }
    mems->push_back({x, j, ik_sz, ik_lo, ik_rc});
    live = false;
  }

  void step(const Fmi& f, RankCache& rc, int64_t min_occ, int32_t min_len) {
    static const int COMP[6] = {0, 4, 3, 2, 1, 5};
    Ext e;
    if (phase == PH_FWD) {
      extend_back(f, ik_rc, ik_lo, ik_sz, e, rc);
      int c = COMP[q[j]];
      if (e.sz[c] < min_occ) {
        mems->push_back({x, j, ik_sz, ik_lo, ik_rc});
        init_ik(f, q[j]);  // BACK2 preamble (j < n on this path)
        i = j - 1;
        if (i > x) {
          phase = PH_B2;
          pf_back(f);
          return;
        }
        start_window(f, min_len, i + 1);
        return;
      }
      ik_rc = e.lo[c];
      ik_lo = e.rc[c];
      ik_sz = e.sz[c];
      ++j;
      if (j < n) {
        pf_fwd(f);
        return;
      }
      mems->push_back({x, j, ik_sz, ik_lo, ik_rc});
      live = false;
      return;
    }
    extend_back(f, ik_lo, ik_rc, ik_sz, e, rc);
    int c = q[i];
    bool ok = e.sz[c] >= min_occ;
    if (phase == PH_B1) {
      if (!ok) {
        start_window(f, min_len, i + 1);
        return;
      }
      ik_lo = e.lo[c];
      ik_rc = e.rc[c];
      ik_sz = e.sz[c];
      --i;
      if (i >= x) {
        pf_back(f);
        return;
      }
      j = x + min_len;
      if (j < n) {
        phase = PH_FWD;
        pf_fwd(f);
        return;
      }
      mems->push_back({x, j, ik_sz, ik_lo, ik_rc});
      live = false;
      return;
    }
    // PH_B2
    if (ok) {
      ik_lo = e.lo[c];
      ik_rc = e.rc[c];
      ik_sz = e.sz[c];
      --i;
      if (i > x) {
        pf_back(f);
        return;
      }
    }
    start_window(f, min_len, i + 1);
  }
};

// ---- full backtrack (align/bwasw.py _backtrack1*, _cs_core) --------------

struct Hit {
  int32_t score = 0, qlen = 0, rlen = 0, mlen = 0, blen = 0;
  int64_t lo = 0, hi = 0;
  std::vector<uint32_t> cigar;
  std::vector<uint8_t> rseq;  // one entry per reference-consuming step (rlen total)
  std::vector<int32_t> qoff;
  std::string cs;
};

static int backtrack1_fill(const Opt& o, const Fmi& f, const DawgOwned& g,
                           const std::vector<std::vector<Cell>>& rows, int64_t pos, Hit& hit) {
  int n_col = o.n_best;
  int last = 0, last_op = -1, ed = 0;
  hit.score = rows[pos / n_col][pos % n_col].H;
  hit.rlen = hit.qlen = 0;
  hit.cigar.clear();
  hit.rseq.clear();
  while (pos > 0) {
    int64_t r = pos / n_col;
    const Cell& p = rows[r][pos % n_col];
    int x = p.H_from | (p.E_from << 2) | (p.F_from << 3);
    int state = last == 0 ? (x & 3) : last;
    int ext = (state == 1 || state == 2) ? (x >> (state + 1)) & 1 : 0;
    int c = ref_base(f.acc, p.lo);
    int op = state;
    if (state == SW_FROM_H) {
      op = (c == g.c[r]) ? 7 : 8;
      pos = p.H_from_pos;
      ed += op == 8;
    } else if (state == SW_FROM_E) {
      pos = p.E_from_pos;
      ++ed;
    } else {
      pos = r * n_col + p.F_from_off;
      ++ed;
    }
    // sw_push_state writes rseq[rlen] BEFORE bumping rlen (bwa-sw.c:63): an
    // insertion (op 1) leaves rlen unchanged, so its base is overwritten by
    // the next reference-consuming op and never lands in rseq
    if ((int64_t)hit.rseq.size() == hit.rlen) hit.rseq.push_back((uint8_t)c);
    else hit.rseq[hit.rlen] = (uint8_t)c;
    if (last_op == op) hit.cigar.back() += 1u << 4;
    else hit.cigar.push_back((1u << 4) | (uint32_t)op);
    if (op == 7 || op == 8) {
      ++hit.qlen;
      ++hit.rlen;
    } else if (op == 1) {
      ++hit.qlen;
    } else if (op == 2) {
      ++hit.rlen;
    }
    last_op = op;
    last = ((state == 1 || state == 2) && ext) ? state : 0;
  }
  hit.rseq.resize(hit.rlen);  // drop a trailing insertion's write
  return ed;
}

static const char CS_CH[] = "$acgtn";

static void cs_core(Hit& hit, const uint8_t* qseq) {
  std::string out;
  int64_t x = 0, y = hit.qoff.empty() ? 0 : hit.qoff[0];
  for (uint32_t cval : hit.cigar) {
    int op = cval & 0xF;
    int64_t ln = cval >> 4;
    if (op == 7) {
      out += ':';
      out += std::to_string(ln);
      x += ln;
      y += ln;
    } else if (op == 8) {
      for (int64_t i = 0; i < ln; ++i) {
        out += '*';
        out += CS_CH[qseq[y + i]];
        out += CS_CH[hit.rseq[x + i]];
      }
      x += ln;
      y += ln;
    } else if (op == 1) {
      out += '+';
      for (int64_t i = 0; i < ln; ++i) out += CS_CH[qseq[y + i]];
      y += ln;
    } else if (op == 2) {
      out += '-';
      for (int64_t i = 0; i < ln; ++i) out += CS_CH[hit.rseq[x + i]];
      x += ln;
    }
  }
  hit.cs = std::move(out);
}

static void backtrack1(const Opt& o, const Fmi& f, const DawgOwned& g, const Bwtl* qb,
                       const std::vector<std::vector<Cell>>& rows, const uint8_t* qseq,
                       int64_t pos, Hit& hit) {
  int n_col = o.n_best;
  int64_t r = pos / n_col;
  const Cell& q = rows[r][pos % n_col];
  hit.lo = q.lo;
  hit.hi = q.hi;
  hit.qoff.clear();
  if (g.hi[r] >= 0)
    for (int32_t k = g.lo[r]; k < g.hi[r]; ++k) hit.qoff.push_back(qb->sa[k]);
  else
    hit.qoff.push_back(g.lo[r]);
  backtrack1_fill(o, f, g, rows, pos, hit);
  cs_core(hit, qseq);
  hit.mlen = hit.blen = 0;
  for (uint32_t cval : hit.cigar) {
    int op = cval & 0xF;
    int32_t ln = (int32_t)(cval >> 4);
    hit.blen += ln;
    if (op == 7) hit.mlen += ln;
  }
}

// ---- one full sw read (rb3_sw: prefilter + DAWG + DP + backtrack) --------

// Whether a read can have hits at all: the -j prefilter (sw_read, rb3_sw)
static bool prefilter_pass(const Opt& o, const Fmi& f, RankCache& rc, const uint8_t* seq, int32_t n) {
  return !(o.min_mem_len > 0 && o.min_mem_len > o.end_len) || smem_present_cpp(f, rc, seq, n, o.min_mem_len);
}

// The read's DAWG: the linear chain for e2e, else the prefix DAWG of its
// query BWT `qb` (which the backtrack reads for qoff)
static void make_dawg(const Opt& o, const uint8_t* seq, int32_t n, Bwtl& qb, DawgOwned& g) {
  if (o.flag & RB3_SWF_E2E) {
    dawg_linear(seq, n, g);
  } else {
    bwtl_gen_cpp(seq, n, qb);
    dawg_gen_cpp(qb, g);
  }
}

// The hits of a scored read (sw_read's tail): every kept FROM_H cell of the
// last row for e2e, else one hit from best_pos.
static void select_hits(const Opt& o, const Fmi& f, const DawgOwned& g, const Bwtl& qb,
                        const std::vector<std::vector<Cell>>& rows, const uint8_t* seq, int64_t best_pos,
                        std::vector<Hit>& hits) {
  int n_col = o.n_best;
  if (o.flag & RB3_SWF_E2E) {
    const std::vector<Cell>& prow = rows[g.n_node - 1];
    if (prow.empty()) return;
    int32_t H0 = prow[0].H;
    for (size_t i = 0; i < prow.size(); ++i) {
      const Cell& q = prow[i];
      if (q.flt || q.H_from != SW_FROM_H || q.H < o.min_sc) continue;
      if (o.e2e_drop >= 0 && H0 - q.H > o.e2e_drop) continue;
      hits.emplace_back();
      backtrack1(o, f, g, &qb, rows, seq, (int64_t)(g.n_node - 1) * n_col + (int64_t)i, hits.back());
    }
  } else {
    hits.emplace_back();
    backtrack1(o, f, g, &qb, rows, seq, best_pos, hits.back());
  }
}

static void sw_read(Engine& eng, const uint8_t* seq, int32_t n, std::vector<Hit>& hits) {
  const Opt& o = eng.o;
  hits.clear();
  if (!prefilter_pass(o, eng.f, eng.cache, seq, n)) return;
  DawgOwned g;
  Bwtl qb;
  const bool st = Engine::stats_on();
  uint64_t tg = st ? __rdtsc() : 0;
  make_dawg(o, seq, n, qb, g);
  if (st) eng.cyc[6] += __rdtsc() - tg;
  eng.run(g.view());
  if (eng.best_score < o.min_sc) return;
  uint64_t tb = st ? __rdtsc() : 0;
  select_hits(o, eng.f, g, qb, eng.rows, seq, eng.best_pos, hits);
  if (st) eng.cyc[7] += __rdtsc() - tb;
}

// ---- hit blob serialization ----------------------------------------------

static void put_i64(std::string& s, int64_t v) { s.append((const char*)&v, 8); }
static void put_bytes(std::string& s, const void* p, size_t n) { s.append((const char*)p, n); }
static void pad8(std::string& s) {
  while (s.size() & 7) s.push_back(0);
}

static void serialize_hits(const std::vector<Hit>& hits, std::string& b) {
  put_i64(b, (int64_t)hits.size());
  for (const Hit& h : hits) {
    put_i64(b, h.score);
    put_i64(b, h.qlen);
    put_i64(b, h.rlen);
    put_i64(b, h.mlen);
    put_i64(b, h.blen);
    put_i64(b, h.lo);
    put_i64(b, h.hi);
    put_i64(b, (int64_t)h.cigar.size());
    put_i64(b, (int64_t)h.qoff.size());
    put_i64(b, (int64_t)h.rseq.size());
    put_i64(b, (int64_t)h.cs.size());
    put_bytes(b, h.cigar.data(), h.cigar.size() * 4);
    put_bytes(b, h.qoff.data(), h.qoff.size() * 4);
    put_bytes(b, h.rseq.data(), h.rseq.size());
    put_bytes(b, h.cs.data(), h.cs.size());
    pad8(b);
  }
}

// [n_reads+1 int64 blob offsets][the blobs], malloc'd (rb3t_buf_free)
static uint8_t* pack_blobs(const std::vector<std::string>& blobs, int64_t* out_len) {
  const int64_t n_reads = (int64_t)blobs.size();
  std::vector<int64_t> offs(n_reads + 1);
  int64_t total = 0;
  for (int64_t r = 0; r < n_reads; ++r) {
    offs[r] = total;
    total += (int64_t)blobs[r].size();
  }
  offs[n_reads] = total;
  int64_t head = (n_reads + 1) * 8;
  uint8_t* buf = (uint8_t*)std::malloc((size_t)(head + total));
  if (!buf) {
    *out_len = 0;
    return nullptr;
  }
  std::memcpy(buf, offs.data(), (size_t)head);
  uint8_t* p = buf + head;
  for (int64_t r = 0; r < n_reads; ++r) {
    std::memcpy(p, blobs[r].data(), blobs[r].size());
    p += blobs[r].size();
  }
  *out_len = head + total;
  return buf;
}

// n_threads workers (at most one an item) each run work(cursor), claiming
// items from the shared cursor until none are left
template <class Work>
static void run_workers(int64_t n_items, int32_t n_threads, Work work) {
  std::atomic<int64_t> cursor(0);
  if (n_threads <= 1 || n_items < 2) {
    work(cursor);
    return;
  }
  std::vector<std::thread> th;
  for (int32_t t = 0; t < n_threads && t < n_items; ++t) th.emplace_back([&]() { work(cursor); });
  for (std::thread& t : th) t.join();
}

// ---- the device engine's host halves (align/sw.py SwDeviceEngine) --------

// Cell j of an archive row as the host backtrack's Cell (rebuild_rows,
// sw_jax.py:609-643): E and F as indicator values, flt 0, rlen and qlen 0
// (the walk reads neither), the 5-bit F_from_off and the 16-bit positions
// with their "unset" codes; lo, hi and lo_rc as uint32.
static Cell arch_cell(uint32_t lo, uint32_t hi, uint32_t rc, int64_t w) {
  Cell c = cell_zero();
  c.lo = lo, c.hi = hi, c.lo_rc = rc;
  c.H = (int32_t)((w >> 1) & 0xFFF);
  c.H_from = (uint8_t)((w >> 13) & 3);
  c.E_from = (uint8_t)((w >> 15) & 1);
  c.F_from = (uint8_t)((w >> 16) & 1);
  c.F_off_set = (uint8_t)((w >> 17) & 1);
  c.F_from_off = c.F_off_set ? (uint32_t)((w >> 18) & 0x1F) : SW_F_UNSET;
  const uint32_t hp = (uint32_t)((w >> 23) & 0xFFFF), ep = (uint32_t)((w >> 39) & 0xFFFF);
  c.H_from_pos = hp != 0xFFFF ? hp : U32MAX;
  c.E_from_pos = ep != 0xFFFF ? ep : U32MAX;
  c.E = c.E_from_pos != U32MAX;
  c.F = c.F_off_set;
  return c;
}

}  // namespace

extern "C" {

// Batched hapdiv windows (equal length k, nt6-coded), threaded.
// out[w*10] = [best_score, n_al, max_ed, n_hap[0..6]]
void rb3t_hapdiv_batch(const uint8_t* bwt, const uint16_t* occ_block, const int64_t* occ_super,
                       const int64_t* acc, int64_t n, const int32_t* opt9, const uint8_t* seqs,
                       int64_t n_win, int64_t k, int32_t n_threads, int64_t* out,
                       const uint8_t* pline) {
  Fmi f{bwt, occ_block, occ_super, acc, n, nullptr, (const PlRec*)pline};
  Opt o = opt_from(opt9);
  // dynamic claiming (out rows are per-window; schedule can't reorder them)
  std::atomic<uint64_t> agg[8] = {{0}, {0}, {0}, {0}, {0}, {0}, {0}, {0}};
  run_workers(n_win, n_threads, [&](std::atomic<int64_t>& cursor) {
    Engine eng;
    eng.f = f;
    eng.o = o;
    eng.cache.rebits(13);  // hapdiv DP cache optimum (see RankCache::rebits)
    for (int64_t w; (w = cursor.fetch_add(1, std::memory_order_relaxed)) < n_win;)
      hapdiv_one(eng, seqs + w * k, k, out + w * 10);
    for (int i = 0; i < 8; ++i) agg[i] += eng.cyc[i];
  });
  if (Engine::stats_on()) {
    static const char* nm[8] = {"HE-loop", "prune", "topn", "closure", "rebuild", "extends", "dawggen", "backtrack"};
    for (int i = 0; i < 8; ++i)
      fprintf(stderr, "[dp-stats] %-9s %12.3f Gcyc\n", nm[i], (double)agg[i].load() / 1e9);
  }
}


// Batched full sw reads (prefilter + DAWG + DP + backtrack), threaded.
// seqs: concatenated nt6 reads, seq_off: [n_reads+1] offsets.  Returns a
// malloc'd buffer: [n_reads+1 int64 blob offsets][per-read hit blobs]
// (layout in serialize_hits); caller frees with rb3t_buf_free.
uint8_t* rb3t_sw_batch(const uint8_t* bwt, const uint16_t* occ_block, const int64_t* occ_super,
                       const int64_t* acc, int64_t n, const int32_t* opt10, const uint8_t* seqs,
                       const int64_t* seq_off, int64_t n_reads, int32_t n_threads,
                       int64_t* out_len, const uint8_t* pline) {
  Fmi f{bwt, occ_block, occ_super, acc, n, nullptr, (const PlRec*)pline};
  Opt o = opt_from(opt10);
  std::vector<std::string> blobs(n_reads);
  // dynamic claiming (blobs are per-read; schedule can't reorder output)
  std::atomic<uint64_t> agg[8] = {{0}, {0}, {0}, {0}, {0}, {0}, {0}, {0}};
  run_workers(n_reads, n_threads, [&](std::atomic<int64_t>& cursor) {
    Engine eng;
    eng.f = f;
    eng.o = o;
    std::vector<Hit> hits;
    for (int64_t r; (r = cursor.fetch_add(1, std::memory_order_relaxed)) < n_reads;) {
      sw_read(eng, seqs + seq_off[r], (int32_t)(seq_off[r + 1] - seq_off[r]), hits);
      serialize_hits(hits, blobs[r]);
    }
    for (int i = 0; i < 8; ++i) agg[i] += eng.cyc[i];
  });
  if (Engine::stats_on()) {
    static const char* nm[8] = {"HE-loop", "prune", "topn", "closure", "rebuild", "extends", "dawggen", "backtrack"};
    for (int i = 0; i < 8; ++i)
      fprintf(stderr, "[dp-stats] %-9s %12.3f Gcyc\n", nm[i], (double)agg[i].load() / 1e9);
  }
  return pack_blobs(blobs, out_len);
}

// The device engine's staging: for each read, the -j prefilter's verdict
// (pass[r]), and for a read that passes, its DAWG's n_node and largest
// in-degree; a DAWG of at most ncap nodes and in-degree pcap also lands in
// node_c (n_reads, ncap) int32 (each node's edge symbol, the root's 0) and
// pre (n_reads, ncap, pcap) int32 (its predecessors, -1 after the last), the
// arrays sw_jax.py _run_bucket stages.  Rows of other reads are not written.
void rb3t_sw_stage(const uint8_t* bwt, const uint16_t* occ_block, const int64_t* occ_super, const int64_t* acc,
                   int64_t n, const int32_t* opt10, const uint8_t* seqs, const int64_t* seq_off, int64_t n_reads,
                   int32_t n_threads, int32_t ncap, int32_t pcap, uint8_t* pass, int32_t* n_node, int32_t* max_pre,
                   int32_t* node_c, int32_t* pre) {
  const Fmi f{bwt, occ_block, occ_super, acc, n, nullptr, nullptr};
  const Opt o = opt_from(opt10);
  run_workers(n_reads, n_threads, [&](std::atomic<int64_t>& cursor) {
    RankCache rc{12};
    DawgOwned g;
    Bwtl qb;
    for (int64_t r; (r = cursor.fetch_add(1, std::memory_order_relaxed)) < n_reads;) {
      const uint8_t* seq = seqs + seq_off[r];
      const int32_t len = (int32_t)(seq_off[r + 1] - seq_off[r]);
      n_node[r] = max_pre[r] = 0;
      pass[r] = prefilter_pass(o, f, rc, seq, len);
      if (!pass[r]) continue;
      make_dawg(o, seq, len, qb, g);
      int32_t mp = 0;
      for (int32_t i = 0; i < g.n_node; ++i) mp = std::max(mp, g.pre_off[i + 1] - g.pre_off[i]);
      n_node[r] = g.n_node, max_pre[r] = mp;
      if (g.n_node > ncap || mp > pcap) continue;
      int32_t* nc = node_c + r * (int64_t)ncap;
      int32_t* pr = pre + r * (int64_t)ncap * pcap;
      for (int32_t i = 0; i < ncap; ++i) {
        nc[i] = i < g.n_node ? std::max(g.c[i], 0) : 0;
        const int32_t deg = i < g.n_node ? g.pre_off[i + 1] - g.pre_off[i] : 0;
        for (int32_t p = 0; p < pcap; ++p) pr[(int64_t)i * pcap + p] = p < deg ? g.pre[g.pre_off[i] + p] : -1;
      }
    }
  });
}

// The device engine's finish: m reads scored on the card, read sel[i] of
// seqs / seq_off, its archive rows from row arch_row[i] of arch_lo, arch_hi,
// arch_rc (uint32 bits as int32) and arch_w (int64; sw_jax.py _pack_arch),
// n_best cells a row, one row a node of its DAWG.  For a read whose best_sc
// reaches min_sc: the rows rebuilt, the last row's containment dedup
// (Engine::cell_dedup), the DAWG and query BWT made again and the backtrack
// of sw_read; the hits serialized as rb3t_sw_batch does.
uint8_t* rb3t_sw_finish(const uint8_t* bwt, const uint16_t* occ_block, const int64_t* occ_super, const int64_t* acc,
                        int64_t n, const int32_t* opt10, const uint8_t* seqs, const int64_t* seq_off,
                        const int64_t* sel, int64_t m, int32_t n_threads, const int32_t* arch_lo,
                        const int32_t* arch_hi, const int32_t* arch_rc, const int64_t* arch_w,
                        const int64_t* arch_row, const int32_t* best_sc, const int32_t* best_pos, int64_t* out_len) {
  const Fmi f{bwt, occ_block, occ_super, acc, n, nullptr, nullptr};
  const Opt o = opt_from(opt10);
  std::vector<std::string> blobs(m);
  run_workers(m, n_threads, [&](std::atomic<int64_t>& cursor) {
    std::vector<std::vector<Cell>> rows;
    std::vector<Hit> hits;
    DawgOwned g;
    Bwtl qb;
    for (int64_t i; (i = cursor.fetch_add(1, std::memory_order_relaxed)) < m;) {
      hits.clear();
      if (best_sc[i] >= o.min_sc) {
        const uint8_t* seq = seqs + seq_off[sel[i]];
        make_dawg(o, seq, (int32_t)(seq_off[sel[i] + 1] - seq_off[sel[i]]), qb, g);
        if ((int32_t)rows.size() < g.n_node) rows.resize(g.n_node);
        for (int32_t r = 0; r < g.n_node; ++r) {
          rows[r].clear();
          const int64_t base = (arch_row[i] + r) * (int64_t)o.n_best;
          for (int32_t j = 0; j < o.n_best && (arch_w[base + j] & 1); ++j)
            rows[r].push_back(arch_cell((uint32_t)arch_lo[base + j], (uint32_t)arch_hi[base + j],
                                        (uint32_t)arch_rc[base + j], arch_w[base + j]));
        }
        Engine::cell_dedup(rows[g.n_node - 1]);
        select_hits(o, f, g, qb, rows, seq, best_pos[i], hits);
      }
      serialize_hits(hits, blobs[i]);
    }
  });
  return pack_blobs(blobs, out_len);
}

// Build the pline record table (one 64-B PlRec per 128 symbols; see PlRec).
// n_recs = (n >> 7) + 1; counts come from the existing per-64-block rows
// (record b starts exactly at 64-block 2b); plane bits read the bwt buffer,
// zero-filling past n_pad (the buffer is padded one 64-block past n, which
// covers every in-range rank query — bits beyond n are never counted).
void rb3t_pline_build(const uint8_t* bwt, const uint16_t* occ_block, int64_t n_recs,
                      int64_t n_pad, uint8_t* out, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      PlRec* r = (PlRec*)out + b;
      std::memset(r, 0, sizeof(PlRec));
      std::memcpy(r->cnt, occ_block + (size_t)b * 2 * 6, 12);
      int64_t base = b << PL_SHIFT;
      int lim = (int)std::min<int64_t>(128, n_pad - base);
      for (int i = 0; i < lim; ++i) {
        uint64_t s = bwt[base + i];
        int w = i >> 6, bit = i & 63;
        r->p[w] |= (s & 1) << bit;
        r->p[2 + w] |= ((s >> 1) & 1) << bit;
        r->p[4 + w] |= ((s >> 2) & 1) << bit;
      }
    }
  };
  if (n_threads == 1 || n_recs < (int64_t)1 << 16) {
    work(0, n_recs);
    return;
  }
  std::vector<std::thread> th;
  int64_t per = (n_recs + n_threads - 1) / n_threads;
  for (int32_t t = 1; t < n_threads; ++t) {
    int64_t a = per * t, b = std::min(n_recs, a + per);
    if (a < b) th.emplace_back(work, a, b);
  }
  work(0, std::min(n_recs, per));
  for (auto& x : th) x.join();
}

// Batched SMEM-TG (threaded CPU engine) over the split rows, or the pline
// records when `pline` is given.  Returns a malloc'd buffer:
// [n_reads+1 int64 blob offsets][per read: int64 n_mems, then n_mems x
// (st,en,size,lo,lo_rc) int64 rows]; free with rb3t_buf_free.
uint8_t* rb3t_smem_batch(const uint8_t* bwt, const uint16_t* occ_block, const int64_t* occ_super,
                         const int64_t* acc, int64_t n, int64_t min_occ, int32_t min_len,
                         const uint8_t* seqs, const int64_t* seq_off, int64_t n_reads,
                         int32_t n_threads, int64_t* out_len, const uint8_t* pline) {
  Fmi f{bwt, occ_block, occ_super, acc, n, nullptr, (const PlRec*)pline};
  if (n_threads < 1) n_threads = 1;
  std::vector<std::string> blobs(n_reads);
  constexpr int G = 16;  // reads interleaved per thread (latency hiding)
  // dynamic per-read claiming instead of a static range split: when a core
  // is partially stolen (e.g. the device engine's thread during
  // --engine=hybrid), a static partition makes that thread the straggler
  // for the whole call.  blobs[] is indexed by global read id, so the
  // schedule cannot change any output byte.
  std::atomic<int64_t> cursor(0);
  auto work = [&]() {
    // with the one-line pline records the rank cache's hit value drops but
    // its 3.5 MB footprint cost stays: 2^12 entries with them
    RankCache rc(f.pline ? 12 : 16);
    std::vector<SmemSM> sm(G);
    std::vector<std::vector<MemRec>> memv(G);
    std::vector<int64_t> rid(G);
    auto flush = [&](int gi) {
      std::string& b = blobs[rid[gi]];
      put_i64(b, (int64_t)memv[gi].size());
      put_bytes(b, memv[gi].data(), memv[gi].size() * sizeof(MemRec));
    };
    for (;;) {
      bool any = false;
      for (int gi = 0; gi < G; ++gi) {
        while (!sm[gi].live) {
          int64_t r = cursor.fetch_add(1, std::memory_order_relaxed);
          if (r >= n_reads) break;
          rid[gi] = r;
          memv[gi].clear();
          sm[gi].q = seqs + seq_off[r];
          sm[gi].n = (int32_t)(seq_off[r + 1] - seq_off[r]);
          sm[gi].mems = &memv[gi];
          sm[gi].start_window(f, min_len, 0);
          if (!sm[gi].live) flush(gi);
        }
        if (sm[gi].live) {
          any = true;
          sm[gi].step(f, rc, min_occ, min_len);
          if (!sm[gi].live) flush(gi);
        }
      }
      if (!any) break;
    }
  };
  if (n_threads == 1 || n_reads < 2) {
    work();
  } else {
    std::vector<std::thread> th;
    for (int32_t t = 0; t < n_threads && t < n_reads; ++t) th.emplace_back(work);
    for (std::thread& t : th) t.join();
  }
  return pack_blobs(blobs, out_len);
}

void rb3t_buf_free(void* p) { std::free(p); }

// Interleave B1 (bwt1, length n1) with B2 (seq2, length n2) into merged:
// the host half of a merge whose B1 lives in host memory
// (construct/merge.py merge_host; ropebwt3_tpu/native/bwasw_core.cpp:2067).
// B2 symbol i lands at position ins[i]+i, B1 symbols fill the gaps in order.
void rb3t_merge_apply(const uint8_t* bwt1, int64_t n1, const uint8_t* seq2, const int64_t* ins,
                      int64_t n2, uint8_t* merged) {
  int64_t n = n1 + n2;
  int nt = (int)std::thread::hardware_concurrency();
  if (nt > 8) nt = 8;
  if (nt < 2 || n < (int64_t)1 << 22) {
    memset(merged, 0xFF, (size_t)n);
    for (int64_t i = 0; i < n2; i++) merged[ins[i] + i] = seq2[i];
    int64_t j = 0;
    for (int64_t p = 0; p < n; p++)
      if (merged[p] == 0xFF) merged[p] = bwt1[j++];
    return;
  }
  // phase 1: per-chunk histogram of B2 target positions (chunking the merged
  // array), so the gap-fill can run chunk-parallel with exact B1 offsets
  std::vector<int64_t> bound(nt + 1);
  for (int t = 0; t <= nt; t++) bound[t] = n * t / nt;
  std::vector<std::vector<int64_t>> hist(nt);
  {
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
      th.emplace_back([&, t] {
        auto& h = hist[t];
        h.assign(nt, 0);
        int64_t a = n2 * t / nt, b = n2 * (t + 1) / nt;
        for (int64_t i = a; i < b; i++) {
          int64_t p = ins[i] + i;
          int c = (int)((p * nt) / n);  // approx, then align to floor bounds
          if (c > nt - 1) c = nt - 1;
          while (p >= bound[c + 1]) c++;
          while (p < bound[c]) c--;
          h[c]++;
        }
      });
    for (auto& t : th) t.join();
  }
  {
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
      th.emplace_back([&, t] {
        int64_t a = n * t / nt, b = n * (t + 1) / nt;
        memset(merged + a, 0xFF, (size_t)(b - a));
      });
    for (auto& t : th) t.join();
  }
  {
    // parallel scatter of B2 symbols (disjoint random targets)
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
      th.emplace_back([=] {
        int64_t a = n2 * t / nt, b = n2 * (t + 1) / nt;
        for (int64_t i = a; i < b; i++) {
          if (i + 16 < b) __builtin_prefetch(&merged[ins[i + 16] + i + 16], 1, 0);
          merged[ins[i] + i] = seq2[i];
        }
      });
    for (auto& t : th) t.join();
  }
  {
    // chunk c of merged contains (b2_in_chunk) B2 symbols; B1 fills the rest
    // in order, so chunk c's B1 read offset = chunk_start - B2_before_chunk
    std::vector<int64_t> b2_before(nt + 1, 0);
    for (int c = 0; c < nt; c++) {
      int64_t s = 0;
      for (int t = 0; t < nt; t++) s += hist[t][c];
      b2_before[c + 1] = b2_before[c] + s;
    }
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
      th.emplace_back([&, t] {
        int64_t a = n * t / nt, b = n * (t + 1) / nt;
        int64_t j = a - b2_before[t];
        for (int64_t p = a; p < b; p++)
          if (merged[p] == 0xFF) merged[p] = bwt1[j++];
      });
    for (auto& t : th) t.join();
  }
}

}  // extern "C"
