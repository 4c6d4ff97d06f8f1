// Native host codec of the port: the FMD ("RLD\3") decoder and encoder
// behind formats/fmd.py, the run expansion and one-pass dense tables behind
// index/dense.py, and the run-block row builder behind ops/runblock.py.
//
// The functions the port calls, copied from ropebwt3_tpu/native/rld_codec.cpp
// (the per-block count pass is left out).  Bit-exact with the rld0 on-disk
// format (reference rld0.c:45-243).  Built with g++ at first use and loaded
// with ctypes (native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int LBITS = 23;
constexpr int64_t LSIZE = 1LL << LBITS;
constexpr uint64_t DEC_TAB = 0x333333335555779bULL;

inline int ilog2_64(uint64_t v) { return v ? 63 - __builtin_clzll(v) : -1; }

struct DeltaCode {
    uint64_t code;
    int width;
};

inline DeltaCode delta_enc(uint64_t l) {
    int y = ilog2_64(l);
    int z = ilog2_64((uint64_t)(y + 1));
    DeltaCode d;
    d.width = (z << 1) + 1 + y;
    d.code = (l ^ (1ULL << y)) | ((uint64_t)(y + 1) << y);
    return d;
}

// rld_enc / rld_enc_finish / rld_rank_index (rld0.c:107-204) for the DNA
// alphabet (asize 6, 3-bit symbols, sbits 3).
struct Encoder {
    int asize = 6, asize1 = 7, sbits = 3, ssize = 8;
    int off0[3];
    std::vector<uint64_t> words;
    int64_t shead = 0, p = 0;
    int r = 64;
    int64_t cnt[7] = {0}, mcnt[7] = {0};
    int pend_c = -1;
    int64_t pend_l = 0;
    int64_t n_bytes = 0;
    int ibits = 0;
    int64_t n_frames = 0;
    std::vector<uint64_t> frame;
    int64_t final_mcnt[7];

    Encoder() {
        off0[0] = (asize1 * 16 + 63) / 64;
        off0[1] = (asize1 * 32 + 63) / 64;
        off0[2] = asize1;
        words.resize(1 << 16, 0);
        p = off0[0];
    }

    void grow(int64_t need) {
        if (need >= (int64_t)words.size()) {
            size_t ns = words.size() * 2;
            while ((int64_t)ns <= need) ns *= 2;
            words.resize(ns, 0);
        }
    }

    int64_t stail(int64_t sh) const {
        bool last_in_seg = (sh % LSIZE) + ssize == LSIZE;
        return sh + ssize - (last_in_seg ? 2 : 1);
    }

    void next_block() {
        int64_t st = stail(shead);
        if ((st % LSIZE) + 2 == LSIZE)
            shead = (shead / LSIZE + 1) * LSIZE;
        else
            shead += ssize;
        grow(shead + ssize);
        int64_t marg0 = cnt[0] - mcnt[0];
        int typ;
        if (marg0 < 0x4000) typ = 0;
        else if (marg0 < 0x40000000LL) typ = 1;
        else typ = 2;
        if (typ == 0) {
            uint16_t *q = (uint16_t *)&words[shead];
            for (int i = 0; i < asize1; ++i) q[i] = (uint16_t)(cnt[i] - mcnt[i]);
        } else if (typ == 1) {
            uint32_t *q = (uint32_t *)&words[shead];
            for (int i = 0; i < asize1; ++i) q[i] = (uint32_t)(cnt[i] - mcnt[i]);
        } else {
            uint64_t *q = &words[shead];
            for (int i = 0; i < asize1; ++i) q[i] = (uint64_t)(cnt[i] - mcnt[i]);
        }
        words[shead] |= (uint64_t)typ << 62;
        p = shead + off0[typ];
        r = 64;
        memcpy(mcnt, cnt, sizeof(cnt));
    }

    void enc1(int64_t l, int c) {
        DeltaCode d = delta_enc((uint64_t)l);
        uint64_t x = d.code << 3 | (unsigned)c;
        int w = d.width + 3;
        if (w >= r && p == stail(shead)) next_block();
        if (w > r) {
            int w2 = w - r;
            words[p] |= x >> w2;
            ++p;
            r = 64 - w2;
            words[p] = x << r;
        } else {
            r -= w;
            words[p] |= x << r;
        }
        cnt[0] += l;
        cnt[c + 1] += l;
    }

    void put(int64_t l, int c) {
        if (l == 0) return;
        if (pend_c != c) {
            if (pend_l) enc1(pend_l, pend_c);
            pend_c = c;
            pend_l = l;
        } else {
            pend_l += l;
        }
    }

    void finish() {
        if (pend_l) enc1(pend_l, pend_c);
        next_block();
        n_bytes = p * 8;
        for (int i = 0; i < asize1; ++i) final_mcnt[i] = cnt[i];
        build_frames();
    }

    void build_frames() {
        int64_t n_blks = n_bytes * 8 / 64 / ssize + 1;
        int64_t last = (n_bytes >> 3) >> sbits << sbits;
        int64_t tot = final_mcnt[0];
        ibits = ilog2_64((uint64_t)(tot / n_blks)) + 4;
        n_frames = ((tot + (1LL << ibits) - 1) >> ibits) + 1;
        frame.assign((size_t)(n_frames * asize1), 0);
        int64_t cnt6[6] = {0};
        int64_t k = 1;
        for (int64_t i = ssize; i <= last; i += ssize) {
            uint64_t w0 = words[i];
            int typ = (int)(w0 >> 62);
            if (typ == 0) {
                const uint16_t *q = (const uint16_t *)&words[i];
                for (int j = 1; j < asize1; ++j) cnt6[j - 1] += q[j];
            } else if (typ == 1) {
                const uint32_t *q = (const uint32_t *)&words[i];
                for (int j = 1; j < asize1; ++j) cnt6[j - 1] += q[j] & 0x3fffffffu;
            } else {
                const uint64_t *q = &words[i];
                for (int j = 1; j < asize1; ++j) cnt6[j - 1] += q[j];
            }
            int64_t sum = 0;
            for (int j = 0; j < 6; ++j) sum += cnt6[j];
            while (sum >= (k << ibits)) ++k;
            if (k < n_frames) {
                int64_t x = k * asize1;
                frame[x] = (uint64_t)i;
                for (int j = 0; j < 6; ++j) frame[x + j + 1] = (uint64_t)cnt6[j];
            }
        }
        for (int64_t kk = 1; kk < n_frames; ++kk) {
            int64_t x = kk * asize1;
            if (frame[x] == 0)
                for (int j = 0; j < asize1; ++j) frame[x + j] = frame[x - asize1 + j];
        }
    }
};

}  // namespace

extern "C" {

// Decode an FMD byte buffer into run arrays.  Two modes:
//   syms == NULL: return the number of (merged) runs, or -1 on format error.
//   syms != NULL: fill syms/lens (capacity cap) and return the count.
int64_t rb3t_fmd_decode(const uint8_t *data, int64_t size, uint8_t *syms, int64_t *lens, int64_t cap) {
    if (size < 32 || memcmp(data, "RLD\x03", 4) != 0) return -1;
    uint32_t a;
    memcpy(&a, data + 4, 4);
    int asize = a >> 16, sbits = a & 0xffff;
    int asize1 = asize + 1;
    int off0[3] = {(asize1 * 16 + 63) / 64, (asize1 * 32 + 63) / 64, asize1};
    uint64_t n_bytes;
    memcpy(&n_bytes, data + 16, 8);
    const uint64_t *words = (const uint64_t *)(data + 32 + 8 * asize);
    int64_t ssize = 1LL << sbits;
    int64_t last = ((int64_t)n_bytes >> 3) >> sbits << sbits;
    int64_t n = 0;
    int last_c = -1;
    int64_t shead = 0;
    while (shead < last) {
        int64_t stail = shead + ssize - (((shead % LSIZE) + ssize == LSIZE) ? 2 : 1);
        uint64_t w0 = words[shead];
        int typ = (int)(w0 >> 62);
        int64_t p = shead + off0[typ];
        int r = 64;
        while (1) {
            uint64_t x = words[p] << (64 - r);
            if (p != stail && r != 64) x |= words[p + 1] >> r;
            int64_t run_l;
            int w;
            if (x >> 63) {
                run_l = 1;
                w = 1;
            } else {
                w = (int)(DEC_TAB >> ((x >> 59) << 2) & 0xf);
                if (w == 0xb && (x >> 58) == 0) break;
                int64_t y = (int64_t)(x >> (64 - w)) - 1;
                run_l = (int64_t)((x << w) >> (64 - y)) | (1LL << y);
                w += (int)y;
            }
            int c = (int)((x << w) >> 61);
            w += 3;
            if (c > asize) break;
            if (r > w) r -= w;
            else { ++p; r = 64 + r - w; }
            if (c == last_c) {
                if (syms) lens[n - 1] += run_l;
            } else {
                if (syms) {
                    if (n >= cap) return -2;
                    syms[n] = (uint8_t)c;
                    lens[n] = run_l;
                }
                ++n;
                last_c = c;
            }
        }
        if ((shead % LSIZE) + 2 * ssize > LSIZE)
            shead = (shead / LSIZE + 1) * LSIZE;
        else
            shead += ssize;
    }
    return n;
}

// Encode runs into a malloc'd FMD byte buffer; the caller frees it with
// rb3t_free.  Adjacent runs of one symbol merge, as rld_enc does.
uint8_t *rb3t_fmd_encode(const uint8_t *syms, const int64_t *lens, int64_t n_runs, int64_t *out_size) {
    Encoder e;
    for (int64_t i = 0; i < n_runs; ++i) e.put(lens[i], syms[i]);
    e.finish();
    int64_t data_bytes = e.n_bytes;
    int64_t total = 4 + 4 + 8 + 8 + 8 + 8 * 6 + data_bytes + 8 * e.n_frames * 7;
    uint8_t *out = (uint8_t *)malloc((size_t)total);
    if (out == nullptr) return nullptr;
    uint8_t *q = out;
    memcpy(q, "RLD\x03", 4); q += 4;
    uint32_t a = (uint32_t)(6 << 16 | 3);
    memcpy(q, &a, 4); q += 4;
    uint64_t zero = 0;
    memcpy(q, &zero, 8); q += 8;
    uint64_t nb = (uint64_t)data_bytes;
    memcpy(q, &nb, 8); q += 8;
    uint64_t nf = (uint64_t)e.n_frames;
    memcpy(q, &nf, 8); q += 8;
    for (int i = 1; i <= 6; ++i) {
        uint64_t v = (uint64_t)e.final_mcnt[i];
        memcpy(q, &v, 8); q += 8;
    }
    memcpy(q, e.words.data(), (size_t)data_bytes); q += data_bytes;
    memcpy(q, e.frame.data(), (size_t)(8 * e.n_frames * 7));
    *out_size = total;
    return out;
}

void rb3t_free(void *p) { free(p); }

// Expand runs into a dense symbol array (helper for fast index loading).
void rb3t_runs_expand(const uint8_t *syms, const int64_t *lens, int64_t n_runs, uint8_t *out) {
    int64_t off = 0;
    for (int64_t i = 0; i < n_runs; ++i) {
        memset(out + off, syms[i], (size_t)lens[i]);
        off += lens[i];
    }
}

}  // extern "C"

extern "C" {

// ---- run-block device occ builder (ops/runblock.py) ----------------------
// Compressed device rank rows: per RB_S-symbol block either a run payload
// (RB_R packed uint16 records, (end_in_block << 3) | keyed_sym, zero-length
// padding) or, when the block holds more than RB_R split-runs, a dense
// escape (three keyed bit-planes).  Counterpart of the reference's
// delta-coded rld0 blocks (rld0.c:107-204) reshaped for O(1) XLA gathers.
// Pass 1: split-run count per block.  Pass 2: fill rows + payload given the
// per-block payload word offsets (python decides run/dense + offsets).

static const int RB_KEY[6] = {0, 4, 3, 2, 1, 5};  // KEY[sym]: complement-order position

void rb3t_runblock_count(const int64_t *lens, int64_t n_runs, int64_t S, int32_t *n_split_out) {
  int64_t pos = 0;
  for (int64_t i = 0; i < n_runs; ++i) {
    int64_t end = pos + lens[i];
    // one split-run in every block the run touches
    for (int64_t bb = pos / S, b1 = (end - 1) / S; bb <= b1; ++bb) n_split_out[bb] += 1;
    pos = end;
  }
}

// rows: (n_blocks, 40) int32 — [0:6 counts-before-block (filled by python) |
// 6 escape index or -1 (filled by python) | 7 pad | 8:40 RB_R=64 packed
// uint16 run records].  esc: (n_esc, 3*S/32) int32 keyed bit-planes for
// blocks whose split-run count exceeds RB_R.  This fills the record words
// and the escape planes; counts/indices come pre-filled from python.
// mega: (n_mega, 6) int64 megablock base counts, or NULL for absolute-int32
// counts (indexes below 2^31 symbols); blocks_per_mega = 2^32 / S.
void rb3t_runblock_fill(const uint8_t *syms, const int64_t *lens, int64_t n_runs, int64_t n,
                        int64_t S, int64_t R, int32_t *rows, int32_t *esc, int64_t *mega) {
  const int64_t n_blocks = (n + S - 1) / S;
  const int64_t plane_words = S / 32;
  const int64_t bpm = ((int64_t)1 << 32) / S;
  int64_t pos = 0, ri = 0;       // start position / index of the current run
  int64_t cnt[6] = {0, 0, 0, 0, 0, 0};  // symbol counts before `pos`
  int64_t mega_cur[6] = {0, 0, 0, 0, 0, 0};
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t base = b * S, lim = base + S < n ? base + S : n;
    // advance to the run covering `base`, accumulating counts
    while (ri < n_runs && pos + lens[ri] <= base) {
      cnt[syms[ri]] += lens[ri];
      pos += lens[ri++];
    }
    int64_t at_base[6];
    for (int c = 0; c < 6; ++c) at_base[c] = cnt[c];
    if (ri < n_runs && pos < base) at_base[syms[ri]] += base - pos;
    if (mega) {
      if (b % bpm == 0) {
        for (int c = 0; c < 6; ++c) mega_cur[c] = at_base[c];
        int64_t *mrow = mega + (b / bpm) * 6;
        for (int c = 0; c < 6; ++c) mrow[c] = at_base[c];
      }
      for (int c = 0; c < 6; ++c)
        ((uint32_t *)(rows + b * 40))[c] = (uint32_t)(at_base[c] - mega_cur[c]);
    } else {
      for (int c = 0; c < 6; ++c) rows[b * 40 + c] = (int32_t)at_base[c];
    }
    const int32_t esc_i = rows[b * 40 + 6];
    if (esc_i < 0) {  // run records, cumulative in-block ends, keyed symbols
      uint16_t *dst = (uint16_t *)(rows + b * 40 + 8);
      int64_t slot = 0, p = pos, j = ri, last_end = 0;
      while (p < lim && j < n_runs) {
        int64_t e = p + lens[j];
        int64_t end_in = (e < lim ? e : lim) - base;
        dst[slot++] = (uint16_t)((end_in << 3) | RB_KEY[syms[j]]);
        last_end = end_in;
        p = e;
        ++j;
      }
      for (; slot < R; ++slot) dst[slot] = (uint16_t)(last_end << 3);  // zero-length pad
    } else {  // dense escape: three keyed bit-planes over the block
      int32_t *dst = esc + (int64_t)esc_i * 3 * plane_words;
      int64_t p = pos, j = ri;
      while (p < lim && j < n_runs) {
        int64_t e = p + lens[j];
        int64_t a = (p > base ? p : base) - base, z = (e < lim ? e : lim) - base;
        int key = RB_KEY[syms[j]];
        for (int64_t q = a; q < z; ++q) {
          int64_t w = q >> 5, bit = q & 31;
          for (int pl = 0; pl < 3; ++pl)
            if ((key >> pl) & 1) dst[pl * plane_words + w] |= (int32_t)(1u << bit);
        }
        p = e;
        ++j;
      }
    }
  }
}

// One-pass dense occ tables (index/dense.py from_bwt semantics): per-block
// uint16 within-super counts, int64 superblock bases, acc — replacing the
// multi-pass numpy build whose GB-scale int64 intermediates cost ~65 s/G
// per merge batch at pangenome scale (round 4).  Threaded over superblocks;
// per-block counting via SSE2 byte-compare movemask+popcount.
void rb3t_dense_tables(const uint8_t *bwt, int64_t n, int64_t n_blocks, int64_t n_supers,
                       uint16_t *occ_block, int64_t *occ_super, int64_t *acc, int32_t n_threads) {
  const int64_t BPS = 1024;  // BLOCKS_PER_SUPER (SUPER 2^16 / BLOCK 64)
  std::vector<int64_t> totals((size_t)n_supers * 6, 0);
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t s0, int64_t s1) {
    for (int64_t s = s0; s < s1; ++s) {
      int64_t run[6] = {0, 0, 0, 0, 0, 0};
      int64_t b_end = (s + 1) * BPS;
      if (b_end > n_blocks + 1) b_end = n_blocks + 1;
      for (int64_t b = s * BPS; b < b_end; ++b) {
        uint16_t *row = occ_block + (size_t)b * 6;
        for (int c = 0; c < 6; ++c) row[c] = (uint16_t)run[c];
        if (b >= n_blocks) continue;
        const uint8_t *blk = bwt + (b << 6);
        int64_t lim = n - (b << 6);
        if (lim >= 64) {
#if defined(__AVX2__)
          __m256i v0 = _mm256_loadu_si256((const __m256i *)blk);
          __m256i v1 = _mm256_loadu_si256((const __m256i *)(blk + 32));
          for (int c = 0; c < 6; ++c) {
            __m256i t = _mm256_set1_epi8((char)c);
            uint64_t bits = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v0, t)) |
                            ((uint64_t)(uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(v1, t)) << 32);
            run[c] += (int64_t)__builtin_popcountll(bits);
          }
#else
          for (int i = 0; i < 64; ++i) run[blk[i]]++;
#endif
        } else {
          for (int64_t i = 0; i < lim; ++i) run[blk[i]]++;
        }
      }
      if (s < n_supers)
        for (int c = 0; c < 6; ++c) totals[(size_t)s * 6 + c] = run[c];
    }
  };
  int64_t n_sp = n_supers > 0 ? n_supers : 1;
  if (n_threads == 1 || n_supers < 2) {
    work(0, n_sp);
  } else {
    std::vector<std::thread> th;
    for (int t = 1; t < n_threads; ++t) {
      int64_t a = n_sp * t / n_threads, b = n_sp * (t + 1) / n_threads;
      if (a < b) th.emplace_back(work, a, b);
    }
    work(0, n_sp / n_threads);
    for (auto &x : th) x.join();
  }
  // prefix over supers -> absolute bases; final row = total counts
  int64_t pre[6] = {0, 0, 0, 0, 0, 0};
  for (int64_t s = 0; s < n_supers; ++s) {
    for (int c = 0; c < 6; ++c) {
      occ_super[(size_t)s * 6 + c] = pre[c];
      pre[c] += totals[(size_t)s * 6 + c];
    }
  }
  for (int c = 0; c < 6; ++c) occ_super[(size_t)n_supers * 6 + c] = pre[c];
  // the extra occ_block row at b == n_blocks, when it belongs to super
  // n_supers (n_blocks % BPS == 0): within-super count before it is 0
  if (n_blocks % BPS == 0)
    for (int c = 0; c < 6; ++c) occ_block[(size_t)n_blocks * 6 + c] = 0;
  acc[0] = 0;
  for (int c = 0; c < 6; ++c) acc[c + 1] = acc[c] + pre[c];
}

}  // extern "C"
