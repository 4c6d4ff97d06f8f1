// fa2line: FASTA/FASTQ -> one line per strand, byte-identical to the
// Python path of `fa2line` (cli.py main_fa2line) and to the reference
// `ropebwt3 fa2line` (main.c's fa2line path through io.c's nt6 encoding).
//
// cli.py main_fa2line builds this program with g++ at first use (native/
// __init__.py fa2line_binary, into ../_build/) and runs it for the
// `fa2line [-R] files` argv shape, its output passed through; every other
// shape (usage, other flags) keeps the Python path, whose behaviour this
// mirrors exactly:
//
//  - record parsing matches seqio.read_seqs (kseq-style autodetect: '>'
//    FASTA with multi-line sequences, '@' FASTQ with single-line seq/qual
//    and the malformed-'+' FASTA fallback; per line one trailing '\n' then
//    ALL trailing '\r's are stripped)
//  - per output byte: "\nACGTX"[nt6[c]] with nt6 per nt6.py (io.c:12-28:
//    bytes 0..4 map to themselves, ACGT/acgt to 1..4, everything else to
//    5); the reverse-complement line (unless -R) maps through the
//    complemented table in reverse order
//  - unopenable files print "ERROR: failed to open file '<fn>'" to stderr
//    and processing continues
//
// gzip input is transparent (zlib gzopen reads plain files too).

#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <unistd.h>
#include <zlib.h>

static unsigned char fwd_tab[256], rc_tab[256];

static void init_tables() {
    // nt6: 0..4 -> themselves, ACGT/acgt -> 1..4, else 5
    static const char *out = "\nACGTX";
    unsigned char nt6[256];
    memset(nt6, 5, sizeof(nt6));
    for (int i = 0; i < 5; i++) nt6[i] = (unsigned char)i;
    const char *b = "ACGT", *bl = "acgt";
    for (int i = 0; i < 4; i++) {
        nt6[(unsigned char)b[i]] = (unsigned char)(i + 1);
        nt6[(unsigned char)bl[i]] = (unsigned char)(i + 1);
    }
    static const int comp[6] = {0, 4, 3, 2, 1, 5};
    for (int c = 0; c < 256; c++) {
        fwd_tab[c] = (unsigned char)out[nt6[c]];
        rc_tab[c] = (unsigned char)out[comp[nt6[c]]];
    }
}

// buffered gz line reader: returns length (without the newline handling —
// caller gets the raw line WITHOUT its trailing '\n'), -1 at EOF
struct GzReader {
    gzFile fp;
    std::vector<char> buf;
    size_t pos = 0, len = 0;
    bool eof = false;
    explicit GzReader(gzFile f) : fp(f), buf(1u << 20) {}
    // reads one line into `line` (excluding '\n'); false at EOF with empty line
    bool getline(std::string &line) {
        line.clear();
        for (;;) {
            if (pos == len) {
                if (eof) return !line.empty();
                int r = gzread(fp, buf.data(), (unsigned)buf.size());
                if (r <= 0) { eof = true; return !line.empty(); }
                pos = 0;
                len = (size_t)r;
            }
            char *nl = (char *)memchr(buf.data() + pos, '\n', len - pos);
            if (nl) {
                line.append(buf.data() + pos, nl - (buf.data() + pos));
                pos = (size_t)(nl - buf.data()) + 1;
                return true;
            }
            line.append(buf.data() + pos, len - pos);
            pos = len;
        }
    }
};

static void strip_cr(std::string &s) {
    // read_seqs: rstrip('\n') then rstrip('\r') — getline already removed
    // the '\n'; strip ALL trailing '\r's like Python's rstrip
    size_t n = s.size();
    while (n && s[n - 1] == '\r') n--;
    s.resize(n);
}

static std::vector<char> obuf;

static void flush_out() {
    if (!obuf.empty()) {
        fwrite(obuf.data(), 1, obuf.size(), stdout);
        obuf.clear();
    }
}

static void emit(const std::string &seq, bool no_rev) {
    size_t n = seq.size();
    size_t base = obuf.size();
    obuf.resize(base + n + 1 + (no_rev ? 0 : n + 1));
    char *o = obuf.data() + base;
    const unsigned char *s = (const unsigned char *)seq.data();
    for (size_t i = 0; i < n; i++) o[i] = (char)fwd_tab[s[i]];
    o[n] = '\n';
    if (!no_rev) {
        char *r = o + n + 1;
        for (size_t i = 0; i < n; i++) r[i] = (char)rc_tab[s[n - 1 - i]];
        r[n] = '\n';
    }
    if (obuf.size() >= (4u << 20)) flush_out();
}

static void one_file(const char *fn, bool no_rev) {
    gzFile fp = strcmp(fn, "-") == 0 ? gzdopen(dup(0), "rb") : gzopen(fn, "rb");
    if (!fp) {
        fprintf(stderr, "ERROR: failed to open file '%s'\n", fn);
        return;
    }
    GzReader rd(fp);
    std::string line, seq;
    bool have = false;  // a FASTA record is open
    bool ok = rd.getline(line);
    while (ok) {
        if (!line.empty() && line[0] == '>') {
            if (have) emit(seq, no_rev);
            have = true;
            seq.clear();
            ok = rd.getline(line);
        } else if (!line.empty() && line[0] == '@') {
            if (have) { emit(seq, no_rev); have = false; seq.clear(); }
            std::string fq;
            if (!rd.getline(fq)) fq.clear();
            strip_cr(fq);
            std::string plus;
            bool got_plus = rd.getline(plus);
            if (got_plus && !plus.empty() && plus[0] == '+') {
                rd.getline(line);  // quality, discarded
                emit(fq, no_rev);
                ok = rd.getline(line);
            } else {  // malformed; treat as FASTA-ish (read_seqs fallback)
                have = true;
                seq = fq;
                line = plus;
                ok = got_plus;
            }
        } else {
            strip_cr(line);
            seq += line;
            ok = rd.getline(line);
        }
    }
    if (have) emit(seq, no_rev);
    gzclose(fp);
}

int main(int argc, char **argv) {
    bool no_rev = false;
    std::vector<const char *> files;
    for (int i = 1; i < argc; i++) {
        if (strcmp(argv[i], "-R") == 0) no_rev = true;
        else files.push_back(argv[i]);
    }
    if (files.empty()) return 2;  // main_fa2line never runs this shape
    init_tables();
    obuf.reserve(8u << 20);
    for (const char *fn : files) {
        // match cli.seq_openable: regular file must exist (stdin always ok)
        if (strcmp(fn, "-") != 0 && access(fn, R_OK) != 0) {
            fprintf(stderr, "ERROR: failed to open file '%s'\n", fn);
            continue;
        }
        one_file(fn, no_rev);
    }
    flush_out();
    fflush(stdout);
    return 0;
}
