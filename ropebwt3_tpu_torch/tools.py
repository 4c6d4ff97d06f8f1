"""rb3tools in the port, `python -m ropebwt3_tpu_torch.tools`: a copy of
ropebwt3_tpu/tools.py, the post-processing utilities ported from the
reference's k8 script (rb3tools.js): mapflt/mapflt2 mappability filters,
`call` naive small-variant caller over `sw --all-e2e` output, getsnp,
uniqmer.  Host only (getopt, re and sys); output is tab-delimited like k8's
print() and byte-equal to `python -m ropebwt3_tpu.tools`.
"""

from __future__ import annotations

import getopt
import re
import sys

RB3_VERSION = "3.10-r283-dirty"

_QS_RE = re.compile(r"^QS\t(\S+):(\d+)-(\d+)\t")
_QH_RE = re.compile(r"^QH\t(\d+)\t(\d+)\t(\d+)")
_QH4_RE = re.compile(r"^QH\t(\d+)\t(\d+)\t(\d+)\t(\S+)")
_CS_RE = re.compile(r"([:=*+-])(\d+|[A-Za-z]+)")


def _readlines(fn: str):
    fp = sys.stdin if fn == "-" else open(fn)
    for line in fp:
        yield line.rstrip("\n")


def _print(*args):
    sys.stdout.write("\t".join(str(a) for a in args) + "\n")


def cmd_mapflt(args: list[str]) -> int:
    opts, rest = getopt.gnu_getopt(args, "d:g:")
    max_diff, gap_size = 5, 50
    for o, a in opts:
        if o == "-d":
            max_diff = int(a)
        elif o == "-g":
            gap_size = int(a)
    if len(rest) < 2:
        print("Usage: rb3tools mapflt [options] <maxHap> <in.e2e>")
        return 1
    max_hap = int(rest[0])
    ctg0, st0, en0, gap = "", 0, 0, 0
    ctg1, st1, en1, n_hap = "", 0, 0, 0
    for line in _readlines(rest[1]):
        if (m := _QS_RE.match(line)) is not None:
            ctg1, st1, en1, n_hap = m.group(1), int(m.group(2)) - 1, int(m.group(3)), 0
        elif (m := _QH_RE.match(line)) is not None:
            if n_hap > max_hap:
                continue
            if int(m.group(3)) <= max_diff:
                n_hap += int(m.group(1))
        elif line == "//":
            if 0 < n_hap <= max_hap:
                continue
            if ctg1 != ctg0 or st1 > en0 + gap_size:
                if ctg0 != "":
                    _print(ctg0, st0, en0, gap)
                ctg0, st0, en0, gap = ctg1, st1, en1, 0
            else:
                gap += max(st1 - en0, 0)
                en0 = max(en0, en1)
    if ctg0 != "":
        _print(ctg0, st0, en0, gap)
    return 0


def _e2e_read1(it, thres1: int, thres2: int):
    r = {"c1": 0, "c2": 0, "ctg": None, "st": -1, "en": -1}
    for line in it:
        if (m := _QS_RE.match(line)) is not None:
            r["ctg"], r["st"], r["en"] = m.group(1), int(m.group(2)) - 1, int(m.group(3))
        elif (m := _QH_RE.match(line)) is not None:
            ed, cnt = int(m.group(3)), int(m.group(1))
            if ed <= thres1:
                r["c1"] += cnt
            if ed <= thres2:
                r["c2"] += cnt
        elif line == "//":
            break
    return r if r["ctg"] is not None else None


def cmd_mapflt2(args: list[str]) -> int:
    opts, rest = getopt.gnu_getopt(args, "p:r:g:")
    max_rdiff, max_pdiff, gap_size = 3, 7, 50
    for o, a in opts:
        if o == "-p":
            max_pdiff = int(a)
        elif o == "-r":
            max_rdiff = int(a)
        elif o == "-g":
            gap_size = int(a)
    if len(rest) < 3:
        print("Usage: rb3tools mapflt2 [options] <maxHap> <in.ref.e2e> <in.pan.e2e>")
        return 1
    max_hap = int(rest[0])
    fr, fp = _readlines(rest[1]), _readlines(rest[2])
    ctg0, st0, en0, gap = "", 0, 0, 0
    while (r := _e2e_read1(fr, max_rdiff, max_pdiff)) is not None:
        p = _e2e_read1(fp, max_rdiff, max_pdiff)
        if p is None:
            raise RuntimeError("more records in the reference e2e file")
        if r["ctg"] != p["ctg"] or r["st"] != p["st"] or r["en"] != p["en"]:
            raise RuntimeError("inconsistent coordinate")
        flt = False
        if r["c1"] == 1 and 0 < p["c1"] <= max_hap:
            if r["c2"] == 1 and p["c2"] > max_hap:
                flt = True
        else:
            flt = True
        if flt:
            if r["ctg"] != ctg0 or r["st"] > en0 + gap_size:
                if ctg0 != "":
                    _print(ctg0, st0, en0, gap)
                ctg0, st0, en0, gap = r["ctg"], r["st"], r["en"], 0
            else:
                gap += max(r["st"] - en0, 0)
                en0 = max(en0, r["en"])
    if ctg0 != "":
        _print(ctg0, st0, en0, gap)
    return 0


class _Allele:
    __slots__ = ("cnt", "score", "ed", "acc", "type")

    def __init__(self, cnt, score, ed):
        self.cnt, self.score, self.ed = cnt, score, ed
        self.acc = 0
        self.type = -1


class _KmerVar:
    __slots__ = ("st", "en", "aid", "ref", "alt", "key")

    def __init__(self, st, en, aid, ref, alt):
        self.st, self.en, self.aid, self.ref, self.alt = st, en, aid, ref, alt
        self.key = f"{st}-{ref}-{alt}"


class _Variant:
    def __init__(self, opt, kmer_id, ctg, off, length, w):
        self.opt = opt
        self.kmer_id, self.ctg = kmer_id, ctg
        self.st, self.en = off + w.st, off + w.en
        self.ref, self.alt = w.ref, w.alt
        self.end_dist = min(w.st, length - w.en)
        self.conflict_flt = False
        self.key = f"{self.ctg}-{self.st}-{self.ref}-{self.alt}"
        self.ac_real = self.ac_ambi = self.ac_flt = 0
        self.an_real = self.an_ambi = self.an_flt = 0
        self.rel_score = 0
        self.n_support = 1
        self.type = -1

    def __str__(self):
        info = [
            f"AC={self.ac_real}", f"AN={self.an_real}", f"AC_AMBI={self.ac_ambi}", f"AN_AMBI={self.an_ambi}",
            f"AC_DUP={self.ac_flt}", f"AN_DUP={self.an_flt}", f"RSCORE={self.rel_score}", f"SUPPORT={self.n_support}",
        ]
        flt = []
        if self.type > 0:
            flt.append("LOWCONF" if self.type == 1 else "AMBI" if self.type == 2 else "DUP")
        if not self.opt["keep_supp1"] and self.n_support < 2:
            flt.append("SUPPORT1")
        if self.opt["flag_conflict"] and self.conflict_flt:
            flt.append("CONFLICT")
        if not flt:
            flt.append("PASS")
        if len(self.ref) == len(self.alt):
            pos, ref, alt = self.st + 1, self.ref, self.alt
        else:
            pos, ref, alt = self.st, f"N{self.ref}", f"N{self.alt}"
        return "\t".join(str(x) for x in [self.ctg, pos, ".", ref, alt, 60, ";".join(flt), ";".join(info)])


def cmd_call(args: list[str]) -> int:
    opt = {"dbg": False, "ambi_range": 4, "drop_score": 12, "max_gced": 5, "keep_supp1": False, "flag_conflict": False}
    opts, rest = getopt.gnu_getopt(args, "r:a:d:1c", ["dbg"])
    for o, a in opts:
        if o == "--dbg":
            opt["dbg"] = True
        elif o == "-r":
            opt["drop_score"] = int(a)
        elif o == "-a":
            opt["ambi_range"] = int(a)
        elif o == "-d":
            opt["max_gced"] = int(a)
        elif o == "-1":
            opt["keep_supp1"] = True
        elif o == "-c":
            opt["flag_conflict"] = True
    if len(rest) < 2:
        print("Usage: rb3tools call [options] <nHap> <in.e2e>")
        return 1
    max_hap = int(rest[0])

    print("##fileformat=VCFv4.2")
    print(f"##source=rb3tools-{RB3_VERSION}")
    print('##INFO=<ID=AC,Number=A,Type=Integer,Description="Number of alternate allele">')
    print('##INFO=<ID=AN,Number=1,Type=Integer,Description="Number of samples">')
    print('##INFO=<ID=AC_AMBI,Number=A,Type=Integer,Description="Number of ambiguous alleles">')
    print("##INFO=<ID=AN_AMBI,Number=1,Type=Integer>")
    print('##INFO=<ID=AC_DUP,Number=A,Type=Integer,Description="Number of duplicate alleles">')
    print("##INFO=<ID=AN_DUP,Number=1,Type=Integer>")
    print('##INFO=<ID=RSCORE,Number=1,Type=Integer,Description="Relative k-mer alignment score">')
    print('##INFO=<ID=SUPPORT,Number=1,Type=Integer,Description="Number of supporting k-mers">')
    print('##FILTER=<ID=LOWCONF,Description="Low confidence">')
    print('##FILTER=<ID=AMBI,Description="Ambiguous">')
    print('##FILTER=<ID=DUP,Description="Likely caused by duplications">')
    print('##FILTER=<ID=SUPPORT1,Description="Supported by one k-mer only">')
    if opt["flag_conflict"]:
        print('##FILTER=<ID=CONFLICT,Description="Conflictive with a better k-mer alignment">')
    _print("#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO")

    kmer_id, vcf, a, al = 0, [], [], []
    ctg1, st1, en1 = "", 0, 0
    for line in _readlines(rest[1]):
        if (m := _QS_RE.match(line)) is not None:
            ctg1, st1, en1 = m.group(1), int(m.group(2)) - 1, int(m.group(3))
            a, al = [], []
        elif (m := _QH4_RE.match(line)) is not None:
            cnt, score, ed, cs = int(m.group(1)), int(m.group(2)), int(m.group(3)), m.group(4)
            x, gced, b = 0, 0, []
            for mm in _CS_RE.finditer(cs):
                tag, val = mm.group(1), mm.group(2)
                if tag == ":":
                    x += int(val)
                elif tag == "*":
                    b.append(_KmerVar(x, x + 1, len(al), val[0].upper(), val[1].upper()))
                    x += 1
                    gced += 1
                elif tag == "+":
                    b.append(_KmerVar(x, x + len(val), len(al), val.upper(), ""))
                    x += len(val)
                    gced += 1
                elif tag == "-":
                    b.append(_KmerVar(x, x, len(al), "", val.upper()))
                    gced += 1
            if gced <= opt["max_gced"]:
                a.extend(b)
                al.append(_Allele(cnt, score, ed))
        elif line == "//":
            if opt["dbg"]:
                _print("X1", f"{ctg1}:{st1+1}-{en1}")
            while vcf and (vcf[0].ctg != ctg1 or vcf[0].en <= st1):
                print(vcf.pop(0))
            # accumulate al[].acc (al sorted by score already)
            n_hap = 0
            i, j = 1, 0
            while i <= len(al):
                if i == len(al) or al[i].score != al[j].score:
                    for k in range(j, i):
                        n_hap += al[k].cnt
                    for k in range(j, i):
                        al[k].acc = n_hap
                    j = i
                i += 1
            score_cutoff = score_next = 0
            for t in al:
                if t.acc >= max_hap and score_cutoff == 0:
                    score_cutoff = t.score
                if t.acc > max_hap and score_next == 0:
                    score_next = t.score
            if score_cutoff == 0 and al:
                score_cutoff = al[-1].score
            if opt["dbg"]:
                _print("X2", score_cutoff, score_next)
            an_real = an_ambi = an_flt = 0
            for t in al:
                if t.score >= score_cutoff and t.score >= score_next + opt["ambi_range"]:
                    t.type = 0
                    an_real += t.cnt
                elif t.score >= score_cutoff and t.score > score_next:
                    t.type = 1
                    an_real += t.cnt
                elif t.score < score_cutoff - opt["drop_score"]:
                    t.type = 4
                elif t.score == score_next:
                    t.type = 2
                    an_ambi += t.cnt
                elif t.score < score_next:
                    t.type = 3
                    an_flt += t.cnt
            an_flt += an_real + an_ambi
            an_ambi += an_real
            if score_cutoff == score_next:
                an_real = max_hap
            a.sort(key=lambda w: w.key)
            i, j = 1, 0
            while i <= len(a):
                if i == len(a) or a[j].key != a[i].key:
                    v = _Variant(opt, kmer_id, ctg1, st1, en1 - st1, a[j])
                    max_sc, best_type = 0, 4
                    for k in range(j, i):
                        t = al[a[k].aid]
                        best_type = min(best_type, t.type)
                        if t.type == 4:
                            continue
                        elif t.type <= 1:
                            v.ac_real += t.cnt
                            v.an_real = 0
                        elif t.type == 2:
                            v.ac_ambi += t.cnt
                        elif t.type == 3:
                            v.ac_flt += t.cnt
                        max_sc = max(max_sc, t.score)
                    if best_type < 4:
                        v.type = best_type
                        v.rel_score = max_sc - score_cutoff
                        v.an_real, v.an_ambi, v.an_flt = an_real, an_ambi, an_flt
                        vcf.append(v)
                    j = i
                i += 1
            # resolve conflicts with other k-mers
            wcf = []
            vcf.sort(key=lambda v: (v.st, v.key))
            i, j = 1, 0
            while i <= len(vcf):
                if i == len(vcf) or vcf[j].key != vcf[i].key:
                    n_curr, max_end_dist, max_k, n_support = 0, -1, -1, 0
                    for k in range(j, i):
                        v = vcf[k]
                        if v.kmer_id == kmer_id:
                            n_curr += 1
                        if v.end_dist > max_end_dist:
                            max_end_dist, max_k = v.end_dist, k
                        n_support += v.n_support
                    if n_curr > 1 or max_k < 0:
                        raise RuntimeError("Bug!")
                    v = vcf[max_k]
                    v.n_support = n_support
                    if n_curr == 0:
                        curr_end_dist = min(v.st - st1, en1 - v.en)
                        if v.end_dist < curr_end_dist:
                            v.conflict_flt = True
                    wcf.append(v)
                    j = i
                i += 1
            vcf = wcf
            kmer_id += 1
    while vcf:
        print(vcf.pop(0))
    return 0


def cmd_getsnp(args: list[str]) -> int:
    opts, rest = getopt.gnu_getopt(args, "a")
    auto_only = any(o == "-a" for o, _ in opts)
    if len(rest) < 1:
        print("Usage: rb3tools getsnp [options] <in.vcf>")
        return 1
    auto_re = re.compile(r"^(chr\d+|\d+)$")
    for line in _readlines(rest[0]):
        if not line or line[0] == "#":
            continue
        t = line.split("\t", 8)
        if auto_only and not auto_re.match(t[0]):
            continue
        ref = t[3]
        for alt in t[4].split(","):
            if len(ref) != len(alt):
                continue
            for k in range(len(ref)):
                if ref[k] != alt[k]:
                    print("-".join([t[0], t[1], ref[k], alt[k]]))
    return 0


def cmd_uniqmer(args: list[str]) -> int:
    opts, rest = getopt.gnu_getopt(args, "d:e:E:")
    within_diff, max_exact, min_exact = 5, -1, -1
    for o, a in opts:
        if o == "-d":
            within_diff = int(a)
        elif o == "-e":
            min_exact = int(a)
        elif o == "-E":
            max_exact = int(a)
    if len(rest) < 1:
        print("Usage: rb3tools uniqmer [options] <all.e2e>")
        return 1
    name = -1
    for line in _readlines(rest[0]):
        t = line.split("\t")
        if t[0] == "QS":
            name = t[1]
        elif t[0] == "QH":
            cnt = int(t[3])
            is_excl = False
            if cnt == 0:
                x = int(t[1])
                if max_exact > 0 and x > max_exact:
                    is_excl = True
                if min_exact > 0 and x < min_exact:
                    is_excl = True
            elif 0 < cnt < within_diff:
                is_excl = True
            if is_excl:
                print(name)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("Usage: rb3tools <command> [arguments]")
        print("Commands:")
        print("  call           call small variants")
        print("  mapflt2        generate mappability filter")
        print("  getsnp         extract SNPs")
        print("  uniqmer        extract highly unique k-mer")
        print("  version        print version number")
        return 1
    cmd, rest = args[0], args[1:]
    if cmd == "mapflt":
        return cmd_mapflt(rest)
    if cmd == "mapflt2":
        return cmd_mapflt2(rest)
    if cmd == "call":
        return cmd_call(rest)
    if cmd == "getsnp":
        return cmd_getsnp(rest)
    if cmd == "uniqmer":
        return cmd_uniqmer(rest)
    if cmd == "version":
        print(RB3_VERSION)
        return 0
    raise SystemExit(f"unrecognized command: {cmd}")


if __name__ == "__main__":
    sys.exit(main())
