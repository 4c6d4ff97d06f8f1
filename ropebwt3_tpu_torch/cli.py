"""`python -m ropebwt3_tpu_torch`: ropebwt3's command line for the commands
the port owns: `mem`, `ssa`, `stat` and `version`.

`mem [--device=cuda|cpu] [--occ=auto|dense|rb] [options] idx.fmd reads...`
loads the index (`load_index`), reads each file in flat batches of -K
symbols (`seqio.iter_flat_batches`), finds each batch's MEMs with
`BatchedSmemTG` on the device's occ rows (--occ auto: dense unless they
would pass 75% of the card's memory, ops/smem.py `resolve_occ`), and writes
the BED from the engine's flat (counts, rows), with `-c`, `--gap`, `--cov`
and `-p`, byte-equal to `python -m ropebwt3_tpu mem --engine=native`.

`ssa [--device=cuda|cpu] [-s INT] [-o FILE] [-t INT] idx.fmd` walks every
sequence on the device's dense occ rows (ssa_ops.py) and writes the SSA
file byte-equal to `python -m ropebwt3_tpu ssa`; `-t` is accepted and
unused, as the JAX package's own walk ignores it.

With the default `--device=cuda` and no CUDA both exit non-zero; they never
go on on the CPU unasked.  Every other command, and every option that the
port's engines do not run, is refused with one `ERROR:` line that names the
ROADMAP queue item porting it (`refusal`); `python -m ropebwt3_tpu` runs
them.  The option parser, the usage text, the index loader and the BED
writer are copies of ropebwt3_tpu/cli.py's (main_search, _run_mem's flat
path, main_ssa, main_stat).
"""

from __future__ import annotations

import getopt
import os
import re
import sys

import numpy as np

from . import log
from .bufio import write_all
from .index.dense import DenseFMIndex
from .nt6 import char2nt6
from .seqio import iter_flat_batches, read_seqs, read_sid

REF_VERSION = "3.10-r281"  # ropebwt3 version whose formats and outputs are matched
OWNED = ("mem", "ssa", "stat", "version")
# main_search's short and long options (ropebwt3_tpu/cli.py:1022-1029)
_SEARCH_OPTS = "Ll:c:t:K:MdN:A:B:O:E:C:m:k:uj:ey:a:w:p:bg:"
_LONG_OPTS = ["no-ssa", "seq", "gap=", "cov", "old-mem", "all-e2e", "no-kalloc", "dbg-dawg", "dbg-sw", "dbg-qname",
              "dbg-bt", "engine=", "mesh=", "occ="]
# the ROADMAP queue 1 item that ports each command or engine the port refuses
_ENGINE_ITEM = {"sw": "item 11 (sw scoring DP)", "hapdiv": "item 10 (hapdiv DP)",
                "search": "items 4, 10 and 11 (use `mem`, `sw` or `hapdiv`)"}
_COMMAND_ITEM = {**_ENGINE_ITEM, "build": "item 14", "merge": "item 15", "get": "item 16", "suffix": "item 17",
                 "kount": "item 18", "fa2line": "item 19", "fa2kmer": "item 20", "plain2fmd": "item 21"}


def atoi(s: str) -> int:
    """C atoi: optional whitespace and sign, leading digits, 0 on garbage."""
    m = re.match(r"[ \t\n\r]*([+-]?[0-9]+)", s or "")
    return int(m.group(1)) if m else 0


def parse_num(s: str) -> int:
    """rb3_parse_num (misc.c:7-16): strtod prefix + optional K/M/G suffix,
    rounding with +0.499; garbage parses as 0."""
    m = re.match(r"[ \t\n\r]*([+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?)(.?)", s or "")
    if not m:
        return 0
    x = float(m.group(1)) * {"G": 1e9, "g": 1e9, "M": 1e6, "m": 1e6, "K": 1e3, "k": 1e3}.get(m.group(2), 1)
    return int(x + 0.499)


def _err(msg: str) -> int:
    print(f"ERROR: {msg}", file=sys.stderr)
    return 1


def seq_openable(fn: str) -> bool:
    """Whether rb3_seq_open would succeed (io.c:42-58)."""
    if fn == "-":
        return True
    try:
        open(fn, "rb").close()
        return True
    except OSError:
        return False


class KetoptUnknown(Exception):
    """Raised in strict mode on an unknown option or a missing argument."""


def ketopt(argv: list[str], ostr: str, longopts: list[str] = (), strict: bool = False
           ) -> tuple[list[tuple[str, str]], list[str]]:
    """ketopt.h-compatible option parsing (permuting; ketopt.h:57-121), as
    ropebwt3_tpu/cli.py parses: unknown options and missing arguments are
    skipped, or with `strict` reported as "ERROR: unknown option" (raises
    KetoptUnknown), as main_search does (search.c:487-491).  `longopts` use
    the getopt convention ("name=" takes an argument); unambiguous prefixes
    of long names are accepted.  Pairs come as ("-x", arg) / ("--name", arg)."""

    def bad():
        if strict:
            print("ERROR: unknown option", file=sys.stderr)
            raise KetoptUnknown()

    lo = [(s[:-1], True) if s.endswith("=") else (s, False) for s in longopts]
    opts: list[tuple[str, str]] = []
    args: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-") or a == "-":
            args.append(a)
            i += 1
            continue
        if a.startswith("--"):
            if a == "--":
                args.extend(argv[i + 1 :])
                break
            j = a.find("=", 2)
            name = a[2:] if j < 0 else a[2:j]
            exact = [o for o in lo if o[0] == name]
            partial = [o for o in lo if o[0].startswith(name) and o[0] != name]
            o = exact[0] if len(exact) == 1 else (partial[0] if not exact and len(partial) == 1 else None)
            if o is not None:
                arg = "" if j < 0 else a[j + 1 :]
                if o[1] and j < 0:
                    if i + 1 < len(argv):
                        i += 1
                        arg = argv[i]
                    else:
                        o = None  # ketopt ':' (missing argument): skipped
                        bad()
                if o is not None:
                    opts.append(("--" + o[0], arg))
            else:
                bad()
            i += 1
            continue
        pos = 1
        while pos < len(a):
            c = a[pos]
            pos += 1
            k = ostr.find(c)
            if k < 0:
                bad()
                continue  # ketopt '?' (unknown option): skipped
            if k + 1 < len(ostr) and ostr[k + 1] == ":":
                if pos < len(a):
                    opts.append(("-" + c, a[pos:]))
                elif i + 1 < len(argv):
                    i += 1
                    opts.append(("-" + c, argv[i]))
                else:
                    bad()  # ketopt ':' (missing argument): skipped
                pos = len(a)
            else:
                opts.append(("-" + c, ""))
        i += 1
    return opts, args


# usage text; the first _USAGE_STDOUT_LINES lines go to stdout and the rest
# to stderr, as the reference prints them (search.c:508, main.c, ssa.c:261)
_USAGE = {
    "mem": """Usage: python -m ropebwt3_tpu_torch mem [options] <idx.fmr> <seq.fa> [...]
Options:
  -l INT      min MEM length [19]
  -c INT      min interval size [1]
  --gap=NUM   output regions >=NUM that are not covered by MEMs [0]
  --cov       output breadth of coverage
  -p INT      output up to INT positions [0]
  -L          one sequence per line in the input
  -K NUM      query batch size [100m]
  --device=STR  cuda (the kernels) or cpu (the plain PyTorch engine) [cuda]
  --occ=STR     device occ rows: auto, dense, rb (run-block compressed) [auto]""",
    "ssa": """Usage: python -m ropebwt3_tpu_torch ssa [options] <in.fmd>
Options:
  -t INT     number of threads [4]
  -s INT     sample rate one SA per 2**INT bases [8]
  -o FILE    output to file [stdout]
  --device=STR  cuda or cpu [cuda]""",
    "stat": "Usage: python -m ropebwt3_tpu_torch stat [-M] <idx.fmd>",
}
_USAGE_STDOUT_LINES = {"mem": 1, "ssa": 0, "stat": 1}


def _usage(cmd: str) -> int:
    lines = _USAGE[cmd].split("\n")
    n_out = _USAGE_STDOUT_LINES[cmd]
    if n_out:
        print("\n".join(lines[:n_out]))
    if lines[n_out:]:
        print("\n".join(lines[n_out:]), file=sys.stderr)
    return 1


# ---------------------------------------------------------------------------
# index loading (ropebwt3_tpu/cli.py:299-369)
# ---------------------------------------------------------------------------


class IndexLoadError(Exception):
    pass


def load_runs(fn: str) -> tuple[np.ndarray, np.ndarray]:
    """The BWT of an FMD, FMR or BRE file (told apart by magic) as runs."""
    from .formats import bre, fmd, fmr

    try:
        with open(fn, "rb") as fp:
            data = fp.read()
    except OSError as e:
        raise IndexLoadError(f"failed to load BWT from file \"{fn}\": {e.strerror}") from e
    if data[:4] == b"RLD\x03":
        return fmd.decode_runs(data)
    if data[:3] == b"RB\x02":
        return fmr.read_fmr_bytes(data)[1:]
    if data[:4] == b"BRE\x01":
        return bre.read_bre_bytes(data)
    raise IndexLoadError(f"failed to load BWT from file \"{fn}\": unrecognized format")


def load_index(fn: str, load_ssa: bool = False, load_sid: bool = False) -> DenseFMIndex:
    """The dense host index of `fn`, through the `<fn>.dense` sidecar: a load
    maps it when it is no older than `fn`, or decodes `fn` and writes it
    (RB3TPU_CACHE=0 turns both off).  The sidecar is the JAX package's
    format, so both packages share it.  `load_ssa` attaches `<fn>.ssa`,
    `load_sid` (with it) `<fn>.len.gz`."""
    from .formats.ssa import read_ssa
    from .index.sidecar import read_sidecar, write_sidecar

    cache_fn = fn + ".dense"
    use_cache = os.environ.get("RB3TPU_CACHE", "1") != "0"
    f = None
    if use_cache and os.path.exists(cache_fn) and os.path.getmtime(cache_fn) >= os.path.getmtime(fn):
        f = read_sidecar(cache_fn)
        if f is not None and f._sidecar_version == 1:
            try:  # one-time upgrade to the 2 MiB-aligned v2 layout
                write_sidecar(cache_fn, f)
                f = read_sidecar(cache_fn) or f
            except OSError:
                pass
    if f is None:
        f = DenseFMIndex.from_runs(*load_runs(fn))
        if use_cache:
            try:
                write_sidecar(cache_fn, f)
            except OSError:
                pass
    log.info("loaded the BWT", func="load_index")
    if load_ssa and os.path.exists(fn + ".ssa"):
        f.ssa = read_ssa(fn + ".ssa")
        if f.ssa.m != int(f.acc[1]):
            print("ERROR: number of sequences do not match between BWT and sampled suffix array", file=sys.stderr)
            f.ssa = None
    if load_ssa and load_sid and os.path.exists(fn + ".len.gz"):
        sid = read_sid(fn + ".len.gz")
        if sid.n_seq * 2 != int(f.acc[1]):
            print("ERROR: number of sequences do not match between BWT and the sequence list", file=sys.stderr)
        else:
            f.sid = sid
    return f


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def refusal(argv: list[str]) -> str | None:
    """Why the port refuses `argv`, or None.  `serve`, `--mesh` on any
    command and `sw` / `hapdiv` / `search` with `--engine=jax|hybrid|server`
    would reach the JAX package's device code; every other command that
    the port does not own is a ROADMAP queue 1 item of its own."""
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        return "serve (the resident JAX engine server) is not ported: ROADMAP queue 1 item 13"
    # parsed as the commands parse them: ketopt takes `--name X`, `--name=X`
    # and unambiguous prefixes (no other long option of any command starts
    # with `m` or `e`); the last value wins
    given = dict(ketopt(rest, "", ["mesh=", "engine="])[0])
    if "--mesh" in given:
        return f"{cmd} --mesh is not ported (multi-GPU): ROADMAP queue 1 item 12"
    engine = given.get("--engine", "auto")
    if cmd in _ENGINE_ITEM and engine in ("jax", "hybrid", "server"):
        return f"{cmd} --engine={engine} runs the JAX package's device engine, not ported: ROADMAP queue 1 {_ENGINE_ITEM[cmd]}"
    if cmd in _COMMAND_ITEM:
        return f"{cmd} is not ported: ROADMAP queue 1 {_COMMAND_ITEM[cmd]}; `python -m ropebwt3_tpu {cmd}` runs it"
    if cmd not in OWNED:
        return f"unknown command '{cmd}'"
    return None


def _split_device(argv: list[str]) -> tuple[str, list[str]]:
    """Take `--device=X` / `--device X` out of argv (the search options'
    parser rejects unknown options)."""
    device, rest, it = "cuda", [], iter(argv)
    for a in it:
        if a == "--":
            rest.append(a)
            rest.extend(it)
        elif a == "--device":
            device = next(it, "")
        elif a.startswith("--device="):
            device = a[len("--device=") :]
        else:
            rest.append(a)
    return device, rest


# ---------------------------------------------------------------------------
# mem (ropebwt3_tpu/cli.py main_search and _run_mem's flat path)
# ---------------------------------------------------------------------------


def main_mem(argv: list[str], device: str) -> int:
    from .ops.smem import BatchedSmemTG, smem_tg_cuda, smem_tgc_cuda

    try:
        opts, args = ketopt(argv, _SEARCH_OPTS, _LONG_OPTS, strict=True)
    except KetoptUnknown:
        return 1
    is_line, min_len, min_occ, max_pos, min_gap_len, write_cov = False, 19, 1, 0, 0, False
    occ, batch_size, other = "auto", 100_000_000, None
    for o, a in opts:
        if o == "-L":
            is_line = True
        elif o == "-l":
            min_len = atoi(a)
        elif o == "-c":
            min_occ = atoi(a)
        elif o == "-K":
            batch_size = parse_num(a)
        elif o == "-p":
            max_pos = atoi(a)
        elif o == "--gap":
            min_gap_len = parse_num(a)
        elif o == "--cov":
            write_cov = True
        elif o == "--occ":
            if a not in ("auto", "dense", "rb"):
                raise getopt.GetoptError(f"invalid --occ value '{a}' (auto|dense|rb)")
            occ = a
        elif o == "-d":  # mem -d, -a and -w run sw and hapdiv (ropebwt3_tpu/cli.py:1053-1058)
            other = f"mem {o} runs sw: ROADMAP queue 1 {_ENGINE_ITEM['sw']}", o
        elif o in ("-a", "-w"):
            other = f"mem {o} runs hapdiv: ROADMAP queue 1 {_ENGINE_ITEM['hapdiv']}", o
        elif o == "--old-mem":
            other = "mem --old-mem (the original MEM algorithm) is not ported: ROADMAP queue 1 item 4", o
    if len(args) < 2:
        return _usage("mem")
    if other:
        return _err(f"{other[0]}; `python -m ropebwt3_tpu mem {other[1]}` runs it")
    if min_gap_len > 0:
        max_pos = 0
    f = load_index(args[0], load_ssa=max_pos > 0, load_sid=max_pos > 0)
    if max_pos > 0 and (f.ssa is None or f.sid is None):
        return _err("failed to load suffix array samples or sequence names/lengths")
    if not f.is_symmetric():
        return _err("BWT doesn't contain both strands")
    eng = BatchedSmemTG(f, min_occ, min_len, device=device, occ=occ)
    ret = _run_mem(f, eng, args[1:], is_line, batch_size, min_gap_len, write_cov, max_pos)
    lay = eng.idx.layout
    log.info("%d smem_tg launches (%s): %d chunked, %d one-thread; %d reads rerun on the card, %d unmerged",
             smem_tgc_cuda.launches[lay] + smem_tg_cuda.launches[lay], lay, smem_tgc_cuda.launches[lay],
             smem_tg_cuda.launches[lay], eng.n_rerun, eng.n_unmerged, func="mem")
    return ret


def record_batches(fn: str, is_line: bool, batch_size: int):
    """(names, flat nt6, offsets) batches of ~batch_size symbols from the
    record reader, for inputs the vectorized reader does not take."""
    from .ops.smem import pack_reads

    names, seqs, tot = [], [], 0
    for rec in read_seqs(fn, is_line):
        names.append(rec.name)
        seqs.append(char2nt6(rec.seq))
        tot += len(seqs[-1])
        if tot >= batch_size:
            yield names, *pack_reads(seqs)
            names, seqs, tot = [], [], 0
    if names:
        yield names, *pack_reads(seqs)


def _run_mem(f, eng, files: list[str], is_line: bool, batch_size: int, min_gap_len: int, write_cov: bool,
             max_pos: int) -> int:
    seq_id = 0
    for fn in files:
        if not seq_openable(fn):
            # search.c:571-575: report and stop processing further files
            print(f"ERROR: failed to load the sequence file '{fn}'", file=sys.stderr)
            break
        batches = iter_flat_batches(fn, is_line, batch_size)
        for names, flat, offs in batches if batches is not None else record_batches(fn, is_line, batch_size):
            counts, rows = eng.run_flat(flat, offs)
            seq_id = write_bed(sys.stdout, f, names, offs, counts, rows, seq_id, min_gap_len, write_cov, max_pos)
    return 0


def write_bed(out, f, names, offs, counts, rows, seq_id: int, min_gap_len: int, write_cov: bool, max_pos: int) -> int:
    """BED lines of one batch from the engine's (counts, rows), as
    ropebwt3_tpu/cli.py writes them (emit_flat, write_records): the MEMs,
    with up to max_pos positions each (-p), or the gaps (--gap) or the
    covered length (--cov) of each read.  A read without a name is seq<N>,
    N counting reads from 1 across batches.  Returns the last N."""
    rows_l = rows.tolist()
    lens = np.diff(offs).tolist()
    pos = None
    if max_pos > 0 and min_gap_len == 0 and not write_cov:
        from .ssa_ops import ssa_multi_batch

        pos = iter(ssa_multi_batch(f, f.ssa, [(lo, lo + sz, max_pos) for _, _, sz, lo, _ in rows_l]))
    buf: list[str] = []
    k = 0
    for i, c in enumerate(counts.tolist()):
        seq_id += 1
        nm = names[i] if names[i] else f"seq{seq_id}"
        mems, L = rows_l[k : k + c], lens[i]
        k += c
        if min_gap_len > 0:
            last = 0
            for st, en, *_ in mems:
                if st > last:
                    if st - last >= min_gap_len:
                        buf.append(f"{nm}\t{last}\t{st}\t{L}\n")
                    last = en
                else:
                    last = max(last, en)
            if L - last >= min_gap_len:
                buf.append(f"{nm}\t{last}\t{L}\t{L}\n")
        elif write_cov:
            st0 = en0 = cov = 0
            for st, en, *_ in mems:
                if st > en0:
                    cov += en0 - st0
                    st0, en0 = st, en
                else:
                    en0 = max(en0, en)
            cov += en0 - st0
            if cov > 0:
                buf.append(f"{nm}\t{L}\t{cov}\n")
        else:
            for st, en, sz, *_ in mems:
                buf.append(f"{nm}\t{st}\t{en}\t{sz}\n" if pos is None else _mem_line(f, nm, st, en, sz, next(pos)))
        if len(buf) >= 65536:
            write_all(out, "".join(buf))
            buf.clear()
    write_all(out, "".join(buf))
    return seq_id


def _mem_line(f, nm: str, st: int, en: int, sz: int, pos: list[tuple[int, int]]) -> str:
    line = f"{nm}\t{st}\t{en}\t{sz}"
    if pos:  # n_pos column only when > 0 (search.c:305)
        line += f"\t{len(pos)}"
    for sid, p in pos:
        pp = int(f.sid.lens[sid >> 1]) - (p + (en - st)) if sid & 1 else p
        line += f"\t{f.sid.names[sid >> 1]}:{'+-'[sid & 1]}:{pp}"
    return line + "\n"


# ---------------------------------------------------------------------------
# ssa, stat
# ---------------------------------------------------------------------------


def main_ssa(argv: list[str], device: str) -> int:
    from .formats.ssa import write_ssa
    from .ops.rank import OccIndex
    from .ssa_ops import ssa_gen, ssa_gen_cuda

    opts, args = ketopt(argv, "t:s:o:")
    ssa_shift, out_fn = 8, None
    for o, a in opts:
        if o == "-s":
            ssa_shift = atoi(a)
        elif o == "-o":
            out_fn = a
    if not args:
        return _usage("ssa")
    f = load_index(args[0])
    idx = OccIndex.from_dense(f, device)
    write_ssa(out_fn if out_fn else "-", ssa_gen(f, ssa_shift, occ=idx))
    log.info("%d ssa_gen launches (%s)", sum(ssa_gen_cuda.launches.values()), idx.layout, func="ssa")
    return 0


def main_stat(argv: list[str]) -> int:
    """ropebwt3_tpu/cli.py:772-787 over the port's loader."""
    opts, args = ketopt(argv, "M")
    if not args:
        _usage("stat")
        return 0
    f = load_index(args[0])
    a = f.acc
    print(f"{a[1]} sequences\n{a[6]} symbols\n{f.n_runs} runs\n{a[2] - a[1]} A\n{a[3] - a[2]} C\n{a[4] - a[3]} G\n"
          f"{a[5] - a[4]} T\n{a[6] - a[5]} N")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python -m ropebwt3_tpu_torch <command> <arguments>\nCommands: " + ", ".join(OWNED)
              + "; `python -m ropebwt3_tpu` runs the rest")
        return 0
    if why := refusal(argv):
        return _err(why)
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        print(REF_VERSION)
        return 0
    try:
        if cmd == "stat":
            ret = main_stat(rest)
        else:
            device, rest = _split_device(rest)
            if device not in ("cuda", "cpu"):
                return _err(f"invalid --device '{device}' (cuda|cpu)")
            if device == "cuda":
                import torch

                if not torch.cuda.is_available():
                    return _err("CUDA is not available; pass --device=cpu to run the plain PyTorch engine")
            ret = (main_mem if cmd == "mem" else main_ssa)(rest, device)
    except (IndexLoadError, getopt.GetoptError) as e:
        ret = _err(str(e))
    except BrokenPipeError:
        ret = 0
    if ret == 0 and len(argv) > 1:
        log.footer(argv, REF_VERSION)
    return ret
