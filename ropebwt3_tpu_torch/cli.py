"""`python -m ropebwt3_tpu_torch`: ropebwt3's command line for the commands
the port owns: `build`, `merge`, `plain2fmd`, `mem`, `ssa`, `stat` and
`version`.

`build [--device=cuda|cpu] [options] in.fa...` reads each file in batches
of -m symbols (each record then its reverse complement, 0-terminated),
suffix-sorts each batch into its multi-string BWT on the device
(construct/sa.py, K7), merges each later batch into the BWT so far on the
device (construct/merge.py, K6) and writes the index as plain text, FMD
(-d), FMR (-b), BRE (-e) or the -T tree, byte-equal to `python -m
ropebwt3_tpu build` with the same arguments.  `merge` merges FMD/FMR/BRE
indexes the same way and writes FMR; `plain2fmd` (host only) encodes a
plain-text BWT as FMD.

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

With the default `--device=cuda` and no CUDA, `build`, `merge`, `mem` and
`ssa` exit non-zero; they never go on on the CPU unasked.  Every other
command, and every option that the port's engines do not run, is refused
with one `ERROR:` line that names the ROADMAP queue item porting it
(`refusal`); `python -m ropebwt3_tpu` runs them.  The option parsers, the
usage texts, the index loader and the writers are copies of
ropebwt3_tpu/cli.py's (main_build, _dump_index, main_merge, main_plain2fmd,
main_search, _run_mem's flat path, main_ssa, main_stat).
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
from .nt6 import NT6_TABLE, char2nt6, nt6_to_str, revcomp
from .seqio import batch_nt6_flat, iter_flat_batches, read_batch_nt6, read_seqs, read_sid

REF_VERSION = "3.10-r281"  # ropebwt3 version whose formats and outputs are matched
OWNED = ("build", "merge", "plain2fmd", "mem", "ssa", "stat", "version")
# main_search's short and long options (ropebwt3_tpu/cli.py:1022-1029)
_SEARCH_OPTS = "Ll:c:t:K:MdN:A:B:O:E:C:m:k:uj:ey:a:w:p:bg:"
_LONG_OPTS = ["no-ssa", "seq", "gap=", "cov", "old-mem", "all-e2e", "no-kalloc", "dbg-dawg", "dbg-sw", "dbg-qname",
              "dbg-bt", "engine=", "mesh=", "occ="]
# the ROADMAP queue 1 item that ports each command or engine the port refuses
_ENGINE_ITEM = {"sw": "item 11 (sw scoring DP)", "hapdiv": "item 10 (hapdiv DP)",
                "search": "items 4, 10 and 11 (use `mem`, `sw` or `hapdiv`)"}
_COMMAND_ITEM = {**_ENGINE_ITEM, "get": "item 16", "suffix": "item 17", "kount": "item 18", "fa2line": "item 19",
                 "fa2kmer": "item 20"}


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
    "build": """Usage: python -m ropebwt3_tpu_torch build [options] <in.fa> [...]
Options:
  Algorithm:
    -m NUM      batch size [7G]
    -t INT      total number of threads [4]
    -p INT      #threads for sais and run sais and merge together (more RAM) [0]
    -l INT      leaf block size in B+-tree [512]
    -n INT      max number children per internal node [64]
    -2          use the ropebwt2 algorithm (libsais by default)
    -s          build BWT in the reverse lexicographical order (RLO; force -2)
    -r          build BWT in RCLO (force -2)
  Input:
    -i FILE     read existing index from FILE []
    -L          one sequence per line in the input
    -F          no forward strand
    -R          no reverse strand
  Output:
    -o FILE     output to FILE [stdout]
    -d          dump in the fermi-delta format (FMD)
    -b          dump in the ropebwt format (FMR)
    -e          dump in the BRE format
    -T          output the index in the Newick format (for debugging)
    -S FILE     save the current index to FILE after each input file []
  Device:
    --device=STR  cuda (the kernels) or cpu (the plain PyTorch versions) [cuda]""",
    "merge": """Usage: python -m ropebwt3_tpu_torch merge [options] <base.fmr> <other1.fmr> [...]
Options:
  -t INT     number of threads [1]
  -o FILE    output FMR to FILE [stdout]
  -S FILE    save the current index to FILE after each input file []
  --device=STR  cuda or cpu [cuda]""",
    "plain2fmd": "Usage: python -m ropebwt3_tpu_torch plain2fmd [-o output.fmd] <in.txt>",
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
_USAGE_STDOUT_LINES = {"build": 0, "merge": 4, "plain2fmd": 1, "mem": 1, "ssa": 0, "stat": 1}


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
# build, merge, plain2fmd (ropebwt3_tpu/cli.py:377-660, 718-749)
# ---------------------------------------------------------------------------


class CapacityError(Exception):
    """The work does not fit the card; raised before it starts, or from an
    allocation that failed on the card."""


def card_bytes(dev) -> int | None:
    """Bytes of the card this process can use: its free memory plus what
    PyTorch's allocator holds, live tensors included; None off the card."""
    import torch

    if dev.type != "cuda":
        return None
    return torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)


def _to_device(bwt: np.ndarray, dev):
    import torch

    return torch.from_numpy(np.ascontiguousarray(bwt, dtype=np.uint8)).to(dev)


def _merge_into(bwt, seq2, dev):
    """B2 (a uint8 BWT, host or device) merged into the device BWT `bwt`,
    on B1's rows built where it lies; the check comes first, so a merge
    that would not fit the card stops with one error, never on the host."""
    from .construct.merge import merge_bytes, merge_plain
    from .ops.rank import OccIndex

    n1, n2 = bwt.numel(), len(seq2)
    budget = card_bytes(dev)
    if budget is not None:
        need = merge_bytes(n1, n2, int((seq2 == 0).sum()))
        if need > budget:
            raise CapacityError(f"merging {n2} symbols into an index of {n1} needs ~{need} B of the card, which "
                                f"has {budget} B")
    return merge_plain(OccIndex.from_bwt(bwt), bwt, seq2)


def _launch_summary() -> str:
    from .construct.merge import merge_rank_cuda
    from .construct.sa import SA_LAUNCHES

    rank = ", ".join(f"{v} {k}" for k, v in sorted(merge_rank_cuda.launches.items())) or "0"
    return f"{sum(SA_LAUNCHES.values())} sa_round launches ({dict(SA_LAUNCHES)}); merge_rank launches: {rank}"


def main_build(argv: list[str], device: str) -> int:
    import torch

    from .construct.sa import SA_BYTES_PER_SYMBOL, gsa_bwt
    from .formats.fmr import write_fmr

    opts, args = ketopt(argv, "l:n:m:t:2sri:LFRo:dbTS:p:e")
    fmt, batch_size, user_m, is_line, is_for, is_rev = "plain", 7_000_000_000, False, False, True, True
    fn_in = fn_tmp = out_fn = None
    sort_order = 0
    for o, a in opts:
        # -t, -p, -l, -n and -2 are taken and change nothing, as in the JAX
        # package: -l/-n do not shape its dumped tree, -2 gives the same BWT,
        # and -p (sort the next batch while merging this one) changes only
        # timing there.  Here batches run in order on the one card, where
        # both phases would share the same SMs.
        if o == "-m":
            batch_size, user_m = parse_num(a), True
        elif o in ("-s", "-r"):
            sort_order = 1 if o == "-s" else 2
        elif o == "-i":
            fn_in = a
        elif o == "-L":
            is_line = True
        elif o == "-F":
            is_for = False
        elif o == "-R":
            is_rev = False
        elif o == "-o":
            out_fn = a
        elif o in ("-d", "-b", "-T", "-e"):
            fmt = {"-d": "fmd", "-b": "fmr", "-T": "tree", "-e": "bre"}[o]
        elif o == "-S":
            fn_tmp = a
    if not args and fn_in is None:
        return _usage("build")
    if not (is_for or is_rev):
        return _err("-F and -R leave no strand to index")
    dev = torch.device(device)
    bwt = None  # the BWT built so far, on the device
    if fn_in is not None:
        if sort_order != 0:
            return _err("-s/-r cannot be combined with -i yet")
        f = load_index(fn_in)
        bwt = _to_device(f.bwt[: f.n], dev)
        del f
    try:  # the input's size in symbols, roughly (its files' bytes, times the strands)
        est = sum(os.path.getsize(fn) for fn in args if fn != "-" and os.path.exists(fn))
    except OSError:
        est = 0
    est *= int(is_for) + int(is_rev)
    if not user_m and sort_order == 0:
        # the JAX package's auto batch size (ropebwt3_tpu/cli.py:446-460);
        # batch boundaries change no output, the merge keeps order
        if est > 160_000_000:
            batch_size = min(max(est // 6, 48_000_000), 320_000_000)
            log.info("auto batch size %d for ~%d input symbols (pass -m to override)", batch_size, est, func="main_build")
    budget, capped = card_bytes(dev), False
    if budget is not None:
        # half the card for a batch's suffix sort, the rest for the index
        cap = budget // (2 * (SA_BYTES_PER_SYMBOL + 1))
        capped = cap < batch_size
        batch_size = min(batch_size, cap)
        log.info("batch size %d symbols (the card has %d B; the suffix sort takes %d B a symbol)", batch_size, budget,
                 SA_BYTES_PER_SYMBOL + 1, func="main_build")

    def from_records(records):
        while (got := read_batch_nt6(records, batch_size, is_for, is_rev))[0]:
            yield got

    def batches():
        nonlocal n_batches
        for fn in args:
            if not seq_openable(fn):
                # build.c:209: report and move on to the next input
                print(f"ERROR: failed to open file '{fn}'", file=sys.stderr)
                continue
            strands = int(is_for) + int(is_rev)
            fb = iter_flat_batches(fn, is_line, max(1, batch_size // strands))
            if fb is not None:
                gen = (batch_nt6_flat(bflat, boffs, is_for, is_rev) for _names, bflat, boffs in fb)
            else:
                gen = from_records(read_seqs(fn, is_line))
            for n_seq, seq in gen:
                if n_seq == 0:
                    continue
                n_batches += 1
                log.info("read %d symbols", len(seq), func="main_build")
                if sort_order != 0:
                    if n_batches > 1 and capped:
                        raise IndexLoadError(
                            f"-s/-r sort the input as one batch, and the card takes batches of at most {batch_size} "
                            f"symbols ({budget} B at {2 * (SA_BYTES_PER_SYMBOL + 1)} B a symbol), but the input has "
                            + (f"~{est} symbols" if est > batch_size else f"more than {batch_size} symbols"))
                    if n_batches > 1:
                        raise IndexLoadError("-s/-r only supported within a single batch; raise -m")
                    seq = _sort_units(seq, sort_order)
                yield seq
            yield None  # file boundary (for -S checkpointing)

    n_batches = 0
    try:
        for seq in batches():
            if seq is None:
                if fn_tmp and bwt is not None:
                    write_fmr(fn_tmp, *_runs_of_bwt(bwt.cpu().numpy()))
                    log.info("saved the current index to '%s'", fn_tmp, func="main_build")
                continue
            n1 = 0 if bwt is None else bwt.numel()
            budget = card_bytes(dev)
            if budget is not None and (SA_BYTES_PER_SYMBOL + 1) * len(seq) + n1 > budget:
                raise CapacityError(f"a batch of {len(seq)} symbols does not fit the card beside an index of {n1} "
                                    f"symbols ({budget} B); lower -m")
            b2 = gsa_bwt(seq, dev)[0]
            log.info("constructed partial BWT for %d symbols", len(b2), func="main_build")
            bwt = b2 if bwt is None else _merge_into(bwt, b2, dev)
            if n1:
                log.info("merged the partial BWT for %d symbols", len(b2), func="main_build")
    except torch.OutOfMemoryError as e:
        raise CapacityError(f"out of card memory: {str(e).splitlines()[0]}") from e
    if bwt is None:
        return 1
    _dump_index(bwt.cpu().numpy(), fmt, out_fn)
    log.info(_launch_summary(), func="main_build")
    return 0


def _sort_units(seq: np.ndarray, sort_order: int) -> np.ndarray:
    """Reorder the 0-terminated units of a batch for RLO (-s) or RCLO (-r)
    construction: sentinels sort by position, so permuting the units into
    reverse-lexicographic or reverse-complement-lexicographic order gives the
    BWT the reference's inserter builds (mrope.c:300-385)."""
    ends = np.flatnonzero(seq == 0)
    starts = np.concatenate(([0], ends[:-1] + 1))
    units = [seq[s:e] for s, e in zip(starts, ends)]
    if sort_order == 1:  # RLO
        keys = [u[::-1].tobytes() for u in units]
    else:  # RCLO
        keys = [revcomp(u).tobytes() for u in units]
    order = sorted(range(len(units)), key=lambda t: keys[t])
    zero = np.zeros(1, dtype=np.uint8)
    return np.concatenate([x for t in order for x in (units[t], zero)])


def _runs_of_bwt(bwt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run-length encode a raw BWT array: (symbols uint8, lengths int64)."""
    if len(bwt) == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(bwt[1:] != bwt[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [len(bwt)]))
    return bwt[starts].copy(), (ends - starts).astype(np.int64)


def _dump_index(raw: np.ndarray, fmt: str, out_fn: str | None) -> None:
    """Write a BWT (uint8 array) as plain text, FMD, FMR, BRE or the -T tree."""
    from .formats.fmr import _pack_leaves, rle_decode_block, split_runs_into_buckets

    syms, lens = _runs_of_bwt(raw)
    out = sys.stdout.buffer if out_fn is None else open(out_fn, "wb")
    try:
        if fmt == "plain":
            write_all(out, nt6_to_str(raw).encode() + b"\n")
        elif fmt == "fmd":
            from .formats.fmd import encode_runs

            write_all(out, encode_runs(syms, lens))
        elif fmt == "fmr":
            from .formats.fmr import write_fmr_bytes

            write_all(out, write_fmr_bytes(split_runs_into_buckets(syms, lens)))
        elif fmt == "bre":
            from .formats.bre import write_bre_bytes

            write_all(out, write_bre_bytes(syms, lens))
        elif fmt == "tree":
            chunks = []
            for bs, bl in split_runs_into_buckets(syms, lens):
                leaves = _pack_leaves(bs, bl, 512)
                inner = ",".join("".join(nt6_to_str(np.repeat(c, l)) for c, l in rle_decode_block(d)) for d, _ in leaves)
                chunks.append("(" + inner + ")")
            write_all(out, ("".join(chunks) + "\n").encode())
    finally:
        if out_fn is not None:
            out.close()


def main_merge(argv: list[str], device: str) -> int:
    import torch

    from .formats.fmr import write_fmr

    opts, args = ketopt(argv, "t:o:S:")
    out_fn = fn_tmp = None
    for o, a in opts:
        if o == "-o":
            out_fn = a
        elif o == "-S":
            fn_tmp = a
    if len(args) < 2:
        return _usage("merge")
    dev = torch.device(device)
    f = load_index(args[0])
    bwt = _to_device(f.bwt[: f.n], dev)
    del f
    try:
        for fn in args[1:]:
            syms, lens = load_runs(fn)
            bwt = _merge_into(bwt, np.repeat(syms, lens), dev)
            if fn_tmp:
                write_fmr(fn_tmp, *_runs_of_bwt(bwt.cpu().numpy()))
    except torch.OutOfMemoryError as e:
        raise CapacityError(f"out of card memory: {str(e).splitlines()[0]}") from e
    write_fmr(out_fn if out_fn else "-", *_runs_of_bwt(bwt.cpu().numpy()))
    log.info(_launch_summary(), func="main_merge")
    return 0


def main_plain2fmd(argv: list[str]) -> int:
    """A plain-text BWT (nt6 letters; '\\n' and '$' are separators,
    main.c:320-326) as FMD, through the native encoder: one run list over
    all the files, so runs that meet across files merge, as one encoder's
    would."""
    from .formats.fmd import encode_runs

    opts, args = ketopt(argv, "o:")
    out_fn = None
    for o, a in opts:
        if o == "-o":
            out_fn = a
    if not args:
        return _usage("plain2fmd")
    syms, lens = [], []
    for fn in args:
        if fn == "-":
            data = sys.stdin.buffer.read()
        else:
            try:
                with open(fn, "rb") as fp:
                    data = fp.read()
            except OSError as e:
                raise IndexLoadError(f"failed to open file '{fn}': {e.strerror}") from e
        a = np.frombuffer(data, dtype=np.uint8)
        codes = NT6_TABLE[a]
        codes[(a == ord("\n")) | (a == ord("$"))] = 0
        s, l = _runs_of_bwt(codes)
        syms.append(s)
        lens.append(l)
    data = encode_runs(np.concatenate(syms), np.concatenate(lens))
    out = sys.stdout.buffer if out_fn is None else open(out_fn, "wb")
    try:
        write_all(out, data)
    finally:
        if out_fn is not None:
            out.close()
    return 0


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
        elif cmd == "plain2fmd":
            ret = main_plain2fmd(rest)
        else:
            device, rest = _split_device(rest)
            if device not in ("cuda", "cpu"):
                return _err(f"invalid --device '{device}' (cuda|cpu)")
            if device == "cuda":
                import torch

                if not torch.cuda.is_available():
                    return _err("CUDA is not available; pass --device=cpu to run the plain PyTorch engine")
            ret = {"build": main_build, "merge": main_merge, "mem": main_mem, "ssa": main_ssa}[cmd](rest, device)
    except (IndexLoadError, CapacityError, getopt.GetoptError) as e:
        ret = _err(str(e))
    except BrokenPipeError:
        ret = 0
    if ret == 0 and len(argv) > 1:
        log.footer(argv, REF_VERSION)
    return ret
