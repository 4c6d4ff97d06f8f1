"""`python -m ropebwt3_tpu_torch`: ropebwt3's command line in the port:
`build`, `merge`, `plain2fmd`, `mem`, `sw`, `hapdiv`, `search`, `ssa`,
`stat`, `get`, `suffix`, `kount`, `fa2line`, `fa2kmer`, `serve` and
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

`mem [--device=cuda|cpu] [--engine=auto|jax|native|hybrid|py]
[--occ=auto|dense|rb] [options] idx.fmd reads...` loads the index
(`load_index`), reads each file in flat batches of -K symbols
(`seqio.iter_flat_batches`), finds each batch's MEMs with `BatchedSmemTG`
on the device's occ rows (--occ auto: dense unless they would pass 75% of
the card's memory, ops/smem.py `resolve_occ`), and writes the BED from the
engine's flat (counts, rows), with `-c`, `--gap`, `--cov` and `-p`,
byte-equal to `python -m ropebwt3_tpu mem --engine=native`.  That is the
engine of `auto` and `jax`; `native` runs the threaded native SMEM-TG
engine (ops/smem_native.py) instead, each batch's BED written while the
next one runs, and builds no rows; `hybrid` splits each batch between the
two (align/cli_hooks.py `HybridEngine`, RB3TPU_MEM_SPLIT); `py` (or any
other value) runs ops/smem_ref.py's smem_tg read by read.  `--occ` and
`--mesh` apply to the card's engine.

`mem --old-mem` (and `search --old-mem`) runs the original ropebwt2/fermi
SMEM algorithm read by read on the host (ops/smem_ref.py `smem_orig`), as
the JAX package does, and writes its BED through the same writer.

`hapdiv [--device=cuda|cpu] [--engine=auto|native|jax|hybrid] [options]
idx.fmd seqs...` (and `mem -a/-w`, which run it) counts the haplotypes at
each edit distance of every -a-mer at step -w of each sequence: the
windows, batched across sequences, go through the hapdiv DP on the device
(align/hapdiv.py: the kernel of csrc/hapdiv.cu, or its plain version with
--device=cpu), the windows it flags rerun on the native DP
(native/bwasw_core.cpp), and the rows are written byte-equal to `python -m
ropebwt3_tpu hapdiv`, whose engine is the native DP; `--engine=native` runs
the native DP alone, `jax` is `auto`, and `hybrid` splits each batch
between the two (align/cli_hooks.py `HybridEngine`).

`sw [--device=cuda|cpu] [--engine=auto|native|jax|hybrid] [options] idx.fmd
reads...` (and `mem -d`, which runs it) aligns each read to the index with
BWA-SW: the reads, 4,096 a batch, are staged natively (the -j prefilter and
each read's DAWG), scored on the device (align/sw.py: the kernel of
csrc/sw.cu, or its plain version with --device=cpu), their hits taken from
the archive by the native backtrack, and the reads the device does not take
or flags rerun on the native engine; PAF, or --all-e2e / -g records,
byte-equal to `python -m ropebwt3_tpu sw`, whose engine is the native one;
the engines as `hapdiv`'s.  `--dbg-dawg`, `--dbg-sw`, `--dbg-qname` and
`--dbg-bt` write the Python DP's traces to stderr as the JAX package does
(align/bwasw.py; on auto and native the Python DP runs alone).  `search`
runs `mem`, `hapdiv` or `sw` by its options, as ropebwt3_tpu/cli.py
main_search does.

`ssa [--device=cuda|cpu] [-s INT] [-o FILE] [-t INT] idx.fmd` walks every
sequence on the device's dense occ rows (ssa_ops.py) and writes the SSA
file byte-equal to `python -m ropebwt3_tpu ssa`; `-t` is accepted and
unused, as the JAX package's own walk ignores it.  With `--mesh=DPxIDX`
the rows go to every device of the mesh and the walk's segments are split
over all of them (ssa_ops.py ssa_gen_mesh); `build --mesh=DPxIDX` runs each
merge's rank with B1's rows sharded over IDX devices and its segments split
over all of them (construct/merge.py merge_rank_mesh).  Either output is
byte-equal to the same command without `--mesh`.

`get [--device=cuda|cpu] idx.fmd INT...` walks LF from each valid k on the
device's dense rows (ops/walk.py retrieve_cuda, K11 of csrc/walk.cu, all k
in one walk); `suffix [--device=cuda|cpu] [-L] idx.fmd reads...` runs each
batch's backward searches at once (suffix_cuda, K12); `kount
[--device=cuda|cpu] [-k INT] [-m INT] idx.fmd...` expands the k-mer trie a
level at a time with one kount_rank launch a level and index (ops/kount.py,
csrc/kount.cu), its frontier on the device in BWT order.  `fa2line` and
`fa2kmer` run on the host.  The stdout of each is byte-equal to `python -m
ropebwt3_tpu`'s.

`serve [--device=cuda|cpu] [--engine=auto|native] [--warm=...]
[--warm-hapdiv=...] [--warm-sw=...] [--daemon] [--stop] idx.fmd` keeps the
index and one set of occ rows resident (server.py).  `mem` on auto or
hybrid, and `sw` and `hapdiv` on jax or hybrid, go to a server that holds
their index on their device when one answers (`route`), and run here when
none does; `mem`, `sw` and `hapdiv` with `--engine=server` go to one or
fail with one ERROR line; `search`, and `sw` and `hapdiv` on auto, stay
here.  That choice is made before torch is imported, so a request that a
server answers never imports it.  RB3TPU_AUTO_SERVE=1 starts a server in the
background when none answers `mem`.

`mem --mesh=DPxIDX` shards the occ rows over IDX devices and splits each
batch's reads over all DP x IDX of them (parallel/); `sw`, `hapdiv` and
`search --mesh=N` split each batch's reads or windows over N devices, the
rows replicated; `ssa` and `build` take it as above.  The devices are
cuda:0 .. (one a mesh slot; too few cards is one ERROR line), or the CPU
with --device=cpu.  Under torchrun the spec is global: its DP x IDX slots
are dealt out row by row, DP x IDX / WORLD_SIZE a process, each on its own
devices, and the processes join a gloo group.  An idx axis may span the
processes of one node: each slab is created and filled by the process that
holds its slot and mapped by every process of its dp row (parallel/mesh.py
ShardedRows, parallel/ipc.py); a dp row across hosts is one ERROR line.
Process 0 writes all output (parallel/launch.py), and with `ssa` and
`build` every process writes its own `-o` file.  The other commands skip
`--mesh`, and fa2kmer stops at it (`ERROR: unknown option`), as the JAX
package's do.

With the default `--device=cuda` and no CUDA, every command that runs on
the device stops with one `ERROR:` line; none goes on on the CPU unasked.
The exit code is the JAX package's (its main, after the reference's
main.c:46-82): 0 for every known command, its errors included, and 1 for
an unknown one; with RB3TPU_STRICT_EXIT=1, the
command's own code (`run`), and UNKNOWN_CMD for an unknown command.  The option parsers, the usage texts,
the index loader and the writers are copies of ropebwt3_tpu/cli.py's
(main_build, _dump_index, main_merge, main_plain2fmd, main_search, _run_mem's
flat path, main_ssa, main_stat, main_get, main_suffix, main_kount,
main_fa2line, main_fa2kmer).  The copies of align/cli_hooks.py,
align/bwasw.py and native/bwasw_core.cpp that `sw` and `hapdiv` run are
under align/ and native/.
"""

from __future__ import annotations

import getopt
import os
import re
import sys
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np

from . import log
from .bufio import write_all
from .index.dense import DenseFMIndex, runs_of_bwt
from .nt6 import COMP_TABLE, NT6_TABLE, char2nt6, nt6_to_str, revcomp
from .parallel import MeshError
from .seqio import batch_nt6_flat, iter_flat_batches, read_batch_nt6, read_seqs, read_sid

REF_VERSION = "3.10-r281"  # ropebwt3 version whose formats and outputs are matched
UNKNOWN_CMD = 127  # `run`'s code for an unknown command (ropebwt3_tpu/cli.py _UNKNOWN_CMD)
OWNED = ("build", "merge", "plain2fmd", "mem", "sw", "hapdiv", "search", "ssa", "stat", "get", "suffix", "kount",
         "fa2line", "fa2kmer", "serve", "version")
# main_search's short and long options (ropebwt3_tpu/cli.py:1022-1029)
_SEARCH_OPTS = "Ll:c:t:K:MdN:A:B:O:E:C:m:k:uj:ey:a:w:p:bg:"
_LONG_OPTS = ["no-ssa", "seq", "gap=", "cov", "old-mem", "all-e2e", "no-kalloc", "dbg-dawg", "dbg-sw", "dbg-qname",
              "dbg-bt", "engine=", "mesh=", "occ="]
DP_ENGINES = ("auto", "native", "jax", "hybrid")  # sw's and hapdiv's --engine (a server's: server.EngineCache.ENGINES)
# mem's --engine values that run K1 on the card (server: a resident server's
# own); native runs the native engine, any other value the Python one
MEM_DEVICE_ENGINES = ("auto", "jax", "hybrid", "server")
# sw's scoring options (ropebwt3_tpu/cli.py _SW_SCORING)
_SW_SCORING = """  -N INT      keep up to INT hits per DAWG node [25]
  -m INT      min alignment score [30]
  -A INT      match score [1]
  -B INT      mismatch penalty [3]
  -O INT      gap open penalty [5]
  -E INT      gap extension penalty; a k-long gap costs O+k*E [2]
  -y INT      ignore secondary hits scored INT lower than the best [-1]"""


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
    --device=STR  cuda (the kernels) or cpu (the plain PyTorch versions) [cuda]
    --mesh=DPxIDX  run the merge rank phase over a device mesh: its segments
                over all DP x IDX devices, occ rows over IDX devices; under
                torchrun the spec is global, an idx axis may span the
                processes of one node []""",
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
  --old-mem   use the original MEM algorithm, on the host (for testing)
  -L          one sequence per line in the input
  -K NUM      query batch size [100m]
  --device=STR  cuda (the kernels) or cpu (the plain PyTorch engine) [cuda]
  --mesh=DPxIDX shard over a device mesh: reads over all DP x IDX devices,
                occ rows over IDX devices (e.g. --mesh=4x2); under torchrun
                the spec is global, an idx axis may span the processes of
                one node []
  --occ=STR     device occ rows: auto, dense, rb (run-block compressed) [auto]""",
    "sw": f"""Usage: python -m ropebwt3_tpu_torch sw [options] <idx.fmr> <seq.fa> [...]
Options:
{_SW_SCORING}
  -e          end-to-end mode (forcing -k to 1)
  -j INT      min MEM length to initiate alignment [0]
  -k INT      require INT-mer match at the end of alignment [11]
  -b          align both strands (effective with --all-e2e)
  -u          write unmapped queries to PAF
  --seq       write reference sequence to the rs tag
  --all-e2e   write all end-to-end hits in a compact format (forcing -e)
  -g INT      cap the number of --all-e2e output to INT (forcing --all-e2e)
  --no-ssa    ignore the sampled suffix array
  -p INT      output up to INT positions [0]
  -L          one sequence per line in the input
  --device=STR  cuda (the kernel) or cpu (the plain PyTorch version) [cuda]
  --engine=STR  DP engine: auto or jax (the device), native (the host DP),
                hybrid (each batch split between the two) [auto]
  --mesh=N      run the device DP data-parallel over N devices (reads over
                the dp axis, tables replicated) []""",
    "search": "Usage: python -m ropebwt3_tpu_torch search [options] <idx.fmr> <seq.fa> [...]",
    "hapdiv": """Usage: python -m ropebwt3_tpu_torch hapdiv [options] <idx.fmr> <seq.fa> [...]
Options:
  -a INT      annotate sliding INT-mers [101]
  -w INT      k-mer step size for annotation [50]
  -N INT      keep up to INT hits per DAWG node [25]
  -m INT      min alignment score [30]
  -A INT      match score [1]
  -B INT      mismatch penalty [3]
  -O INT      gap open penalty [5]
  -E INT      gap extension penalty; a k-long gap costs O+k*E [2]
  -y INT      ignore secondary hits scored INT lower than the best [-1]
  -L          one sequence per line in the input
  --device=STR  cuda (the kernel) or cpu (the plain PyTorch version) [cuda]
  --engine=STR  DP engine: auto or jax (the device), native (the host DP),
                hybrid (each batch split between the two) [auto]
  --mesh=N      run the device DP data-parallel over N devices (windows over
                the dp axis, tables replicated) []""",
    "ssa": """Usage: python -m ropebwt3_tpu_torch ssa [options] <in.fmd>
Options:
  -t INT     number of threads [4]
  -s INT     sample rate one SA per 2**INT bases [8]
  -o FILE    output to file [stdout]
  --device=STR  cuda or cpu [cuda]
  --mesh=DPxIDX  generate on a device mesh: the LF walk's segments over all
                 DP x IDX devices, the occ rows on each; under torchrun the
                 spec is global []""",
    "stat": "Usage: python -m ropebwt3_tpu_torch stat [-M] <idx.fmd>",
    "get": "Usage: python -m ropebwt3_tpu_torch get <idx.fmr> <int> [...]",
    "suffix": """Usage: python -m ropebwt3_tpu_torch suffix [options] <idx.fmr> <seq.fa> [...]
Options:
  -L        one sequence per line in the input
  --device=STR  cuda (the kernel) or cpu (the plain PyTorch version) [cuda]""",
    "kount": """Usage: python -m ropebwt3_tpu_torch kount [options] <in1.fmd> [in2.fmd [...]]
Options:
  -k INT       k-mer length [51]
  -m INT       min k-mer occurrence [100]
  --device=STR  cuda or cpu [cuda]""",
    "fa2line": """Usage: python -m ropebwt3_tpu_torch fa2line [options] <seq.fa> [...]
Options:
  -R        no reverse strand""",
    "fa2kmer": """Usage: python -m ropebwt3_tpu_torch fa2kmer [options] <seq.fa> [...]
Options:
  -k INT      k-mer size [151]
  -w INT      step size [50]""",
}
# get, stat and plain2fmd print their usage on stdout, build, ssa and kount
# on stderr, the rest their first line on stdout (ropebwt3_tpu/cli.py:275-281)
_USAGE_STDOUT_LINES = {"build": 0, "merge": 4, "plain2fmd": 1, "mem": 1, "sw": 1, "search": 1, "hapdiv": 1, "ssa": 0,
                       "stat": 1, "get": 1, "suffix": 1, "kount": 0, "fa2line": 1, "fa2kmer": 1}


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
    """Why the port refuses `argv`, or None: an unknown command, or `search`
    with `--engine=server` (search never goes to a server).  `--mesh` is
    each command's own: mem, sw, hapdiv, search, build and ssa take it,
    fa2kmer (a strict parse) stops at it, and the others skip it, as the
    JAX package's commands do."""
    cmd, rest = argv[0], argv[1:]
    if cmd not in OWNED:
        return f"unknown command '{cmd}'"
    if cmd == "serve":
        return None  # server.py parses its own options
    # parsed as the commands parse them: ketopt takes `--name X`, `--name=X`
    # and unambiguous prefixes (no other long option of any command starts
    # with `e`); the last value wins
    engine = dict(ketopt(rest, "", ["engine="])[0]).get("--engine", "auto")
    if cmd == "search" and engine == "server":
        return "search never goes to a server: `--engine=server` takes mem, sw and hapdiv"
    return None


def route(cmd: str, rest: list[str]) -> int | None:
    """Send `cmd rest` to a resident server (server.py) where it belongs:
    `mem`, `sw` or `hapdiv` with `--engine=server` (one ERROR line when no
    server answers for the index on the request's device); without --mesh,
    when one answers, `mem` on auto or hybrid (its SMEM path, not -d, -a/-w
    or --old-mem) and `sw` and `hapdiv` (or `mem -d`, `mem -a/-w`) on jax or
    hybrid, as ropebwt3_tpu/cli.py:1161-1166 does: otherwise they run here.
    RB3TPU_AUTO_SERVE=1 starts a server in the background for `mem` on auto
    when none answers.  Returns the server's exit code, or None to run here.
    Imports no torch."""
    from . import server

    device, argv = _split_device(rest)
    opts, args = ketopt(argv, _SEARCH_OPTS, _LONG_OPTS)  # the command's own parse reports what is wrong
    engine, algo, mesh = "auto", cmd, False
    for o, a in opts:
        if o == "--engine":
            engine = a
        elif o == "--mesh":
            mesh = True
        elif o == "-d" and cmd == "mem":
            algo = "sw"
        elif o in ("-a", "-w") and cmd == "mem":
            algo = "hapdiv"
        elif o == "--old-mem" and cmd == "mem":
            algo = "mem_ori"
    sent = {"mem": ("auto", "hybrid"), "sw": ("jax", "hybrid"), "hapdiv": ("jax", "hybrid")}.get(algo, ())
    if len(args) < 2 or not (engine == "server" or (engine in sent and not mesh)):
        return None
    got = server.server_device(args[0])
    if got == device:
        try:
            return server.client_run(args[0], rest, cmd)
        except OSError as e:
            if engine == "server":
                return _err(f"server request failed: {e}")
            return None
    if engine == "server":
        if got is None:
            return _err(f"no server for '{args[0]}' (start one: python -m ropebwt3_tpu_torch serve {args[0]})")
        return _err(f"the server for '{args[0]}' runs on {got}, not {device}")
    if engine == "auto" and algo == "mem":
        server.maybe_autospawn(args[0], device)
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


def check_card(need: int, dev, what: str, layout: str) -> None:
    """A CapacityError naming the bytes unless `need` B of `layout` rows
    (`what`: whose) fit the card's budget (card_bytes), raised before any
    upload; nothing off the card."""
    import torch

    budget = card_bytes(torch.device(dev))
    if budget is not None and need > budget:
        raise CapacityError(f"{what} need ~{need} B of the card ({layout} rows), which has {budget} B")


def _to_device(bwt, dev):
    """The BWT on `dev`: a tensor as it is, a host array uploaded."""
    import torch

    if torch.is_tensor(bwt):
        return bwt.to(dev)
    return torch.from_numpy(np.ascontiguousarray(bwt, dtype=np.uint8)).to(dev)


def _on_host(bwt) -> np.ndarray:
    """The BWT in host memory: an array as it is, a tensor downloaded."""
    return bwt if isinstance(bwt, np.ndarray) else bwt.cpu().numpy()


def _placement(bwt, seq2, dev, mesh=None, host: bool = False) -> str:
    """Where merging seq2 (B2) into `bwt` runs, "card" or "host"
    (construct/merge.py placement, over `mesh` when given; with `host` an
    index already in host memory stays there; over a mesh under torchrun
    every process takes the host where any one would), logged with why:
    its bytes against the card's."""
    from .construct.merge import placement
    from .parallel import launch

    n1, n2, m2 = len(bwt), len(seq2), int((seq2 == 0).sum())
    where, why = placement(n1, n2, m2, dev, mesh)
    if host and where == "card":
        where, why = "host", f"the index stays in host memory ({why})"
    if mesh is not None and "host" in launch.all_gather(where) and where == "card":  # one answer for the job
        where, why = "host", f"another process's card path does not fit ({why})"
    log.info("merging %d symbols into %d on the %s: %s", n2, n1, where, why, func="merge")
    return where


def _merge_into(bwt, seq2, dev, mesh=None, where: str | None = None):
    """B2 (a uint8 BWT, host or device) merged into `bwt` (B1: a tensor on
    the card, or an array in host memory), where `_placement` puts it (or
    `where`).  On the card: B1 there (uploaded if it is in host memory), on
    its rows built where it lies (with `mesh`, whose first device is dev:
    those rows sharded over it, parallel/mesh.py ShardedRows, and the merge
    rank's segments split over its devices), the merged BWT a tensor there;
    the mesh's check comes first, so a merge that would not fit a card
    stops with one error.  On the host: construct/merge.py merge_host, B1's
    rows on the card, or with `mesh` merge_host_mesh, B1's rows slab by
    slab on the cards of its idx axis; the merged BWT in host memory."""
    import torch

    from .construct.merge import merge_host, merge_host_mesh, merge_mesh_bytes, merge_plain
    from .ops.rank import OccIndex
    from .parallel.mesh import ShardedRows, settle

    where = _placement(bwt, seq2, dev, mesh) if where is None else where
    if where == "host" and mesh is None:
        return merge_host(_on_host(bwt), seq2, dev)
    if where == "host":
        merged = merge_host_mesh(_on_host(bwt), seq2, mesh)
        settle()  # the slabs that other processes map go once every process has merged
        return merged
    bwt = _to_device(bwt, dev)
    if mesh is None:
        return merge_plain(OccIndex.from_bwt(bwt), bwt, seq2)
    n1, n2, m2 = bwt.numel(), len(seq2), int((seq2 == 0).sum())
    for d, b in merge_mesh_bytes(n1, n2, m2, mesh).items():
        budget = card_bytes(torch.device(d))
        if budget is not None and b > budget:
            raise CapacityError(f"merging {n2} symbols into an index of {n1} needs ~{b} B of {d}, which has {budget} B")
    rows = OccIndex.from_bwt(bwt)
    sharded = ShardedRows(rows, mesh)
    log.info("merge rank over %s", sharded.describe(), func="merge")
    merged = merge_plain(sharded.views, bwt, seq2)
    del sharded, rows
    settle()  # the slabs that other processes map go once every process has merged
    return merged


def _launch_summary() -> str:
    from .construct.merge import merge_rank_cuda
    from .construct.sa import SA_LAUNCHES

    rank = ", ".join(f"{v} {k}" for k, v in sorted(merge_rank_cuda.launches.items())) or "0"
    return f"{sum(SA_LAUNCHES.values())} sa_round launches ({dict(SA_LAUNCHES)}); merge_rank launches: {rank}"


def main_build(argv: list[str], device: str) -> int:
    import torch

    from .construct.sa import PACKED_MAX, SA_BYTES_PER_SYMBOL, bytes_per_symbol, gsa_bwt
    from .formats.fmr import write_fmr

    opts, args = ketopt(argv, "l:n:m:t:2sri:LFRo:dbTS:p:e", ["mesh="])
    fmt, batch_size, user_m, is_line, is_for, is_rev = "plain", 7_000_000_000, False, False, True, True
    fn_in = fn_tmp = out_fn = mesh_spec = None
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
        elif o == "--mesh":
            mesh_spec = a
    if not args and fn_in is None:
        return _usage("build")
    if not (is_for or is_rev):
        return _err("-F and -R leave no strand to index")
    # --mesh: each merge's rank over the mesh (B1's rows over its idx axis,
    # the segments over all its devices); the batches on its first device
    mesh = _cli_mesh(mesh_spec, device, None, "main_build")
    dev = torch.device(device) if mesh is None else mesh.devices[0]
    # the BWT built so far: a tensor on the card, or an array in host memory
    # (an index loaded by -i, or one that a merge left there: it stays)
    bwt, stay = None, False
    if fn_in is not None:
        if sort_order != 0:
            return _err("-s/-r cannot be combined with -i yet")
        f = load_index(fn_in)
        bwt = np.asarray(f.bwt[: f.n])
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
    budget, cap = card_bytes(dev), None
    if budget is not None:
        # half the card for a batch's suffix sort, the rest for the index;
        # batches stay on the packed path, which SA_BYTES_PER_SYMBOL sizes
        cap = min(budget // (2 * (SA_BYTES_PER_SYMBOL + 1)), PACKED_MAX - 1)
        log.info("batch size %d symbols (the card has %d B; the suffix sort takes %d B a symbol)", min(batch_size, cap),
                 budget, SA_BYTES_PER_SYMBOL + 1, func="main_build")
    # -s/-r read the one batch the JAX package reads, sort its units, and
    # cut the sorted stream at unit boundaries into batches the card takes:
    # sentinels sort by position and a merge keeps B1's sequences before
    # B2's, so the cuts change no output
    read_size = batch_size if sort_order != 0 or cap is None else min(batch_size, cap)

    def from_records(records):
        while (got := read_batch_nt6(records, read_size, is_for, is_rev))[0]:
            yield got

    def batches():
        nonlocal n_batches
        for fn in args:
            if not seq_openable(fn):
                # build.c:209: report and move on to the next input
                print(f"ERROR: failed to open file '{fn}'", file=sys.stderr)
                continue
            strands = int(is_for) + int(is_rev)
            fb = iter_flat_batches(fn, is_line, max(1, read_size // strands))
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
                    if n_batches > 1:
                        raise IndexLoadError("-s/-r only supported within a single batch; raise -m")
                    seq = _sort_units(seq, sort_order)
                    if cap is not None and len(seq) > cap:
                        cuts = _unit_cuts(seq, cap)
                        log.info("cut the sorted batch of %d symbols into %d batches of whole sequences, at most %d "
                                 "symbols each where a sequence allows", len(seq), len(cuts) - 1, cap, func="main_build")
                        yield from (seq[a:b] for a, b in zip(cuts[:-1], cuts[1:]))
                        continue
                yield seq
            yield None  # file boundary (for -S checkpointing)

    n_batches = 0
    for seq in batches():
        if seq is None:
            if fn_tmp and bwt is not None:
                write_fmr(fn_tmp, *runs_of_bwt(_on_host(bwt)))
                log.info("saved the current index to '%s'", fn_tmp, func="main_build")
            continue
        n1 = 0 if bwt is None else len(bwt)
        on_card = n1 if torch.is_tensor(bwt) else 0  # an index in host memory takes no card bytes
        budget = card_bytes(dev)
        if budget is not None and (bytes_per_symbol(len(seq)) + 1) * len(seq) + on_card > budget:
            raise CapacityError(f"a batch of {len(seq)} symbols does not fit the card beside an index of {on_card} "
                                f"symbols on it ({budget} B); lower -m")
        b2 = gsa_bwt(seq, dev)[0]
        log.info("constructed partial BWT for %d symbols", len(b2), func="main_build")
        if bwt is None:
            bwt = b2
        else:
            where = _placement(bwt, b2, dev, mesh, host=stay)
            if where == "host":
                bwt = _on_host(bwt)  # the card keeps no copy of B1 through a merge on the host
            bwt = _merge_into(bwt, b2, dev, mesh, where)
            stay = isinstance(bwt, np.ndarray)
        if n1:
            log.info("merged the partial BWT for %d symbols", len(b2), func="main_build")
    if bwt is None:
        return 1
    _dump_index(_on_host(bwt), fmt, out_fn)
    log.info(_launch_summary(), func="main_build")
    return 0


def _unit_cuts(seq: np.ndarray, cap: int) -> list[int]:
    """Cut points [0, ..., len(seq)] of a batch of 0-terminated units into
    runs of whole units of at most `cap` symbols each (a unit longer than
    the cap alone)."""
    ends = np.flatnonzero(seq == 0) + 1
    cuts = [0]
    while cuts[-1] < len(seq):
        j = int(np.searchsorted(ends, cuts[-1] + cap, side="right")) - 1
        if j < 0 or ends[j] <= cuts[-1]:
            j = int(np.searchsorted(ends, cuts[-1], side="right"))
        cuts.append(int(ends[j]))
    return cuts


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


def _dump_index(raw: np.ndarray, fmt: str, out_fn: str | None) -> None:
    """Write a BWT (uint8 array) as plain text, FMD, FMR, BRE or the -T tree."""
    from .formats.fmr import _pack_leaves, rle_decode_block, split_runs_into_buckets

    syms, lens = runs_of_bwt(raw)
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
    bwt, stay = np.asarray(f.bwt[: f.n]), False  # in host memory until a merge on the card takes it there
    del f
    for fn in args[1:]:
        syms, lens = load_runs(fn)
        seq2 = np.repeat(syms, lens)
        where = _placement(bwt, seq2, dev, host=stay)
        if where == "host":
            bwt = _on_host(bwt)  # the card keeps no copy of B1 through a merge on the host
        bwt = _merge_into(bwt, seq2, dev, where=where)
        stay = isinstance(bwt, np.ndarray)
        if fn_tmp:
            write_fmr(fn_tmp, *runs_of_bwt(_on_host(bwt)))
    write_fmr(out_fn if out_fn else "-", *runs_of_bwt(_on_host(bwt)))
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
        s, l = runs_of_bwt(codes)
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


def main_mem(argv: list[str], device: str, cmd: str = "mem", served=None) -> int:
    """`mem`, or `search` (cmd "search"): SMEMs, with --old-mem by the
    original algorithm on the host, or with -d sw and with -a/-w hapdiv, the
    last of them given (ropebwt3_tpu/cli.py:1053-1058, 1108-1109).
    `--engine` picks the SMEM engine as ropebwt3_tpu/cli.py:1384-1467 does,
    but for auto: `auto`, `jax` (and a server's own `server`) run K1 on
    `device` (`mem_engine`), where the JAX package's one-shot auto runs the
    native engine and its server's auto the hybrid; the port's auto is the
    card, as it is for `sw` and `hapdiv`.  `native` runs the native engine
    (ops/smem_native.py) alone, `hybrid` each batch split between K1 and the
    native engine (align/cli_hooks.py HybridEngine), and `py` or any other
    value smem_ref.smem_tg read by read.  `served`: a resident server's
    EngineCache (server.py), whose index and occ rows the request runs on."""
    try:
        opts, args = ketopt(argv, _SEARCH_OPTS, _LONG_OPTS, strict=True)
    except KetoptUnknown:
        return 1
    is_line, min_len, min_occ, max_pos, min_gap_len, write_cov = False, 19, 1, 0, 0, False
    occ, batch_size, algo, mesh_spec, engine = "auto", 100_000_000, "mem", None, "auto"
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
        elif o == "-d":
            algo = "sw"
        elif o in ("-a", "-w"):
            algo = "hapdiv"
        elif o == "--old-mem":
            algo = "mem_ori"
        elif o == "--mesh":
            mesh_spec = a
        elif o == "--engine":
            engine = a
    if algo == "hapdiv":
        return main_hapdiv(argv, device, cmd, served)
    if algo == "sw":
        return main_sw(argv, device, cmd, served)
    if len(args) < 2:
        return _usage(cmd)
    if min_gap_len > 0:
        max_pos = 0
    mesh = None if algo == "mem_ori" else _cli_mesh(mesh_spec, device, served, "mem", engine)
    f = _index(args[0], max_pos > 0, served)
    if max_pos > 0 and (f.ssa is None or f.sid is None):
        return _err("failed to load suffix array samples or sequence names/lengths")
    if not f.is_symmetric():
        return _err("BWT doesn't contain both strands")
    out = (f, args[1:], is_line, batch_size, min_gap_len, write_cov, max_pos)
    if algo == "mem_ori":
        from .ops.smem_ref import smem_orig

        _run_mem(_per_read(smem_orig, f, min_occ, min_len), *out)
        return 0
    from .ops.smem_native import smem_tg_flat_native

    def native(flat: np.ndarray, offs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return smem_tg_flat_native(f, flat, offs, min_occ, min_len)

    if engine == "native":
        n = _run_mem(native, *out, pipelined=True)
        log.info("native SMEM engine (ops/smem_native.py): %d reads on up to %d host threads; no smem_tg kernel or plain "
                 "version ran", n, os.cpu_count() or 1, func="mem")
        return 0
    if engine not in MEM_DEVICE_ENGINES:
        from .ops.smem_ref import smem_tg

        n = _run_mem(_per_read(smem_tg, f, min_occ, min_len), *out)
        log.info("Python SMEM engine (ops/smem_ref.py smem_tg, read by read): %d reads; no smem_tg kernel or plain "
                 "version ran", n, func="mem")
        return 0
    from .ops.smem import smem_tg_cuda, smem_tgc_cuda

    eng = card = mem_engine(f, min_occ, min_len, device, occ, served, mesh, engine)
    if engine == "hybrid":
        from .align.cli_hooks import MEM_SPLIT, MEM_SPLIT_MAX, HybridEngine, log_hybrid

        eng = HybridEngine(card, native, MEM_SPLIT, MEM_SPLIT_MAX)
    if mesh is not None:
        from .parallel.launch import DistMem, world

        eng = DistMem(eng) if world()[1] > 1 else eng
    try:
        _run_mem(eng.run_flat, *out, pipelined=engine == "hybrid")
    finally:
        if engine == "hybrid":
            log_hybrid(eng, "reads", "mem")
    lay = card.idx.layout
    log.info("%d smem_tg launches (%s): %d chunked, %d one-thread; %d reads rerun on the card, %d unmerged, %d whole",
             smem_tgc_cuda.launches[lay] + smem_tg_cuda.launches[lay], lay, smem_tgc_cuda.launches[lay],
             smem_tg_cuda.launches[lay], card.n_rerun, card.n_unmerged, card.n_whole, func="mem")
    return 0


def mem_engine(f, min_occ: int, min_len: int, device: str, occ: str, served, mesh, engine: str = "auto"):
    """The card's SMEM engine of `mem` (ops/smem.py BatchedSmemTG) over a
    resident server's rows when `served`, else over rows it builds.  For
    `--engine=hybrid` it is built on a worker thread (`Building`), so the
    rows are made while the native half runs its share of the first batch."""
    from .ops.smem import BatchedSmemTG

    rows = None if served is None else served.mem_rows(occ)

    def build():
        return BatchedSmemTG(f, min_occ, min_len, device=device, occ=occ, rows=rows, mesh=mesh)

    return Building(build) if engine == "hybrid" else build()


class Building:
    """An object that `build()` makes on a worker thread from now on: its
    attributes (run_flat, idx, ...) wait for it and raise what the build
    raised."""

    def __init__(self, build):
        from concurrent.futures import ThreadPoolExecutor

        ex = ThreadPoolExecutor(1)
        self._made = ex.submit(build)
        ex.shutdown(wait=False)  # its thread ends once the build has

    def __getattr__(self, name):
        return getattr(self._made.result(), name)


def _per_read(fn, f, min_occ: int, min_len: int):
    """A host SMEM algorithm of ops/smem_ref.py (smem_tg, smem_orig), read by
    read, as an engine's run_flat: (counts, rows) of a flat batch."""

    def run_flat(flat: np.ndarray, offs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        mems = [fn(f, flat[offs[i] : offs[i + 1]], min_occ, min_len) for i in range(len(offs) - 1)]
        counts = np.array([len(m) for m in mems], np.int64)
        rows = np.array([(m.start, m.end, m.size, m.lo, m.lo_rc) for ms in mems for m in ms], np.int64)
        return counts, rows.reshape(-1, 5)

    return run_flat


def _cli_mesh(spec: str | None, device: str, served, func: str, engine: str = "auto"):
    """This process's share of the global `--mesh=spec` (parallel/launch.py
    `local_mesh`: under torchrun a dp row may span the processes of one
    node, and the process joins the process group), or None: no
    spec, or one that the engine ignores, with the JAX package's warning
    (ropebwt3_tpu/align/cli_hooks.py:133-142): a host engine (any
    `--engine` but auto, jax and hybrid) or a resident server's engine
    answers."""
    if not spec:
        return None
    if served is not None or engine == "server":
        sys.stderr.write(f"[W::{func}] --mesh={spec} ignored: the resident server's engine answers (serve takes no "
                         "--mesh)\n")
        return None
    if engine not in ("auto", "jax", "hybrid"):
        sys.stderr.write(f"[W::{func}] --mesh={spec} ignored with --engine={engine} (host engine)\n")
        return None
    from .parallel import launch

    mesh = launch.local_mesh(spec, device)
    launch.init()
    return mesh


def _search_args(argv: list[str], cmd: str):
    """main_search's parse (ropebwt3_tpu/cli.py:1031-1132) for the sw and
    hapdiv options: a namespace of them, or an exit code (an unknown
    option).  `--gap` > 0 zeroes max_pos, not sw_opts' copy; the `--dbg-*`
    flags go to sw_opts["dbg"], for this command only."""
    from .align.bwasw import DBG_OPTS

    try:
        opts, args = ketopt(argv, _SEARCH_OPTS, _LONG_OPTS, strict=True)
    except KetoptUnknown:
        return 1
    a = SimpleNamespace(args=args, is_line=False, k=101, w=50, max_pos=0, min_gap_len=0, no_ssa=False, engine="auto",
                        mesh=None)
    a.sw_opts = {
        "n_best": 25, "min_sc": 30, "match": 1, "mis": 3, "gap_open": 5, "gap_ext": 2, "end_len": 11,
        "min_mem_len": 0, "e2e_drop": -1, "r2cache_size": 0x10000, "max_pos": 0, "e2e": False, "keep_rs": False,
        "write_all": False, "max_all_out": 0, "both_dir": False, "write_unmap": False, "dbg": 0,
    }
    for o, v in opts:
        if o == "-L":
            a.is_line = True
        elif o == "-a":
            a.k = atoi(v)
        elif o == "-w":
            a.w = atoi(v)
        elif o == "-g":
            a.sw_opts.update(max_all_out=atoi(v), write_all=True, e2e=True, end_len=1)
            a.no_ssa = True
        elif o == "-p":
            a.max_pos = a.sw_opts["max_pos"] = atoi(v)
        elif o in ("-N", "-A", "-B", "-O", "-E", "-m", "-k", "-j", "-y"):
            a.sw_opts[{"-N": "n_best", "-A": "match", "-B": "mis", "-O": "gap_open", "-E": "gap_ext", "-m": "min_sc",
                       "-k": "end_len", "-j": "min_mem_len", "-y": "e2e_drop"}[o]] = atoi(v)
        elif o == "-C":
            a.sw_opts["r2cache_size"] = parse_num(v)
        elif o == "-e":
            a.sw_opts.update(e2e=True, end_len=1)
        elif o == "-u":
            a.sw_opts["write_unmap"] = True
        elif o == "-b":
            a.sw_opts["both_dir"] = True
        elif o == "--no-ssa":
            a.no_ssa = True
        elif o == "--seq":
            a.sw_opts["keep_rs"] = True
        elif o == "--gap":
            a.min_gap_len = parse_num(v)
        elif o == "--all-e2e":
            a.sw_opts.update(write_all=True, e2e=True, end_len=1)
            a.no_ssa = True
        elif o == "--engine":
            a.engine = v
        elif o == "--mesh":
            a.mesh = v
        elif o == "--occ" and v not in ("auto", "dense", "rb"):
            raise getopt.GetoptError(f"invalid --occ value '{v}' (auto|dense|rb)")
        elif o in DBG_OPTS:
            a.sw_opts["dbg"] |= DBG_OPTS[o]
    if a.min_gap_len > 0:
        a.max_pos = 0
    return a


def _index(fn: str, load_all: bool, served):
    """load_index(fn) with the SSA and sequence lengths when `load_all`, or
    the resident server's copy of them (server.py EngineCache.index)."""
    if served is not None:
        return served.index(fn, load_all)
    return load_index(fn, load_ssa=load_all, load_sid=load_all)


def _search_index(a, cmd: str, load_all: bool, served=None):
    """The index of a search command, or an exit code: usage with too few
    arguments, an engine the port does not run, or an index that cannot
    serve the options (a server's EngineCache.ENGINES include its own)."""
    if len(a.args) < 2:
        return _usage(cmd)
    engines = DP_ENGINES if served is None else served.ENGINES
    if a.engine not in engines:
        return _err(f"invalid --engine '{a.engine}' ({'|'.join(engines)})")
    f = _index(a.args[0], load_all, served)
    if a.max_pos > 0 and (f.ssa is None or f.sid is None):
        return _err("failed to load suffix array samples or sequence names/lengths")
    if not f.is_symmetric():
        return _err("BWT doesn't contain both strands")
    return f


def _dp_engine(a, device: str, served, func: str) -> dict:
    """run_sw_cli / run_hapdiv_cli's engine arguments: the engine's name;
    unless it is native, the device, and with --mesh the devices of its dp
    rows (one each; the rows replicated); on a resident server its
    EngineCache.dp_engine decides the device."""
    mesh = _cli_mesh(a.mesh, device, served, func, a.engine)
    if served is not None:
        return {**served.dp_engine(a.engine), "engine": a.engine}
    if a.engine == "native":
        return {"engine": "native"}
    return {"device": device, "engine": a.engine,
            **({} if mesh is None else {"mesh": [next(d for d in row if d is not None) for row in mesh.grid]})}


def main_sw(argv: list[str], device: str, cmd: str = "sw", served=None) -> int:
    """`sw`, or `mem -d` / `search -d` (cmd "mem" / "search"): `sw` and
    `search` load the SSA unless --no-ssa, `mem` only with -p
    (ropebwt3_tpu/cli.py:1134-1145)."""
    from .align.cli_hooks import run_sw_cli

    a = _search_args(argv, cmd)
    if isinstance(a, int):
        return a
    f = _search_index(a, cmd, a.max_pos > 0 if cmd == "mem" else not a.no_ssa, served)
    if isinstance(f, int):
        return f
    return run_sw_cli(f, a.args[1:], a.is_line, a.sw_opts, **_dp_engine(a, device, served, "sw"))


def main_hapdiv(argv: list[str], device: str, cmd: str = "hapdiv", served=None) -> int:
    """`hapdiv`, or `mem -a/-w` / `search -a/-w` (cmd "mem" / "search"):
    `hapdiv` sets end_len 1 and e2e, the others keep -k's end_len
    (ropebwt3_tpu/cli.py:1137-1140)."""
    from .align.cli_hooks import run_hapdiv_cli

    a = _search_args(argv, cmd)
    if isinstance(a, int):
        return a
    if cmd == "hapdiv":
        a.sw_opts["end_len"], a.sw_opts["e2e"] = 1, True
    f = _search_index(a, cmd, cmd == "mem" and a.max_pos > 0, served)
    if isinstance(f, int):
        return f
    return run_hapdiv_cli(f, a.args[1:], a.is_line, a.sw_opts, a.k, a.w, **_dp_engine(a, device, served, "hapdiv"))


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


def _run_mem(run_flat, f, files: list[str], is_line: bool, batch_size: int, min_gap_len: int, write_cov: bool,
             max_pos: int, pipelined: bool = False) -> int:
    """The BED of every read of `files` through an engine's `run_flat`, a
    flat batch of ~batch_size symbols at a time.  `pipelined` (an engine
    that releases the GIL: the native one, the hybrid): batch i+1 runs on a
    worker thread while batch i's BED is written, as
    ropebwt3_tpu/cli.py:1449-1467 does.  Returns the reads run."""
    seq_id = n_reads = 0

    def emit(names, offs, got) -> None:
        nonlocal seq_id
        if got is not None:  # None: a process of a torchrun job other than 0 (process 0 writes)
            seq_id = write_bed(sys.stdout, f, names, offs, *got, seq_id, min_gap_len, write_cov, max_pos)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as ex:
        for fn in files:
            if not seq_openable(fn):
                # search.c:571-575: report and stop processing further files
                print(f"ERROR: failed to load the sequence file '{fn}'", file=sys.stderr)
                break
            batches = iter_flat_batches(fn, is_line, batch_size)
            pend = None
            for names, flat, offs in batches if batches is not None else record_batches(fn, is_line, batch_size):
                n_reads += len(names)
                if not pipelined:
                    emit(names, offs, run_flat(flat, offs))
                    continue
                fut = ex.submit(run_flat, flat, offs)
                if pend is not None:
                    emit(pend[0], pend[1], pend[2].result())
                pend = (names, offs, fut)
            if pend is not None:
                emit(pend[0], pend[1], pend[2].result())
    return n_reads


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
    from .ops.rank import needs_int64
    from .ssa_ops import ssa_gen, ssa_gen_cuda, ssa_gen_mesh

    opts, args = ketopt(argv, "t:s:o:", ["mesh="])
    ssa_shift, out_fn, mesh_spec = 8, None, None
    for o, a in opts:
        if o == "-s":
            ssa_shift = atoi(a)
        elif o == "--mesh":
            mesh_spec = a
        elif o == "-o":
            out_fn = a
    if not args:
        return _usage("ssa")
    mesh = _cli_mesh(mesh_spec, device, None, "ssa")
    f = load_index(args[0])
    if mesh is not None:
        # the rows once a device, the walk's segments over all the mesh's
        # devices; under torchrun every process writes its own -o file
        write_ssa(out_fn if out_fn else "-", ssa_gen_mesh(f, ssa_shift, mesh))
        log.info("%d ssa_gen range launches (%s) over a %s", sum(ssa_gen_mesh.launches.values()),
                 "dense64" if needs_int64(f.n) else "dense32", mesh, func="ssa")
        return 0
    idx = occ_rows([f], device, "ssa")[0]
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


# ---------------------------------------------------------------------------
# get, suffix, kount (ropebwt3_tpu/cli.py:757-770, 790-920)
# ---------------------------------------------------------------------------

SUFFIX_BATCH = 1 << 26  # symbols of reads a suffix_walk launch


def _lap(sec: Counter, piece: str, t0: float) -> float:
    """Add the seconds since t0 to sec[piece]; return now."""
    t = time.perf_counter()
    sec[piece] += t - t0
    return t


def _log_pieces(sec: Counter, func: str) -> None:
    log.info("wall seconds by piece: %s", ", ".join(f"{k} {v:.3f}" for k, v in sec.items()), func=func)


def occ_rows(fs: list[DenseFMIndex], device: str, func: str, occ: str = "auto") -> list:
    """The occ rows of each index on `device` that `get`, `suffix`, `kount`
    and `ssa` run on: the layout ops/smem.py `resolve_occ` picks for the
    indexes' total n, as `mem` picks it (dense rows, or rb rows where dense
    ones would pass the card's budget; RB3TPU_DEVICE_OCC overrides), the
    width from each n.  rb rows come from the `.rb.npz` cache where it is
    fresh.  On the card, a CapacityError naming the bytes unless they all
    fit, before any upload or launch.  Logs the layout, its block size and
    the bytes on the device under `func`."""
    import torch

    from .ops import runblock
    from .ops.rank import OccIndex
    from .ops.smem import resolve_occ

    dev = torch.device(device)
    layout = resolve_occ(occ, sum(f.n for f in fs), dev)
    if layout == "rb":
        host = [runblock.from_dense_np(f) for f in fs]
        need = sum(runblock.device_bytes(d) for d in host)
    else:
        need = sum(48 * len(f.occ_block) for f in fs)
    check_card(need, dev, f"the occ rows of {len(fs)} index(es)", layout)
    try:
        rows = ([runblock.RunBlockIndex.from_np(d, dev) for d in host] if layout == "rb"
                else [OccIndex.from_dense(f, dev) for f in fs])
    except torch.OutOfMemoryError as e:
        raise CapacityError(f"out of card memory: {str(e).splitlines()[0]}") from e
    for x in rows:
        s = f"block size S {x.S}, {x.n_esc} escape blocks, " if layout == "rb" else ""
        log.info("occ layout %s (%s%s rows): %d bytes on %s", x.layout, s, "int64" if x.int64 else "int32", x.nbytes,
                 x.device, func=func)
    return rows


def main_get(argv: list[str], device: str) -> int:
    """Each k of the arguments in [0, n) (C atol: garbage is 0), its
    sequence decoded by one LF walk of all of them at once (retrieve_cuda:
    segments, forward symbols, one download)."""
    from .ops.walk import retrieve_cuda

    opts, args = ketopt(argv, "")
    if len(args) < 2:
        _usage("get")
        return 0
    sec, t0 = Counter(), time.perf_counter()
    f = load_index(args[0])
    ks = [atoi(s) for s in args[1:]]
    valid = [k for k in ks if 0 <= k < f.n]
    if not valid:
        return 0
    t0 = _lap(sec, "load", t0)
    idx = occ_rows([f], device, "get")[0]
    t0 = _lap(sec, "rows", t0)
    seqs, ends = retrieve_cuda(idx, valid)
    t0 = _lap(sec, "walk", t0)
    out, i = [], 0
    for k in ks:
        if 0 <= k < f.n:
            out.append(f">{k} {ends[i]}\n{nt6_to_str(seqs[i])}\n")
            i += 1
    write_all(sys.stdout, "".join(out))
    _lap(sec, "write", t0)
    log.info("%d retrieve_seg walks (%s)", retrieve_cuda.launches[idx.layout], idx.layout, func="get")
    _log_pieces(sec, "get")
    return 0


def main_suffix(argv: list[str], device: str) -> int:
    """Per read: name, where its longest suffix matching the index starts,
    its length and the last non-empty interval's size; the reads of each
    batch searched at once (suffix_cuda)."""
    import torch

    from .ops.walk import suffix_cuda

    opts, args = ketopt(argv, "L")
    is_line = any(o == "-L" for o, _ in opts)
    if len(args) < 2:
        _usage("suffix")
        return 0
    sec, t0 = Counter(), time.perf_counter()
    f = load_index(args[0])
    t0 = _lap(sec, "load", t0)
    idx = occ_rows([f], device, "suffix")[0]
    t0 = _lap(sec, "rows", t0)
    rec_num = 0
    for fn in args[1:]:
        if not seq_openable(fn):
            # the reference crashes here (main.c main_suffix has no NULL
            # check); the JAX package reports it and goes on
            print(f"ERROR: failed to open file '{fn}'", file=sys.stderr)
            continue
        batches = iter_flat_batches(fn, is_line, SUFFIX_BATCH)
        for names, flat, offs in batches if batches is not None else record_batches(fn, is_line, SUFFIX_BATCH):
            t0 = _lap(sec, "read", t0)
            start, last = suffix_cuda(idx, torch.from_numpy(np.ascontiguousarray(flat, np.uint8)).to(idx.device),
                                      torch.from_numpy(np.asarray(offs, np.int64)).to(idx.device))
            start, last = start.tolist(), last.tolist()
            t0 = _lap(sec, "search", t0)
            lines = []
            for name, st, ln, sz in zip(names, start, np.diff(offs).tolist(), last):
                rec_num += 1
                lines.append(f"{name if name else f'seq{rec_num}'}\t{st}\t{ln}\t{sz}\n")
            write_all(sys.stdout, "".join(lines))
            t0 = _lap(sec, "write", t0)
    log.info("%d suffix_walk launches (%s)", suffix_cuda.launches[idx.layout], idx.layout, func="suffix")
    _log_pieces(sec, "suffix")
    return 0


def main_kount(argv: list[str], device: str) -> int:
    """The k-mers of length -k that occur at least -m times in any of the
    indexes, with their counts in each, as ropebwt3_tpu/cli.py main_kount
    expands them: the trie a level at a time (ops/kount.py kount_levels:
    one kount_rank launch of the frontier's (k, l) a level and index, the
    frontier kept on the device in BWT order); the lines sorted into the
    reference's DFS order at the end."""
    from .ops.kount import kount_levels, kount_rank_cuda

    opts, args = ketopt(argv, "k:m:")
    depth, min_occ = 51, 100
    for o, a in opts:
        if o == "-k":
            depth = atoi(a)
        elif o == "-m":
            min_occ = atoi(a)
    if not args:
        return _usage("kount")
    sec, t0 = Counter(), time.perf_counter()
    fs = [load_index(fn) for fn in args]
    if depth <= 0:
        return 0
    t0 = _lap(sec, "load", t0)
    idxs = occ_rows(fs, device, "kount")
    t0 = _lap(sec, "rows", t0)
    widths = []
    last = kount_levels(idxs, depth, min_occ, on_level=lambda d, ks, ls, chars: widths.append(len(ks[0])))
    if last is None or len(last[0]) == 0:
        return 0
    log.info("%d kount_rank launches (%s), the widest of %d nodes", sum(kount_rank_cuda.launches.values()),
             idxs[0].layout, max(widths), func="kount")
    chars, leaf_occ = (t.cpu().numpy() for t in last)
    t0 = _lap(sec, "levels", t0)
    # the reference's DFS order: children are pushed ascending and popped
    # off a stack (descending) at every internal level, while the last level
    # prints ascending; np.lexsort's last key is the primary one
    keys = [chars[:, depth - 1]] + [-(chars[:, j].astype(np.int16)) for j in range(depth - 2, -1, -1)]
    order = np.lexsort(keys)
    strs = np.frombuffer(b"$ACGTN", np.uint8)[chars[:, ::-1]]
    t0 = _lap(sec, "sort", t0)
    write_all(sys.stdout, "".join(strs[i].tobytes().decode() + "\t" + "\t".join(str(int(c)) for c in leaf_occ[i]) + "\n"
                                  for i in order))
    _lap(sec, "write", t0)
    _log_pieces(sec, "kount")
    return 0


# ---------------------------------------------------------------------------
# fa2line, fa2kmer (host only; ropebwt3_tpu/cli.py:922-1015)
# ---------------------------------------------------------------------------


def _fa2line_native(argv: list[str]) -> int:
    """`fa2line [-R] files` through the native program (native/fa2line.cpp,
    built at first use; a failed build raises): its stdout copied to ours
    as it comes, its stderr after; its exit code."""
    import subprocess
    import threading

    from .native import fa2line_binary

    sys.stdout.flush()
    proc = subprocess.Popen([fa2line_binary(), *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    err: list[bytes] = []
    drain = threading.Thread(target=lambda: err.append(proc.stderr.read()))
    drain.start()
    while chunk := proc.stdout.read(1 << 22):
        write_all(sys.stdout.buffer, chunk)
    drain.join()
    sys.stderr.write(b"".join(err).decode(errors="replace"))
    return proc.wait()


def _fa2line_shape(argv: list[str]) -> bool:
    """Whether argv is the shape bin/rb3tpu hands to the JAX package's
    native fa2line: -R and file names (or -) only, at least one file."""
    return any(a != "-R" for a in argv) and all(a in ("-R", "-") or not a.startswith("-") for a in argv)


def main_fa2line(argv: list[str]) -> int:
    if _fa2line_shape(argv):
        return _fa2line_native(argv)
    opts, args = ketopt(argv, "R")
    no_rev = any(o == "-R" for o, _ in opts)
    if not args:
        _usage("fa2line")
        return 0
    tab = np.frombuffer(b"\nACGTX", dtype=np.uint8)
    for fn in args:
        if not seq_openable(fn):
            print(f"ERROR: failed to open file '{fn}'", file=sys.stderr)
            continue
        fb = iter_flat_batches(fn, False, 1 << 26)
        if fb is not None:
            for _names, bflat, boffs in fb:
                nrec = len(boffs) - 1
                if nrec and len(bflat) >= (nrec << 8):
                    # long records: two whole-buffer maps and a slice a
                    # record (record i's rc line is a window of the reversed
                    # buffer)
                    fwd = tab[bflat]
                    parts: list[bytes] = []
                    if no_rev:
                        for i in range(nrec):
                            parts += [fwd[boffs[i] : boffs[i + 1]].tobytes(), b"\n"]
                    else:
                        crev = tab[COMP_TABLE[bflat]][::-1]
                        T = len(bflat)
                        for i in range(nrec):
                            parts += [fwd[boffs[i] : boffs[i + 1]].tobytes(), b"\n",
                                      crev[T - boffs[i + 1] : T - boffs[i]].tobytes(), b"\n"]
                    write_all(sys.stdout.buffer, b"".join(parts))
                    continue
                # the [fwd, 0][, rc, 0] construction layout is the fa2line
                # output under the "\nACGTX" map (separators = line breaks)
                _, seq = batch_nt6_flat(bflat, boffs, True, not no_rev)
                write_all(sys.stdout.buffer, tab[seq].tobytes())
            continue
        for rec in read_seqs(fn, False):
            s = char2nt6(rec.seq)
            sys.stdout.buffer.write(tab[s].tobytes() + b"\n")
            if not no_rev:
                sys.stdout.buffer.write(tab[revcomp(s)].tobytes() + b"\n")
    return 0


def main_fa2kmer(argv: list[str]) -> int:
    try:
        opts, args = ketopt(argv, "k:w:", strict=True)
    except KetoptUnknown:
        return 1
    kmer, step = 151, 50
    for o, a in opts:
        if o == "-k":
            kmer = atoi(a)
        elif o == "-w":
            step = atoi(a)
    if not args:
        _usage("fa2kmer")
        return 0
    if step <= 0:
        # the reference walks i += step unguarded and faults on a negative
        # seq[i] read (main.c fa2kmer loop); this must not hang
        print(f"ERROR: step size must be positive, got {step}", file=sys.stderr)
        return 1
    for fn in args:
        if not seq_openable(fn):
            print(f"ERROR: failed to open file '{fn}'", file=sys.stderr)
            continue
        buf: list[bytes] = []
        for rec in read_seqs(fn, False):
            seq, L = rec.seq, len(rec.seq)
            name = (rec.name or "").encode()
            i = 0
            while i < L:
                en = L if i + step + kmer > L else i + kmer
                buf.append(b">%s:%d-%d\n%s\n" % (name, i + 1, en, seq[i:en]))
                if en == L:
                    break
                i += step
            if len(buf) >= 65536:
                write_all(sys.stdout.buffer, b"".join(buf))
                buf.clear()
        write_all(sys.stdout.buffer, b"".join(buf))
    return 0


def main(argv: list[str] | None = None) -> int:
    """The command line's exit code: `run`'s where RB3TPU_STRICT_EXIT=1,
    else 0 for every known command and 1 for an unknown one, as the JAX
    package's main gives it."""
    ret = run(sys.argv[1:] if argv is None else argv)
    if os.environ.get("RB3TPU_STRICT_EXIT") == "1":
        return ret
    return 1 if ret == UNKNOWN_CMD else 0


def run(argv: list[str]) -> int:
    """Run one command: its own exit code (1 on an ERROR line, UNKNOWN_CMD
    for an unknown command)."""
    if not argv:
        print("Usage: python -m ropebwt3_tpu_torch <command> <arguments>\nCommands: " + ", ".join(OWNED)
              + "; `python -m ropebwt3_tpu` runs the rest")
        return 0
    if why := refusal(argv):
        _err(why)
        return UNKNOWN_CMD if argv[0] not in OWNED else 1
    cmd, rest = argv[0], argv[1:]
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # a torchrun job: only process 0 owns stdout; raw fd 1 goes to
        # stderr in every process, so the connection banner gloo prints at
        # its first collective stays out of the output (ropebwt3_tpu/cli.py main)
        sys.stdout.flush()
        out_fd = os.dup(1) if int(os.environ.get("RANK", "0")) == 0 else None
        os.dup2(2, 1)
        sys.stdout = os.fdopen(out_fd, "w") if out_fd is not None else open(os.devnull, "w")
    if cmd == "version":
        print(REF_VERSION)
        return 0
    if cmd == "serve":
        from .server import main_serve

        return main_serve(rest)
    try:
        if cmd in ("mem", "sw", "hapdiv") and (ret := route(cmd, rest)) is not None:
            pass  # answered by a resident server, before any torch import
        elif cmd in ("stat", "plain2fmd", "fa2line", "fa2kmer"):
            ret = {"stat": main_stat, "plain2fmd": main_plain2fmd, "fa2line": main_fa2line, "fa2kmer": main_fa2kmer}[cmd](rest)
        else:
            device, rest = _split_device(rest)
            if device not in ("cuda", "cpu"):
                return _err(f"invalid --device '{device}' (cuda|cpu)")
            if device == "cuda":
                import torch

                if not torch.cuda.is_available():
                    return _err("CUDA is not available; pass --device=cpu to run the plain PyTorch engine")
            if cmd == "search":
                ret = main_mem(rest, device, "search")
            else:
                ret = {"build": main_build, "merge": main_merge, "mem": main_mem, "sw": main_sw, "hapdiv": main_hapdiv,
                       "ssa": main_ssa, "get": main_get, "suffix": main_suffix, "kount": main_kount}[cmd](rest, device)
    except (IndexLoadError, CapacityError, getopt.GetoptError, MeshError) as e:
        ret = _err(str(e))
    except BrokenPipeError:
        ret = 0
    except Exception as e:  # torch's OutOfMemoryError: one ERROR line, as a CapacityError (torch is imported by then)
        torch = sys.modules.get("torch")
        if torch is None or not isinstance(e, torch.OutOfMemoryError):
            raise
        ret = _err(f"out of card memory: {str(e).splitlines()[0]}")
    finally:
        if (launch := sys.modules.get(f"{__package__}.parallel.launch")) is not None:
            launch.finish()
    if ret == 0 and len(argv) > 1:
        log.footer(argv, REF_VERSION)
    return ret
