"""Wall time of the DP commands on each engine, and of the host options, in
this process, on bench.py's index.

    python -m ropebwt3_tpu_torch.engine_time WORK [TAG]

Makes bench.py's workload under WORK as dp_time does (`make_workload`: the
index built once by the port's `build`), with the index's SSA (the port's
`ssa`) and sequence lengths beside it, so `sw` writes positions as
chip_smoke.py's [sw] path does, and chip_smoke's 17th haplotype (genome 0
at 1% substitutions).  Then runs, through cli.run in this process, each
stdout to a file under WORK:

- `sw` of the first 10,000 reads with --engine=auto, jax, hybrid and native,
  then in the reverse order (A B C D D C B A: the first run of a process
  pays for what it loads first);
- `hapdiv` of the haplotype (-a101 -w50) with auto, hybrid and native, then
  in the reverse order;
- `mem -l31` of bench.py's 100,000 reads with --engine=auto (K1 on the
  card), native (the host engine) and hybrid, then in the reverse order;
- `mem --old-mem -l31` and `mem --engine=py -l31` (the Python engines,
  read by read) of the first OLD_MEM_READS reads, beside `mem -l31` of the
  same reads;
- `sw --dbg-dawg --dbg-sw --dbg-qname --dbg-bt` of the first DBG_READS
  reads (the Python DP), its traces to a file.

Every engine's stdout must equal auto's (a run that differs fails).  The
hybrids start from RB3TPU_SW_SPLIT / RB3TPU_HAPDIV_SPLIT / RB3TPU_MEM_SPLIT
(their defaults unless set).  Prints one JSON line tagged TAG: each run's wall (a list, in
run order, for the engines), the hybrid's items on the card and its share
at the end (its log line), the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import os
import re
import sys
import time

import numpy as np
import torch

from . import cli, corpus, dp_time, probe
from .corpus import DIVERGENCE, SEED

OLD_MEM_READS, DBG_READS = 300, 20
HYBRID = re.compile(r"hybrid: (\d+) of (\d+) \w+ on the card, the card's share at the end ([\d.]+)")


def fail(msg: str):
    raise SystemExit(f"engine_time: FAIL: {msg}")


def write_fasta(fn: str, names: list[str], seqs) -> str:
    alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    with open(fn, "wb") as fh:
        fh.write(b"".join(b">%s\n" % n.encode() + alpha[s].tobytes() + b"\n" for n, s in zip(names, seqs)))
    return fn


def timed(work: str, name: str, argv: list[str]) -> dict:
    """argv through cli.run: its wall, stdout in WORK/name.out, stderr in
    WORK/name.err, and the hybrid's numbers where it logged them."""
    out_fn, err_fn = os.path.join(work, f"{name}.out"), os.path.join(work, f"{name}.err")
    err = io.StringIO()
    t0 = time.perf_counter()
    with open(out_fn, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.run(argv)
    rec = {"s": time.perf_counter() - t0}
    with open(err_fn, "w") as fh:
        fh.write(err.getvalue())
    if rc != 0:
        fail(f"{' '.join(argv)} exited {rc}: {err.getvalue()[-2000:]}")
    if m := HYBRID.search(err.getvalue()):
        rec.update(on_card=int(m.group(1)), items=int(m.group(2)), share=float(m.group(3)))
    with open(out_fn, "rb") as fh:
        rec["lines"] = fh.read().count(b"\n")
    return rec


def same(work: str, a: str, b: str) -> None:
    with open(os.path.join(work, f"{a}.out"), "rb") as fa, open(os.path.join(work, f"{b}.out"), "rb") as fb:
        if fa.read() != fb.read():
            fail(f"{b}'s stdout differs from {a}'s")


def main(argv: list[str]) -> int:
    if len(argv) not in (1, 2) or not torch.cuda.is_available():
        print(__doc__ if len(argv) not in (1, 2) else "engine_time: needs a CUDA card", file=sys.stderr)
        return 1
    work = os.path.abspath(argv[0])
    fmd, g0, reads = dp_time.make_workload(work)
    if not os.path.exists(fmd + ".ssa"):
        with contextlib.redirect_stderr(io.StringIO()):
            if cli.run(["ssa", "-o", fmd + ".ssa", fmd]) != 0:
                fail("the SSA failed")
    with gzip.open(fmd + ".len.gz", "wt") as fh:
        fh.write("".join(f"g{g}\t{corpus.GENOME_LEN}\n" for g in range(corpus.N_GENOMES)))
    rng = np.random.default_rng(SEED + 10)  # chip_smoke.py's [hapdiv] haplotype
    hap = g0.copy()
    mut = rng.random(len(hap)) < DIVERGENCE
    hap[mut] = rng.integers(1, 5, int(mut.sum()))
    hap_fa = write_fasta(os.path.join(work, "hap17.fa"), ["hap17"], [hap])
    reads_fa = write_fasta(os.path.join(work, "reads.fa"), [f"r{i}" for i in range(len(reads))], reads)
    few_fa = write_fasta(os.path.join(work, "few.fa"), [f"r{i}" for i in range(OLD_MEM_READS)], reads[:OLD_MEM_READS])
    rng = np.random.default_rng(SEED)  # all of bench.py's reads, as make_workload draws them
    all_reads = corpus.short_reads(rng, corpus.genomes(rng)[0])
    all_fa = write_fasta(os.path.join(work, "all.fa"), [f"r{i}" for i in range(len(all_reads))], all_reads)
    dbg_fa = write_fasta(os.path.join(work, "dbg.fa"), [f"r{i}" for i in range(DBG_READS)], reads[:DBG_READS])
    res = {"tag": argv[1] if len(argv) == 2 else None, "card": probe.card_line(), "reads": len(reads),
           "hapdiv_windows": (len(hap) - 101) // 50 + 1,
           "mem_reads": len(all_reads),
           "split": {v: os.environ.get(v) for v in ("RB3TPU_SW_SPLIT", "RB3TPU_HAPDIV_SPLIT", "RB3TPU_MEM_SPLIT")}}
    for cmd, engines, fa, opts in (("sw", ("auto", "jax", "hybrid", "native"), reads_fa, []),
                                   ("hapdiv", ("auto", "hybrid", "native"), hap_fa, []),
                                   ("mem", ("auto", "native", "hybrid"), all_fa, ["-l31"])):
        for eng in engines + engines[::-1]:
            name = f"{cmd}_{eng}"
            rec = timed(work, name, [cmd, f"--engine={eng}", *opts, fmd, fa])
            same(work, f"{cmd}_auto", name)
            res.setdefault(name, []).append(rec)
    res["mem"] = timed(work, "mem", ["mem", "-l31", fmd, few_fa])
    res["old_mem"] = timed(work, "old_mem", ["mem", "--old-mem", "-l31", fmd, few_fa])
    res["old_mem"]["reads"] = OLD_MEM_READS
    res["mem_py"] = timed(work, "mem_py", ["mem", "--engine=py", "-l31", fmd, few_fa])
    res["mem_py"]["reads"] = OLD_MEM_READS
    same(work, "mem", "mem_py")
    res["sw_dbg"] = timed(work, "sw_dbg", ["sw", "--dbg-dawg", "--dbg-sw", "--dbg-qname", "--dbg-bt", fmd, dbg_fa])
    with open(os.path.join(work, "sw_dbg.err")) as fh:
        res["sw_dbg"].update(reads=DBG_READS, trace_lines=sum(1 for line in fh if re.match(r"(DG|SW|BT|Q)\t", line)))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
