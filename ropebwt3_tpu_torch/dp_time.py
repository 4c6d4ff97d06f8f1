"""Time the two DP kernels on the card, for side-by-side runs of two trees.

    python -m ropebwt3_tpu_torch.dp_time WORK [TAG]

Makes bench.py's workload under WORK from its seed (16 x 2 Mbp genomes at
1% divergence, double strand; 100,000 x 150 bp reads at 1% error) and its
index with the port's own `build` (both kept in WORK for the next run),
then times, on dense32 rows with CUDA events:

- K8 (csrc/hapdiv.cu) on 1,024 and 16,384 of `hapdiv`'s windows (-a101
  -w50) of a 17th haplotype, genome 0 at 1% substitutions;
- K9 (csrc/sw.cu) on 128 and 4,096 of the DAWGs of the first 10,000 reads
  (default options: general DAWGs), as SwDeviceEngine sends them.

Each kernel is held against its plain version on a sample (hapdiv_plain on
HAPDIV_CHECK windows, sw_plain on SW_CHECK reads: every output, and the
trips of those not flagged), so a tree whose kernel is wrong fails.  Where
the tree has them it also prints each kernel's occupancy (blocks an SM,
shared bytes a block, registers a thread: `rb3c_occupancy_{hapdiv,sw}_*`)
and its phase split (`rb3c_timed_{hapdiv,sw}_*`, the timing-only
instantiation: lane 0's clock64 laps by phase, summed over the windows or
reads, and those of the slowest one).  Prints one JSON line tagged TAG.
Two trees compare in one call: run each from its own root (`cd TREE &&
python -m ropebwt3_tpu_torch.dp_time WORK TAG`) in turns A, B, B, A; the C
entry points of the kernels are the same in both.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import sys
import time

import numpy as np
import torch

from . import cli, corpus, kernels, probe
from .align import bwasw, hapdiv, sw
from .corpus import DIVERGENCE, SEED
from .ops.rank import OccIndex

HAPDIV_K, HAPDIV_STEP = 101, 50  # hapdiv -a101 -w50
SW_READS = 10_000  # the reads staged for K9 (chip_smoke's `sw` path)
HAPDIV_SIZES, SW_SIZES = (1024, 16384), (128, 4096)
HAPDIV_CHECK, SW_CHECK = 32, 16
REPS = 3
# the phases of the timing-only kernels (csrc/dp.cuh PH_*); K8's last is the
# dedup and backtrack, K9's the prune
PHASES = ("extend", "merge", "hpos_scan", "top_n_1", "closure_extend", "closure", "top_n_2", "archive", "tail")
_V, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
TIMED_ARGS = {"hapdiv": [*[_V] * 4, _I32, _I32, _V, _I64, *[_I32] * 8, *[_V] * 8],
              "sw": [*[_V] * 4, _I32, _I32, _V, _V, _V, _V, _I64, *[_I32] * 8, *[_V] * 11]}


def fail(msg: str):
    raise SystemExit(f"dp_time: FAIL: {msg}")


def make_workload(work: str) -> tuple[str, np.ndarray, list[np.ndarray]]:
    """genomes.fa and its FMD under `work` (built once by the port's `build`),
    the first genome and the first SW_READS reads, all from SEED as
    chip_smoke.py makes bench.py's corpus."""
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(SEED)
    base, gens = corpus.genomes(rng)
    short = corpus.short_reads(rng, base)
    fa, fmd = os.path.join(work, "genomes.fa"), os.path.join(work, "idx.fmd")
    if not os.path.exists(fmd):
        alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
        with open(fa, "wb") as fh:
            fh.write(b"".join(b">g%d\n" % g + alpha[s].tobytes() + b"\n" for g, s in enumerate(gens)))
        with contextlib.redirect_stderr(io.StringIO()):
            if cli.run(["build", "-do", fmd + ".tmp", fa]) != 0:
                fail("the index build failed")
        os.replace(fmd + ".tmp", fmd)
    return fmd, gens[0], list(short[:SW_READS])


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def occupancy(kind: str, layout: str, n_best: int) -> dict | None:
    """K8's ("hapdiv") or K9's ("sw") resident blocks an SM, static shared
    bytes a block and registers a thread in `layout` at n_best; None in a
    tree without the query."""
    fn = getattr(kernels.lib(), f"rb3c_occupancy_{kind}_{layout}", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [_I32, _V, _V, _V], ctypes.c_int
    v = [ctypes.c_int(0) for _ in range(3)]
    err = fn(n_best, *(ctypes.byref(x) for x in v))
    if err:
        fail(f"{kind} occupancy query: CUDA error {err}")
    return dict(blocks_per_sm=v[0].value, smem_bytes=v[1].value, regs=v[2].value)


def split(clk: torch.Tensor, ok: torch.Tensor) -> dict:
    """Phase cycles summed over the unflagged windows or reads, their shares,
    and the slowest one's."""
    c = clk[ok].double()
    tot = c.sum(0)
    slow = c[int(c.sum(1).argmax())]
    return dict(cycles=[int(x) for x in tot.tolist()], share={p: round(float(x), 4) for p, x in zip(PHASES, (tot / tot.sum()).tolist())},
                slowest_cycles=[int(x) for x in slow.tolist()], n=int(ok.sum()))


def timed_hapdiv(x, seqs, K: int) -> dict | None:
    """The phase split of one launch of K8's timing-only twin on windows
    seqs (W, K) in x's layout; None in a tree without it."""
    name = f"rb3c_timed_hapdiv_{x.layout}"
    fn = getattr(kernels.lib(), name, None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = TIMED_ARGS["hapdiv"], ctypes.c_int
    W, dev, N = seqs.shape[0], seqs.device, hapdiv.N_BEST
    arch = torch.empty((W, K, N, 2), dtype=torch.int32, device=dev)
    outs = [torch.empty(W, dtype=torch.int32, device=dev), torch.empty(W, dtype=torch.int32, device=dev),
            torch.empty((W, 7), dtype=torch.int64, device=dev), torch.empty(W, dtype=torch.bool, device=dev),
            torch.empty(W, dtype=torch.int32, device=dev)]
    clk = torch.zeros((W, len(PHASES)), dtype=torch.int64, device=dev)
    kernels.launch(name, dev, *x.kernel_tables(), seqs.data_ptr(), W, K, N, 30, 1, 1, 3, 5, 2,
                   arch.data_ptr(), *(t.data_ptr() for t in outs), clk.data_ptr())
    torch.cuda.synchronize()
    return split(clk.cpu(), ~outs[3].cpu())


def timed_sw(x, args, kw) -> dict | None:
    """The phase split of one launch of K9's timing-only twin on the DAWGs
    args (node_c, pre, n_node) in x's layout; None in a tree without it."""
    name = f"rb3c_timed_sw_{x.layout}"
    fn = getattr(kernels.lib(), name, None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = TIMED_ARGS["sw"], ctypes.c_int
    node_c, pre, n_node = args
    W, dev, N = node_c.shape[0], node_c.device, sw.N_BEST
    rows = sw.arch_rows(n_node)
    T = int(rows[-1])
    scratch = torch.empty((T, N, 4), dtype=torch.int64, device=dev)
    arch = [torch.empty((T, N), dtype=torch.int32, device=dev) for _ in range(3)]
    arch.append(torch.empty((T, N), dtype=torch.int64, device=dev))
    outs = [torch.empty(W, dtype=torch.int32, device=dev), torch.empty(W, dtype=torch.int32, device=dev),
            torch.empty(W, dtype=torch.bool, device=dev), torch.empty(W, dtype=torch.int32, device=dev)]
    clk = torch.zeros((W, len(PHASES)), dtype=torch.int64, device=dev)
    kernels.launch(name, dev, *x.kernel_tables(), node_c.data_ptr(), pre.data_ptr(),
                   n_node.data_ptr(), rows.data_ptr(), W, node_c.shape[1], pre.shape[2], N, kw["end_len"], 1, 3, 5, 2,
                   scratch.data_ptr(), *(t.data_ptr() for t in arch), *(t.data_ptr() for t in outs), clk.data_ptr())
    torch.cuda.synchronize()
    return split(clk.cpu(), ~outs[2].cpu())


def run_hapdiv(x, g0: np.ndarray) -> dict:
    rng = np.random.default_rng(SEED + 10)
    hap = g0.copy()
    mut = rng.random(len(hap)) < DIVERGENCE
    hap[mut] = rng.integers(1, 5, int(mut.sum()))
    K = HAPDIV_K
    offs = np.arange(0, len(hap) - K + 1, HAPDIV_STEP)
    wins = hap[offs[:, None] + np.arange(K)].astype(np.int32)
    dev = x.device
    out = {"windows": len(wins)}
    sample = torch.from_numpy(wins[np.linspace(0, len(wins) - 1, HAPDIV_CHECK).astype(np.int64)]).to(dev)
    got, want = hapdiv.hapdiv_cuda(x, sample, K, trips=True), hapdiv.hapdiv_plain(x, sample, K, trips=True)
    ok = ~want[3]
    if not (all(torch.equal(a, b) for a, b in zip(got[:4], want[:4])) and torch.equal(got[4][ok], want[4][ok])):
        fail("K8 differs from hapdiv_plain")
    for n in HAPDIV_SIZES:
        sel = wins[np.linspace(0, len(wins) - 1, n).astype(np.int64)] if n < len(wins) else wins
        seqs = torch.from_numpy(np.ascontiguousarray(sel)).to(dev)
        arch = torch.empty((n, K, hapdiv.N_BEST, 2), dtype=torch.int32, device=dev)
        ms = events_ms(lambda: hapdiv.launch_hapdiv(x, seqs, K, arch=arch), REPS)
        del arch
        out[str(n)] = dict(ms=ms, split=timed_hapdiv(x, seqs, K))
    out["occupancy"] = occupancy("hapdiv", x.layout, hapdiv.N_BEST)
    return out


def run_sw(x, f, reads: list[np.ndarray]) -> dict:
    opt = bwasw.SwOpt()
    flat, seq_off = bwasw.flat_reads(reads)
    ok, n_node, max_pre, node_c, pre = bwasw.sw_stage(opt, f, flat, seq_off, sw.NC_MAX, sw.P_MAX)
    elig = np.flatnonzero(ok & (n_node <= sw.NC_MAX) & (max_pre <= sw.P_MAX))
    dev = x.device

    def dawgs(sel):
        NC, P = int(n_node[sel].max()), max(1, int(max_pre[sel].max()))
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (node_c[sel, :NC], pre[sel, :NC, :P], n_node[sel])]

    kw = dict(end_len=opt.end_len)
    check = dawgs(elig[:SW_CHECK])
    got, want = sw.sw_cuda(x, *check, trips=True, **kw), sw.sw_plain(x, *check, trips=True, **kw)
    okr = ~want[6]
    rows = torch.repeat_interleave(okr, check[2].long())
    if not (all(torch.equal(a, b) for a, b in zip(got[4:7], want[4:7]))
            and all(torch.equal(a[rows], b[rows]) for a, b in zip(got[:4], want[:4])) and torch.equal(got[7][okr], want[7][okr])):
        fail("K9 differs from sw_plain")
    out = {"eligible": len(elig)}
    for n in SW_SIZES:
        args = dawgs(elig[:n])
        arows = sw.arch_rows(args[2])
        scratch = torch.empty((int(arows[-1]), sw.N_BEST, 4), dtype=torch.int64, device=dev)
        ms = events_ms(lambda: sw.launch_sw(x, *args, rows=arows, scratch=scratch, **kw), REPS)
        del scratch
        out[str(n)] = dict(ms=ms, NC=args[0].shape[1], P=args[1].shape[2], split=timed_sw(x, args, kw))
    out["occupancy"] = occupancy("sw", x.layout, sw.N_BEST)
    return out


def main(argv: list[str]) -> int:
    if len(argv) not in (1, 2) or not torch.cuda.is_available():
        print(__doc__ if len(argv) not in (1, 2) else "dp_time: needs a CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(1)  # the plain versions' lock-step loops run thousands of small ops
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    fmd, g0, reads = make_workload(argv[0])
    f = cli.load_index(fmd)
    x = OccIndex.from_dense(f, dev)
    kernels.lib()
    out = {"tag": argv[1] if len(argv) == 2 else None, "card": probe.card_line(), "n": f.n}
    out["hapdiv"] = run_hapdiv(x, g0)
    out["sw"] = run_sw(x, f, reads)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
