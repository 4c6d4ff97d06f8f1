#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (ropebwt3_tpu_torch).

Drives the port's entry points on one CUDA card: `build` (and `merge`) of
bench.py's genomes and of its short reads, `mem -l31` on the workload
of bench.py (16 x 2 Mbp genomes at 1% divergence, indexed double strand:
~64 M symbols, ~48 MB of dense occ rows; 100,000 x 150 bp reads at 1% error)
plus 200 reads of 5-20 kb, once on the default rows (the main path) and once
with `--occ=rb`; `ssa` on bench.py's index and two more; and the row-gather
probes.  Every rank and SMEM kernel runs on each of the four occ layouts
(dense32, dense64, rb32, rb64), ssa_gen on both dense ones.  The reference
outputs come from `python -m ropebwt3_tpu` in subprocesses (`build`,
`merge`, `mem --engine=native`, `ssa -o`): this script imports nothing of
it.  Phases:

  build     compile the kernels from csrc/ (nvcc, sm_90a, one nvcc per source)
  corpus    generate the data from a seed; build the FMD with the repo's own
            index build (cached under .bench/torch_smoke/)
  construct `build` on the card (csrc/sa_round.cu K7, csrc/merge_rank.cu K6):
            bench.py's genomes in one batch, then with -m 16M (three merges
            of 8 sequences of 2 M steps: the build path, counts reset before
            and read after), then the 100,000 short reads with -m 12M, each
            FMD byte-equal to the repo's index build; K7 round by round (the
            passes, and torch.sort alone on the same keys) against its plain
            passes on the card, sa and BWT exact; K6 on each -m 16M merge and
            on the short reads' first merge (80,000 sequences; dense32 and
            dense64, megablocks of 2^20 symbols) at the derived stride, its
            ins exact against merge_rank_chunked_plain on the card (segment
            records too), the JAX package's native walk (a subprocess) and,
            on the short reads, merge_rank_plain on the card; its stride,
            lanes, meeting lengths and hand-overs; each -m 16M
            merge's peak card memory at or under merge_bytes; `merge` of the
            genomes' two halves byte-equal to `python -m ropebwt3_tpu merge`;
            beside each, the JAX package's native command timed
  rank      occ_rank1a / occ_extend_c of each layout vs the plain PyTorch
            rank1a / extend_c on the card, on the bench index: 1 M positions
            (0, n, block and megablock boundaries included), 1 M intervals;
            exact.  rb32 at choose_S's S; rb64 at S = 256; dense64 and rb64
            with megablocks shrunk to 2^20 symbols
  rank64    rb64 rows of a synthetic BWT given as runs, n = 2^32 + 2^31
            (no suffix array): S = 8192 from choose_S, escape blocks from a
            high-entropy stretch across 2^32; occ_rank1a / occ_extend_c vs
            the plain rb rank on the card and rank1a vs an independent rank
            from the run lengths, on 1 M positions incl. 0, n, 2^32 +- 1 and
            block boundaries; exact
  probe     the three probe kernels (csrc/probe.cu) vs their plain versions
            on the card, exact: shared-memory capacity at the opt-in limit
            (one 512-B row past it must be refused), the shared-memory and
            device-memory row gathers in every mode, 48-B and 512-B rows, and
            `tab[idx]` beside the `indep` gathers as the library yardstick;
            then the probe path, `python -m ropebwt3_tpu_torch.probe`'s main,
            with launch counts reset before and read after: its latency sweep
            gives this run's ns per dependent step, which the chain floors use
  smem      per layout: smem_tg (one thread per read) vs smem_tg_plain on the
            card, 4,096 reads, exact; smem_tgc (one thread per lane) vs the
            plain lanes on the main path's lanes of 64 long reads and 2,048
            short ones (rows, counts, START logs, trips), exact; then on the
            main path's batch the chunked engine (smem_tgc, stitch, reruns)
            must equal the one-thread kernel's rows and counts (rerun with a
            buffer of the true counts) and dense32's; times of both kernels,
            n_unmerged, trip counts, the roofline bound and the chain floor;
            on dense32 also a sweep of the chunk size
  ssa       ssa_gen on three indexes: bench.py's (m = 32, dense32 and dense64
            with megablocks of 2^20 symbols), one of the 100,000 short reads
            (m = 200,000, cached under .bench/torch_smoke/many/) and the CPU
            tests' corpus; the SSA byte-equal to `python -m ropebwt3_tpu ssa`
            (whose run gives the native walk's time), the kernel's arrays equal
            to ssa_gen_plain on the card (not run on bench.py's index: ~2 M
            lock-step trips); then `ssa` through ropebwt3_tpu_torch.cli.main
            on each index (bench.py's is the ssa path: counts reset before,
            read after) and once as `python -m ropebwt3_tpu_torch ssa`
  mem       the main path: `mem -l31` through ropebwt3_tpu_torch.cli.main with
            launch counts reset before and read after; its BED must equal
            `python -m ropebwt3_tpu mem --engine=native` byte for byte; then
            its host work piece by piece
  mem-rb    the second path: `mem -l31 --occ=rb`, counts reset before and
            read after; BED byte-equal to native, >= 1 rb32 smem_tgc launch

Any failure exits non-zero.  The last line is {"ok": true, "device": ...}.
Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".bench", "torch_smoke")
# bench.py:78-85
N_GENOMES, GENOME_LEN, DIVERGENCE = 16, 2_000_000, 0.01
N_READS, READ_LEN, READ_ERR, MIN_LEN = 100_000, 150, 0.01, 31
SEED = 20260817
N_LONG, LONG_LEN = 200, (5_000, 20_000)
PROBE_Q, PROBE_ITERS = 4096, 200  # probe phase checks: lanes, steps
PROBE_HBM_SHAPES = ((1_000_000, 12), (2_000_000, 128))  # 48 MB of 48-B rows, 1 GB of 512-B rows
SSA_SHIFT = 8  # `ssa`'s default -s; the CPU tests' corpus runs -s 4
N_CHECK = 1 << 20  # rank phase positions and intervals
N_SMEM = 4096  # smem phase: reads of the one-thread kernel's plain check
N_TGC_SHORT, N_TGC_LONG = 2048, 64  # smem phase: reads of the chunked kernel's plain check
CHUNK_SWEEP = (64, 128, 256, 512, 1024)  # smem phase, dense32: chunk sizes timed (margin = chunk / 2)
MAX_MEMS = 64  # BatchedSmemTG's MEM buffer rows per chain
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's 3.35 TB/s HBM3 rate, in bytes a millisecond
# the latency sweep's tables (probe.LAT_TABLES) whose ns per dependent step
# the chain floors use: one the L2 holds, and one of the bench index's 48 MB
LAT_L2, LAT_48MB = "48 B x 87 k (4 MB)", "48 B x 1 M (48 MB)"
SUBPROCESS_TIMEOUT = 600
LAYOUTS = ("dense32", "dense64", "rb32", "rb64")
# bench-index int64 layouts: megablocks of 2^20 symbols; rb64 at the smallest
# S, where run-coded blocks remain (choose_S's S makes every block an escape)
DENSE64_SHIFT, RB64_S, RB64_SHIFT = 14, 256, 12
# [construct]: bench.py's genomes in four batches of four (three merges of 8
# lanes); the short reads in batches of 40,000, 40,000 and 20,000 reads
CONSTRUCT_M, MANY_M = "16M", "12M"
N64 = (1 << 32) + (1 << 31)  # rank64: 6,442,450,944 symbols, a multiple of 8192
DEVICE = "cuda"


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def say(msg: str) -> None:
    print(msg, flush=True)


def make_corpus(work: str, n_genomes: int, genome_len: int, n_reads: int, n_long: int, seed: int) -> tuple[str, str, list[np.ndarray]]:
    """genomes.fa and reads.fa under `work` (short reads first, then the long
    ones), made from `seed`; returns their paths and the reads as nt6."""
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 5, genome_len).astype(np.uint8)
    alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    fa, reads_fa = os.path.join(work, "genomes.fa"), os.path.join(work, "reads.fa")
    with open(fa, "wb") as fh:
        for g in range(n_genomes):
            s = base.copy()
            mut = rng.random(genome_len) < DIVERGENCE
            s[mut] = rng.integers(1, 5, int(mut.sum()))
            fh.write(b">g%d\n" % g + alpha[s].tobytes() + b"\n")
    starts = rng.integers(0, genome_len - READ_LEN, n_reads)
    short = base[starts[:, None] + np.arange(READ_LEN)]
    short = np.where(rng.random(short.shape) < READ_ERR, rng.integers(1, 5, short.shape), short).astype(np.uint8)
    reads = list(short)
    for _ in range(n_long):
        ln = int(rng.integers(*LONG_LEN))
        st = int(rng.integers(0, genome_len - ln))
        r = base[st : st + ln].copy()
        err = rng.random(ln) < READ_ERR
        r[err] = rng.integers(1, 5, int(err.sum()))
        reads.append(r)
    with open(reads_fa, "wb") as fh:
        fh.write(b"".join(b">r%d\n" % i + alpha[r].tobytes() + b"\n" for i, r in enumerate(reads)))
    return fa, reads_fa, reads


def build_index(fa: str) -> str:
    """The FMD of `fa` from the repo's own index build (native SA-IS), cached
    next to it."""
    fmd = os.path.join(os.path.dirname(fa), "idx.fmd")
    stamp = fmd + ".from"
    key = f"{os.path.getsize(fa)} {SEED}"
    if not (os.path.exists(fmd) and os.path.exists(stamp) and open(stamp).read() == key):
        run([sys.executable, "-m", "ropebwt3_tpu", "build", "-do", fmd, fa])
        with open(stamp, "w") as fh:
            fh.write(key)
    return fmd


def run(cmd: list[str], stdout=subprocess.DEVNULL) -> tuple[float, str]:
    """Run `cmd` from the repo root; fail unless it exits 0.  Returns its wall
    seconds and its stderr."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, stdout=stdout, stderr=subprocess.PIPE, timeout=SUBPROCESS_TIMEOUT)
    if r.returncode != 0:
        fail(f"{' '.join(cmd)} exited {r.returncode}: {r.stderr.decode()[-2000:]}")
    return time.perf_counter() - t0, r.stderr.decode()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def first_diff(a: bytes, b: bytes) -> str:
    la, lb = a.splitlines(), b.splitlines()
    for t, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return f"line {t + 1}: {x!r} != {y!r}"
    return f"{len(la)} vs {len(lb)} lines"


def max_abs(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def intervals(rng, n: int, size: int, max_size: int) -> np.ndarray:
    """Bi-intervals (x0, x1, s) whose primary span lies in [0, n] in both
    directions, so either endpoint may be the one ranked."""
    lo = rng.integers(0, n + 1, size)
    s = np.minimum(rng.integers(0, n + 1 - lo), rng.integers(0, max_size, size))
    hi = rng.integers(0, n + 1 - s)
    return np.stack([lo, hi, s], axis=1).astype(np.int64)


def boundaries(n: int, step: int, limit: int) -> np.ndarray:
    """Multiples of `step` in [0, n] and their neighbours, at most `limit` of them."""
    b = np.arange(0, n + 1, step, dtype=np.int64)[:limit]
    return np.clip(np.concatenate([b - 1, b, b + 1]), 0, n)


def bound_ms(nbytes: int) -> float:
    """Milliseconds to move `nbytes` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_MS


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def table_bytes(rank, idx, k) -> int:
    """Bytes of idx's tables that ranks at positions k need, each row once:
    the distinct occ rows (and megablock bases); for rb rows the distinct
    160-B rows and, for escape blocks among them, their escape rows."""
    import torch

    if isinstance(idx, rank.OccIndex):
        rows = torch.unique(k.long() >> 6)
        return rows.numel() * 48 + (torch.unique(rows >> idx.mega_shift).numel() * 48 if idx.int64 else 0)
    rows = torch.unique(idx.block_and_offset(k.long())[0])
    esc = idx.rows[rows, 6]
    n = rows.numel() * 160 + torch.unique(esc[esc >= 0]).numel() * idx.esc.shape[1] * 4
    return n + (torch.unique(rows >> idx.mega_shift).numel() * 48 if idx.int64 else 0)


def check_occ_kernels(rank, idx, k, ik, c, back, plain_reps: int) -> dict:
    """occ_rank1a and occ_extend_c of idx's layout vs the plain versions on
    the card; fails unless exact.  Returns errors, times (ms) and bounds."""
    import torch

    got = rank.rank1a_cuda(idx, k)
    want = rank.rank1a(idx, k).to(idx.dtype)
    r_err = max_abs(got, want)
    ik = ik.to(idx.dtype)
    e_got = rank.extend_c_cuda(idx, ik, c, back)
    e_want = rank.extend_c(idx, ik, c, back).to(idx.dtype)
    e_err = max_abs(e_got, e_want)
    if r_err or e_err:
        fail(f"{idx.layout}: occ_rank1a off by {r_err}, occ_extend_c off by {e_err} against the plain versions")
    prim = torch.where(back, ik[:, 0], ik[:, 1]).long()
    return dict(
        got=got, rank_err=r_err, ext_err=e_err,
        rank_ms=cuda_ms(lambda: rank.rank1a_cuda(idx, k), 10), rank_plain=cuda_ms(lambda: rank.rank1a(idx, k), plain_reps),
        ext_ms=cuda_ms(lambda: rank.extend_c_cuda(idx, ik, c, back), 10),
        ext_plain=cuda_ms(lambda: rank.extend_c(idx, ik, c, back), plain_reps),
        rank_bound=bound_ms(table_bytes(rank, idx, k) + nbytes(k, got)),
        ext_bound=bound_ms(table_bytes(rank, idx, torch.cat([prim, prim + ik[:, 2].long()])) + nbytes(ik, c, back, e_got)),
    )


def runs_summing_to(rng, total: int, lo: int, hi: int) -> np.ndarray:
    """Random run lengths in [lo, hi) that sum to `total` exactly."""
    lens = rng.integers(lo, hi, int(total / ((lo + hi - 1) / 2) * 1.05) + 64)
    cs = np.cumsum(lens)
    m = int(np.searchsorted(cs, total))
    if m >= len(lens):
        fail("runs_summing_to drew too few runs")
    lens = lens[: m + 1].copy()
    lens[-1] -= int(cs[m]) - total  # >= 1: cs[m - 1] < total
    return lens


def synthetic_runs(seed: int) -> tuple[np.ndarray, np.ndarray, tuple[int, int]]:
    """A BWT of N64 symbols as runs: run lengths 1..1999 (mean ~1000) and a
    high-entropy stretch of 81,920 symbols in runs of 1..3 across 2^32.
    Returns (syms, lens, the stretch's span)."""
    rng = np.random.default_rng(seed)
    a0 = (1 << 32) - 40_960
    parts = [runs_summing_to(rng, a0, 1, 2000), runs_summing_to(rng, 81_920, 1, 4)]
    parts.append(runs_summing_to(rng, N64 - a0 - 81_920, 1, 2000))
    lens = np.concatenate(parts)
    return rng.integers(0, 6, len(lens)).astype(np.uint8), lens, (a0, a0 + 81_920)


def run_length_rank(syms: np.ndarray, lens: np.ndarray, k: np.ndarray) -> np.ndarray:
    """rank1a at k from the runs alone: counts before the run that holds
    position k (a search over run starts) plus the part of that run below k."""
    starts = np.cumsum(lens) - lens
    j = np.searchsorted(starts, k, side="right") - 1
    out = np.empty((len(k), 6), np.int64)
    for c in range(6):
        before = np.cumsum(np.where(syms == c, lens, 0)) - np.where(syms == c, lens, 0)
        out[:, c] = before[j] + np.where(syms[j] == c, k - starts[j], 0)
    return out


def write_fasta(path: str, seqs) -> str:
    """nt6 sequences as FASTA records r0, r1, ..."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"".join(b">r%d\n" % i + alpha[s].tobytes() + b"\n" for i, s in enumerate(seqs)))
    return path


def make_test_corpus(work: str) -> str:
    """genomes.fa of the CPU tests' `corpus` fixture (tests/conftest.py):
    8 x 8 kb genomes at 1% divergence from seed 42."""
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(42)
    base = rng.integers(0, 4, 8000)
    fa = os.path.join(work, "genomes.fa")
    with open(fa, "w") as fh:
        for i in range(8):
            s = base.copy()
            mut = rng.random(len(s)) < 0.01
            s[mut] = rng.integers(0, 4, mut.sum())
            fh.write(f">s{i}\n" + "".join("ACGT"[c] for c in s) + "\n")
    return fa


def check_probes(probe, dev) -> dict:
    """The three probe kernels vs their plain versions on the card; fails
    unless exact.  Capacity at the opt-in limit (and one row past it, which
    must be refused); each gather in every mode on 48-B and 512-B rows with
    values over the whole int32 range, PROBE_Q lanes and a ragged count.
    Times at the first shape: `dep` (the kernel's time), and `indep` beside
    `tab[idx]` over the same rows (the library yardstick)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    optin = probe.smem_optin(dev)
    top = optin // 512 * 512
    out, err = probe.smem_capacity_cuda(top, dev)
    if err or not torch.equal(out, probe.smem_capacity_plain(top, dev)):
        fail(f"probe_smem_capacity at the opt-in size {top} B: {err or 'wrong sum'}")
    past, refusal = probe.smem_capacity_cuda(top + 512, dev)
    if past is not None:
        fail(f"probe_smem_capacity ran {top + 512} B, past the opt-in limit {optin} B")
    res = {"probe_smem_capacity": dict(
        err=0, ms=cuda_ms(lambda: probe.smem_capacity_cuda(top, dev), 10),
        plain=cuda_ms(lambda: probe.smem_capacity_plain(top, dev), 10), bound=bound_ms(out.numel() * 4), library=None,
        input=f"{top} B of shared memory; {top + 512} B refused ({refusal})",
        replaces="scripts/fused_probe.py:43 (P1), scripts/fused_probe2.py:42 (P4)")}
    say(f"[probe] probe_smem_capacity: {top} B ran, P4's sum exact; {top + 512} B refused ({refusal}); "
        f"cudaDevAttrMaxSharedMemoryPerBlockOptin {optin} B")
    gathers = (
        ("probe_smem_gather", probe.smem_gather_cuda, ((optin // 48, 12), (optin // 512, 128)),
         "scripts/fused_probe.py:100 (P2), scripts/fused_probe2.py:75 (P5)"),
        ("probe_hbm_gather", probe.hbm_gather_cuda, PROBE_HBM_SHAPES,
         "scripts/fused_probe.py:146 (P3), scripts/fused_probe2.py:116 (P6), scripts/fused_probe3.py:44 (P7)"),
    )
    for name, fn, shapes, replaces in gathers:
        err, r = 0, None
        for rows, cols in shapes:
            tab = torch.randint(-(1 << 31), 1 << 31, (rows, cols), dtype=torch.int64, device=dev, generator=gen).int()
            for q in (PROBE_Q, PROBE_Q - 97):
                idx0 = probe.random_starts(q, rows, dev, gen)
                for mode in probe.MODES:
                    err = max(err, max_abs(fn(tab, idx0, PROBE_ITERS, mode), probe.gather_plain(tab, idx0, PROBE_ITERS, mode)))
                if r is None:  # the kernel alone: the wrapper's bounds check syncs
                    rows_idx = (idx0.long()[:, None] + torch.arange(PROBE_ITERS, device=dev)) % rows
                    row_bytes = min(q * PROBE_ITERS, rows) * cols * 4  # at most the table: each row once
                    r = dict(ms=probe.queued_ms([lambda: probe.launch_gather(fn, tab, idx0, PROBE_ITERS, "dep")] * 10),
                             plain=cuda_ms(lambda: probe.gather_plain(tab, idx0, PROBE_ITERS, "dep"), 3),
                             indep_ms=probe.queued_ms([lambda: probe.launch_gather(fn, tab, idx0, PROBE_ITERS, "indep")] * 10),
                             library=cuda_ms(lambda: tab[rows_idx], 10), bound=bound_ms(row_bytes + nbytes(idx0) + 12 * q),
                             input=f"({rows}, {cols}) int32 table, {q} lanes x {PROBE_ITERS} dep steps; indep and "
                                   f"`tab[idx]` over the same {q} x {PROBE_ITERS} rows")
            del tab
        if err:
            fail(f"{name} differs from gather_plain by up to {err}")
        res[name] = dict(r, err=err, replaces=replaces)
        say(f"[probe] {name}: exact in every mode ({', '.join(probe.MODES)}) on "
            + " and ".join(f"({rows}, {cols})" for rows, cols in shapes)
            + f" int32 tables, {PROBE_Q} and {PROBE_Q - 97} lanes x {PROBE_ITERS} steps; {r['input']}: dep "
            f"{r['ms']:.4f} ms vs plain {r['plain']:.4f} ms; indep {r['indep_ms']:.4f} ms vs `tab[idx]` "
            f"{r['library']:.4f} ms; bound {r['bound']:.4f} ms")
    return res


def walk_err(got, want) -> int:
    """Largest difference between the kernel's and the plain version's walk
    arrays (ssa_l only where a lane hit)."""
    filled = want[1] >= 0
    return max(max_abs(got[1], want[1]), max_abs(got[0][filled], want[0][filled]), max_abs(got[2], want[2]),
               max_abs(got[3], want[3]))


def native_walk_s(stderr: str) -> float:
    """The seconds `python -m ropebwt3_tpu ssa` spent after loading the
    index (its native walk and the SSA write), from its log: the footer's
    real time less the time of the `loaded the BWT` line."""
    load = re.search(r"\[M::load_index::([0-9.]+)\*", stderr)
    end = re.search(r"Real time: ([0-9.]+) sec", stderr)
    if load is None or end is None:
        fail(f"`python -m ropebwt3_tpu ssa` logged no load or end time: {stderr[-500:]}")
    return float(end.group(1)) - float(load.group(1))


def check_ssa(cli, ssa_ops, probe, rank, dev, card: str, f, fmd: str, idxs: dict, reads, ns: dict) -> tuple[dict, dict]:
    """ssa_gen of both dense layouts on bench.py's index, the many-sequence
    index and the CPU tests' corpus: byte-equal to `python -m ropebwt3_tpu
    ssa`, arrays equal to ssa_gen_plain on the card where it runs; then `ssa`
    through the CLI on each, byte-equal to the same file.  Returns the
    per-layout records and the ssa path's launch counts (bench.py's index)."""
    import torch

    from ropebwt3_tpu_torch.formats.ssa import write_ssa_bytes

    inputs = [("bench", f, fmd, idxs["dense32"], idxs["dense64"], SSA_SHIFT)]
    t0 = time.perf_counter()
    for name, fa, ss in (("many", write_fasta(os.path.join(WORK, "many", "reads.fa"), reads[:N_READS]), SSA_SHIFT),
                         ("corpus", make_test_corpus(os.path.join(WORK, "corpus")), 4)):
        x_fmd = build_index(fa)
        xf = cli.load_index(x_fmd)
        inputs.append((name, xf, x_fmd, rank.OccIndex.from_dense(xf, dev),
                       rank.OccIndex.from_dense(xf, dev, int64=True, mega_shift=DENSE64_SHIFT), ss))
    say("[ssa] indexes: " + "; ".join(f"{x[0]} n={x[1].n} m={int(x[1].acc[1])}" for x in inputs)
        + f" (built or loaded in {time.perf_counter() - t0:.3f} s)")
    res = {lay: {} for lay in ("dense32", "dense64")}
    refs = {}
    for name, xf, x_fmd, d32, d64, ss in inputs:
        m = int(xf.acc[1])
        opts = [] if ss == SSA_SHIFT else ["-s", str(ss)]
        ref_fn = os.path.join(WORK, f"ssa_{name}_ref.ssa")
        ref_s, ref_err = run([sys.executable, "-m", "ropebwt3_tpu", "ssa", *opts, "-o", ref_fn, x_fmd])
        want = open(ref_fn, "rb").read()
        native_ms = native_walk_s(ref_err) * 1e3
        refs[name] = (ref_fn, ref_s, opts)
        for lay, x in (("dense32", d32), ("dense64", d64)):
            walk = ssa_ops.ssa_gen_cuda(x, m, ss)
            if write_ssa_bytes(ssa_ops.assemble(m, ss, *walk)) != want:
                fail(f"ssa_gen {lay} on the {name} index differs from `python -m ropebwt3_tpu ssa`")
            longest = int(walk[2].max())
            ms = probe.queued_ms([lambda: ssa_ops.launch_walk(x, m, ss)] * (1 if name == "bench" else 5))
            r = res[lay]
            if name == "bench":
                r.update(bench_ms=ms, bench_native_ms=native_ms, bench_longest=longest,
                         bench_chain_floor_ms=longest * ns[LAT_48MB] / 1e6)
                plain_note = f"plain not run (lanes of ~{int((xf.acc[6] - m) // m)} steps: as many lock-step trips)"
            else:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                want_arr = ssa_ops.ssa_gen_plain(x, m, ss)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t1) * 1e3
                err = walk_err(walk, want_arr)
                if err:
                    fail(f"ssa_gen {lay} on the {name} index: arrays differ from ssa_gen_plain by up to {err}")
                r["err"] = max(r.get("err", 0), err)
                if name == "many":  # its 22.6 MB of rows stay in the L2
                    r.update(ms=ms, plain=plain_ms, bound=bound_ms(x.nbytes + nbytes(*walk)), longest=longest,
                             chain_floor_ms=longest * ns[LAT_L2] / 1e6,
                             input=f"many-sequence index: {N_READS} x {READ_LEN} bp reads, double strand, n={xf.n}, "
                                   f"m={m}, -s {ss}")
                plain_note = f"plain on the card {plain_ms:.4f} ms, arrays exact"
            say(f"[ssa] {name} {lay}: SSA (-s {ss}) byte-equal to `python -m ropebwt3_tpu ssa`; kernel {ms:.4f} ms, "
                f"longest walk {longest} steps, vs the reference's native walk and write {native_ms:.4f} ms "
                f"({os.cpu_count()} host cores; its log); {plain_note} ({card})")

    path = None
    for name, xf, x_fmd, d32, d64, ss in inputs:
        ref_fn, ref_s, opts = refs[name]
        port_fn = os.path.join(WORK, f"ssa_{name}_port.ssa")
        argv = ["ssa", *opts, "-o", port_fn, x_fmd]
        ssa_ops.ssa_gen_cuda.launches.clear()
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        port_s = time.perf_counter() - t0
        launches = dict(ssa_ops.ssa_gen_cuda.launches)
        sys.stderr.write(err.getvalue())
        if rc != 0:
            fail(f"ropebwt3_tpu_torch {' '.join(argv)} exited {rc}")
        if open(port_fn, "rb").read() != open(ref_fn, "rb").read():
            fail(f"port `ssa` on the {name} index differs from `python -m ropebwt3_tpu ssa`")
        if launches.get("dense32", 0) < 1 or f"{launches['dense32']} ssa_gen launches (dense32)" not in err.getvalue():
            fail(f"port `ssa` on the {name} index: no dense32 ssa_gen launch counted ({launches})")
        if name == "bench":
            path = dict(launches=launches, port_s=port_s)
        say(f"[ssa] `{' '.join(['ssa', *opts])}` on the {name} index: file byte-equal to `python -m ropebwt3_tpu ssa`; "
            f"launches {launches}; port in-process {port_s:.3f} s, reference `python -m ropebwt3_tpu ssa` {ref_s:.3f} s")
    many_fmd = inputs[1][2]
    sub_fn = os.path.join(WORK, "ssa_many_sub.ssa")
    sub_s, sub_err = run([sys.executable, "-m", "ropebwt3_tpu_torch", "ssa", "-o", sub_fn, many_fmd])
    m_sub = re.search(r"(\d+) ssa_gen launches \(dense32\)", sub_err)
    if m_sub is None or int(m_sub.group(1)) < 1:
        fail(f"`python -m ropebwt3_tpu_torch ssa` reported no dense32 launch: {sub_err[-500:]}")
    if open(sub_fn, "rb").read() != open(refs["many"][0], "rb").read():
        fail("`python -m ropebwt3_tpu_torch ssa` on the many index differs from `python -m ropebwt3_tpu ssa`")
    say(f"[ssa] `python -m ropebwt3_tpu_torch ssa` on the many index: byte-equal, {m_sub.group(1)} dense32 launch, "
        f"{sub_s:.3f} s one-shot ({card})")
    return res, path


def chains_err(got, want, max_mems: int, what: str) -> int:
    """Largest difference between two Chains (kernel vs plain) over the
    filled MEM rows, the filled START log entries and the trips; fails if a
    count differs."""
    import torch

    if not torch.equal(got.n_mem.long(), want.n_mem.long()):
        fail(f"{what}: MEM counts differ from the plain version")
    filled = torch.arange(max_mems, device=got.mems.device) < got.n_mem.long().clamp(max=max_mems)[:, None]
    err = max_abs(got.mems[filled], want.mems[filled])
    if got.trips is not None:
        err = max(err, max_abs(got.trips, want.trips))
    if got.log is not None:
        if not torch.equal(got.n_log.long(), want.n_log.long()):
            fail(f"{what}: START log counts differ from the plain version")
        k = got.log.shape[1]
        filled = torch.arange(k, device=got.log.device) < got.n_log.long().clamp(max=k)[:, None]
        err = max(err, max_abs(got.log[filled], want.log[filled]))
    return err


def serial_answer(smem, x, flat, seq_off) -> tuple:
    """Every read's MEMs from the one-thread kernel, rerun with a buffer of
    the largest true count where the first buffer overflowed; and its trips."""
    import torch

    one = smem.smem_tg_cuda(x, flat, seq_off, min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS, trips=True)
    big = max(int(one.n_mem.max()), 1)
    if big > MAX_MEMS:
        one = smem.smem_tg_cuda(x, flat, seq_off, min_occ=1, min_len=MIN_LEN, max_mems=big, trips=True)
    width = one.mems.shape[1]
    filled = torch.arange(width, device=flat.device) < one.n_mem.long()[:, None]
    return one.n_mem.long(), one.mems[filled], one.trips


def cli_run(cli, argv: list[str]) -> tuple[float, str]:
    """`python -m ropebwt3_tpu_torch <argv>` in this process (stdout to
    /dev/null); fails unless it exits 0.  Returns its wall seconds (the card
    synchronized) and its stderr."""
    import torch

    err = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    if rc != 0:
        fail(f"ropebwt3_tpu_torch {' '.join(argv)} exited {rc}: {err.getvalue()[-2000:]}")
    return s, err.getvalue()


def same_file(a: str, b: str, what: str) -> None:
    if open(a, "rb").read() != open(b, "rb").read():
        fail(f"{what}: {a} differs from {b}")


def host_batches(fa: str, batch_size: int) -> list[np.ndarray]:
    """The construction batches `build -m batch_size` reads from `fa` (both
    strands), through the port's reader as main_build calls it."""
    from ropebwt3_tpu_torch import seqio

    return [seqio.batch_nt6_flat(fl, of)[1] for _, fl, of in seqio.iter_flat_batches(fa, False, batch_size // 2)]


def longest_walk(seq: np.ndarray) -> int:
    """Steps of the longest LF walk over a batch's sequences: its longest
    0-terminated sequence, sentinel included."""
    ends = np.flatnonzero(seq == 0)
    return int(np.diff(np.concatenate([[-1], ends])).max())


def timed_rounds(sa, seq_d, passes) -> tuple[list[dict], object, object, float]:
    """construct/sa.py's rounds (packed keys) pass by pass, with CUDA events
    around each pass, the library sort and the scan: (per round ms, sa, bwt,
    the final gather's ms)."""
    import torch

    keys, flags, scatter, to_bwt = passes
    n = seq_d.numel()
    rank = sa.initial_ranks(seq_d)
    k, rounds = 1, []
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        t0 = time.perf_counter()
        ev[0].record()
        key = keys(rank, k, True)
        ev[1].record()
        key_s, perm = torch.sort(key)
        ev[2].record()
        del key
        neq = flags(key_s, None)
        ev[3].record()
        del key_s
        nr = torch.cumsum(neq, 0)
        ev[4].record()
        del neq
        done = int(nr[-1]) == n - 1
        ev[5].record()
        if not done:
            scatter(perm, nr, rank)
        ev[6].record()
        ev[6].synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]
        rounds.append(dict(k=k, keys=ms[0], sort=ms[1], flags=ms[2], scan=ms[3], scatter=ms[5],
                           wall=(time.perf_counter() - t0) * 1e3))
        if done:
            break
        k *= 2
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    bwt = to_bwt(seq_d, perm)
    b.record()
    b.synchronize()
    return rounds, perm, bwt, a.elapsed_time(b)


def k6_ms(merge, idx, rec, m2: int, S: int, reps: int) -> tuple[float, object, object]:
    """K6's mean ms over `reps` launches at stride S, each into its own ins
    (allocated beforehand, as merge_rank_cuda's allocation takes no card
    time); returns the time, one result and its segment records."""
    import torch

    ins = [torch.empty_like(rec) for _ in range(reps)]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    segs = [merge.launch_merge_rank(idx, rec, x, m2, S)[1] for x in ins]
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, ins[0], segs[0]


# ins of the JAX package's native merge walk, in a subprocess (this script
# imports nothing of that package): merge_rank_native, which its tests hold
# bit-identical to its merge_rank_plain
NATIVE_INS = ("import sys\nimport numpy as np\nfrom ropebwt3_tpu.construct.merge import merge_rank_native\n"
              "from ropebwt3_tpu.index.dense import DenseFMIndex\nd = np.load(sys.argv[1])\n"
              "np.save(sys.argv[2], merge_rank_native(DenseFMIndex.from_bwt(d['b1']), d['b2'])[1])\n")


def native_ins(b1, b2) -> tuple[np.ndarray, float]:
    """(ins, seconds of the subprocess) of the native merge walk of B2 into B1."""
    src, dst = os.path.join(WORK, "k6_in.npz"), os.path.join(WORK, "k6_ins.npy")
    np.savez(src, b1=b1.cpu().numpy(), b2=b2.cpu().numpy())
    s, _ = run([sys.executable, "-c", NATIVE_INS, src, dst])
    return np.load(dst), s


def check_k6(merge, idx, b1, b2, reps: int, lanes_plain: bool) -> dict:
    """K6 on one merge, B2's BWT b2 into B1 (b1, its rows idx), at the
    derived stride, as merge_rank_cuda runs it: timed, and its ins held
    exactly against merge_rank_chunked_plain on the card (segment records
    too), the native walk, and (lanes_plain) merge_rank_plain on the card.
    Returns ins and the record of the merge."""
    import torch

    acc2, rec = merge.lf2_packed(b2)
    m2, n2 = int(acc2[1]), rec.numel()
    S = merge.stride(n2, idx.device)
    first, n_seg = merge.segments(n2, m2, S)
    ms, ins, seg = k6_ms(merge, idx, rec, m2, S, reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pins, pseg = merge.merge_rank_chunked_plain(idx, rec.clone(), m2, S)
    torch.cuda.synchronize()
    chunked_plain = (time.perf_counter() - t0) * 1e3
    nat, nat_s = native_ins(b1, b2)
    err = max(max_abs(ins, pins), int(np.abs(ins.cpu().numpy() - nat).max()) if n2 else 0)
    plain = None
    if lanes_plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = merge.merge_rank_plain(idx, rec.clone(), m2)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        err = max(err, max_abs(ins, want))
    if err or not torch.equal(seg, pseg):
        fail(f"[construct] merge_rank_{idx.layout} (n1={idx.n}, n2={n2}, S={S}) differs from its plain versions or the "
             f"native walk by {err}, or its segment records differ")
    meet, length, _, _, hand = (x.cpu().numpy() for x in pseg)
    met = meet[m2:][meet[m2:] != merge.NEVER]
    q = np.percentile(met, [50, 99]) if met.size else [0, 0]
    return ins, dict(
        n1=idx.n, n2=n2, m2=m2, S=S, lanes=n_seg, err=err, ms=ms, plain=plain,
        chunked_plain_ms=chunked_plain, native_walk_s=nat_s, meet_median=float(q[0]), meet_p99=float(q[1]),
        meet_max=int(met.max()) if met.size else 0, never_met=int(n_seg - m2 - met.size),
        longest_segment=int(length.max()) if n_seg else 0, longest_hand_over=int(hand.max()) if n_seg else 0,
        # the rows and acc read, the records read and ins written (8 B each a
        # B2 symbol), the segment records written
        bound=bound_ms(idx.nbytes + 16 * n2 + 8 * merge.SEG_ROWS * n_seg))


def k6_line(m: dict) -> str:
    return (f"n1={m['n1']} n2={m['n2']} m2={m['m2']}: S {m['S']}, {m['lanes']} lanes, meeting length median "
            f"{m['meet_median']:.0f} / p99 {m['meet_p99']:.0f} / max {m['meet_max']} steps ({m['never_met']} strided "
            f"segments never met), longest segment {m['longest_segment']}, longest hand-over "
            f"{m['longest_hand_over']}; K6 {m['ms']:.4f} ms, bytes bound {m['bound']:.4f} ms; "
            f"merge_rank_chunked_plain on the card {m['chunked_plain_ms']:.1f} ms"
            + (f", merge_rank_plain {m['plain']:.1f} ms" if m["plain"] is not None else "")
            + f"; ins exact against both plain versions and the native walk ({m['native_walk_s']:.2f} s subprocess)")


def log_merge_s(stderr: str) -> list[float]:
    """Seconds of each merge in a `python -m ropebwt3_tpu build` log: each
    `merged the partial BWT` line's time less the line before it (its dense
    tables, lf2, native merge rank, merge apply and the merged tables)."""
    stamps = [(float(m.group(1)), m.group(2)) for m in re.finditer(r"\[M::main_build::([0-9.]+)\*[0-9.]+\] (.*)", stderr)]
    return [t - stamps[i - 1][0] for i, (t, msg) in enumerate(stamps) if msg.startswith("merged the partial BWT") and i]


def check_construct(cli, dev, card: str, fa: str, fmd: str, many_fa: str, many_fmd: str) -> dict:
    """[construct]: `build` on the card, its FMDs byte-equal to the repo's
    own (native SA-IS) index build; K7 and K6 against their plain versions
    on the card; `merge` byte-equal to the JAX package's.  Returns the
    records of the kernels line (K6's chain floors wait for [probe]'s ns per
    step)."""
    import torch

    from ropebwt3_tpu_torch.cli import _runs_of_bwt
    from ropebwt3_tpu_torch.construct import merge, sa
    from ropebwt3_tpu_torch.formats.fmd import encode_runs
    from ropebwt3_tpu_torch.ops.rank import OccIndex

    out = {}
    # 1. bench.py's genomes in one batch
    port_fmd = os.path.join(WORK, "construct_port.fmd")
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    one_s, _ = cli_run(cli, ["build", "-do", port_fmd, fa])
    peak = torch.cuda.max_memory_allocated(dev) - base_mem
    same_file(port_fmd, fmd, "port `build -do` (one batch) vs the repo's index build")
    ref_fmd = os.path.join(WORK, "construct_ref.fmd")
    ref_s, _ = run([sys.executable, "-m", "ropebwt3_tpu", "build", "-do", ref_fmd, fa])
    same_file(ref_fmd, fmd, "a fresh `python -m ropebwt3_tpu build -do`")
    sub_fmd = os.path.join(WORK, "construct_sub.fmd")
    sub_s, _ = run([sys.executable, "-m", "ropebwt3_tpu_torch", "build", "-do", sub_fmd, fa])
    same_file(sub_fmd, fmd, "`python -m ropebwt3_tpu_torch build -do`")
    # its pieces, warm: read, sort (upload, K7, download), FMD encode
    t0 = time.perf_counter()
    (seq,) = host_batches(fa, 7_000_000_000)
    t_read = time.perf_counter() - t0
    n = len(seq)
    seq_d = torch.from_numpy(seq).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bwt_host = sa.gsa_bwt(seq_d, dev)[0].cpu().numpy()
    t_sort = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = encode_runs(*_runs_of_bwt(bwt_host))
    t_enc = time.perf_counter() - t0
    if data != open(fmd, "rb").read():
        fail("[construct] gsa_bwt's BWT of bench.py's batch, encoded, differs from the index build's FMD")
    # 4. K7 against its plain passes on the card, pass by pass
    rounds, perm, bwt_k, bwt_ms = timed_rounds(sa, seq_d, sa.CUDA)
    prounds, pperm, bwt_p, pbwt_ms = timed_rounds(sa, seq_d, sa.PLAIN)
    k7_err = max(max_abs(perm, pperm), max_abs(bwt_k, bwt_p))
    if k7_err or len(rounds) != len(prounds) or not np.array_equal(bwt_k.cpu().numpy(), bwt_host):
        fail(f"[construct] K7 kernels vs plain passes: sa/bwt off by {k7_err}, {len(rounds)} vs {len(prounds)} rounds")
    del perm, pperm, bwt_k, bwt_p

    def passes_ms(rs, last):
        return sum(r["keys"] + r["flags"] + r["scatter"] for r in rs) + last

    nr = len(rounds)
    k7 = dict(rounds=nr, per_round=rounds, ms=passes_ms(rounds, bwt_ms), plain=passes_ms(prounds, pbwt_ms),
              sort_ms=sum(r["sort"] for r in rounds), scan_ms=sum(r["scan"] for r in rounds),
              total_ms=sum(r["wall"] for r in rounds) + bwt_ms, err=k7_err,
              # keys 16 B, flags 16 B, scatter 24 B a symbol (not in the last round), the gather 10 B
              bound=bound_ms(n * (32 * nr + 24 * (nr - 1) + 10)), peak_b_per_sym=peak / n,
              input=f"bench.py's batch: {n} symbols, one batch, {nr} rounds")
    say(f"[construct] `build -do` of bench.py's genomes (one batch, n={n}): FMD byte-equal to the repo's index build; "
        f"port in-process {one_s:.3f} s (read {t_read:.3f} s, upload + sort + download {t_sort:.3f} s, FMD encode "
        f"{t_enc:.3f} s), one-shot `python -m ropebwt3_tpu_torch build -do` {sub_s:.3f} s, fresh `python -m "
        f"ropebwt3_tpu build -do` (native SA-IS, {os.cpu_count()} host cores) {ref_s:.3f} s; peak card memory {peak} B "
        f"({peak / n:.2f} B a symbol) ({card})")
    say(f"[construct] K7 on bench.py's batch: {nr} rounds, card ms per round (keys / torch.sort / flags / cumsum / "
        f"scatter; wall): " + "; ".join(
            f"k={r['k']}: {r['keys']:.3f}/{r['sort']:.3f}/{r['flags']:.3f}/{r['scan']:.3f}/{r['scatter']:.3f}; "
            f"{r['wall']:.3f}" for r in rounds)
        + f"; final gather {bwt_ms:.3f} ms; total {k7['total_ms']:.3f} ms, of it torch.sort {k7['sort_ms']:.3f} ms, "
        f"the four passes {k7['ms']:.3f} ms (plain passes on the card {k7['plain']:.3f} ms; sa and BWT exact); "
        f"passes' bound (bytes) {k7['bound']:.4f} ms ({card})")
    del seq_d
    out["sa_round"] = k7

    # 2. the same genomes with -m 16M: three merges, the build path
    port16 = os.path.join(WORK, "construct_port_m16.fmd")
    sa.SA_LAUNCHES.clear()
    merge.merge_rank_cuda.launches.clear()
    path_s, path_err = cli_run(cli, ["build", "-m", CONSTRUCT_M, "-do", port16, fa])
    out["path"] = dict(sa=dict(sa.SA_LAUNCHES), merge=dict(merge.merge_rank_cuda.launches), s=path_s)
    same_file(port16, fmd, f"port `build -m {CONSTRUCT_M} -do` vs the one-batch index build")
    if min(out["path"]["sa"].get(p, 0) for p in ("sa_keys", "sa_flags", "sa_scatter", "sa_bwt")) < 1 or \
            out["path"]["merge"].get("dense32", 0) < 1:
        fail(f"[construct] the build path launched {out['path']} (every sa_round pass and merge_rank_dense32 expected)")
    ref16 = os.path.join(WORK, "construct_ref_m16.fmd")
    ref16_s, ref16_err = run([sys.executable, "-m", "ropebwt3_tpu", "build", "-m", CONSTRUCT_M, "-do", ref16, fa])
    same_file(ref16, fmd, f"`python -m ropebwt3_tpu build -m {CONSTRUCT_M} -do`")
    merges, bwt = [], None
    for seq in host_batches(fa, cli.parse_num(CONSTRUCT_M)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b2 = sa.gsa_bwt(seq, dev)[0]
        torch.cuda.synchronize()
        t_k7 = time.perf_counter() - t0
        if bwt is None:
            bwt = b2
            continue
        t0 = time.perf_counter()
        idx = OccIndex.from_bwt(bwt)
        torch.cuda.synchronize()
        t_rows = time.perf_counter() - t0
        ins, m = check_k6(merge, idx, bwt, b2, 3, lanes_plain=False)
        t0 = time.perf_counter()
        merged = merge.merge_apply(bwt, b2, ins)
        torch.cuda.synchronize()
        t_apply = time.perf_counter() - t0
        del idx, ins
        # the merge as `build` runs it, its peak card memory against merge_bytes (which counts B1 and B2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        other = torch.cuda.memory_allocated(dev) - bwt.numel() - b2.numel()
        got = cli._merge_into(bwt, b2, dev)
        peak = torch.cuda.max_memory_allocated(dev) - other
        count = merge.merge_bytes(bwt.numel(), b2.numel(), m["m2"])
        if peak > count or not torch.equal(got, merged):
            fail(f"[construct] merge of {b2.numel()} symbols into {bwt.numel()}: peak {peak} B against merge_bytes "
                 f"{count} B, or _merge_into's BWT differs from the pieces'")
        m.update(longest=longest_walk(seq), k7_s=t_k7, rows_s=t_rows, apply_s=t_apply, peak_bytes=peak,
                 merge_bytes=count)
        merges.append(m)
        bwt = merged
        del got
    if encode_runs(*_runs_of_bwt(bwt.cpu().numpy())) != open(fmd, "rb").read():
        fail(f"[construct] the -m {CONSTRUCT_M} pieces, run one by one, give another FMD")
    del bwt, b2
    native16 = log_merge_s(ref16_err)
    out["merges16"] = merges
    say(f"[construct] `build -m {CONSTRUCT_M} -do` (the build path): FMD byte-equal to the one-batch build; launches "
        f"{out['path']['sa']}, merge_rank {out['path']['merge']}; port in-process {path_s:.3f} s, `python -m "
        f"ropebwt3_tpu build -m {CONSTRUCT_M} -do` {ref16_s:.3f} s (its merges {[round(x, 3) for x in native16]} s); "
        f"K7 per later batch (upload, sort) {[round(m['k7_s'] * 1e3, 3) for m in merges]} ms ({card})")
    for m in merges:
        say(f"[construct] -m {CONSTRUCT_M} merge, dense32, {k6_line(m)}; rows (OccIndex.from_bwt) "
            f"{m['rows_s'] * 1e3:.3f} ms, merge_apply {m['apply_s'] * 1e3:.3f} ms; peak card memory {m['peak_bytes']} "
            f"B, merge_bytes {m['merge_bytes']} B ({card})")

    # 3. many short walks: the 100,000 reads with -m 12M
    many_port = os.path.join(WORK, "construct_port_many.fmd")
    many_s, _ = cli_run(cli, ["build", "-m", MANY_M, "-do", many_port, many_fa])
    same_file(many_port, many_fmd, f"port `build -m {MANY_M}` of the short reads vs their index build")
    many_ref = os.path.join(WORK, "construct_ref_many.fmd")
    many_ref_s, many_ref_err = run([sys.executable, "-m", "ropebwt3_tpu", "build", "-m", MANY_M, "-do", many_ref, many_fa])
    same_file(many_ref, many_fmd, f"`python -m ropebwt3_tpu build -m {MANY_M}` of the short reads")
    s1, s2 = host_batches(many_fa, cli.parse_num(MANY_M))[:2]
    b1, b2 = sa.gsa_bwt(s1, dev)[0], sa.gsa_bwt(s2, dev)[0]
    steps = longest_walk(s2)
    for layout, idx in (("dense32", OccIndex.from_bwt(b1)),
                        ("dense64", OccIndex.from_bwt(b1, int64=True, mega_shift=DENSE64_SHIFT))):
        if idx.layout != layout:
            fail(f"[construct] the short reads' B1 rows are {idx.layout}, not {layout}")
        _, r = check_k6(merge, idx, b1, b2, 5, lanes_plain=True)
        r.update(longest=steps, many_native_merges_s=log_merge_s(many_ref_err),
                 input=f"the short reads' first merge (-m {MANY_M}): n1={idx.n}, n2={len(s2)}, m2={r['m2']} sequences "
                       f"of up to {steps} steps")
        out[f"merge_rank_{layout}"] = r
        say(f"[construct] merge_rank_{layout} on the short reads' first merge (longest walk {steps} steps), {k6_line(r)} "
            f"({card})")
    say(f"[construct] `build -m {MANY_M}` of the {N_READS} short reads: FMD byte-equal to their index build; port "
        f"in-process {many_s:.3f} s, `python -m ropebwt3_tpu build -m {MANY_M}` {many_ref_s:.3f} s (its merges "
        f"{[round(x, 3) for x in log_merge_s(many_ref_err)]} s) ({card})")
    del b1, b2

    # 5. merge: the first and the second half of the genomes, built by the port
    halves = []
    with open(fa, "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    half = N_GENOMES  # lines of N_GENOMES // 2 genomes, two lines each
    for i in range(2):
        part = os.path.join(WORK, f"construct_half{i}.fa")
        with open(part, "wb") as fh:
            fh.writelines(lines[i * half : (i + 1) * half])
        halves.append(os.path.join(WORK, f"construct_half{i}.fmd"))
        cli_run(cli, ["build", "-do", halves[-1], part])
    port_fmr, ref_fmr = os.path.join(WORK, "construct_port.fmr"), os.path.join(WORK, "construct_ref.fmr")
    merge_s, _ = cli_run(cli, ["merge", "-o", port_fmr, *halves])
    ref_merge_s, _ = run([sys.executable, "-m", "ropebwt3_tpu", "merge", "-o", ref_fmr, *halves])
    same_file(port_fmr, ref_fmr, "port `merge` vs `python -m ropebwt3_tpu merge`")
    say(f"[construct] `merge` of the two halves ({N_GENOMES // 2} genomes each, built by the port): FMR byte-equal to "
        f"`python -m ropebwt3_tpu merge`; port in-process {merge_s:.3f} s, reference {ref_merge_s:.3f} s ({card})")
    return out


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "ropebwt3_tpu_torch")) or not os.path.isdir(os.path.join(ROOT, "ropebwt3_tpu")):
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    import ropebwt3_tpu_torch
    from ropebwt3_tpu_torch import cli, kernels, probe, ssa_ops
    from ropebwt3_tpu_torch.ops import rank, runblock, smem

    if os.path.dirname(os.path.abspath(ropebwt3_tpu_torch.__file__)) != os.path.join(ROOT, "ropebwt3_tpu_torch"):
        fail(f"imported ropebwt3_tpu_torch from {ropebwt3_tpu_torch.__file__}, not from this checkout")
    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    counters = (rank.rank1a_cuda, rank.extend_c_cuda, smem.smem_tg_cuda, smem.smem_tgc_cuda)

    # ---- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.lib()
    say(f"[build] kernels built and loaded in {time.perf_counter() - t0:.3f} s ({kernels.build()})")

    # ---- corpus --------------------------------------------------------------
    t0 = time.perf_counter()
    fa, reads_fa, reads = make_corpus(WORK, N_GENOMES, GENOME_LEN, N_READS, N_LONG, SEED)
    t1 = time.perf_counter()
    fmd = build_index(fa)
    t2 = time.perf_counter()
    f = cli.load_index(fmd)
    idx = rank.OccIndex.from_dense(f, dev)
    say(
        f"[corpus] {N_GENOMES} x {GENOME_LEN} bp genomes, {N_READS} x {READ_LEN} bp + {N_LONG} long reads in "
        f"{t1 - t0:.3f} s; index n={f.n} built in {t2 - t1:.3f} s; occf {tuple(idx.occf.shape)} "
        f"({idx.occf.numel() * 4 / 1e6:.3f} MB) on the card in {time.perf_counter() - t2:.3f} s"
    )
    t0 = time.perf_counter()
    S_bench, s_stats = runblock.choose_S(runblock.runs_from_dense(f)[1], f.n)
    idxs = {
        "dense32": idx,
        "dense64": rank.OccIndex.from_dense(f, dev, int64=True, mega_shift=DENSE64_SHIFT),
        "rb32": runblock.RunBlockIndex.from_dense(f, dev, cache=None),
        "rb64": runblock.RunBlockIndex.from_dense(f, dev, S=RB64_S, int64=True, mega_shift=RB64_SHIFT, cache=None),
    }
    say(
        f"[corpus] the other layouts in {time.perf_counter() - t0:.3f} s: "
        + "; ".join(
            f"{name} {x.nbytes} B ({x.nbytes / f.n:.4f} B/sym"
            + (f", S {x.S}, {x.n_esc} escape blocks" if name.startswith("rb") else "")
            + (f", {x.mega.shape[0]} megablocks" if x.int64 else "") + ")"
            for name, x in idxs.items()
        )
        + "; choose_S (bytes, escape share): " + ", ".join(f"{S}: {v[0]} {v[1]:.4f}" for S, v in s_stats.items())
    )

    # ---- construct -----------------------------------------------------------
    t0 = time.perf_counter()
    many_fa = write_fasta(os.path.join(WORK, "many", "reads.fa"), reads[:N_READS])
    con = check_construct(cli, dev, card, fa, fmd, many_fa, build_index(many_fa))
    say(f"[construct] phase in {time.perf_counter() - t0:.3f} s")

    # ---- rank ----------------------------------------------------------------
    rng = np.random.default_rng(SEED + 1)
    special = np.concatenate([[0, f.n], boundaries(f.n, 1 << 20, 64), boundaries(f.n, RB64_S, N_CHECK // 256),
                              boundaries(f.n, S_bench, N_CHECK // 256)])
    k = torch.from_numpy(np.concatenate([special, rng.integers(0, f.n + 1, N_CHECK - len(special))]).astype(np.int64)).to(dev)
    ik = torch.from_numpy(intervals(rng, f.n, N_CHECK, 100_000)).to(dev)
    c = torch.from_numpy(rng.integers(0, 6, N_CHECK).astype(np.int32)).to(dev)
    back = torch.from_numpy(rng.random(N_CHECK) < 0.5).to(dev)
    occ_res = {}
    for name, x in idxs.items():
        r = occ_res[name] = check_occ_kernels(rank, x, k, ik, c, back, 3)
        if r["got"][1].tolist() != (f.acc[1:] - f.acc[:-1]).tolist():
            fail(f"{name}: rank1a(n) is not the symbol totals")
        say(
            f"[rank] {name}: exact on {N_CHECK} positions and {N_CHECK} intervals; occ_rank1a {r['rank_ms']:.4f} ms "
            f"vs plain {r['rank_plain']:.4f} ms; occ_extend_c {r['ext_ms']:.4f} ms vs plain {r['ext_plain']:.4f} ms ({card})"
        )
        del r["got"]

    # ---- rank64 --------------------------------------------------------------
    t0 = time.perf_counter()
    syms, lens, (e0, e1) = synthetic_runs(SEED + 2)
    S64, stats = runblock.choose_S(lens, N64)
    d64 = runblock.build_runblock_np(syms, lens, n=N64)
    t1 = time.perf_counter()
    x64 = runblock.RunBlockIndex.from_np(d64, dev)
    del d64
    if not (S64 == x64.S == 8192 and x64.int64 and x64.n_esc >= 1 and x64.n % x64.S == 0):
        fail(f"rank64 rows: S {x64.S} (choose_S {S64}), int64 {x64.int64}, {x64.n_esc} escape blocks")
    say(
        f"[rank64] {len(lens)} runs, n={N64}; rb64 rows built in {t1 - t0:.3f} s: S {x64.S}, {x64.rows.shape[0]} rows, "
        f"{x64.n_esc} escape blocks, {x64.mega.shape[0]} megablocks, {x64.nbytes} B on the card "
        f"({x64.nbytes / N64:.5f} B/sym; choose_S bytes {[stats[s][0] for s in runblock.S_CHOICES]})"
    )
    special = np.concatenate([
        [0, 1, N64 - 1, N64, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1],
        boundaries(N64, 8192, N_CHECK // 16), np.arange(e0 - 8192, e1 + 8192, 7)[: N_CHECK // 8],
    ])
    k64 = np.concatenate([special, rng.integers(0, N64 + 1, N_CHECK - len(special))]).astype(np.int64)
    ik64 = torch.from_numpy(intervals(rng, N64, N_CHECK, 1 << 34)).to(dev)
    r64 = check_occ_kernels(rank, x64, torch.from_numpy(k64).to(dev), ik64, c, back, 2)
    indep = run_length_rank(syms, lens, k64)
    ind_err = int(np.abs(r64.pop("got").cpu().numpy() - indep).max())
    if ind_err:
        fail(f"rank64: occ_rank1a differs from the run-length rank by up to {ind_err}")
    del syms, lens, indep
    say(
        f"[rank64] exact on {N_CHECK} positions (vs plain and vs the run-length rank) and {N_CHECK} intervals; "
        f"occ_rank1a {r64['rank_ms']:.4f} ms vs plain {r64['rank_plain']:.4f} ms; occ_extend_c {r64['ext_ms']:.4f} ms "
        f"vs plain {r64['ext_plain']:.4f} ms ({card})"
    )
    del x64, ik64

    # ---- probe ---------------------------------------------------------------
    probe_res = check_probes(probe, dev)
    counted = (probe.smem_capacity_cuda, probe.smem_gather_cuda, probe.hbm_gather_cuda)
    for fn in counted:
        fn.launches.clear()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = probe.main([])
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        fail("python -m ropebwt3_tpu_torch.probe failed")
    for fn, name in zip(counted, ("probe_smem_capacity", "probe_smem_gather", "probe_hbm_gather")):
        probe_res[name]["launches"] = sum(fn.launches.values())
        if probe_res[name]["launches"] < 1:
            fail(f"the probe path launched no {name}")
    # this run's ns per dependent row step, from the probe path's latency sweep
    ns = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[probe\] probe_hbm_gather (.+?) q=32 dep, new starts: \d+ steps in [0-9.]+ ms, ([0-9.]+) ns/step", buf.getvalue())}
    if LAT_L2 not in ns or LAT_48MB not in ns:
        fail(f"the probe path's latency sweep gave no ns per step for {LAT_L2} and {LAT_48MB}: {ns}")
    say(f"[probe] path `python -m ropebwt3_tpu_torch.probe` in {time.perf_counter() - t0:.3f} s; launches "
        + ", ".join(f"{k} {v['launches']}" for k, v in probe_res.items())
        + f"; ns per dependent step: {ns[LAT_L2]} ({LAT_L2}), {ns[LAT_48MB]} ({LAT_48MB})")

    # K6's chain floors: pass 1's longest segment, then pass 2's longest
    # hand-over, a dependent row step each.  The short reads' B1 rows (9 MB)
    # stay in the L2; the genomes' (12-36 MB) are taken at the 48 MB
    # table's ns per step
    for m, step in [(con[f"merge_rank_{lay}"], ns[LAT_L2]) for lay in ("dense32", "dense64")] + \
            [(m, ns[LAT_48MB]) for m in con["merges16"]]:
        m["chain_floor_ms"] = (m["longest_segment"] + m["longest_hand_over"]) * step / 1e6
    say("[construct] K6 chain floors (longest segment + longest hand-over): short reads' merge " + ", ".join(
            f"{lay} {con[f'merge_rank_{lay}']['chain_floor_ms']:.4f} ms (K6 {con[f'merge_rank_{lay}']['ms']:.4f} ms)"
            for lay in ("dense32", "dense64"))
        + f" ({ns[LAT_L2]} ns a step); -m {CONSTRUCT_M} merges "
        + ", ".join(f"{m['chain_floor_ms']:.3f} ms (K6 {m['ms']:.3f} ms)" for m in con["merges16"])
        + f" ({ns[LAT_48MB]} ns a step) ({card})")

    # ---- smem ----------------------------------------------------------------
    args = dict(min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS)

    def on_card(rs):
        return tuple(torch.from_numpy(a).to(dev) for a in smem.pack_reads(rs))

    sflat, soff = on_card(reads[:N_SMEM])
    cflat, coff = on_card(reads[:N_TGC_SHORT] + reads[N_READS : N_READS + N_TGC_LONG])
    clanes = smem.chunk_lanes(coff)
    aflat, aoff = on_card(reads)
    alanes = smem.chunk_lanes(aoff)
    n_short = N_READS * READ_LEN
    smem_res, ref, sweep = {}, None, []
    for name, x in idxs.items():
        k1 = smem.smem_tg_cuda(x, sflat, soff, trips=True, **args)
        err1 = chains_err(k1, smem.smem_tg_plain(x, sflat, soff, **args), MAX_MEMS, f"smem_tg {name}")
        kc = smem.smem_tgc_cuda(x, cflat, coff, clanes, trips=True, **args)
        errc = chains_err(kc, smem.smem_tg_plain(x, cflat, coff, lanes=clanes, log_len=smem.LOG_LEN, **args), MAX_MEMS,
                          f"smem_tgc {name}")
        if err1 or errc:
            fail(f"smem {name}: smem_tg off by {err1}, smem_tgc off by {errc} against smem_tg_plain")
        r = dict(err=err1, cerr=errc,
                 ms=probe.queued_ms([lambda: smem.launch_tg(x, sflat, soff, **args)] * 10),
                 plain=wall_ms(lambda: smem.smem_tg_plain(x, sflat, soff, **args)),
                 bound=bound_ms(x.nbytes + nbytes(sflat, soff) + nbytes(k1.n_mem) + int(k1.n_mem.clamp(max=MAX_MEMS).sum())
                                * 5 * k1.mems.element_size()),
                 floor=int(k1.trips.max()) * ns[LAT_48MB] / 1e6,
                 cms=probe.queued_ms([lambda: smem.launch_tgc(x, cflat, coff, clanes, **args)] * 10),
                 cplain=wall_ms(lambda: smem.smem_tg_plain(x, cflat, coff, lanes=clanes, log_len=smem.LOG_LEN, **args)),
                 cbound=bound_ms(x.nbytes + nbytes(cflat, coff, clanes, kc.n_mem, kc.n_log)
                                 + int(kc.n_mem.clamp(max=MAX_MEMS).sum()) * 5 * kc.mems.element_size()
                                 + int(kc.n_log.clamp(max=smem.LOG_LEN).sum()) * 4),
                 cfloor=int(kc.trips.max()) * ns[LAT_48MB] / 1e6)
        # the main path's batch: the chunked engine against the one-thread kernel
        out = smem.smem_tg(x, aflat, aoff, **args)
        counts, rows, read_trips = serial_answer(smem, x, aflat, aoff)
        if not (torch.equal(out.counts, counts) and torch.equal(out.rows, rows)):
            fail(f"smem {name}: the chunked engine's rows on the main path's batch differ from the one-thread kernel's")
        if ref is None:
            ref = (counts, rows.long())
        elif not (torch.equal(counts, ref[0]) and torch.equal(rows.long(), ref[1])):
            fail(f"smem {name}: rows on the main path's batch differ from the dense32 kernels'")
        lane_trips = smem.launch_tgc(x, aflat, aoff, alanes, trips=True, **args).trips
        r.update(
            n_unmerged=out.n_unmerged, n_rerun=out.n_rerun, n_mems=int(counts.sum()), lanes=alanes.shape[0],
            tgc_ms=probe.queued_ms([lambda: smem.launch_tgc(x, aflat, aoff, alanes, **args)] * 3),
            tg_ms=probe.queued_ms([lambda: smem.launch_tg(x, aflat, aoff, **args)] * 3),
            short_ms=probe.queued_ms([lambda: smem.launch_tg(x, aflat[:n_short], aoff[: N_READS + 1], **args)] * 3),
            engine_ms=wall_ms(lambda: smem.smem_tg(x, aflat, aoff, **args)),
            lane_trips=int(lane_trips.max()), lane_trips_sum=int(lane_trips.sum()), read_trips=int(read_trips.max()),
            read_trips_sum=int(read_trips.sum()),
            batch_bound=bound_ms(x.nbytes + nbytes(aflat, aoff, counts, rows)),
        )
        for key, trips in (("tgc", r["lane_trips"]), ("tg", r["read_trips"])):
            r[f"{key}_floor"] = (trips * ns[LAT_L2] / 1e6, trips * ns[LAT_48MB] / 1e6)
        smem_res[name] = r
        say(
            f"[smem] {name}: smem_tg exact on {N_SMEM} reads ({int(k1.n_mem.sum())} MEMs) {r['ms']:.4f} ms vs plain "
            f"{r['plain']:.4f} ms; smem_tgc exact on the lanes of {N_TGC_SHORT} short + {N_TGC_LONG} long reads "
            f"({clanes.shape[0]} lanes; rows, counts, START logs, trips) {r['cms']:.4f} ms vs plain {r['cplain']:.4f} ms "
            f"({card})")
        say(
            f"[smem] {name} main path's batch ({len(reads)} reads, {r['lanes']} lanes of {smem.CHUNK} + {smem.MARGIN}): "
            f"chunked engine rows equal to the one-thread kernel's ({r['n_mems']} MEMs) and dense32's; smem_tgc "
            f"{r['tgc_ms']:.4f} ms, engine (launch, stitch, reruns) {r['engine_ms']:.4f} ms, n_unmerged {out.n_unmerged}, "
            f"n_rerun {out.n_rerun}; one-thread smem_tg {r['tg_ms']:.4f} ms, its {N_READS} short reads alone "
            f"{r['short_ms']:.4f} ms; trips: longest lane {r['lane_trips']} (all lanes {r['lane_trips_sum']}), longest "
            f"read {r['read_trips']} (all reads {r['read_trips_sum']}); roofline bound (bytes) {r['batch_bound']:.4f} ms; "
            f"chain floor smem_tgc {r['tgc_floor'][0]:.4f} / {r['tgc_floor'][1]:.4f} ms, smem_tg {r['tg_floor'][0]:.4f} / "
            f"{r['tg_floor'][1]:.4f} ms (at {ns[LAT_L2]} / {ns[LAT_48MB]} ns a step) ({card})"
        )
        if name == "dense32":
            for C in CHUNK_SWEEP:
                lanes = smem.chunk_lanes(aoff, C, C // 2)
                o = smem.smem_tg(x, aflat, aoff, chunk=C, margin=C // 2, **args)
                if not (torch.equal(o.counts, counts) and torch.equal(o.rows, rows)):
                    fail(f"smem dense32: chunk {C} gives other rows than the one-thread kernel")
                t = smem.launch_tgc(x, aflat, aoff, lanes, trips=True, **args).trips
                sweep.append(dict(chunk=C, margin=C // 2, lanes=lanes.shape[0], n_unmerged=o.n_unmerged,
                                  max_trips=int(t.max()), sum_trips=int(t.sum()),
                                  ms=probe.queued_ms([lambda lanes=lanes: smem.launch_tgc(x, aflat, aoff, lanes, **args)] * 3),
                                  engine_ms=wall_ms(lambda C=C: smem.smem_tg(x, aflat, aoff, chunk=C, margin=C // 2, **args))))
            say("[smem] dense32 chunk sweep (exact at each): " + "; ".join(
                f"C {w['chunk']} W {w['margin']}: {w['lanes']} lanes, smem_tgc {w['ms']:.4f} ms, engine "
                f"{w['engine_ms']:.4f} ms, longest lane {w['max_trips']} trips (all {w['sum_trips']}), n_unmerged "
                f"{w['n_unmerged']}" for w in sweep) + f" ({card})")
        del k1, kc, out, rows
    del aflat, aoff, alanes, ref

    # ---- ssa -----------------------------------------------------------------
    ssa_res, ssa_path = check_ssa(cli, ssa_ops, probe, rank, dev, card, f, fmd, idxs, reads, ns)

    # ---- mem: the main path, then --occ=rb --------------------------------------
    # the reference output first, untimed: that run also builds the JAX
    # package's native library and its sidecars, one-time costs
    native_bed = os.path.join(WORK, "native.bed")
    native_cmd = [sys.executable, "-m", "ropebwt3_tpu", "mem", "--engine=native", f"-l{MIN_LEN}", fmd, reads_fa]
    with open(native_bed, "wb") as out:
        run(native_cmd, stdout=out)
    want = open(native_bed, "rb").read()
    n_all = len(reads)
    paths = {}
    names = ("occ_rank1a", "occ_extend_c", "smem_tg", "smem_tgc")
    for path, extra, layout in (("mem", [], "dense32"), ("mem-rb", ["--occ=rb"], "rb32")):
        argv = ["mem", f"-l{MIN_LEN}", *extra, fmd, reads_fa]
        port_bed = os.path.join(WORK, f"port_{path}.bed")
        for counted in counters:
            counted.launches.clear()
        err = io.StringIO()
        t0 = time.perf_counter()
        with open(port_bed, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        port_s = time.perf_counter() - t0
        launches = {name: dict(counted.launches) for name, counted in zip(names, counters)}
        sys.stderr.write(err.getvalue())
        if rc != 0:
            fail(f"ropebwt3_tpu_torch {' '.join(argv)} exited {rc}")
        if launches["smem_tgc"].get(layout, 0) < 1:
            fail(f"{path}: no {layout} smem_tgc launch ({launches})")
        m = re.search(rf"(\d+) smem_tg launches \({layout}\): (\d+) chunked, (\d+) one-thread; (\d+) reads rerun on "
                      rf"the card, (\d+) unmerged", err.getvalue())
        if m is None or int(m.group(2)) != launches["smem_tgc"][layout]:
            fail(f"{path}: the port's mem did not report its engine counts for {layout}")
        got_bed = open(port_bed, "rb").read()
        if got_bed != want:
            fail(f"port {path} BED differs from --engine=native: {first_diff(got_bed, want)}")
        n_lines = want.count(b"\n")
        if n_lines < N_READS:
            fail(f"only {n_lines} BED lines for {N_READS + N_LONG} reads")
        paths[path] = dict(launches=launches, layout=layout, port_s=port_s, n_rerun=int(m.group(4)),
                           n_unmerged=int(m.group(5)))
        say(
            f"[{path}] `{' '.join(argv[:-2])}`: BED byte-equal to --engine=native ({n_lines} lines); launches {launches}; "
            f"n_rerun {m.group(4)}, n_unmerged {m.group(5)} (of {N_LONG} long reads); port in-process {port_s:.3f} s "
            f"({n_all / port_s:.1f} reads/s)"
        )

    # the main path's host work, piece by piece (warm: the sidecar and the
    # kernels exist), through the functions `mem` runs; its BED must match too
    from ropebwt3_tpu_torch import seqio

    t = {}
    t0 = time.perf_counter()
    f2 = cli.load_index(fmd)
    t["load_index"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = smem.BatchedSmemTG(f2, 1, MIN_LEN, device=dev)
    torch.cuda.synchronize()
    t["occ rows build and upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = list(seqio.iter_flat_batches(reads_fa, False, 100_000_000))
    t["FASTA read (iter_flat_batches)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    found = [eng.run_flat(fl, of) for _, fl, of in batches]
    t["engine (run_flat: upload, smem_tgc, stitch, reruns, download)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sink, sid = io.StringIO(), 0
    for (bnames, _, of), (bc, br) in zip(batches, found):
        sid = cli.write_bed(sink, f2, bnames, of, bc, br, sid, 0, False, 0)
    t["BED write (write_bed)"] = time.perf_counter() - t0
    if sink.getvalue().encode() != want:
        fail("the main path's pieces, run one by one, give another BED")
    say("[mem] host work of the main path, warm, in-process: " + "; ".join(f"{k} {v:.3f} s" for k, v in t.items())
        + f" ({len(batches)} batch, {card})")

    sub_bed = os.path.join(WORK, "port_subprocess.bed")
    argv = ["mem", f"-l{MIN_LEN}", fmd, reads_fa]
    with open(sub_bed, "wb") as out:
        sub_s, sub_err = run([sys.executable, "-m", "ropebwt3_tpu_torch"] + argv, stdout=out)
    say("[mem] `python -m ropebwt3_tpu_torch` stderr: " + " | ".join(sub_err.strip().splitlines()))
    if open(sub_bed, "rb").read() != want:
        fail(f"port mem (subprocess) BED differs from --engine=native: {first_diff(open(sub_bed, 'rb').read(), want)}")
    native_s, _ = run(native_cmd)
    say(
        f"[mem] end to end: port in-process {paths['mem']['port_s']:.3f} s (dense32), {paths['mem-rb']['port_s']:.3f} s "
        f"(--occ=rb), port `python -m ropebwt3_tpu_torch` {sub_s:.3f} s ({n_all / sub_s:.1f} reads/s), "
        f"native `python -m ropebwt3_tpu --engine=native` {native_s:.3f} s ({n_all / native_s:.1f} reads/s, "
        f"{os.cpu_count()} host cores) ({card})"
    )
    say(
        "[mem-rb] rows on the card and the chunked engine on the main path's batch: "
        + "; ".join(f"{name} {x.nbytes} B, smem_tgc {smem_res[name]['tgc_ms']:.4f} ms, one-thread smem_tg "
                    f"{smem_res[name]['tg_ms']:.4f} ms" for name, x in idxs.items())
        + f" ({card})"
    )

    def path_launches(kernel: str, layout: str) -> tuple[int, str | None]:
        for path, p in paths.items():
            if p["layout"] == layout and kernel in ("smem_tg", "smem_tgc"):
                return p["launches"][kernel].get(layout, 0), path
        return sum(p["launches"][kernel].get(layout, 0) for p in paths.values()), None

    entries = []
    smem_src, smem_rep = "ropebwt3_tpu_torch/csrc/smem_tg.cu", "ropebwt3_tpu/ops/smem_pallas.py:91"
    for name in LAYOUTS:
        s = smem_res[name]
        n, path = path_launches("smem_tg", name)
        entries.append({
            "name": f"smem_tg_{name}", "route": "cuda", "source": smem_src, "replaces": smem_rep, "launches": n,
            "path": path if n else None, "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain"],
            "bound_ms": s["bound"], "bound_by": "bytes", "library_ms": None, "chain_floor_ms": s["floor"],
            "input": f"{N_SMEM} x {READ_LEN} bp reads, one thread each",
            "main_path_batch_ms": s["tg_ms"], "main_path_batch_short_reads_ms": s["short_ms"],
            "main_path_batch_bound_ms": s["batch_bound"], "main_path_batch_chain_floor_ms": s["tg_floor"],
            "main_path_batch_longest_read_trips": s["read_trips"],
        })
        n, path = path_launches("smem_tgc", name)
        entries.append({
            "name": f"smem_tgc_{name}", "route": "cuda", "source": smem_src, "replaces": smem_rep, "launches": n,
            "path": path, "max_abs_err": s["cerr"], "ms": s["cms"], "plain_ms": s["cplain"], "bound_ms": s["cbound"],
            "bound_by": "bytes", "library_ms": None, "chain_floor_ms": s["cfloor"],
            "input": f"the lanes ({smem.CHUNK} + {smem.MARGIN}) of {N_TGC_SHORT} short and {N_TGC_LONG} long reads",
            "main_path_batch_ms": s["tgc_ms"], "main_path_batch_engine_ms": s["engine_ms"],
            "main_path_batch_bound_ms": s["batch_bound"], "main_path_batch_chain_floor_ms": s["tgc_floor"],
            "main_path_batch_longest_lane_trips": s["lane_trips"], "n_unmerged": s["n_unmerged"], "n_rerun": s["n_rerun"],
            **({"chunk_sweep": sweep} if name == "dense32" else {}),
        })
    for name in LAYOUTS:
        o = occ_res[name]
        src = "ropebwt3_tpu_torch/csrc/occ_rank.cu + " + ("rb.cuh" if name.startswith("rb") else "occ.cuh")
        rep = "ropebwt3_tpu/ops/runblock.py:154" if name.startswith("rb") else "ropebwt3_tpu/ops/rank.py:233"
        for kern, err, ms, plain, bound in (("occ_rank1a", o["rank_err"], o["rank_ms"], o["rank_plain"], o["rank_bound"]),
                                            ("occ_extend_c", o["ext_err"], o["ext_ms"], o["ext_plain"], o["ext_bound"])):
            n, path = path_launches(kern, name)
            e = {"name": f"{kern}_{name}", "route": "cuda", "source": src, "replaces": rep, "launches": n, "path": path,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                 "library_ms": None, "input": f"{N_CHECK} on the bench index"}
            if name == "rb64":
                key = "rank" if kern == "occ_rank1a" else "ext"
                e.update({"rank64_ms": r64[f"{key}_ms"], "rank64_plain_ms": r64[f"{key}_plain"],
                          "rank64_max_abs_err": r64[f"{key}_err"], "rank64_vs_run_length_rank_err": ind_err})
            entries.append(e)
    for name in ("probe_smem_capacity", "probe_smem_gather", "probe_hbm_gather"):
        r = probe_res[name]
        entries.append({"name": name, "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/probe.cu", "replaces": r["replaces"],
                        "launches": r["launches"], "path": "probe", "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"], "bound_by": "bytes", "library_ms": r["library"],
                        "input": r["input"], **({"indep_ms": r["indep_ms"]} if "indep_ms" in r else {})})
    for name in ("dense32", "dense64"):
        r = ssa_res[name]
        entries.append({
            "name": f"ssa_gen_{name}", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/ssa_gen.cu + occ.cuh",
            "replaces": "ropebwt3_tpu/ssa_ops.py:127", "launches": ssa_path["launches"].get(name, 0),
            "path": "ssa" if ssa_path["launches"].get(name, 0) else None, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain"], "bound_ms": r["bound"], "bound_by": "bytes", "library_ms": None,
            "chain_floor_ms": r["chain_floor_ms"], "input": r["input"], "longest_walk": r["longest"],
            "bench_index_ms": r["bench_ms"], "bench_index_native_walk_ms": r["bench_native_ms"],
            "bench_index_longest_walk": r["bench_longest"], "bench_index_chain_floor_ms": r["bench_chain_floor_ms"],
        })
    k7, path = con["sa_round"], con["path"]
    entries.append({
        "name": "sa_round", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/sa_round.cu",
        "replaces": "ropebwt3_tpu/construct/sa_jax.py:23-48 (_round, _initial)", "launches": sum(path["sa"].values()),
        "path": f"build -m {CONSTRUCT_M}", "launches_by_pass": path["sa"], "max_abs_err": k7["err"], "ms": k7["ms"],
        "plain_ms": k7["plain"], "bound_ms": k7["bound"], "bound_by": "bytes", "library_ms": k7["sort_ms"],
        "library": "torch.sort of the same keys, every round", "input": k7["input"], "rounds": k7["rounds"],
        "per_round_ms": k7["per_round"], "cumsum_ms": k7["scan_ms"], "k7_total_ms": k7["total_ms"],
        "peak_card_bytes_per_symbol": k7["peak_b_per_sym"],
    })
    k6_keys = ("S", "lanes", "meet_median", "meet_p99", "meet_max", "never_met", "longest_segment",
               "longest_hand_over", "chunked_plain_ms", "native_walk_s")
    for layout in ("dense32", "dense64"):
        r = con[f"merge_rank_{layout}"]
        n = path["merge"].get(layout, 0)
        entries.append({
            "name": f"merge_rank_{layout}", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/merge_rank.cu + occ.cuh",
            "replaces": "ropebwt3_tpu/construct/merge.py:112-123 (window.step)", "launches": n,
            "path": f"build -m {CONSTRUCT_M}" if n else None, "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain"],
            "bound_ms": r["bound"], "bound_by": "bytes", "library_ms": None, "chain_floor_ms": r["chain_floor_ms"],
            "input": r["input"], "longest_walk": r["longest"], "native_merges_s": r["many_native_merges_s"],
            **{k: r[k] for k in k6_keys},
            **({"build_path_merges": con["merges16"]} if layout == "dense32" else {}),
        })
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
