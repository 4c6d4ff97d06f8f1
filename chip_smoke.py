#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (ropebwt3_tpu_torch).

Drives the port's entry points on one CUDA card: `mem -l31` on the workload
of bench.py (16 x 2 Mbp genomes at 1% divergence, indexed double strand:
~64 M symbols, ~48 MB of dense occ rows; 100,000 x 150 bp reads at 1% error)
plus 200 reads of 5-20 kb that overflow the MEM buffer, once on the default
rows (the main path) and once with `--occ=rb`; `ssa` on bench.py's index and
two more; and the row-gather probes.  Every rank and SMEM kernel runs on each
of the four occ layouts (dense32, dense64, rb32, rb64), ssa_gen on both dense
ones.  Phases:

  build     compile the kernels from csrc/ (nvcc, sm_90a, one nvcc per source)
  corpus    generate the data from a seed; build the FMD with the repo's own
            index build (cached under .bench/torch_smoke/)
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
  smem      smem_tg of each layout vs smem_tg_plain on the card, 4,096 reads,
            exact; then each layout's rows on the main path's batch must equal
            the dense32 kernel's
  probe     the three probe kernels (csrc/probe.cu) vs their plain versions
            on the card, exact: shared-memory capacity at the opt-in limit
            (one 512-B row past it must be refused), the shared-memory and
            device-memory row gathers in every mode, 48-B and 512-B rows;
            then the probe path, `python -m ropebwt3_tpu_torch.probe`'s main,
            with launch counts reset before and read after: the sweep
  ssa       ssa_gen on three indexes: bench.py's (m = 32, dense32 and dense64
            with megablocks of 2^20 symbols), one of the 100,000 short reads
            (m = 200,000, cached under .bench/torch_smoke/many/) and the CPU
            tests' corpus; the SSA byte-equal to ssa_gen_native, the kernel's
            arrays equal to ssa_gen_plain on the card (not run on bench.py's
            index: ~2 M lock-step trips); then `ssa` through
            ropebwt3_tpu_torch.cli.main on each index (bench.py's is the ssa
            path: counts reset before, read after) and once as `python -m
            ropebwt3_tpu_torch ssa`, byte-equal to `python -m ropebwt3_tpu ssa`
  mem       the main path: `mem -l31` through ropebwt3_tpu_torch.cli.main with
            launch counts reset before and read after; its BED must equal
            `python -m ropebwt3_tpu mem --engine=native` byte for byte
  mem-rb    the second path: `mem -l31 --occ=rb`, counts reset before and
            read after; BED byte-equal to native, >= 1 rb32 smem_tg launch

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
N_SMEM = 4096  # smem phase reads
MAX_MEMS = 64  # BatchedSmemTG's MEM buffer rows per read
SUBPROCESS_TIMEOUT = 600
LAYOUTS = ("dense32", "dense64", "rb32", "rb64")
# bench-index int64 layouts: megablocks of 2^20 symbols; rb64 at the smallest
# S, where run-coded blocks remain (choose_S's S makes every block an escape)
DENSE64_SHIFT, RB64_S, RB64_SHIFT = 14, 256, 12
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


def check_occ_kernels(rank, idx, k, ik, c, back, plain_reps: int) -> dict:
    """occ_rank1a and occ_extend_c of idx's layout vs the plain versions on
    the card; fails unless exact.  Returns errors and times (ms)."""
    got = rank.rank1a_cuda(idx, k)
    want = rank.rank1a(idx, k).to(idx.dtype)
    r_err = max_abs(got, want)
    ik = ik.to(idx.dtype)
    e_got = rank.extend_c_cuda(idx, ik, c, back)
    e_want = rank.extend_c(idx, ik, c, back).to(idx.dtype)
    e_err = max_abs(e_got, e_want)
    if r_err or e_err:
        fail(f"{idx.layout}: occ_rank1a off by {r_err}, occ_extend_c off by {e_err} against the plain versions")
    return dict(
        got=got, rank_err=r_err, ext_err=e_err,
        rank_ms=cuda_ms(lambda: rank.rank1a_cuda(idx, k), 10), rank_plain=cuda_ms(lambda: rank.rank1a(idx, k), plain_reps),
        ext_ms=cuda_ms(lambda: rank.extend_c_cuda(idx, ik, c, back), 10),
        ext_plain=cuda_ms(lambda: rank.extend_c(idx, ik, c, back), plain_reps),
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
    Times at the first shape, `dep`."""
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
        plain=cuda_ms(lambda: probe.smem_capacity_plain(top, dev), 10),
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
                    r = dict(ms=probe.queued_ms([lambda: probe.launch_gather(fn, tab, idx0, PROBE_ITERS, "dep")] * 10),
                             plain=cuda_ms(lambda: probe.gather_plain(tab, idx0, PROBE_ITERS, "dep"), 3),
                             input=f"({rows}, {cols}) int32 table, {q} lanes x {PROBE_ITERS} dep steps")
            del tab
        if err:
            fail(f"{name} differs from gather_plain by up to {err}")
        res[name] = dict(r, err=err, replaces=replaces)
        say(f"[probe] {name}: exact in every mode ({', '.join(probe.MODES)}) on "
            + " and ".join(f"({rows}, {cols})" for rows, cols in shapes)
            + f" int32 tables, {PROBE_Q} and {PROBE_Q - 97} lanes x {PROBE_ITERS} steps; {r['input']}: "
            f"{r['ms']:.4f} ms vs plain {r['plain']:.4f} ms")
    return res


def walk_err(got, want) -> int:
    """Largest difference between the kernel's and the plain version's walk
    arrays (ssa_l only where a lane hit)."""
    filled = want[1] >= 0
    return max(max_abs(got[1], want[1]), max_abs(got[0][filled], want[0][filled]), max_abs(got[2], want[2]),
               max_abs(got[3], want[3]))


def check_ssa(cli, ssa_ops, probe, rank, dev, card: str, f, fmd: str, idxs: dict, reads) -> tuple[dict, dict]:
    """ssa_gen of both dense layouts on bench.py's index, the many-sequence
    index and the CPU tests' corpus: byte-equal to ssa_gen_native, arrays
    equal to ssa_gen_plain on the card where it runs; then `ssa` through the
    CLI on each, byte-equal to `python -m ropebwt3_tpu ssa`.  Returns the
    per-layout records and the ssa path's launch counts (bench.py's index)."""
    import torch

    from ropebwt3_tpu.formats.ssa import write_ssa_bytes
    from ropebwt3_tpu.ssa_ops import ssa_gen_native

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
    for name, xf, x_fmd, d32, d64, ss in inputs:
        m = int(xf.acc[1])
        t0 = time.perf_counter()
        want = write_ssa_bytes(ssa_gen_native(xf, ss))
        native_ms = (time.perf_counter() - t0) * 1e3
        for lay, x in (("dense32", d32), ("dense64", d64)):
            if write_ssa_bytes(ssa_ops.ssa_gen(xf, ss, occ=x)) != want:
                fail(f"ssa_gen {lay} on the {name} index differs from ssa_gen_native")
            ms = probe.queued_ms([lambda: ssa_ops.launch_walk(x, m, ss)] * (1 if name == "bench" else 5))
            r = res[lay]
            if name == "bench":
                r.update(bench_ms=ms, bench_native_ms=native_ms)
                plain_note = f"plain not run (lanes of ~{int((xf.acc[6] - m) // m)} steps: as many lock-step trips)"
            else:
                got = ssa_ops.ssa_gen_cuda(x, m, ss)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                want_arr = ssa_ops.ssa_gen_plain(x, m, ss)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t1) * 1e3
                err = walk_err(got, want_arr)
                if err:
                    fail(f"ssa_gen {lay} on the {name} index: arrays differ from ssa_gen_plain by up to {err}")
                r["err"] = max(r.get("err", 0), err)
                if name == "many":
                    r.update(ms=ms, plain=plain_ms, input=f"many-sequence index: {N_READS} x {READ_LEN} bp reads, "
                             f"double strand, n={xf.n}, m={m}, -s {ss}")
                plain_note = f"plain on the card {plain_ms:.4f} ms, arrays exact"
            say(f"[ssa] {name} {lay}: SSA (-s {ss}) byte-equal to ssa_gen_native; kernel {ms:.4f} ms vs native "
                f"{native_ms:.4f} ms wall ({os.cpu_count()} host cores); {plain_note} ({card})")

    path = None
    for name, xf, x_fmd, d32, d64, ss in inputs:
        opts = [] if ss == SSA_SHIFT else ["-s", str(ss)]
        ref_fn, port_fn = os.path.join(WORK, f"ssa_{name}_ref.ssa"), os.path.join(WORK, f"ssa_{name}_port.ssa")
        ref_s, _ = run([sys.executable, "-m", "ropebwt3_tpu", "ssa", *opts, "-o", ref_fn, x_fmd])
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
    if open(sub_fn, "rb").read() != open(os.path.join(WORK, "ssa_many_ref.ssa"), "rb").read():
        fail("`python -m ropebwt3_tpu_torch ssa` on the many index differs from `python -m ropebwt3_tpu ssa`")
    say(f"[ssa] `python -m ropebwt3_tpu_torch ssa` on the many index: byte-equal, {m_sub.group(1)} dense32 launch, "
        f"{sub_s:.3f} s one-shot ({card})")
    return res, path


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
    counters = (rank.rank1a_cuda, rank.extend_c_cuda, smem.smem_tg_cuda)

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

    # ---- smem ----------------------------------------------------------------
    args = dict(min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS)
    sflat, soff = (torch.from_numpy(a).to(dev) for a in smem.pack_reads(reads[:N_SMEM]))
    aflat, aoff = (torch.from_numpy(a).to(dev) for a in smem.pack_reads(reads))
    smem_res, ref = {}, None
    for name, x in idxs.items():
        mk, nk = smem.smem_tg_cuda(x, sflat, soff, **args)
        mp, npl = smem.smem_tg_plain(x, sflat, soff, **args)
        if not torch.equal(nk, npl):
            fail(f"smem_tg {name}: n_mem differs from smem_tg_plain")
        valid = torch.arange(MAX_MEMS, device=dev)[None, :] < nk.clamp(max=MAX_MEMS)[:, None]
        err = max_abs(mk[valid], mp[valid])
        if err != 0:
            fail(f"smem_tg {name}: rows differ from smem_tg_plain by up to {err}")
        ms = cuda_ms(lambda: smem.smem_tg_cuda(x, sflat, soff, **args), 10)
        plain = wall_ms(lambda: smem.smem_tg_plain(x, sflat, soff, **args))
        mf, nf = smem.smem_tg_cuda(x, aflat, aoff, **args)
        if ref is None:
            ref = (mf.long(), nf)
        else:
            fvalid = torch.arange(MAX_MEMS, device=dev)[None, :] < nf.clamp(max=MAX_MEMS)[:, None]
            if not (torch.equal(nf, ref[1]) and torch.equal(mf.long()[fvalid], ref[0][fvalid])):
                fail(f"smem_tg {name}: rows on the main path's batch differ from the dense32 kernel's")
        full_ms = cuda_ms(lambda: smem.smem_tg_cuda(x, aflat, aoff, **args), 3)
        short_ms = cuda_ms(lambda: smem.smem_tg_cuda(x, aflat[: N_READS * READ_LEN], aoff[: N_READS + 1], **args), 3)
        smem_res[name] = dict(err=err, ms=ms, plain=plain, full_ms=full_ms, short_ms=short_ms)
        say(
            f"[smem] {name}: exact on {N_SMEM} reads ({int(nk.sum())} MEMs); smem_tg {ms:.4f} ms "
            f"({N_SMEM / ms * 1e3:.1f} reads/s) vs plain {plain:.4f} ms ({N_SMEM / plain * 1e3:.1f} reads/s); main path's "
            f"batch ({len(reads)} reads, rows equal to dense32's) {full_ms:.4f} ms ({len(reads) / full_ms * 1e3:.1f} reads/s), "
            f"its {N_READS} short reads alone {short_ms:.4f} ms ({N_READS / short_ms * 1e3:.1f} reads/s) ({card})"
        )
        del mk, mp, mf
    del aflat, aoff, ref

    # ---- probe ---------------------------------------------------------------
    probe_res = check_probes(probe, dev)
    counted = (probe.smem_capacity_cuda, probe.smem_gather_cuda, probe.hbm_gather_cuda)
    for fn in counted:
        fn.launches.clear()
    t0 = time.perf_counter()
    if probe.main([]) != 0:
        fail("python -m ropebwt3_tpu_torch.probe failed")
    for fn, name in zip(counted, ("probe_smem_capacity", "probe_smem_gather", "probe_hbm_gather")):
        probe_res[name]["launches"] = sum(fn.launches.values())
        if probe_res[name]["launches"] < 1:
            fail(f"the probe path launched no {name}")
    say(f"[probe] path `python -m ropebwt3_tpu_torch.probe` in {time.perf_counter() - t0:.3f} s; launches "
        + ", ".join(f"{k} {v['launches']}" for k, v in probe_res.items()))

    # ---- ssa -----------------------------------------------------------------
    ssa_res, ssa_path = check_ssa(cli, ssa_ops, probe, rank, dev, card, f, fmd, idxs, reads)

    # ---- mem: the main path, then --occ=rb --------------------------------------
    # the reference output first, untimed: that run also builds the native
    # host library (g++) and the index's packed-row sidecar, one-time costs
    # that the port's host reruns would otherwise pay inside its timing
    native_bed = os.path.join(WORK, "native.bed")
    native_cmd = [sys.executable, "-m", "ropebwt3_tpu", "mem", "--engine=native", f"-l{MIN_LEN}", fmd, reads_fa]
    with open(native_bed, "wb") as out:
        run(native_cmd, stdout=out)
    want = open(native_bed, "rb").read()
    n_all = len(reads)
    paths = {}
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
        launches = {name: dict(counted.launches) for name, counted in zip(("occ_rank1a", "occ_extend_c", "smem_tg"), counters)}
        sys.stderr.write(err.getvalue())
        if rc != 0:
            fail(f"ropebwt3_tpu_torch {' '.join(argv)} exited {rc}")
        if launches["smem_tg"].get(layout, 0) < 1:
            fail(f"{path}: no {layout} smem_tg launch ({launches})")
        m = re.search(rf"(\d+) smem_tg launches \({layout}\); (\d+) reads rerun", err.getvalue())
        if m is None:
            fail(f"{path}: the port's mem did not report its engine counts for {layout}")
        got_bed = open(port_bed, "rb").read()
        if got_bed != want:
            fail(f"port {path} BED differs from --engine=native: {first_diff(got_bed, want)}")
        n_lines = want.count(b"\n")
        if n_lines < N_READS:
            fail(f"only {n_lines} BED lines for {N_READS + N_LONG} reads")
        paths[path] = dict(launches=launches, layout=layout, port_s=port_s)
        say(
            f"[{path}] `{' '.join(argv[:-2])}`: BED byte-equal to --engine=native ({n_lines} lines); launches {launches}; "
            f"n_rerun {m.group(2)} (of {N_LONG} long reads); port in-process {port_s:.3f} s ({n_all / port_s:.1f} reads/s)"
        )

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
        "[mem-rb] rows on the card and smem_tg on the main path's batch: "
        + "; ".join(f"{name} {x.nbytes} B, {smem_res[name]['full_ms']:.4f} ms" for name, x in idxs.items())
        + f" ({card})"
    )

    def path_launches(kernel: str, layout: str) -> tuple[int, str | None]:
        for path, p in paths.items():
            if p["layout"] == layout and kernel == "smem_tg":
                return p["launches"][kernel].get(layout, 0), path
        return sum(p["launches"][kernel].get(layout, 0) for p in paths.values()), None

    entries = []
    for name in LAYOUTS:
        n, path = path_launches("smem_tg", name)
        s = smem_res[name]
        entries.append({
            "name": f"smem_tg_{name}", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/smem_tg.cu",
            "replaces": "ropebwt3_tpu/ops/smem_pallas.py:91", "launches": n, "path": path, "max_abs_err": s["err"],
            "ms": s["ms"], "plain_ms": s["plain"], "input": f"{N_SMEM} x {READ_LEN} bp reads",
            "main_path_batch_ms": s["full_ms"],
        })
    for name in LAYOUTS:
        o = occ_res[name]
        src = "ropebwt3_tpu_torch/csrc/occ_rank.cu + " + ("rb.cuh" if name.startswith("rb") else "occ.cuh")
        rep = "ropebwt3_tpu/ops/runblock.py:154" if name.startswith("rb") else "ropebwt3_tpu/ops/rank.py:233"
        for kern, err, ms, plain in (("occ_rank1a", o["rank_err"], o["rank_ms"], o["rank_plain"]),
                                     ("occ_extend_c", o["ext_err"], o["ext_ms"], o["ext_plain"])):
            n, path = path_launches(kern, name)
            e = {"name": f"{kern}_{name}", "route": "cuda", "source": src, "replaces": rep, "launches": n, "path": path,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain, "input": f"{N_CHECK} on the bench index"}
            if name == "rb64":
                key = "rank" if kern == "occ_rank1a" else "ext"
                e.update({"rank64_ms": r64[f"{key}_ms"], "rank64_plain_ms": r64[f"{key}_plain"],
                          "rank64_max_abs_err": r64[f"{key}_err"], "rank64_vs_run_length_rank_err": ind_err})
            entries.append(e)
    for name in ("probe_smem_capacity", "probe_smem_gather", "probe_hbm_gather"):
        r = probe_res[name]
        entries.append({"name": name, "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/probe.cu", "replaces": r["replaces"],
                        "launches": r["launches"], "path": "probe", "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "input": r["input"]})
    for name in ("dense32", "dense64"):
        r = ssa_res[name]
        entries.append({
            "name": f"ssa_gen_{name}", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/ssa_gen.cu + occ.cuh",
            "replaces": "ropebwt3_tpu/ssa_ops.py:127", "launches": ssa_path["launches"].get(name, 0),
            "path": "ssa" if ssa_path["launches"].get(name, 0) else None, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain"], "input": r["input"], "bench_index_ms": r["bench_ms"],
            "bench_index_native_ms": r["bench_native_ms"],
        })
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
