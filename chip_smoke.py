#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (ropebwt3_tpu_torch).

Drives `mem -l31` once on one CUDA card through the port's CLI, on the
workload of bench.py (16 x 2 Mbp genomes at 1% divergence, indexed double
strand: ~64 M symbols, ~48 MB of occ rows; 100,000 x 150 bp reads at 1%
error) plus 200 reads of 5-20 kb that overflow the MEM buffer.  Phases:

  build   compile the kernels from csrc/ (nvcc, sm_90a)
  corpus  generate the data from a seed; build the FMD with the repo's own
          index build (cached under .bench/torch_smoke/)
  rank    occ_rank1a / occ_extend_c kernels vs the plain PyTorch rank1a /
          extend_c on the card: 1 M positions (k = 0 and n included), 1 M
          intervals; exact
  smem    smem_tg kernel vs smem_tg_plain on the card, 4,096 reads; exact
  mem     the main path: `mem -l31` through ropebwt3_tpu_torch.cli.main with
          launch counts reset before and read after; its BED must equal
          `python -m ropebwt3_tpu mem --engine=native` byte for byte

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
N_CHECK = 1 << 20  # rank phase positions and intervals
N_SMEM = 4096  # smem phase reads
MAX_MEMS = 64  # BatchedSmemTG's MEM buffer rows per read
SUBPROCESS_TIMEOUT = 600


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


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "ropebwt3_tpu_torch")) or not os.path.isdir(os.path.join(ROOT, "ropebwt3_tpu")):
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    import ropebwt3_tpu_torch
    from ropebwt3_tpu_torch import cli, kernels
    from ropebwt3_tpu_torch.ops import rank, smem

    if os.path.dirname(os.path.abspath(ropebwt3_tpu_torch.__file__)) != os.path.join(ROOT, "ropebwt3_tpu_torch"):
        fail(f"imported ropebwt3_tpu_torch from {ropebwt3_tpu_torch.__file__}, not from this checkout")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

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

    # ---- rank ----------------------------------------------------------------
    rng = np.random.default_rng(SEED + 1)
    k = torch.from_numpy(np.concatenate([[0, f.n], rng.integers(0, f.n + 1, N_CHECK - 2)]).astype(np.int64)).to(dev)
    got = rank.rank1a_cuda(idx, k)
    if not torch.equal(got, rank.rank1a(idx, k).int()):
        fail("occ_rank1a differs from the plain rank1a")
    if got[1].tolist() != (f.acc[1:] - f.acc[:-1]).tolist():
        fail("rank1a(n) is not the symbol totals")
    lo = rng.integers(0, f.n + 1, N_CHECK)
    s = np.minimum(rng.integers(0, f.n + 1 - lo), rng.integers(0, 100_000, N_CHECK))
    hi = rng.integers(0, f.n + 1 - s)
    ik = torch.from_numpy(np.stack([lo, hi, s], axis=1).astype(np.int32)).to(dev)
    c = torch.from_numpy(rng.integers(0, 6, N_CHECK).astype(np.int32)).to(dev)
    back = torch.from_numpy(rng.random(N_CHECK) < 0.5).to(dev)
    if not torch.equal(rank.extend_c_cuda(idx, ik, c, back), rank.extend_c(idx, ik, c, back).int()):
        fail("occ_extend_c differs from the plain extend_c")
    rank_ms = cuda_ms(lambda: rank.rank1a_cuda(idx, k), 10)
    rank_plain = cuda_ms(lambda: rank.rank1a(idx, k), 3)
    ext_ms = cuda_ms(lambda: rank.extend_c_cuda(idx, ik, c, back), 10)
    ext_plain = cuda_ms(lambda: rank.extend_c(idx, ik, c, back), 3)
    say(
        f"[rank] exact on {N_CHECK} positions and {N_CHECK} intervals; occ_rank1a {rank_ms:.4f} ms vs plain "
        f"{rank_plain:.4f} ms; occ_extend_c {ext_ms:.4f} ms vs plain {ext_plain:.4f} ms ({card})"
    )

    # ---- smem ----------------------------------------------------------------
    args = dict(min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS)
    sflat, soff = (torch.from_numpy(a).to(dev) for a in smem.pack_reads(reads[:N_SMEM]))
    mk, nk = smem.smem_tg_cuda(idx, sflat, soff, **args)
    mp, npl = smem.smem_tg_plain(idx, sflat, soff, **args)
    if not torch.equal(nk, npl):
        fail("smem_tg n_mem differs from smem_tg_plain")
    valid = torch.arange(MAX_MEMS, device=dev)[None, :] < nk.clamp(max=MAX_MEMS)[:, None]
    smem_err = int((mk[valid].long() - mp[valid].long()).abs().max()) if bool(valid.any()) else 0
    if smem_err != 0:
        fail(f"smem_tg rows differ from smem_tg_plain by up to {smem_err}")
    smem_ms = cuda_ms(lambda: smem.smem_tg_cuda(idx, sflat, soff, **args), 10)
    smem_plain = wall_ms(lambda: smem.smem_tg_plain(idx, sflat, soff, **args))
    say(
        f"[smem] exact on {N_SMEM} reads ({int(nk.sum())} MEMs); smem_tg {smem_ms:.4f} ms "
        f"({N_SMEM / smem_ms * 1e3:.1f} reads/s) vs plain {smem_plain:.4f} ms ({N_SMEM / smem_plain * 1e3:.1f} reads/s) ({card})"
    )
    aflat, aoff = (torch.from_numpy(a).to(dev) for a in smem.pack_reads(reads))
    full_ms = cuda_ms(lambda: smem.smem_tg_cuda(idx, aflat, aoff, **args), 3)
    short_ms = cuda_ms(lambda: smem.smem_tg_cuda(idx, aflat[: N_READS * READ_LEN], aoff[: N_READS + 1], **args), 3)
    say(
        f"[smem] smem_tg on the main path's batch ({len(reads)} reads): {full_ms:.4f} ms "
        f"({len(reads) / full_ms * 1e3:.1f} reads/s); the {N_READS} short reads alone: {short_ms:.4f} ms "
        f"({N_READS / short_ms * 1e3:.1f} reads/s) ({card})"
    )
    del mk, mp, aflat, aoff

    # ---- mem: the main path --------------------------------------------------
    # the reference output first, untimed: that run also builds the native
    # host library (g++) and the index's packed-row sidecar, one-time costs
    # that the port's host reruns would otherwise pay inside its timing
    native_bed = os.path.join(WORK, "native.bed")
    native_cmd = [sys.executable, "-m", "ropebwt3_tpu", "mem", "--engine=native", f"-l{MIN_LEN}", fmd, reads_fa]
    with open(native_bed, "wb") as out:
        run(native_cmd, stdout=out)
    argv = ["mem", f"-l{MIN_LEN}", fmd, reads_fa]
    port_bed = os.path.join(WORK, "port.bed")
    for counted in (rank.rank1a_cuda, rank.extend_c_cuda, smem.smem_tg_cuda):
        counted.launches = 0
    err = io.StringIO()
    t0 = time.perf_counter()
    with open(port_bed, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    port_s = time.perf_counter() - t0
    launches = smem.smem_tg_cuda.launches
    sys.stderr.write(err.getvalue())
    if rc != 0:
        fail(f"ropebwt3_tpu_torch mem exited {rc}")
    if launches < 1:
        fail("the main path launched no smem_tg kernel")
    m = re.search(r"(\d+) smem_tg launches; (\d+) reads rerun", err.getvalue())
    if m is None:
        fail("the port's mem did not report its engine counts")
    n_rerun = int(m.group(2))

    sub_bed = os.path.join(WORK, "port_subprocess.bed")
    with open(sub_bed, "wb") as out:
        sub_s, sub_err = run([sys.executable, "-m", "ropebwt3_tpu_torch"] + argv, stdout=out)
    say("[mem] `python -m ropebwt3_tpu_torch` stderr: " + " | ".join(sub_err.strip().splitlines()))
    native_s, _ = run(native_cmd)
    want = open(native_bed, "rb").read()
    for name, path in (("in-process", port_bed), ("subprocess", sub_bed)):
        got_bed = open(path, "rb").read()
        if got_bed != want:
            fail(f"port mem ({name}) BED differs from --engine=native: {first_diff(got_bed, want)}")
    n_lines = want.count(b"\n")
    if n_lines < N_READS:
        fail(f"only {n_lines} BED lines for {N_READS + N_LONG} reads")
    n_all = len(reads)
    say(
        f"[mem] BED byte-equal to --engine=native ({n_lines} lines); smem_tg launches {launches}; n_rerun {n_rerun} "
        f"(of {N_LONG} long reads)"
    )
    say(
        f"[mem] end to end: port in-process {port_s:.3f} s ({n_all / port_s:.1f} reads/s), "
        f"port `python -m ropebwt3_tpu_torch` {sub_s:.3f} s ({n_all / sub_s:.1f} reads/s), "
        f"native `python -m ropebwt3_tpu --engine=native` {native_s:.3f} s ({n_all / native_s:.1f} reads/s, "
        f"{os.cpu_count()} host cores) ({card})"
    )

    say(json.dumps({"kernels": [{
        "name": "smem_tg", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/smem_tg.cu",
        "replaces": "ropebwt3_tpu/ops/smem_pallas.py:91", "launches": launches, "max_abs_err": smem_err,
        "ms": smem_ms, "plain_ms": smem_plain, "input": f"{N_SMEM} x {READ_LEN} bp reads",
        "main_path_batch_ms": full_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
