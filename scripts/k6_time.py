#!/usr/bin/env python3
"""Times the port's merge-rank kernel (K6, ropebwt3_tpu_torch/csrc/merge_rank.cu)
on the merges that chip_smoke.py's [construct] phase runs: bench.py's genomes
with `build -m 16M` (three merges of 8 sequences of 2 M steps) and the first
merge of its 100,000 short reads with `-m 12M`.  One JSON line per merge.

Run it from the root of the tree whose package it should time, on a CUDA
card, so that two trees (a change and its parent) can be timed in one call:

    cd <tree> && PYTHONPATH=. python <this repo>/scripts/k6_time.py --work DIR --tag NAME

With --fmd IDX (chip_smoke.py's bench index, .bench/torch_smoke/idx.fmd),
K5's walk (ropebwt3_tpu_torch/csrc/ssa_gen.cu: `ssa_ops.launch_walk`) is
timed too, pass by pass, at -s 8 and the derived stride on dense32 rows.

A tree with segments (`merge.segments`) is timed at the derived stride, as
the one-thread-per-sequence walk (a stride above n2) and at the strides of
--sweep; a tree without them (the kernel of one thread per sequence, ins
written over the records) as that kernel.  `ins` is the first 16 hex digits
of the SHA-256 of each merge's ins: equal digests across trees mean equal
ins.  The data are chip_smoke.py's (bench.py:78-115, the same seed and
generator), written once under --work.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess

import numpy as np

# chip_smoke.py's corpus: bench.py:78-85
N_GENOMES, GENOME_LEN, DIVERGENCE = 16, 2_000_000, 0.01
N_READS, READ_LEN, READ_ERR = 100_000, 150, 0.01
SEED = 20260817
ALPHA = np.frombuffer(b"$ACGTN", dtype=np.uint8)


def make_data(work: str) -> tuple[str, str]:
    """genomes.fa and reads.fa (the short reads) under `work`, drawn as
    chip_smoke.make_corpus draws them."""
    fa, reads = os.path.join(work, "genomes.fa"), os.path.join(work, "reads.fa")
    if os.path.exists(reads):
        return fa, reads
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(SEED)
    base = rng.integers(1, 5, GENOME_LEN).astype(np.uint8)
    with open(fa + ".tmp", "wb") as fh:
        for g in range(N_GENOMES):
            s = base.copy()
            mut = rng.random(GENOME_LEN) < DIVERGENCE
            s[mut] = rng.integers(1, 5, int(mut.sum()))
            fh.write(b">g%d\n" % g + ALPHA[s].tobytes() + b"\n")
    starts = rng.integers(0, GENOME_LEN - READ_LEN, N_READS)
    short = base[starts[:, None] + np.arange(READ_LEN)]
    short = np.where(rng.random(short.shape) < READ_ERR, rng.integers(1, 5, short.shape), short).astype(np.uint8)
    with open(reads + ".tmp", "wb") as fh:
        fh.write(b"".join(b">r%d\n" % i + ALPHA[r].tobytes() + b"\n" for i, r in enumerate(short)))
    os.replace(fa + ".tmp", fa)
    os.replace(reads + ".tmp", reads)
    return fa, reads


def batches(fa: str, batch_size: int) -> list[np.ndarray]:
    """The construction batches of `build -m batch_size` (both strands)."""
    from ropebwt3_tpu_torch import seqio

    return [seqio.batch_nt6_flat(fl, of)[1] for _, fl, of in seqio.iter_flat_batches(fa, False, batch_size // 2)]


def events_ms(fn, reps: int) -> float:
    """Mean card milliseconds of fn() over `reps` calls, each given its own
    arguments by fn(i)."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for i in range(reps):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def time_merge(merge, idx, rec, m2: int, lane_reps: int, sweep: list[int]) -> tuple[dict, object]:
    """K6's times on one merge, and ins."""
    import torch

    n2 = rec.numel()
    if not hasattr(merge, "segments"):  # one thread per sequence, ins over the records
        recs = [rec.clone() for _ in range(lane_reps)]
        ms = events_ms(lambda i: merge.launch_merge_rank(idx, recs[i], m2), lane_reps)
        return {"lane_walk_ms": ms}, recs[0]

    def at(S: int, reps: int) -> tuple[float, object]:
        ins = [torch.empty_like(rec) for _ in range(reps)]
        return events_ms(lambda i: merge.launch_merge_rank(idx, rec, ins[i], m2, S), reps), ins[0]

    S = merge.stride(n2, idx.device)
    ms, ins = at(S, 5)
    lanes, ins_l = at(1 << n2.bit_length(), lane_reps)
    if not torch.equal(ins, ins_l):
        raise SystemExit(f"k6_time: ins at S = {S} differs from the lane walk's")
    out = {"S": S, "ms": ms, "lane_walk_ms": lanes}
    out["sweep_ms"] = {T: at(T, 3)[0] for T in sweep}
    return out, ins


def run_input(tag: str, what: str, fa: str, batch_size: int, n_merges: int, lane_reps: int, sweep: list[int],
              card: str) -> None:
    import torch

    from ropebwt3_tpu_torch.construct import merge, sa
    from ropebwt3_tpu_torch.ops.rank import OccIndex

    bwt = None
    for i, seq in enumerate(batches(fa, batch_size)[: n_merges + 1]):
        b2 = sa.gsa_bwt(seq, "cuda")[0]
        if bwt is None:
            bwt = b2
            continue
        idx = OccIndex.from_bwt(bwt)
        acc2, rec = merge.lf2_packed(b2)
        m2 = int(acc2[1])
        res, ins = time_merge(merge, idx, rec, m2, lane_reps, sweep)
        digest = hashlib.sha256(ins.cpu().numpy().tobytes()).hexdigest()[:16]
        print(json.dumps({"tree": tag, "input": what, "merge": i, "n1": bwt.numel(), "n2": b2.numel(), "m2": m2,
                          **res, "ins": digest, "card": card}), flush=True)
        bwt = merge.merge_apply(bwt, b2, ins)
        del idx, rec, ins


def time_walk(tag: str, fmd: str, reps: int, card: str) -> None:
    """K5's three passes on the index `fmd` (CUDA events between them, the
    mean of `reps` walks), and a digest of the arrays."""
    import torch

    from ropebwt3_tpu_torch import cli, ssa_ops
    from ropebwt3_tpu_torch.ops.rank import OccIndex

    f = cli.load_index(fmd)
    x = OccIndex.from_dense(f, "cuda")
    m, ss = int(f.acc[1]), 8
    S = ssa_ops.walk_stride(f.n, m, x.device)
    out = ssa_ops.launch_walk(x, m, ss, S)
    passes = np.zeros(3)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ssa_ops.launch_walk(x, m, ss, S, marks=ev)
        torch.cuda.synchronize()
        passes += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    digest = hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in out[:4])).hexdigest()[:16]
    print(json.dumps({"tree": tag, "input": "K5 walk", "n": f.n, "m": m, "S": S, "pass_ms": (passes / reps).tolist(),
                      "ms": float(passes.sum() / reps), "arrays": digest, "card": card}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", required=True, help="directory of the data (made once, shared by the trees)")
    ap.add_argument("--tag", required=True, help="the tree's name in the output")
    ap.add_argument("--sweep", default="32,64,128,256,1024", help="strides timed besides the derived one")
    ap.add_argument("--fmd", help="also time K5's walk on this index")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k6_time: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    sweep = [int(x) for x in args.sweep.split(",") if x]
    fa, reads = make_data(args.work)
    run_input(args.tag, "genomes -m 16M", fa, 16_000_000, 3, 1, sweep, card)
    run_input(args.tag, "short reads -m 12M", reads, 12_000_000, 1, 5, sweep, card)
    if args.fmd:
        time_walk(args.tag, args.fmd, 5, card)


if __name__ == "__main__":
    main()
