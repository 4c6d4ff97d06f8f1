"""Time K7, the suffix sort's rounds, on the card, for side-by-side runs of two trees.

    python -m ropebwt3_tpu_torch.sa_time [TAG]

Makes bench.py's genomes from its seed (16 x 2 Mbp at 1% divergence) and
their construction batch, each genome then its reverse complement,
0-terminated: n = 64,000,032 symbols, chip_smoke.py's one-batch build.  On
the card it then times, with CUDA events:

- `gsa_bwt` whole (one warm-up, then REPS calls) and its peak card memory a
  symbol beyond the batch (`max_memory_allocated`), beside
  SA_BYTES_PER_SYMBOL; the BWT and SA are held exactly against
  `gsa_bwt_plain` on the card, so a tree whose kernels are wrong fails;
- where the tree has the packed rounds (`live_bits`, `SortSpace`), K7 round
  by round (`timed_rounds`): sa_keys, the sort, torch.sort of the same keys
  (the library's yardstick, outside the round), sa_flags, the cumsum and
  sa_scatter, with each round's live bits and digit passes, and the final
  gather; and the bytes bound of the passes and of the sort; and
  sa_sort's split into its digit passes and its histogram (`sort_split`).

Prints one JSON line tagged TAG, with the card's name and power limit.  Two
trees compare in one call: run each from its own root (`cd TREE && python
-m ropebwt3_tpu_torch.sa_time TAG`; a tree without this file takes a copy of
it and of corpus.py) in turns A, B, B, A.  chip_smoke.py's [construct] runs `timed_rounds`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import corpus
from .construct import sa
from .corpus import SEED

REPS = 3
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's 3.35 TB/s, in bytes a millisecond


def fail(msg: str):
    raise SystemExit(f"sa_time: FAIL: {msg}")


def bench_batch() -> np.ndarray:
    """bench.py's genomes from SEED (corpus.py) as one double-strand
    construction batch."""
    return corpus.construction_batch(corpus.genomes(np.random.default_rng(SEED))[1])


def round_bytes(n: int, key_bytes: int, last: bool) -> dict:
    """Bytes a packed round must move, each input read once and each output
    written once: sa_keys (int32 rank in, keys out), the sort (keys in and
    out, the int32 permutation out: its first pass makes the values, and the
    scatter's bytes count their read), sa_flags (keys in, int32 neq out),
    the cumsum (int32 in and out) and, but in the last round, sa_scatter (sa
    and nr in, rank out)."""
    return dict(keys=n * (4 + key_bytes), sort=n * (2 * key_bytes + 4), flags=n * (key_bytes + 4), scan=8 * n,
                scatter=0 if last else 12 * n)


def timed_rounds(seq_d: torch.Tensor, passes, on_round=None, library: bool = True) -> dict:
    """construct/sa.py's packed rounds pass by pass, with CUDA events around
    each pass, and (library) torch.sort of the same keys timed apart; calls
    on_round(i, rank, sa) after round i's scatter.  Returns the rounds'
    records, the suffix array (int32), the BWT and the final gather's ms."""
    keys, sort, flags, scatter, to_bwt = passes
    n = seq_d.numel()
    rank = sa.initial_ranks(seq_d)
    top = int(rank[-1]) + 5
    space = sa.SortSpace(n, seq_d.device)
    k, rounds = 1, []
    while True:
        shift, bits = sa.live_bits(top)
        key32 = bits <= 32
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        key = keys(rank, k, shift, key32, out=space.key(0, key32))
        ev[1].record()
        ref = key.clone() if library else None  # the library's keys, untimed: the sort overwrites key
        ev[2].record()
        key_s, perm = sort(key, bits, space)
        ev[3].record()
        del key
        spare = space.spare(key_s)
        neq = flags(key_s, None, out=spare[:n])
        ev[4].record()
        nr = torch.cumsum(neq, 0, dtype=torch.int32, out=spare[n:])
        ev[5].record()
        top = int(nr[-1])
        ev[6].record()
        done = top == n - 1
        if not done:
            scatter(perm, nr, rank)
        ev[7].record()
        ev[7].synchronize()
        ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(7)]
        wall = (time.perf_counter() - t0) * 1e3 - ms[1]
        r = dict(k=k, bits=bits, shift=shift, key_bytes=4 if key32 else 8, digit_passes=-(-bits // 8), keys=ms[0],
                 sort=ms[2], flags=ms[3], scan=ms[4], scatter=ms[6], wall=wall, top=top)
        if library:  # once to warm PyTorch's allocator for its outputs and scratch, then timed
            torch.sort(ref)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            lib_s = torch.sort(ref).values
            b.record()
            b.synchronize()
            r["library_sort"] = a.elapsed_time(b)
            # the same multiset sorted: equal where the top bit is clear (torch.sort is signed)
            r["sorted_keys_equal_library"] = bool(torch.equal(lib_s, key_s)) if bits < 8 * r["key_bytes"] else None
            del ref, lib_s
        rounds.append(r)
        if done:
            break
        if on_round is not None:
            on_round(len(rounds) - 1, rank, perm)
        k *= 2
    del rank, space, key_s
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    bwt = to_bwt(seq_d, perm)
    b.record()
    b.synchronize()
    return dict(rounds=rounds, sa=perm, bwt=bwt, bwt_ms=a.elapsed_time(b))


def summary(n: int, t: dict) -> dict:
    """Totals of timed_rounds' records: the passes (keys, flags, scatter and
    the final gather), the sort, the library sort, the cumsum, and the bytes
    bounds of the passes, the sort and K7 in all, beside the parent's
    passes-only figure (int64 passes: keys 16, flags 16, scatter 24 B a
    symbol, the gather 10)."""
    rs = t["rounds"]
    nr = len(rs)
    by = [round_bytes(n, r["key_bytes"], i == nr - 1) for i, r in enumerate(rs)]
    gather = 6 * n  # sa (int32) and seq in, bwt out
    passes_b = sum(b["keys"] + b["flags"] + b["scatter"] for b in by) + gather
    sort_b = sum(b["sort"] for b in by)
    return dict(
        rounds=nr, bits=[r["bits"] for r in rs], digit_passes=sum(r["digit_passes"] for r in rs),
        passes_ms=sum(r["keys"] + r["flags"] + r["scatter"] for r in rs) + t["bwt_ms"],
        sort_ms=sum(r["sort"] for r in rs), library_sort_ms=sum(r.get("library_sort", 0.0) for r in rs),
        scan_ms=sum(r["scan"] for r in rs), total_ms=sum(r["wall"] for r in rs) + t["bwt_ms"],
        passes_bound_ms=passes_b / HBM_BYTES_PER_MS, sort_bound_ms=sort_b / HBM_BYTES_PER_MS,
        k7_bound_ms=(passes_b + sort_b + sum(b["scan"] for b in by)) / HBM_BYTES_PER_MS,
        int64_passes_bound_ms=n * (32 * nr + 24 * (nr - 1) + 10) / HBM_BYTES_PER_MS,
    )


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


def sort_split(n: int, dev) -> dict:
    """sa_sort's phases from its times at 1, 2, ... digit passes: n uniform
    random keys of the batch's widths (52 live bits in 64-bit words, 18 in
    32-bit), each sorted by its low 8, 16, ... bits in one SortSpace; the
    slope is a digit pass, the intercept the histogram, scan and memsets."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    space = sa.SortSpace(n, dev)
    out = {}
    for dt, bits in ((torch.int64, 52), (torch.int32, 18)):
        key = torch.randint(0, 1 << bits, (n,), dtype=dt, device=dev, generator=g)
        out[f"{8 * key.element_size()}-bit words, {bits} live bits"] = {
            b: round(events_ms(lambda b=b: sa.sa_sort_cuda(key, b, space), REPS), 4)
            for b in range(8, min(bits + 8, 8 * key.element_size() + 1), 8)}
    return out


def main(argv: list[str]) -> int:
    tag = argv[0] if argv else "sa_time"
    if not torch.cuda.is_available():
        fail("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    seq_d = torch.from_numpy(bench_batch()).to(dev)
    n = seq_d.numel()
    out = dict(tag=tag, card=card, n=n, sa_bytes_per_symbol=sa.SA_BYTES_PER_SYMBOL)
    bwt, sa_k = sa.gsa_bwt(seq_d, dev)  # warm-up (and the kernels' build)
    del bwt, sa_k
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(REPS):
        bwt, sa_k = sa.gsa_bwt(seq_d, dev)
        del bwt, sa_k
    b.record()
    b.synchronize()
    out.update(gsa_bwt_ms=a.elapsed_time(b) / REPS, gsa_bwt_wall_ms=(time.perf_counter() - t0) * 1e3 / REPS)
    # the peak beyond what was allocated before the call (the batch): the figure build sizes batches by
    out["peak_b_per_sym"] = (torch.cuda.max_memory_allocated(dev) - base + n) / n
    bwt, sa_k = sa.gsa_bwt(seq_d, dev)
    pbwt, psa = sa.gsa_bwt_plain(seq_d)
    if not (torch.equal(bwt, pbwt) and torch.equal(sa_k, psa)):
        fail("gsa_bwt's BWT or SA differs from gsa_bwt_plain's on the card")
    out["bwt_sha_prefix"] = int(bwt[:4096].long().sum())
    del bwt, sa_k, pbwt, psa
    if hasattr(sa, "SortSpace"):
        t = timed_rounds(seq_d, sa.CUDA)
        out["per_round"] = [{k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()} for r in t["rounds"]]
        out.update(summary(n, t), bwt_ms=t["bwt_ms"], launches=dict(sa.SA_LAUNCHES))
        out["sort_split"] = sort_split(n, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
