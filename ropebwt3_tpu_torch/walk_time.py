"""Time K12, `suffix`'s backward search (csrc/walk.cu suffix_walk), on the
card, for side-by-side runs of two trees.

    python -m ropebwt3_tpu_torch.walk_time WORK [TAG]

`suffix`'s batch on chip_smoke's main path: bench.py's genomes' index
(built once in WORK by the port's `build`, smem_time.make_workload) and
its 100,000 short reads followed by the 200 long ones, one launch.  In the
four layouts chip_smoke checks (dense32; dense64 in megablocks of 2^20
symbols; rb32 at choose_S's S; rb64 at S = 256), for each:
  - the kernel's start and last against suffix_plain on the card, exact
    (a digest of them is printed: trees that agree print the same);
  - the kernel timed with CUDA events in four rounds of REPS launches,
    each alone behind a spin kernel (the rows the previous launch read
    stay in L2);
  - the row fetches and 32-B sectors a launch requests in the two designs,
    counted on suffix_plain's steps: `rank6` (each step ranks k and l with
    all six counts: two rows, or for rb two headers and two second rounds,
    and in int64 mode two 48-B megablock rows) and `rank2` (one symbol at
    both ends: one row, header, escape sub-row or record set where both
    ends share it; one 8-B megablock word an end, or one for both); their
    time at 3.35 TB/s were every sector read from HBM;
  - on dense32, the short reads alone and the long reads alone, each
    timed twice;
  - the steps (all reads' and the longest read's), the registers and
    spills `nvcc -Xptxas -v` gives for csrc/walk.cu and, where the tree
    has the query, blocks an SM (rb3c_occupancy_suffix_walk_*).
Prints one JSON line tagged TAG, with the card's name and power limit.  Two
trees compare in one call: run each from its own root (`cd TREE && python
-m ropebwt3_tpu_torch.walk_time WORK TAG`; a tree without this file takes a
copy of it) in turns A, B, B, A.  Without a CUDA card it stops with an error.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time

import torch

from . import cli, corpus, kernels, probe
from .ops import rank, runblock, smem, walk
from .smem_time import digest, make_workload, ptxas

REPS = 10
SPIN_CYCLES = 2_000_000  # ~1 ms at the H100's clock: the launch's host calls run behind it
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's 3.35 TB/s, in bytes a millisecond
DENSE64_SHIFT, RB64_S, RB64_SHIFT = 14, 256, 12  # chip_smoke's int64 layouts


def fail(msg: str):
    raise SystemExit(f"walk_time: FAIL: {msg}")


def layouts(f, dev) -> dict:
    return {"dense32": rank.OccIndex.from_dense(f, dev),
            "dense64": rank.OccIndex.from_dense(f, dev, int64=True, mega_shift=DENSE64_SHIFT),
            "rb32": runblock.RunBlockIndex.from_dense(f, dev, cache=None),
            "rb64": runblock.RunBlockIndex.from_dense(f, dev, S=RB64_S, int64=True, mega_shift=RB64_SHIFT, cache=None)}


class Steps:
    """An index for suffix_plain that keeps the (k, l) of every lock-step
    rank it asks for: each call ranks cat([k, l]) of the live reads, in
    read order."""

    def __init__(self, idx):
        self.idx, self.calls = idx, []

    def __getattr__(self, name):
        return getattr(self.idx, name)

    def rank1a(self, k):
        self.calls.append(k.long().clone())
        return self.idx.rank1a(k)


def step_symbols(calls: list, flat, off, start) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(k, l, c) of every step of every read, and each read's steps, from
    suffix_plain's calls: at lock-step t the live reads are those with more
    than t steps, in read order, each ranking symbol flat[off[r+1] - 1 - t]."""
    rlen = off[1:] - off[:-1]
    steps = rlen - start + (start > 0).long()  # the matched symbols and the step that fails
    ks, ls, cs = [], [], []
    for t, kl in enumerate(calls):
        ids = torch.nonzero(steps > t)[:, 0]
        if 2 * ids.numel() != kl.numel():
            fail(f"lock-step {t}: {kl.numel()} positions for {ids.numel()} live reads")
        ks.append(kl[: ids.numel()])
        ls.append(kl[ids.numel():])
        cs.append(flat[off[ids + 1] - 1 - t].long())
    longest = int(steps.max()) if steps.numel() else 0
    if len(calls) != longest:
        fail(f"{len(calls)} lock-steps for a longest read of {longest}")
    return torch.cat(ks), torch.cat(ls), torch.cat(cs), steps


def traffic(x, k, l) -> dict:
    """Row fetches and 32-B sectors a launch requests, designs rank6 and
    rank2, over the steps' (k, l)."""
    N = k.numel()
    int64 = bool(x.int64)
    if x.layout.startswith("dense"):
        bk, bl = k >> 6, l >> 6
        same = bk == bl
        mega_same = (bk >> x.mega_shift) == (bl >> x.mega_shift)
        f2 = N + int((~same).sum())
        # a 48-B row at 16-B alignment spans two sectors; rank6's megablock
        # row too; rank2's megablock word one
        return {"rank6": dict(fetches=2 * N, sectors=4 * N + (4 * N if int64 else 0)),
                "rank2": dict(fetches=f2, sectors=2 * f2 + (N + int((~mega_same).sum()) if int64 else 0)),
                "steps_in_one_row": int(same.sum())}
    (bk, ok), (bl, ol) = x.block_and_offset(k), x.block_and_offset(l)
    ek, el = x.rows[bk, 6] >= 0, x.rows[bl, 6] >= 0
    W4 = x.S >> 7
    jk, jl = (ok >> 7).clamp(max=W4 - 1), (ol >> 7).clamp(max=W4 - 1)
    same = bk == bl
    # an end: its 32-B header, then an escape sub-row (2 sectors) or the
    # records (4); both ends in one block share the header and the records,
    # and the sub-row when both fall in it
    second = lambda e: torch.where(e, 2, 4)  # noqa: E731
    s6 = N * 2 + second(ek).sum() + second(el).sum()
    shared = 1 + torch.where(ek, 2 * (1 + (jk != jl).long()), 4)
    s2 = torch.where(same, shared, 2 + second(ek) + second(el)).sum()
    f2 = torch.where(same, 2 + (ek & (jk != jl)).long(), 4).sum()
    mega_same = (bk >> x.mega_shift) == (bl >> x.mega_shift)
    return {"rank6": dict(fetches=4 * N, sectors=int(s6) + (4 * N if int64 else 0)),
            "rank2": dict(fetches=int(f2), sectors=int(s2) + (N + int((~mega_same).sum()) if int64 else 0)),
            "steps_in_one_block": int(same.sum()), "steps_in_one_sub_row": int((same & ek & (jk == jl)).sum())}


def occupancy(layout: str) -> dict | None:
    """suffix_walk's resident blocks an SM, local bytes and registers; None
    in a tree without the query."""
    fn = getattr(kernels.lib(), f"rb3c_occupancy_suffix_walk_{layout}", None)
    if fn is None:
        return None
    v = [ctypes.c_int(0) for _ in range(3)]
    err = fn(*(ctypes.byref(x) for x in v))
    if err:
        fail(f"occupancy query: CUDA error {err}")
    return dict(blocks_per_sm=v[0].value, local_bytes=v[1].value, regs=v[2].value)


def timed(launch) -> float:
    """Mean ms of REPS launches, each alone behind a spin kernel."""
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        launch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sum(times) / len(times)


def main(argv: list[str]) -> int:
    if len(argv) not in (1, 2) or not torch.cuda.is_available():
        print(__doc__ if len(argv) not in (1, 2) else "walk_time: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    fmd, reads = make_workload(argv[0])
    f = cli.load_index(fmd)
    kernels.lib()
    flat, off = (torch.from_numpy(a).to(dev) for a in smem.pack_reads(reads))
    out = {"tag": argv[1] if len(argv) == 2 else None, "card": probe.card_line(), "n": f.n, "reads": len(reads),
           "symbols": flat.numel(),
           "ptxas": ptxas("walk.cu", {"suffix_walk": "suffix_walk"})}
    for lay, x in layouts(f, dev).items():
        start, last = torch.empty((2, len(reads)), dtype=torch.int64, device=dev)
        got = walk.suffix_cuda(x, flat, off)
        counted = Steps(x)
        t1 = time.perf_counter()
        want = walk.suffix_plain(counted, flat, off)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"{lay}: suffix_walk differs from suffix_plain")
        k, l, c, steps = step_symbols(counted.calls, flat, off, want[0])
        del counted
        r = out[lay] = dict(digest=digest(*got), plain_ms=plain_ms, steps=int(steps.sum()),
                            longest_steps=int(steps.max()), occupancy=occupancy(lay), **traffic(x, k, l))
        for design in ("rank6", "rank2"):
            r[design]["hbm_ms"] = r[design]["sectors"] * 32 / HBM_BYTES_PER_MS
        del k, l, c
        r["ms"] = [timed(lambda: walk.launch_suffix(x, flat, off, start, last)) for _ in range(4)]
        if not (torch.equal(start, want[0]) and torch.equal(last, want[1])):
            fail(f"{lay}: the timed launches' output differs from suffix_plain")
        if lay == "dense32":  # the short reads alone and the long ones alone
            for part, sub in (("short", reads[: corpus.N_READS]), ("long", reads[corpus.N_READS:])):
                pf, po = (torch.from_numpy(a).to(dev) for a in smem.pack_reads(sub))
                ps, pl = torch.empty((2, len(sub)), dtype=torch.int64, device=dev)
                r[f"{part}_reads_ms"] = [timed(lambda: walk.launch_suffix(x, pf, po, ps, pl)) for _ in range(2)]
        print(f"walk_time {lay}: " + json.dumps(r), file=sys.stderr, flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
