"""Time `kount`'s level ranks on the card, level by level, on kount's own
frontiers.

    python -m ropebwt3_tpu_torch.kount_time IDX.fmd [-k 11] [-m 8] [TAG]

Expands kount's trie on the index's dense rows (the width from n, as
`kount` takes them; ops/kount.py kount_levels) and keeps every level's
frontier as it is ranked: symbol-major, the order `kount` keeps.  Its
node-major order, the one the trie had before (children of each node
together, nodes in their parents' order: lexicographic with the first
chosen symbol first), is the same nodes sorted by their symbols.  For
each level it times three ranks of the frontier with CUDA events, each
queued behind a spin kernel (probe.queued_ms) after a warm-up, in the
order A B C C B A:
  A  occ_rank1a (csrc/occ_rank.cu, all six counts) of the node-major
     `cat([k, l])`, as `kount` ranked a level before kount_rank;
  B  occ_rank1a of the symbol-major `cat([k, l])`;
  C  kount_rank (csrc/kount.cu) of the symbol-major (k, l).
Per level it prints the nodes, the distinct rows they rank in, each
variant's row fetches (the distinct rows of each warp, summed over the
warps) and bound (the distinct rows x 48 B, the megablock bases in int64
mode, positions in and counts out, each once, at 3.35 TB/s), and the
times.  kount_rank's counts must equal occ_rank1a's on every level.  The
rows stay in L2 from one launch to the next (48 MB of rows at bench.py's
index, a 50 MB L2), as they do from one level to the next in `kount`.
Prints one JSON line tagged TAG, with the card's name and power limit.
Without a CUDA card it stops with an error.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from . import cli, kernels, probe
from .ops.kount import BASES, check_kount, kount_levels, launch_kount_rank

REPS = 20
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's 3.35 TB/s, in bytes a millisecond


def fail(msg: str):
    raise SystemExit(f"kount_time: FAIL: {msg}")


def node_major(chars: torch.Tensor) -> torch.Tensor:
    """The permutation that puts a symbol-major frontier in node-major
    order: its k-mers' symbols sorted with the first chosen one first."""
    perm = torch.arange(chars.shape[0], device=chars.device)
    for j in range(chars.shape[1] - 1, -1, -1):  # stable passes, least significant column first
        perm = perm[torch.sort(chars[perm, j], stable=True).indices]
    return perm


def warp_rows(rows: torch.Tensor, warp: torch.Tensor, n_rows: int) -> int:
    """Distinct (warp, row) pairs: the row fetches the warps issue."""
    return int(torch.unique(warp * n_rows + rows).numel())


def level_stats(x, k: torch.Tensor, l: torch.Tensor, perm: torch.Tensor) -> dict:
    """Nodes, distinct rows, and each variant's row fetches and bytes."""
    n_rows, t = x.occf.shape[0], x.dtype.itemsize
    N = k.numel()
    kl = torch.cat([k, l]).long() >> 6
    rows = torch.unique(kl)
    mega = int(torch.unique(rows >> x.mega_shift).numel()) * 48 if x.int64 else 0
    table = rows.numel() * 48 + mega
    thread = torch.arange(N, device=k.device)
    pos_warp = torch.arange(2 * N, device=k.device) // 32
    node_rows = torch.cat([k[perm], l[perm]]).long() >> 6
    return dict(
        nodes=N, rows=rows.numel(),
        warp_rows=dict(A=warp_rows(node_rows, pos_warp, n_rows), B=warp_rows(kl, pos_warp, n_rows),
                       C=warp_rows(kl, torch.cat([thread, thread]) // 32, n_rows)),
        bytes=dict(A=table + 2 * N * 8 + 2 * N * 6 * t, B=table + 2 * N * 8 + 2 * N * 6 * t,
                   C=table + 2 * N * t + 2 * BASES * N * t))


def time_level(x, k: torch.Tensor, l: torch.Tensor, perm: torch.Tensor) -> dict:
    """A B C C B A on one level; fails unless kount_rank equals occ_rank1a."""
    dev, N = k.device, k.numel()
    check_kount(x, k, l)
    pos = {"A": torch.cat([k[perm], l[perm]]).long().contiguous(), "B": torch.cat([k, l]).long().contiguous()}
    out = {v: torch.empty((2 * N, 6), dtype=x.dtype, device=dev) for v in pos}
    ok, size = (torch.empty((BASES, N), dtype=x.dtype, device=dev) for _ in range(2))
    k, l = k.contiguous(), l.contiguous()

    def rank(v):
        return lambda: kernels.launch(f"rb3c_occ_rank1a_{x.layout}", dev, *x.kernel_tables(), pos[v].data_ptr(),
                                      2 * N, out[v].data_ptr())

    fns = {"A": rank("A"), "B": rank("B"), "C": lambda: launch_kount_rank(x, k, l, ok, size)}
    ms = {v: [] for v in fns}
    for v in "ABCCBA":
        ms[v].append(probe.queued_ms([fns[v]] * REPS))
    r = out["B"].long()
    want_ok = r[:N, 1 : 1 + BASES].t()
    if not (torch.equal(ok.long(), want_ok) and torch.equal(size.long(), r[N:, 1 : 1 + BASES].t() - want_ok)):
        fail(f"kount_rank differs from occ_rank1a on a level of {N} nodes")
    inv = torch.argsort(perm)
    if not all(torch.equal(out["A"][h * N : (h + 1) * N][inv], out["B"][h * N : (h + 1) * N]) for h in (0, 1)):
        fail(f"occ_rank1a of the node-major k differs from the symbol-major on a level of {N} nodes")
    return ms


def levels(x, depth: int, min_occ: int, log=None) -> tuple[list[dict], list[tuple]]:
    """kount's trie on x (dense rows on the card), every level's frontier
    captured, then each level's stats and times (A B C C B A), bounds in
    ms; `log`, when given, takes one line a level.  Returns the levels'
    records and their frontiers (k, l, chars)."""
    frontiers = []
    kount_levels([x], depth, min_occ, on_level=lambda d, ks, ls, chars: frontiers.append((ks[0], ls[0], chars)))
    out = []
    for d, (k, l, chars) in enumerate(frontiers):
        perm = node_major(chars)
        lv = {"level": d, **level_stats(x, k, l, perm), "ms": time_level(x, k, l, perm)}
        lv["bound_ms"] = {v: b / HBM_BYTES_PER_MS for v, b in lv["bytes"].items()}
        out.append(lv)
        if log is not None:
            mean = {v: sum(t) / len(t) for v, t in lv["ms"].items()}
            log(f"level {d}: {lv['nodes']} nodes, {lv['rows']} rows; row fetches A {lv['warp_rows']['A']} B "
                f"{lv['warp_rows']['B']} C {lv['warp_rows']['C']}; ms A {mean['A']:.4f} B {mean['B']:.4f} C "
                f"{mean['C']:.4f}; bound A/B {lv['bound_ms']['A']:.4f} C {lv['bound_ms']['C']:.4f}")
    return out, frontiers


def main(argv: list[str]) -> int:
    opts, args = cli.ketopt(argv, "k:m:")
    depth, min_occ = 11, 8
    for o, a in opts:
        if o == "-k":
            depth = cli.atoi(a)
        elif o == "-m":
            min_occ = cli.atoi(a)
    if len(args) not in (1, 2) or depth <= 0:
        print(__doc__, file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("kount_time: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    x = cli.occ_rows([cli.load_index(args[0])], "cuda", "kount_time", "dense")[0]
    kernels.lib()
    card = probe.card_line()
    lv, _ = levels(x, depth, min_occ, log=lambda line: print(f"{line} ({card})", file=sys.stderr))
    out = {"tag": args[1] if len(args) == 2 else None, "card": card, "n": x.n, "layout": x.layout, "k": depth,
           "m": min_occ, "reps": REPS, "levels": lv,
           "total_ms": {v: sum(sum(r["ms"][v]) / len(r["ms"][v]) for r in lv) for v in "ABC"},
           "total_bound_ms": {v: sum(r["bound_ms"][v] for r in lv) for v in "ABC"},
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
