"""Time the rb rank on the card, for side-by-side runs of two trees.

    python -m ropebwt3_tpu_torch.rb_time IDX.fmd READS.fa [TAG]

On the index's rb32 rows at S = 8192 and S = 256 (on a pangenome the first
is mostly escape blocks, the second mostly run-coded) and its dense32 rows:
occ_rank1a on 2^20 random positions and smem_tgc on the lanes of every read
of READS.fa (one batch, `-l31`), each queued behind a spin kernel
(probe.queued_ms); then `mem -l31` through cli.run in-process, warm (the
second of two runs), with --occ=dense and --occ=rb.  The rank is checked against the plain rank on the card
and smem_tgc's rows against dense32's, so a tree whose kernel is wrong
fails.  Prints one JSON line tagged TAG.  Two trees compare in one call:
run each from its own root (`cd TREE && python -m ropebwt3_tpu_torch.rb_time
...`) in turns A, B, B, A.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time

import numpy as np
import torch

from . import cli, kernels, probe, seqio
from .cli import load_index
from .ops import rank, runblock, smem

N_RANK = 1 << 20
MIN_LEN, MAX_MEMS = 31, 64
LAYOUTS = (("rb32 S=8192", dict(S=8192)), ("rb32 S=256", dict(S=256)))


def fail(msg: str):
    raise SystemExit(f"rb_time: FAIL: {msg}")


def mem_s(argv: list[str]) -> float:
    """Seconds of the second of two in-process runs of `argv` (BED and log discarded)."""
    for _ in range(2):
        t0 = time.perf_counter()
        with open(os.devnull, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            if cli.run(argv) != 0:
                fail(f"{' '.join(argv)} failed")
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv: list[str]) -> int:
    if len(argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__ if len(argv) not in (2, 3) else "rb_time: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    f = load_index(argv[0])
    _, flat, off = next(seqio.iter_flat_batches(argv[1], False, 1 << 40))
    flat = torch.from_numpy(np.ascontiguousarray(flat, np.uint8)).to(dev)
    off = torch.from_numpy(np.ascontiguousarray(off, np.int64)).to(dev)
    lanes = smem.chunk_lanes(off)
    order = smem.lane_order(lanes, off)
    k = torch.from_numpy(np.random.default_rng(1).integers(0, f.n + 1, N_RANK)).to(dev)
    args = dict(min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS)
    kernels.lib()
    idxs = {"dense32": rank.OccIndex.from_dense(f, dev)}
    idxs.update({name: runblock.RunBlockIndex.from_dense(f, dev, cache=None, **kw) for name, kw in LAYOUTS})
    ref = None
    out = {"tag": argv[2] if len(argv) == 3 else None, "card": probe.card_line(), "n": f.n, "reads": off.numel() - 1,
           "lanes": lanes.shape[0]}
    for name, x in idxs.items():
        got = torch.empty((N_RANK, 6), dtype=x.dtype, device=dev)

        def launch_rank(x=x, got=got):
            kernels.launch(f"rb3c_occ_rank1a_{x.layout}", dev, *x.kernel_tables(), k.data_ptr(), N_RANK, got.data_ptr())

        launch_rank()
        if not torch.equal(got.long(), rank.rank1a(x, k)):
            fail(f"{name}: occ_rank1a differs from the plain rank")
        c = smem.launch_tgc(x, flat, off, lanes, order, **args)
        filled = torch.arange(MAX_MEMS, device=dev) < c.n_mem.clamp(max=MAX_MEMS)[:, None]  # the slots written
        mine = (c.n_mem, c.mems[filled].long())
        if ref is None:
            ref = mine
        elif not (torch.equal(mine[0], ref[0]) and torch.equal(mine[1], ref[1])):
            fail(f"{name}: smem_tgc's rows differ from dense32's")
        out[name] = dict(S=getattr(x, "S", 64), n_esc=getattr(x, "n_esc", 0), table_bytes=x.nbytes,
                         rank_ms=probe.queued_ms([launch_rank] * 10),
                         tgc_ms=probe.queued_ms([lambda x=x: smem.launch_tgc(x, flat, off, lanes, order, **args)] * 5))
    del idxs, ref
    for occ in ("dense", "rb"):
        out[f"mem_{occ}_s"] = mem_s(["mem", f"-l{MIN_LEN}", f"--occ={occ}", argv[0], argv[1]])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
