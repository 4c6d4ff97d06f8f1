"""Time K1 over sharded rows (smem_tgc over a mesh's mapped range,
parallel/mesh.py ShardedRows) beside unsharded K1 on the card, for
side-by-side runs of two trees.

    python -m ropebwt3_tpu_torch.mesh_time WORK [TAG]

Makes chip_smoke.py's main-path batch under WORK (smem_time.make_workload:
bench.py's index, built once by the port's `build`, and the 100,000 short
reads followed by the 200 long ones).  For dense32 and rb32 rows (choose_S's
S) it times smem_tgc on the batch's lanes (CHUNK + MARGIN) with CUDA
events, queued behind a spin kernel (probe.queued_ms), REPS launches a
turn, in turns unsharded, 2x4, 1x1, 1x1, 2x4, unsharded: the rows sharded
over a 2x4 mesh whose eight slots are this card (the last view: dp row 1,
shard column 3) and over a 1x1 mesh (one slab), each read through its
mapping's base pointer by the unsharded kernel.  The lane trips of all
three must be equal.  Also the kernel's registers and resident blocks an
SM (`rb3c_occupancy_smem_tg_*`).  Prints one JSON line
tagged TAG, with the card's name and power limit.  Two trees compare in
one call: run each from its own root in turns A, B, B, A.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from . import cli, kernels, probe
from .ops import rank, runblock, smem
from .parallel.mesh import ShardedRows, make_mesh
from .smem_time import MAX_MEMS, MIN_LEN, make_workload

REPS = 5


def occupancy(layout: str) -> dict:
    b, loc, regs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = getattr(kernels.lib(), f"rb3c_occupancy_smem_tg_{layout}")(1, ctypes.byref(b), ctypes.byref(loc),
                                                                     ctypes.byref(regs))
    if err:
        raise SystemExit(f"mesh_time: FAIL: occupancy query of {layout}: CUDA error {err}")
    return dict(blocks_per_sm=b.value, local_bytes=loc.value, regs=regs.value)


def main(argv: list[str]) -> None:
    if not argv or len(argv) > 2:
        raise SystemExit("usage: python -m ropebwt3_tpu_torch.mesh_time WORK [TAG]")
    tag = argv[1] if len(argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    fmd, reads = make_workload(argv[0])
    f = cli.load_index(fmd)
    flat, off = (torch.from_numpy(a).to(dev) for a in smem.pack_reads(reads))
    lanes = smem.chunk_lanes(off)
    order = smem.lane_order(lanes, off)
    args = dict(min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS)
    out = dict(tag=tag, card=card, reps=REPS, lanes=lanes.shape[0])
    for name, x in (("dense32", rank.OccIndex.from_dense(f, dev)), ("rb32", runblock.RunBlockIndex.from_dense(f, dev))):
        views = {"unsharded": x, "2x4": ShardedRows(x, make_mesh(2, 4, [dev] * 8)).views[-1],
                 "1x1": ShardedRows(x, make_mesh(1, 1, [dev])).views[0]}
        trips = {k: smem.launch_tgc(v, flat, off, lanes, order, trips=True, **args).trips for k, v in views.items()}
        if not all(torch.equal(t, trips["unsharded"]) for t in trips.values()):
            raise SystemExit(f"mesh_time: FAIL: {name}: the lane trips over the mapped rows differ from the unsharded rows'")
        turns = []
        for k in ("unsharded", "2x4", "1x1", "1x1", "2x4", "unsharded"):
            v = views[k]
            turns.append((k, probe.queued_ms([lambda v=v: smem.launch_tgc(v, flat, off, lanes, order, **args)] * REPS)))
        out[name] = dict(turns=turns, longest_lane_trips=int(trips["unsharded"].max()), occupancy=occupancy(name))
        print(f"[mesh_time] {tag} {name}: " + ", ".join(f"{k} {ms:.4f}" for k, ms in turns)
              + f" ms; longest lane {out[name]['longest_lane_trips']} trips ({card})", flush=True)
        del views, trips
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
