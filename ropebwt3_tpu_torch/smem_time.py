"""Time K1, the SMEM kernel smem_tgc (csrc/smem_tg.cu), on the card, for
side-by-side runs of two trees.

    python -m ropebwt3_tpu_torch.smem_time WORK [TAG]

Makes chip_smoke.py's main-path batch under WORK from bench.py's seed
(corpus.py): the 16 genomes' index, built once by the port's `build` and
kept in WORK, and the 100,000 short reads followed by the 200 long ones.
On dense32 rows and on rb32 rows (choose_S's S) it times smem_tgc with CUDA
events, queued behind a spin kernel (probe.queued_ms), on the lanes
(CHUNK + MARGIN) of three batches: all the reads (the main path's), the
long reads alone and the short reads alone; beside each, the longest
lane's trips and the ns a trip of that lane (kernel ms / its trips).  Then
the engine, `smem.smem_tg` (the launch, stitch, reruns), wall time on the
whole batch.  Where the tree has them it also prints the kernels'
resident blocks an SM, local bytes and registers
(`rb3c_occupancy_smem_tg_*`) and the time of the lane order
(`smem.lane_order`); in every tree the registers and spills that `nvcc
-Xptxas -v` gives for its csrc/smem_tg.cu.  Digests of every lane's
outputs (rows, counts, START log, trips) and of the engine's rows are
printed: two trees that compute the same chains print the same digests.
Prints one JSON line tagged TAG, with the card's name and power limit.
Two trees compare in one call: run each from its own root (`cd TREE &&
python -m ropebwt3_tpu_torch.smem_time WORK TAG`; a tree without this file
takes a copy of it and of corpus.py) in turns A, B, B, A.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import inspect
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from . import cli, corpus, kernels, probe
from .corpus import SEED
from .ops import rank, runblock, smem

MIN_LEN, MAX_MEMS = 31, 64
REPS = 5
LAYOUT_KEYS = {"DenseIiE": "dense32", "DenseIlE": "dense64", "RbIiE": "rb32", "RbIlE": "rb64"}


def fail(msg: str):
    raise SystemExit(f"smem_time: FAIL: {msg}")


def make_workload(work: str) -> tuple[str, list[np.ndarray]]:
    """The FMD of bench.py's genomes under `work` (built once by the port's
    `build`) and the main path's reads: the short ones, then the long ones."""
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(SEED)
    base, gens = corpus.genomes(rng)
    reads = list(corpus.short_reads(rng, base)) + corpus.long_reads(rng, base)
    fa, fmd = os.path.join(work, "genomes.fa"), os.path.join(work, "idx.fmd")
    if not os.path.exists(fmd):
        alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
        with open(fa, "wb") as fh:
            fh.write(b"".join(b">g%d\n" % g + alpha[s].tobytes() + b"\n" for g, s in enumerate(gens)))
        with contextlib.redirect_stderr(io.StringIO()):
            if cli.run(["build", "-do", fmd + f".tmp{os.getpid()}", fa]) != 0:
                fail("the index build failed")
        os.replace(fmd + f".tmp{os.getpid()}", fmd)
    return fmd, reads


def ptxas(source: str = "smem_tg.cu", kinds: dict | None = None) -> dict:
    """Registers and spill bytes of this tree's kernels in csrc/`source`, as
    `nvcc -Xptxas -v` reports them: {"smem_tgc_dense32": {...}, ...}, a key
    a kernel whose name holds a key of `kinds` (default the smem kernels)
    in each layout."""
    kinds = kinds or {"smem_tgc_kernel": "smem_tgc", "smem_tg_kernel": "smem_tg"}
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    obj = os.path.join(kernels.BUILD_DIR, f"ptxas_{source}.{os.getpid()}.o")
    try:
        r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", kernels.CSRC, "-c", "-o", obj,
                            os.path.join(kernels.CSRC, source)], capture_output=True, text=True)
    finally:
        if os.path.exists(obj):
            os.unlink(obj)
    if r.returncode != 0:
        fail(f"nvcc -Xptxas -v failed:\n{r.stderr[-2000:]}")
    out, cur = {}, None
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            kind = next((v for k, v in kinds.items() if k in name), None)
            lay = next((v for k, v in LAYOUT_KEYS.items() if k in name), None)
            cur = out.setdefault(f"{kind}_{lay}", {}) if kind and lay else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
    return out


def occupancy(layout: str, chunked: bool) -> dict | None:
    """The kernel's resident blocks an SM, local bytes and registers a
    thread; None in a tree without the query."""
    fn = getattr(kernels.lib(), f"rb3c_occupancy_smem_tg_{layout}", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [ctypes.c_int32, *[ctypes.c_void_p] * 3], ctypes.c_int
    v = [ctypes.c_int(0) for _ in range(3)]
    err = fn(int(chunked), *(ctypes.byref(x) for x in v))
    if err:
        fail(f"occupancy query: CUDA error {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(blocks_per_sm=v[0].value, local_bytes=v[1].value, regs=v[2].value,
                resident_threads=v[0].value * 256 * sms, sms=sms)


def digest(*ts) -> str:
    h = hashlib.sha1()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def lane_digest(ch) -> str:
    """The lanes' outputs in lane order: filled rows, counts, filled START
    logs, their counts and trips."""
    dev = ch.n_mem.device
    rows = ch.mems[torch.arange(ch.mems.shape[1], device=dev) < ch.n_mem.clamp(max=ch.mems.shape[1]).long()[:, None]]
    logs = ch.log[torch.arange(ch.log.shape[1], device=dev) < ch.n_log.clamp(max=ch.log.shape[1]).long()[:, None]]
    return digest(rows.long(), ch.n_mem.int(), logs.int(), ch.n_log.int(), ch.trips.int())


class Batch:
    """A batch's reads on the card, its chunk lanes and, where the tree's
    smem_tgc takes one, its lane order."""

    def __init__(self, reads: list[np.ndarray], dev):
        flat, off = smem.pack_reads(reads)
        self.flat, self.off = torch.from_numpy(flat).to(dev), torch.from_numpy(off).to(dev)
        self.lanes = smem.chunk_lanes(self.off)
        self.ordered = "order" in inspect.signature(smem.launch_tgc).parameters
        self.order = (smem.lane_order(self.lanes, self.off),) if self.ordered else ()

    def launch(self, x, **kw):
        return smem.launch_tgc(x, self.flat, self.off, self.lanes, *self.order, min_occ=1, min_len=MIN_LEN,
                               max_mems=MAX_MEMS, **kw)


def time_batch(x, b: Batch) -> dict:
    ch = b.launch(x, trips=True)
    trips = ch.trips.long()
    r = dict(lanes=b.lanes.shape[0], ms=probe.queued_ms([lambda: b.launch(x)] * REPS),
             longest_lane_trips=int(trips.max()), trips=int(trips.sum()), lanes_digest=lane_digest(ch))
    r["ns_per_trip"] = r["ms"] * 1e6 / max(r["longest_lane_trips"], 1)
    if b.ordered:
        r["order_ms"] = probe.queued_ms([lambda: smem.lane_order(b.lanes, b.off)] * REPS)
    return r


def main(argv: list[str]) -> int:
    if len(argv) not in (1, 2) or not torch.cuda.is_available():
        print(__doc__ if len(argv) not in (1, 2) else "smem_time: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    fmd, reads = make_workload(argv[0])
    f = cli.load_index(fmd)
    kernels.lib()
    n_short = corpus.N_READS
    batches = {"all": Batch(reads, dev), "long": Batch(reads[n_short:], dev), "short": Batch(reads[:n_short], dev)}
    out = {"tag": argv[1] if len(argv) == 2 else None, "card": probe.card_line(), "n": f.n, "reads": len(reads),
           "ptxas": ptxas()}
    idxs = {"dense32": rank.OccIndex.from_dense(f, dev), "rb32": runblock.RunBlockIndex.from_dense(f, dev, cache=None)}
    b = batches["all"]
    for name, x in idxs.items():
        r = out[name] = {"occupancy_smem_tgc": occupancy(x.layout, True),
                         "occupancy_smem_tg": occupancy(x.layout, False)}
        for key, batch in batches.items():
            r[key] = time_batch(x, batch)
        args = dict(min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS)
        eng = smem.smem_tg(x, b.flat, b.off, **args)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            smem.smem_tg(x, b.flat, b.off, **args)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t1) * 1e3)
        r["engine"] = dict(wall_ms=walls, n_unmerged=eng.n_unmerged, n_rerun=eng.n_rerun, mems=int(eng.counts.sum()),
                           rows_digest=digest(eng.counts, eng.rows.long()))
    if out["dense32"]["engine"]["rows_digest"] != out["rb32"]["engine"]["rows_digest"]:
        fail("the engine's rows on rb32 differ from dense32's")
    for key in batches:
        if out["dense32"][key]["lanes_digest"] != out["rb32"][key]["lanes_digest"]:
            fail(f"smem_tgc's lanes ({key}) on rb32 differ from dense32's")
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
