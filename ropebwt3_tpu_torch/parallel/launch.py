"""dp and idx across processes: the CLI under `torchrun`.

Port of ropebwt3_tpu/parallel/launch.py (`init_distributed`, `global_mesh`,
`to_host`).  torchrun sets WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT; the CLI then joins a gloo process group (`init`).  Its
traffic is the host-side gather of each batch's outputs and, where a dp
row spans processes, the slabs' descriptors (parallel/ipc.py); gloo lets
two processes share one card, which NCCL refuses.  The `--mesh` spec is
global, as the JAX package's is: its dp x idx slots are dealt out row by
row, dp x idx / WORLD_SIZE a process (`local_mesh`), so a process holds
whole dp rows, or a dp row's idx axis spans processes of one node, whose
slabs each process maps from their owners (mesh.ShardedRows).  Each
process takes its contiguous share of every batch (`DistMem`,
`DistList`); process 0 writes all output in input order, the others none
(ropebwt3_tpu/cli.py main: only process 0 owns stdout).  `ssa` and
`build` split a walk's segments instead (`segment_ranges`: one range a
mesh slot, and one a card, `card_ranges`), and every process gets every
share's slots, records and ins (`merge_shares`), finishes the work and
writes its own `-o` file, as the JAX package's processes do.
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import MeshError, by_card, cli_devices, parse_mesh, process_mesh, settle, split_segments


def world() -> tuple[int, int, int]:
    """(rank, world size, processes on this node) from torchrun's environment; (0, 1, 1) without it."""
    size = int(os.environ.get("WORLD_SIZE", "1"))
    return int(os.environ.get("RANK", "0")), size, int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))


def local_mesh(spec: str, device: str):
    """This process's share of the global `--mesh` spec (`mesh.process_mesh`):
    its dp x idx / world slots, row by row, on its devices
    (`mesh.cli_devices`).  MeshError when the processes do not divide the
    slots."""
    dp, idx = parse_mesh(spec)
    rank, size, local_world = world()
    if dp * idx % size:
        raise MeshError(f"--mesh={spec}: dp x idx ({dp * idx}) must be a multiple of the {size} processes")
    m = dp * idx // size
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    return process_mesh(dp, idx, rank, m, cli_devices(device, m, local_rank, local_world))


def init() -> None:
    """Join the gloo process group of a torchrun job (env:// rendezvous);
    nothing without one or once joined."""
    import torch.distributed as dist

    if world()[1] > 1 and not dist.is_initialized():
        dist.init_process_group("gloo")


def barrier() -> None:
    """Wait for every process of the job (nothing in one process)."""
    import torch.distributed as dist

    if world()[1] > 1:
        dist.barrier()


def finish() -> None:
    """Leave the process group, once every process is past its last launch
    over a slab that another process owns (`mesh.settle`)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        settle()
        dist.destroy_process_group()


def share(cuts: np.ndarray) -> tuple[int, int]:
    """This process's [a, b) of a batch cut into one share a process."""
    rank = world()[0]
    return int(cuts[rank]), int(cuts[rank + 1])


def gather(obj) -> list | None:
    """Every process's obj at process 0, in rank order (None elsewhere);
    process 0 returns only once every process has sent its share."""
    import torch.distributed as dist

    rank, size, _ = world()
    if size == 1:
        return [obj]
    out = [None] * size if rank == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def all_gather(obj) -> list:
    """Every process's obj on every process, in rank order."""
    import torch.distributed as dist

    size = world()[1]
    if size == 1:
        return [obj]
    out = [None] * size
    dist.all_gather_object(out, obj)
    return out


def segment_ranges(n_seg: int, n_local: int) -> list[tuple[int, int]]:
    """This process's ranges [g0, g1) of a walk's n_seg segments, one for
    each of its n_local mesh slots: the segments cut into world x n_local
    contiguous ranges (mesh.split_segments), this process's in rank order."""
    rank, size, _ = world()
    cuts = split_segments(n_seg, size * n_local)[rank * n_local :]
    return [(cuts[j], cuts[j + 1]) for j in range(n_local)]


def card_ranges(n_seg: int, devices: list) -> list[tuple[int, int, int]]:
    """This process's share of a walk's n_seg segments as one contiguous
    range [g0, g1) a distinct card of `devices` (its mesh slots, in order),
    as long as its slots' ranges (`segment_ranges`) together: (the card's
    first slot, g0, g1) each, in order of first appearance (mesh.by_card)."""
    ranges = segment_ranges(n_seg, len(devices))
    return by_card(devices, [g0 for g0, _ in ranges] + [ranges[-1][1]])


def merge_shares(parts: list):
    """The elementwise max of `parts`, tensors of one shape that hold the
    shares of one result, each position written in one share (elsewhere a
    value below any written one: -1, or INT64_MIN), on the device of
    parts[0] (reused): across devices, after every card's stream has run
    what wrote its parts; across the processes, by an all-reduce over gloo."""
    import torch

    out = parts[0]
    cards = {p.device for p in parts if p.device.type == "cuda"}
    if len(cards) > 1:
        for d in cards:
            torch.cuda.synchronize(d)
    for p in parts[1:]:
        if p is not out:
            torch.maximum(out, p.to(out.device), out=out)
    if world()[1] > 1:
        import torch.distributed as dist

        host = out.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.MAX)
        out.copy_(host)
    return out


class DistMem:
    """A `mem` engine (`run_flat(flat, seq_off)`) over the processes: each
    runs `eng` on its share of the batch's reads (parallel/smem_sharded.py
    `split_reads` over the processes), and process 0 gets every share's
    (counts, rows) in read order; the others get None."""

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def run_flat(self, flat: np.ndarray, seq_off: np.ndarray):
        from .smem_sharded import split_reads

        a, b = share(split_reads(seq_off, world()[1]))
        got = gather(self.eng.run_flat(flat[seq_off[a] : seq_off[b]], seq_off[a : b + 1] - seq_off[a]))
        if got is None:
            return None
        return np.concatenate([g[0] for g in got]), np.concatenate([g[1] for g in got])


class DistList:
    """A DP engine (`run(items)` -> one result an item: sw's reads, hapdiv's
    windows) over the processes: each runs `eng` on its contiguous share of
    the items (by count), and every process gets all results in input order
    (only process 0 writes them)."""

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def run(self, items: list) -> list:
        size = world()[1]
        cuts = np.arange(size + 1) * len(items) // size
        a, b = share(cuts)
        return [r for part in all_gather(self.eng.run(items[a:b])) for r in part]
