"""A (dp, idx) mesh of torch devices and the occ rows sharded over its `idx`
axis.

Port of ropebwt3_tpu/parallel/mesh.py.  There, a device holds a contiguous
slab of the occ rows, a rank is a masked partial rank that only the shard
owning k's row fills in, and a psum over `idx` makes it whole once per
extend step.  Here the same function is computed where the rank is taken:
the SMEM kernels run over a sharded row source (csrc/occ.cuh `Sharded`)
that picks the owning shard of each rank and loads the row from that
shard's slab, on this card or, over NVLink with peer access on, on another
card of the host.  Only the owner holds the row, so the result equals the
partial plus the psum exactly; no collective runs inside the state machine.

`ShardedRows` cuts an index's rows (ops/rank.py `OccIndex` or
ops/runblock.py `RunBlockIndex`, either width) into idx slabs of nb_local
rows (the rows padded to a multiple of idx; rb pad rows carry no escape,
and each slab numbers its own escape rows, `runblock.shard_layout`) and
places slab s on the device of column s of every dp row: each dp row holds
its own replica, and one device holds one copy of a slab however often the
mesh names it.  acc and int64 mode's megablock bases sit on every device.
A device may repeat in the mesh: eight shards can all live on cuda:0, and
the kernels still route every rank through the shard table.

A `ShardView` is the rows as one device of the mesh sees them: its dp
row's shards, its own acc and megablock bases.  It passes for an index
with the SMEM engine (ops/smem.py): layout `sh_<layout>` (the kernels
rb3c_smem_tg_sh_* / rb3c_smem_tgc_sh_*), `rank1a` the plain sharded rank
`rank6_sharded_plain`, and `kernel_tables` the shard description the
kernels take.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from .. import kernels, log
from ..ops.rank import OccIndex
from ..ops.runblock import RunBlockIndex, shard_layout
from . import MeshError

MAX_SHARDS = 8  # csrc/occ.cuh kMaxShards


def parse_mesh(spec: str) -> tuple[int, int]:
    """(dp, idx) of `--mesh=DPxIDX` or `--mesh=N` (N x 1), as the JAX
    package parses it (ropebwt3_tpu/cli.py:1243-1246)."""
    dd, _, ii = spec.lower().partition("x")
    try:
        dp, idx = int(dd), int(ii) if ii else 1
    except ValueError:
        dp = idx = 0
    if dp < 1 or idx < 1:
        raise MeshError(f"invalid --mesh '{spec}' (DPxIDX or N, positive integers)")
    return dp, idx


@dataclass(frozen=True)
class Mesh:
    """A (dp, idx) grid of devices; a device may appear more than once."""

    grid: tuple[tuple[torch.device, ...], ...]

    @property
    def dp(self) -> int:
        return len(self.grid)

    @property
    def idx(self) -> int:
        return len(self.grid[0])

    @property
    def devices(self) -> list[torch.device]:
        """Every device of the mesh, row by row."""
        return [d for row in self.grid for d in row]

    @property
    def distinct(self) -> list[torch.device]:
        """The devices of the mesh, each once, in order of appearance."""
        out: list[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def __str__(self) -> str:
        return f"{self.dp}x{self.idx} mesh of " + ", ".join(str(d) for d in self.devices)


def make_mesh(dp: int, idx: int, devices=None) -> Mesh:
    """A dp x idx mesh over `devices` (dp * idx of them, row by row), by
    default cuda:0 .. cuda:dp*idx-1.  Stops with a MeshError when the
    machine has fewer cards than the mesh needs; it never wraps around.
    Tests and chip_smoke pass explicit lists such as [cuda:0] * 8."""
    need = dp * idx
    if dp < 1 or idx < 1:
        raise MeshError(f"a mesh needs dp >= 1 and idx >= 1, got {dp}x{idx}")
    if idx > MAX_SHARDS:
        raise MeshError(f"a {dp}x{idx} mesh shards the rows {idx} ways; the kernels take at most {MAX_SHARDS}")
    if devices is None:
        have = torch.cuda.device_count()
        if have < need:
            raise MeshError(f"a {dp}x{idx} mesh needs {need} CUDA cards; this machine has {have}")
        devices = [torch.device("cuda", i) for i in range(need)]
    devices = [torch.device(d) for d in devices]
    devices = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
               for d in devices]
    if len(devices) != need:
        raise MeshError(f"a {dp}x{idx} mesh takes {need} devices, got {len(devices)}")
    for d in devices:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise MeshError(f"{d} is not a CUDA card of this machine (it has {torch.cuda.device_count()})")
    return Mesh(tuple(tuple(devices[r * idx : (r + 1) * idx]) for r in range(dp)))


def _copy(t: torch.Tensor | None, dev: torch.device) -> torch.Tensor | None:
    """t as a tensor of its own on dev (never a view of the unsharded table)."""
    return None if t is None else t.to(dev, copy=True).contiguous()


class ShardedRows:
    """An index's occ rows sharded over the idx axis of `mesh` (module
    docstring).  `views[j]` is the j-th device's ShardView (row by row);
    `nb` the real rows, `nb_local` the rows a slab; `peer` says how the
    shards on other cards are reached."""

    def __init__(self, idx, mesh: Mesh):
        self.mesh, self.layout, self.n = mesh, idx.layout, idx.n
        self.int64, self.mega_shift = idx.int64, idx.mega_shift
        self.is_rb = isinstance(idx, RunBlockIndex)
        self.S = idx.S if self.is_rb else None
        self.block_shift = self.S.bit_length() - 1 if self.is_rb else 6
        table = idx.rows if self.is_rb else idx.occf
        self.nb = table.shape[0]
        if self.is_rb:
            self.nb_local, cut = shard_layout(table, mesh.idx)
            W4 = idx.esc.shape[1]
            parts = [(slab, idx.esc[ids] if ids.numel() else idx.esc.new_zeros((1, W4, idx.esc.shape[2])))
                     for slab, ids in cut]
        else:
            nbl = self.nb_local = -(-self.nb // mesh.idx)
            slabs = [table[s * nbl : (s + 1) * nbl] for s in range(mesh.idx)]
            parts = [(torch.cat([x, x.new_zeros((nbl - x.shape[0], x.shape[1]))]) if x.shape[0] < nbl else x, None)
                     for x in slabs]  # the tail slabs padded with zero rows, never read
        per_dev = {}  # str(device) -> (acc, mega): replicated on each device once
        slabs = {}  # (str(device), s) -> the slab's index object: one copy a device
        for row in mesh.grid:
            for s, dev in enumerate(row):
                if str(dev) not in per_dev:
                    per_dev[str(dev)] = (_copy(idx.acc, dev), _copy(idx.mega, dev))
                if (str(dev), s) not in slabs:
                    acc, mega = per_dev[str(dev)]
                    rows, esc = _copy(parts[s][0], dev), _copy(parts[s][1], dev)
                    slabs[(str(dev), s)] = (
                        RunBlockIndex(rows=rows, esc=esc, acc=acc, n=idx.n, S=idx.S, mega=mega, mega_shift=idx.mega_shift)
                        if self.is_rb else OccIndex(occf=rows, acc=acc, n=idx.n, mega=mega, mega_shift=idx.mega_shift))
        self.slabs = slabs
        cards = [d for d in mesh.distinct if d.type == "cuda"]
        self.peer = "no peer access needed: one device"
        if len(cards) > 1:
            kernels.enable_peer(cards)
            self.peer = "peer access enabled between " + ", ".join(str(d) for d in cards)
        self.views = [ShardView(self, r, dev, [slabs[(str(row[s]), s)] for s in range(mesh.idx)], *per_dev[str(dev)])
                      for r, row in enumerate(mesh.grid) for dev in row]

    @classmethod
    def from_dense(cls, f, mesh: Mesh, occ: str = "auto") -> "ShardedRows":
        """The rows of a DenseFMIndex sharded over `mesh`: built on the host,
        then each slab placed.  `occ` auto|dense|rb is decided per idx shard
        (`resolve_occ` on n / idx, as the JAX engine decides it,
        ropebwt3_tpu/ops/smem.py:136-144) against the first device's memory."""
        from ..ops.smem import resolve_occ

        occ = resolve_occ(occ, -(-f.n // mesh.idx), mesh.devices[0])
        idx = RunBlockIndex.from_dense(f, "cpu") if occ == "rb" else OccIndex.from_dense(f, "cpu")
        return cls(idx, mesh)

    @property
    def nbytes(self) -> int:
        """Bytes of the tables on all devices: the slabs, and acc and the
        megablock bases once a device."""
        return sum(_slab_bytes(x) for x in self.slabs.values()) + sum(
            _small_bytes(v) for v in {str(v.device): v for v in self.views}.values())

    def describe(self) -> str:
        return (f"{self.layout} rows sharded over a {self.mesh}: {self.nb} rows, {self.nb_local} a slab"
                + (f", S {self.S}" if self.is_rb else "") + f"; {self.nbytes} bytes; {self.peer}")


class ShardView:
    """The sharded rows as the kernels on one device of the mesh see them:
    its dp row's shards (their slabs wherever they lie), its own acc and
    megablock bases.  Passes for an index with ops/smem.py (module
    docstring)."""

    def __init__(self, rows: ShardedRows, dp_row: int, device: torch.device, shards: list, acc: torch.Tensor,
                 mega: torch.Tensor | None):
        self.rows, self.dp_row, self.device, self.shards = rows, dp_row, device, shards
        self.acc, self.mega = acc, mega
        self.home = replace(shards[0], acc=acc, mega=mega)  # the plain rank's tables on this device: acc, bases
        self.n, self.S, self.mega_shift, self.int64 = rows.n, rows.S, rows.mega_shift, rows.int64
        self.layout = "sh_" + rows.layout
        # the kernels' shard description: each shard's rows, escape sub-rows, first global row
        self.desc = torch.tensor([[x.rows.data_ptr() if rows.is_rb else x.occf.data_ptr(),
                                   x.esc.data_ptr() if rows.is_rb else 0, s * rows.nb_local]
                                  for s, x in enumerate(shards)], dtype=torch.int64)

    @property
    def dtype(self) -> torch.dtype:
        return self.acc.dtype

    @property
    def nbytes(self) -> int:
        """Bytes of the tables this view reads: its shards' slabs, its acc and bases."""
        return sum(_slab_bytes(x) for x in self.shards) + _small_bytes(self)

    def kernel_tables(self) -> tuple:
        """(desc, n_shards, nb, mega, acc, mega_shift, log2 block) as the sharded C entry points take them."""
        return (self.desc.data_ptr(), self.desc.shape[0], self.rows.nb, self.mega.data_ptr() if self.int64 else None,
                self.acc.data_ptr(), self.mega_shift, self.rows.block_shift)

    def rank1a(self, k: torch.Tensor) -> torch.Tensor:
        return rank6_sharded_plain(self, k)


def _slab_bytes(x) -> int:
    """Bytes of a slab's rows and escape sub-rows."""
    t = [x.rows, x.esc] if isinstance(x, RunBlockIndex) else [x.occf]
    return sum(a.numel() * a.element_size() for a in t)


def _small_bytes(x) -> int:
    """Bytes of acc and the megablock bases of an index or a view."""
    return sum(a.numel() * a.element_size() for a in (x.acc, x.mega) if a is not None)


def block_of(view: ShardView, k: torch.Tensor) -> torch.Tensor:
    """The row a rank at int64 k reads (csrc/occ.cuh and rb.cuh `block`):
    k >> 6 on dense rows; on rb rows (k - 1) >> log2 S, 0 at k = 0 (F1)."""
    if view.rows.is_rb:
        return ((k - 1) >> view.rows.block_shift).clamp(min=0)
    return k >> 6


def rank6_sharded_plain(view: ShardView, k: torch.Tensor) -> torch.Tensor:
    """rank1a of k (any shape, in [0, n]) over the view's shards: the
    plain version of csrc/occ.cuh `Sharded::rank6`.  Each k's owner is the
    shard of its row, which is at most the last real row (F1 on rb rows, so
    the JAX package's ownership clamp, ropebwt3_tpu/parallel/mesh.py:149-156,
    has nothing to do); k's row (and on rb rows its escape sub-row) comes
    from the owner's slab at the local row, and the rank from it with the
    megablock base at the global row.  Every shard gathers for every k, its
    row clamped into the slab, and the owner's is kept: no sync a shard.
    Returns int64 (..., 6) on k's device."""
    k = k.long()
    bi = block_of(view, k)
    nbl = view.rows.nb_local
    owner = (bi // nbl)[..., None]

    def owned(get):  # every shard gathers for every k (its row clamped into the slab); the owner's is kept
        out = None
        for s, x in enumerate(view.shards):
            v = get(s, x).to(k.device)
            out = v if out is None else torch.where(owner == s, v, out)
        return out

    def local(s, x):
        return (bi - s * nbl).clamp(0, nbl - 1).to(x.device)

    if not view.rows.is_rb:
        return view.home.rank_row(k, owned(lambda s, x: x.occf[local(s, x)]))
    row = owned(lambda s, x: x.rows[local(s, x)])
    off = view.home.block_and_offset(k)[1]
    sub = owned(lambda s, x: x.escape_sub_rows(row[..., 6].long().to(x.device), off.to(x.device)))
    return view.home.rank_row(k, row, sub)


def split_segments(n_seg: int, parts: int) -> list[int]:
    """Cut points (parts + 1) of n_seg segments into `parts` contiguous
    ranges, [cuts[j], cuts[j + 1]), as even as whole segments allow."""
    return [j * n_seg // parts for j in range(parts + 1)]


def replicate(idx: OccIndex, devices) -> list[OccIndex]:
    """The dense rows `idx` on each of `devices` (one entry a mesh slot), one
    copy a distinct device: `ssa --mesh`'s tables, which the JAX package
    replicates over its mesh (ropebwt3_tpu/ssa_ops.py:175-176)."""
    copies = {str(idx.device): idx}
    for d in map(torch.device, devices):
        if str(d) not in copies:
            copies[str(d)] = replace(idx, occf=_copy(idx.occf, d), acc=_copy(idx.acc, d), mega=_copy(idx.mega, d))
    return [copies[str(torch.device(d))] for d in devices]


def cli_devices(device: str, need: int, rank: int = 0, local_world: int = 1) -> list[torch.device]:
    """The devices of one process's share of a mesh on the CLI: `need` of
    them, [cpu] * need with --device=cpu; on the card cuda:first ..
    cuda:first+need-1, where a process of a torchrun job on a node that
    holds every process's cards (local_world x need) takes its own, and on
    a node with fewer the processes share cuda:0 .. need-1.  A MeshError
    when the machine has fewer cards than one process needs."""
    if device == "cpu":
        return [torch.device("cpu")] * need
    have = torch.cuda.device_count()
    if have < need:
        raise MeshError(f"the mesh needs {need} CUDA cards in this process; this machine has {have}")
    first = rank * need if have >= local_world * need else 0
    if local_world > 1 and first == 0 and rank > 0:
        log.info("process %d shares cuda:0..%d with the other processes: the node has %d card(s), the %d processes "
                 "need %d", rank, need - 1, have, local_world, local_world * need, func="mesh")
    return [torch.device("cuda", first + i) for i in range(need)]


__all__ = ["MAX_SHARDS", "Mesh", "MeshError", "ShardView", "ShardedRows", "block_of", "cli_devices", "make_mesh",
           "parse_mesh", "rank6_sharded_plain", "replicate", "split_segments"]
