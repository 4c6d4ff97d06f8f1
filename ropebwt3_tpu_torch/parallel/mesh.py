"""A (dp, idx) mesh of torch devices and the occ rows sharded over its `idx`
axis.

Port of ropebwt3_tpu/parallel/mesh.py.  There, a device holds a contiguous
slab of the occ rows, a rank is a masked partial rank that only the shard
owning k's row fills in, and a psum over `idx` makes it whole once per
extend step.  Here each slab is a physical allocation on the card of its
mesh column, and the slabs of a dp row are mapped side by side into ONE
virtual range (csrc/vmm.cu: created on the card that owns the slab, mapped
at the slab's offset, readable by every card of the dp row): a kernel reads
global row bi at base + row bytes x bi, as it reads an unsharded table, and
gets the row from whichever card holds it (over NVLink from another card).
Only the owner holds the row, so the rank equals the partial plus the psum
exactly; no collective and no shard lookup runs in a rank, and the kernels
are the unsharded ones.

The layout (`ShardedRows`): slabs of nb_local rows, ceil(nb / idx) rounded
up to a whole number of mapping units.  A unit is lcm(row bytes,
granularity) / row bytes rows, the granularity being the card's minimum
physical allocation (2 MiB on an H100: 131,072 dense rows of 48 B, 65,536
rb rows of 160 B), so every slab but the last ends on a granularity
boundary and the real rows lie contiguous at their global offsets; the
last slab maps its real rows rounded up to the granularity (pad rows: zero,
no escape), and a slab with no real row maps nothing.  rb rows map their
escape sub-rows into a second range: each slab's escapes from an offset
aligned to the granularity, column 6 of its rows rebased by that offset
(`runblock.shard_layout`).  acc and int64 mode's megablock bases are
ordinary tensors, once a device, read at the global row.  dp rows that name
the same cards in the same order share one mapping, and one physical copy a
(card, slab) is mapped into every range that names it.  A card that cannot
read another's memory is a MeshError.  On the CPU the same layout sits in
one host tensor, its unit a parameter (default 1).

A `ShardView` is the rows as one device of the mesh sees them: its dp row's
range as tensors (`occf`, or `rows` and `esc`), its own acc and megablock
bases.  It passes for an index of the plain layout (`layout`,
`kernel_tables`) with ops/smem.py, construct/merge.py and the walks; its
`rank1a` is `rank6_sharded_plain`, the plain twin, which reads each slab as
its own tensor and keeps the owner's row.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from dataclasses import dataclass

import torch

from .. import kernels, log
from ..ops.rank import OccIndex
from ..ops.runblock import RunBlockIndex, shard_layout
from . import MeshError


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
    if len({d.type for d in devices}) > 1:
        raise MeshError(f"a mesh lies on the CPU or on CUDA cards, not both: {', '.join(map(str, devices))}")
    for d in devices:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise MeshError(f"{d} is not a CUDA card of this machine (it has {torch.cuda.device_count()})")
    return Mesh(tuple(tuple(devices[r * idx : (r + 1) * idx]) for r in range(dp)))


def _copy(t: torch.Tensor | None, dev: torch.device) -> torch.Tensor | None:
    """t as a tensor of its own on dev (never a view of the unsharded table)."""
    return None if t is None else t.to(dev, copy=True).contiguous()


def _round_up(x: int, g: int) -> int:
    return -(-x // g) * g


# ---------------------------------------------------------------------------
# the card's virtual memory (csrc/vmm.cu), as Python objects whose
# finalizers give it back
# ---------------------------------------------------------------------------

_LIVE: dict[int, int] = {}  # card -> physical bytes mapped now
_PEAK: dict[int, int] = {}  # card -> the most since reset_mapped_peak


def mapped_bytes(device) -> tuple[int, int]:
    """(now, peak) physical bytes of mappings on a card: they lie outside
    PyTorch's allocator, so torch.cuda.max_memory_allocated does not count
    them (the peak since `reset_mapped_peak`)."""
    i = torch.device(device).index or 0
    return _LIVE.get(i, 0), _PEAK.get(i, 0)


def reset_mapped_peak(device) -> None:
    i = torch.device(device).index or 0
    _PEAK[i] = _LIVE.get(i, 0)


def _account(card: int, nbytes: int) -> None:
    _LIVE[card] = _LIVE.get(card, 0) + nbytes
    _PEAK[card] = max(_PEAK.get(card, 0), _LIVE[card])


def granularity(cards) -> int:
    """The granularity every mapping over `cards` (device indices) keeps:
    the largest of their minimum physical allocation sizes (powers of two)."""
    out = 1
    for c in cards:
        g = ctypes.c_uint64()
        kernels.vmm("granularity", c, ctypes.byref(g))
        out = max(out, g.value)
    return out


class _Phys:
    """A physical allocation of `nbytes` on card `card`; its handle is
    released when the last range that maps it has been unmapped."""

    def __init__(self, card: int, nbytes: int):
        self.nbytes = nbytes
        h = ctypes.c_uint64()
        kernels.vmm("create", card, nbytes, ctypes.byref(h))
        self.handle = h.value
        _account(card, nbytes)
        weakref.finalize(self, _release, card, nbytes, self.handle)


def _release(card: int, nbytes: int, handle: int) -> None:
    kernels.lib().rb3c_vmm_release(handle)  # at exit too: nothing to raise to
    _account(card, -nbytes)


class _Range:
    """One reserved virtual range with physical allocations mapped side by
    side from its start, readable (and writable: the upload writes through
    it) by each card of `cards`.  `pieces` (offset, _Phys) in order, without
    gaps; unmapped and freed when no tensor over it is left."""

    def __init__(self, pieces: list, cards: list[int], gran: int):
        self.size = sum(p.nbytes for _, p in pieces)
        self.ptr = 0
        if not self.size:
            return
        ptr = ctypes.c_uint64()
        kernels.vmm("reserve", self.size, gran, ctypes.byref(ptr))
        self.ptr = ptr.value
        mapped = [0]  # bytes mapped so far, for the finalizer
        devs = (ctypes.c_int * len(cards))(*cards)
        weakref.finalize(self, _free, self.ptr, mapped, self.size, devs, [p for _, p in pieces])
        for off, p in pieces:
            kernels.vmm("map", self.ptr + off, p.nbytes, p.handle)
            mapped[0] = off + p.nbytes
        kernels.vmm("access", self.ptr, self.size, devs, len(cards))

    def tensor(self, shape: tuple, card: int) -> torch.Tensor:
        """An int32 tensor of `shape` over the range from its start, made on
        card (torch keeps this object alive as long as the tensor)."""
        with torch.cuda.device(card):
            return torch.as_tensor(_Window(self, shape))


def _free(ptr: int, mapped: list, size: int, devs, pieces: list) -> None:
    del pieces  # held until here: each piece is released once no range maps it
    kernels.lib().rb3c_vmm_free(ptr, mapped[0], size, devs, len(devs))


class _Window:
    """A _Range from its start as __cuda_array_interface__ (int32), for torch.as_tensor."""

    def __init__(self, owner: _Range, shape: tuple):
        self.owner = owner  # kept alive by the tensor
        ptr = owner.ptr if math.prod(shape) else 0  # an empty array's pointer is null
        self.__cuda_array_interface__ = {"shape": tuple(shape), "typestr": "<i4", "data": (ptr, False), "version": 3,
                                         "strides": None}


# ---------------------------------------------------------------------------
# the sharded rows
# ---------------------------------------------------------------------------


def slab_plan(nb: int, n_idx: int, row_b: int, gran: int) -> tuple[int, int, list[int], list[int]]:
    """(unit, nb_local, real rows a slab, bytes a slab maps) of nb rows of
    row_b bytes cut into n_idx slabs for a mapping of granularity `gran`
    (module docstring): a slab with no real row maps 0 bytes."""
    unit = math.lcm(row_b, gran) // row_b
    nbl = _round_up(-(-nb // n_idx), unit)
    real = [max(0, min(nbl, nb - s * nbl)) for s in range(n_idx)]
    return unit, nbl, real, [_round_up(r * row_b, gran) for r in real]


@dataclass(frozen=True)
class Slab:
    """Slab s of a dp row's range as the plain twin reads it: global rows
    [first, first + rows.shape[0]) (its real rows), its escape sub-rows
    (rb) from escape row esc_first, each its own tensor."""

    first: int
    rows: torch.Tensor
    esc: torch.Tensor | None = None
    esc_first: int = 0


class ShardedRows:
    """An index's occ rows sharded over the idx axis of `mesh` (module
    docstring).  `views[j]` is the j-th device's ShardView (row by row);
    `nb` the real rows, `nb_local` the rows a slab (a multiple of `unit`),
    `gran` the granularity in bytes, `nbytes` the tables on all devices.
    `unit` is the CPU's mapping unit in rows; on the card it follows from
    the granularity."""

    def __init__(self, idx, mesh: Mesh, unit: int | None = None):
        self.mesh, self.layout, self.n, self.origin = mesh, idx.layout, idx.n, object()
        self.int64, self.mega_shift = idx.int64, idx.mega_shift
        self.is_rb = isinstance(idx, RunBlockIndex)
        self.S = idx.S if self.is_rb else None
        self.block_shift = self.S.bit_length() - 1 if self.is_rb else 6
        table = idx.rows if self.is_rb else idx.occf
        self.nb, width = table.shape
        row_b = 4 * width
        cuda = mesh.devices[0].type == "cuda"
        if cuda:
            if unit is not None:
                raise ValueError("on the card the mapping unit follows from the granularity")
            cards = [d.index for d in mesh.distinct]
            for row in mesh.grid:
                for a in {d.index for d in row}:
                    for b in {d.index for d in row} - {a}:
                        can = ctypes.c_int()
                        kernels.vmm("can_access", a, b, ctypes.byref(can))
                        if not can.value:
                            raise MeshError(f"cuda:{a} cannot read the memory of cuda:{b} (cuDeviceCanAccessPeer is 0): "
                                            "the cards of a dp row must reach each other")
            self.gran = granularity(cards)
        else:
            self.gran = (unit or 1) * row_b
        self.unit, self.nb_local, real, row_bytes = slab_plan(self.nb, mesh.idx, row_b, self.gran)
        nbl = self.nb_local
        esc_bytes = [0] * mesh.idx
        if self.is_rb:
            W4 = idx.esc.shape[1]
            esc_b = 64 * W4  # an escape row: S/128 sub-rows of 64 B
            align = math.lcm(esc_b, self.gran) // esc_b
            table, cut = shard_layout(table, nbl, mesh.idx, align)
            esc_bytes = [_round_up(ids.numel(), align) * esc_b for _, ids in cut]
        per_dev = {}  # str(device) -> (acc, mega): replicated on each device once
        for d in mesh.distinct:
            per_dev[str(d)] = (_copy(idx.acc, d), _copy(idx.mega, d))

        def fill(rows_t, s):  # slab s's mapped rows: the real ones, then pad rows (zero, no escape)
            rows_t[: real[s]] = table[s * nbl : s * nbl + real[s]].to(rows_t.device)
            rows_t[real[s] :] = 0
            if self.is_rb:
                rows_t[real[s] :, 6] = -1

        def fill_esc(esc_t, s):
            ids = cut[s][1]
            esc_t[: ids.numel()] = idx.esc[ids.to(idx.esc.device)].to(esc_t.device)
            esc_t[ids.numel() :] = 0

        # the ranges: one a distinct dp row of cards (on the CPU one host tensor for all)
        ranges = {}  # tuple of str(device) of a dp row -> (rows over the range, escapes over it, its _Ranges)
        if cuda:
            phys = {}  # (card, s) -> (_Phys of rows, _Phys of escapes): one copy a (card, slab)
            for row in mesh.grid:
                for s, d in enumerate(row):
                    if (d.index, s) not in phys:
                        phys[(d.index, s)] = (_Phys(d.index, row_bytes[s]) if row_bytes[s] else None,
                                              _Phys(d.index, esc_bytes[s]) if self.is_rb and esc_bytes[s] else None)
            for row in mesh.grid:
                key = tuple(map(str, row))
                if key not in ranges:
                    cards_r, home = sorted({d.index for d in row}), row[0].index
                    maps = [_Range([(sum(sizes[:s]), phys[(d.index, s)][i]) for s, d in enumerate(row) if sizes[s]],
                                   cards_r, self.gran) for i, sizes in enumerate([row_bytes, esc_bytes][: 1 + self.is_rb])]
                    ranges[key] = (maps[0].tensor((maps[0].size // row_b, width), home),
                                   maps[1].tensor((maps[1].size // esc_b, W4, 16), home) if self.is_rb else None,
                                   tuple(maps))
            self.host_bytes, self.phys_bytes = 0, sum(p.nbytes for pair in phys.values() for p in pair if p is not None)
            self.placement = (f"{len(ranges)} mapping(s) of {len(phys)} physical slab(s), granularity {self.gran} B, "
                         f"{self.unit} rows a unit")
        else:
            host = (torch.empty((sum(row_bytes) // row_b, width), dtype=torch.int32),
                    torch.empty((sum(esc_bytes) // esc_b, W4, 16), dtype=torch.int32) if self.is_rb else None, ())
            ranges = {tuple(map(str, row)): host for row in mesh.grid}
            self.host_bytes, self.phys_bytes = sum(t.numel() * 4 for t in host[:2] if t is not None), 0
            self.placement = "one host tensor"
        # each slab its own view of its range; uploaded once a (device, slab)
        filled, per_row = set(), {}
        for row in mesh.grid:
            key = tuple(map(str, row))
            if key in per_row:
                continue
            rows_r, esc_r, maps = ranges[key]
            slabs, e0 = [], 0
            for s, d in enumerate(row):
                part = rows_r[s * nbl : s * nbl + row_bytes[s] // row_b]
                esc = esc_r[e0 : e0 + esc_bytes[s] // esc_b] if self.is_rb else None
                if (str(d), s) not in filled:
                    fill(part, s)
                    if self.is_rb:
                        fill_esc(esc, s)
                    filled.add((str(d), s))
                slabs.append(Slab(s * nbl, part[: real[s]], esc[: cut[s][1].numel()] if self.is_rb else None, e0))
                e0 += esc_bytes[s] // esc_b if self.is_rb else 0
            per_row[key] = (rows_r[: self.nb], esc_r, slabs, maps)
        if cuda:
            for d in mesh.distinct:  # the uploads done before any card reads a range
                torch.cuda.synchronize(d)
        self.views = [ShardView(self, r, dev, *per_row[tuple(map(str, row))], *per_dev[str(dev)])
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
        """Bytes of the tables on all devices: the mappings' physical slabs
        (the host tensors on the CPU), and acc and the megablock bases once
        a device."""
        return self.host_bytes + self.phys_bytes + sum(
            _small_bytes(v) for v in {str(v.device): v for v in self.views}.values())

    def describe(self) -> str:
        return (f"{self.layout} rows sharded over a {self.mesh}: {self.nb} rows, {self.nb_local} a slab"
                + (f", S {self.S}" if self.is_rb else "") + f"; {self.nbytes} bytes; {self.placement}")


class ShardView:
    """The sharded rows as the kernels on one device of the mesh see them:
    its dp row's range (real rows at their global offsets), its own acc and
    megablock bases.  Passes for an index of the plain layout (module
    docstring).  It holds its dp row's mapping (`maps`), not the
    ShardedRows, so the mapping goes with the last view or tensor over it;
    `origin` is the same object in every view of one ShardedRows."""

    def __init__(self, sharded: ShardedRows, dp_row: int, device: torch.device, rows: torch.Tensor,
                 esc: torch.Tensor | None, slabs: list, maps: tuple, acc: torch.Tensor, mega: torch.Tensor | None):
        self.dp_row, self.device, self.slabs, self.maps = dp_row, device, slabs, maps
        self.origin = sharded.origin
        self.acc, self.mega = acc, mega
        self.n, self.S, self.mega_shift, self.int64 = sharded.n, sharded.S, sharded.mega_shift, sharded.int64
        self.layout, self.is_rb, self.nb_local, self.block_shift = (sharded.layout, sharded.is_rb, sharded.nb_local,
                                                                    sharded.block_shift)
        if self.is_rb:
            self.rows, self.esc = rows, esc
            self.home = RunBlockIndex(rows=rows, esc=esc, acc=acc, n=self.n, S=self.S, mega=mega,
                                      mega_shift=self.mega_shift)
        else:
            self.occf = rows
            self.home = OccIndex(occf=rows, acc=acc, n=self.n, mega=mega, mega_shift=self.mega_shift)

    @property
    def dtype(self) -> torch.dtype:
        return self.acc.dtype

    @property
    def nbytes(self) -> int:
        """Bytes of the tables this view reads: its range's real rows (and
        escapes), its acc and bases."""
        t = [self.rows, self.esc] if self.is_rb else [self.occf]
        return sum(a.numel() * a.element_size() for a in t) + _small_bytes(self)

    def kernel_tables(self) -> tuple:
        """(rows, esc, mega, acc, mega_shift, log2 block) as the C entry points
        take them: the range's base pointers."""
        return self.home.kernel_tables()

    def rank1a(self, k: torch.Tensor) -> torch.Tensor:
        return rank6_sharded_plain(self, k)


def _small_bytes(x) -> int:
    """Bytes of acc and the megablock bases of an index or a view."""
    return sum(a.numel() * a.element_size() for a in (x.acc, x.mega) if a is not None)


def block_of(view: ShardView, k: torch.Tensor) -> torch.Tensor:
    """The row a rank at int64 k reads (csrc/occ.cuh and rb.cuh): k >> 6 on
    dense rows; on rb rows (k - 1) >> log2 S, 0 at k = 0 (F1)."""
    if view.is_rb:
        return ((k - 1) >> view.block_shift).clamp(min=0)
    return k >> 6


def rank6_sharded_plain(view: ShardView, k: torch.Tensor) -> torch.Tensor:
    """rank1a of k (any shape, in [0, n]) over the view's slabs: the plain
    twin of the kernels' rank over the mapped range, independent of its base
    pointer.  Each k's owner is the slab of its row, which is at most the
    last real row (F1 on rb rows, so the JAX package's ownership clamp,
    ropebwt3_tpu/parallel/mesh.py:149-156, has nothing to do); k's row (and
    on rb rows its escape sub-row, at the row's escape id less the slab's
    first) comes from the owner's slab at the local row, and the rank from
    it with the megablock base at the global row.  Every slab gathers for
    every k, its row clamped into the slab, and the owner's is kept: no sync
    a slab.  Returns int64 (..., 6) on k's device."""
    k = k.long()
    bi = block_of(view, k)
    owner = (bi // view.nb_local)[..., None]
    slabs = [(s, x) for s, x in enumerate(view.slabs) if x.rows.shape[0]]

    def owned(get):
        out = None
        for s, x in slabs:
            v = get(x).to(k.device)
            out = v if out is None else torch.where(owner == s, v, out)
        return out

    def local(x):
        return (bi - x.first).clamp(0, x.rows.shape[0] - 1).to(x.rows.device)

    if not view.is_rb:
        return view.home.rank_row(k, owned(lambda x: x.rows[local(x)]))
    row = owned(lambda x: x.rows[local(x)])
    off = view.home.block_and_offset(k)[1]
    W4 = view.esc.shape[1]

    def sub(x):
        if not x.esc.shape[0]:  # no escape in this slab: its rows are all run-coded
            return torch.zeros(k.shape + (16,), dtype=torch.int32, device=x.rows.device)
        e = (row[..., 6].long().to(x.esc.device) - x.esc_first).clamp(0, x.esc.shape[0] - 1)
        return x.esc[e, (off.to(x.esc.device) >> 7).clamp(max=W4 - 1)]

    return view.home.rank_row(k, row, owned(sub))


def by_card(devices: list, cuts) -> list[tuple[int, int, int]]:
    """(j, a, b) for each distinct device of `devices` (one a mesh slot, in
    order), in order of first appearance: j its first slot, [a, b) one
    contiguous share as long as its slots' shares together, where slot j's
    share would be [cuts[j], cuts[j + 1]).  A card then runs one launch over
    its share, however often the mesh names it."""
    first: dict[str, list[int]] = {}
    for j, d in enumerate(devices):
        first.setdefault(str(d), [j, 0])[1] += 1
    out, p = [], 0
    for j, c in first.values():
        out.append((j, int(cuts[p]), int(cuts[p + c])))
        p += c
    return out


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


__all__ = ["Mesh", "MeshError", "ShardView", "ShardedRows", "Slab", "block_of", "by_card", "cli_devices", "granularity",
           "make_mesh", "mapped_bytes", "parse_mesh", "rank6_sharded_plain", "replicate", "reset_mapped_peak",
           "slab_plan", "split_segments"]
