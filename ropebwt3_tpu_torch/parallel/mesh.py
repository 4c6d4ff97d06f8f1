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

Across processes (torchrun; `process_mesh` deals the global spec's slots
out row by row, so a dp row may span the processes of one node): the
process that holds a slot creates its slab (shareable: its memory can be
exported as a POSIX file descriptor) and fills it; every other process of
the dp row imports the slab from the descriptor its owner sent
(parallel/ipc.py) and maps it at the same offset into its own copy of the
row's range, then grants its own cards access.  Each step ends with every
process's word (`_agree`): a MeshError in one stops all.  The fills end
with a barrier before any read, and the owners keep their slabs until
`settle` (a barrier) so that none frees or exits while a peer launches.
On the CPU a slab is a memfd, and a range is one span of addresses with
the memfds mapped side by side (`_HostRange`), page-aligned.

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
import mmap
import os
import socket
import time
import weakref
from dataclasses import dataclass, replace

import torch

from .. import kernels, log
from ..ops.rank import HostBwtRows, OccIndex
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
    """A (dp, idx) grid of devices; a device may appear more than once.
    Under torchrun it is one process's share of the global spec
    (`process_mesh`): the dp rows it holds a slot in, from global row
    `row0`, each slot its device or None where another process holds it;
    the job's processes hold `per_process` slots each, row by row."""

    grid: tuple[tuple[torch.device | None, ...], ...]
    row0: int = 0
    per_process: int = 0  # 0: one process holds the whole mesh

    @property
    def dp(self) -> int:
        return len(self.grid)

    @property
    def idx(self) -> int:
        return len(self.grid[0])

    @property
    def devices(self) -> list[torch.device]:
        """Every device of this process's slots, row by row."""
        return [d for row in self.grid for d in row if d is not None]

    @property
    def distinct(self) -> list[torch.device]:
        """The devices of the mesh, each once, in order of appearance."""
        out: list[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    @property
    def shared(self) -> bool:
        """Whether a dp row of this process's has a slot of another process."""
        return any(d is None for row in self.grid for d in row)

    def owner(self, row: int, s: int) -> int:
        """The process that holds slot s of global dp row `row`."""
        return (row * self.idx + s) // self.per_process if self.per_process else 0

    def rows_of(self, rank: int) -> range:
        """The global dp rows in which process `rank` holds a slot."""
        m = self.per_process
        return range(rank * m // self.idx, ((rank + 1) * m - 1) // self.idx + 1)

    def __str__(self) -> str:
        return f"{self.dp}x{self.idx} mesh of " + ", ".join(
            str(d) if d is not None else f"process {self.owner(self.row0 + r, s)}"
            for r, row in enumerate(self.grid) for s, d in enumerate(row))


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


def process_mesh(dp: int, idx: int, rank: int, per_process: int, devices) -> Mesh:
    """Process `rank`'s share of a global dp x idx mesh whose slots are
    dealt out `per_process` a process, row by row: slots [rank x
    per_process, (rank + 1) x per_process) on `devices` (one a slot), the
    other slots of their dp rows None.  Whole rows, a row across
    processes, or parts of two rows are all shares."""
    mine = make_mesh(1, per_process, devices).devices
    a = rank * per_process
    r0, r1 = a // idx, (a + per_process - 1) // idx + 1
    grid = tuple(tuple(mine[r * idx + s - a] if a <= r * idx + s < a + per_process else None for s in range(idx))
                 for r in range(r0, r1))
    return Mesh(grid, r0, per_process)


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


def granularity(cards, shareable: bool = False) -> int:
    """The granularity every mapping over `cards` (device indices) keeps:
    the largest of their minimum physical allocation sizes (powers of two),
    of allocations that can be exported when `shareable`."""
    out = 1
    for c in cards:
        g = ctypes.c_uint64()
        kernels.vmm("granularity", c, int(shareable), ctypes.byref(g))
        out = max(out, g.value)
    return out


_HELD: list = []  # a list a ShardedRows across processes: the slabs this process owns there, released at `settle`


def settle() -> None:
    """Wait for every process of the job, then let go of the slabs this
    process owns and other processes map (ShardedRows across processes
    holds them here): no owner gives its memory back, or exits, while a
    peer may still launch over it.  Every process calls it at the same
    point (after a merge, at the end of a command); nothing to do, and no
    wait, when no dp row spans processes."""
    if _HELD:
        from . import launch

        launch.barrier()
        _HELD.clear()


class _Phys:
    """A physical allocation of `nbytes` on card `card`, exportable to other
    processes when `shareable`; its handle is released when the last range
    that maps it has been unmapped."""

    def __init__(self, card: int, nbytes: int, shareable: bool = False):
        self.nbytes = nbytes
        h = ctypes.c_uint64()
        kernels.vmm("create", card, nbytes, int(shareable), ctypes.byref(h))
        self.handle = h.value
        _account(card, nbytes)
        weakref.finalize(self, _release, card, nbytes, self.handle)

    def export(self) -> int:
        """A new POSIX file descriptor of the allocation, for another process."""
        fd = ctypes.c_int()
        kernels.vmm("export", self.handle, ctypes.byref(fd))
        return fd.value


def _release(card: int, nbytes: int, handle: int) -> None:
    kernels.lib().rb3c_vmm_release(handle)  # at exit too: nothing to raise to
    _account(card, -nbytes)


class _Imported:
    """Another process's slab on the card: the handle imported from the
    descriptor it sent (closed here: the handle keeps the allocation),
    released when no range maps it.  Its owner counts its bytes."""

    def __init__(self, fd: int, nbytes: int):
        self.nbytes = nbytes
        h = ctypes.c_uint64()
        try:
            kernels.vmm("import", fd, ctypes.byref(h))
        finally:
            os.close(fd)
        self.handle = h.value
        weakref.finalize(self, kernels.lib().rb3c_vmm_release, self.handle)


class _HostPhys:
    """On the CPU, a slab shared between processes: a memfd of `nbytes`,
    mapped writable by its owner; closed when the object goes (its
    mappings keep the memory)."""

    writable = True

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.fd = os.memfd_create("rb3torch-slab", os.MFD_CLOEXEC)
        weakref.finalize(self, os.close, self.fd)
        os.ftruncate(self.fd, nbytes)

    def export(self) -> int:
        return os.dup(self.fd)


class _HostImported:
    """On the CPU, another process's slab: the memfd it sent, mapped
    read-only, then closed (`close`, once mapped)."""

    writable = False

    def __init__(self, fd: int, nbytes: int):
        self.nbytes, self.fd = nbytes, fd
        self.close = weakref.finalize(self, os.close, fd)


class _Range:
    """One reserved virtual range with physical allocations mapped side by
    side from its start, readable (and writable: the upload writes through
    it) by each card of `cards`.  `pieces` (offset, _Phys or _Imported) in
    order, without gaps; unmapped and freed when no tensor over it is left."""

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


_PROT_READ, _PROT_WRITE, _MAP_SHARED, _MAP_PRIVATE, _MAP_FIXED, _MAP_ANONYMOUS, _MAP_NORESERVE = (
    1, 2, 0x01, 0x02, 0x10, 0x20, 0x4000)
_libc = None


def _mmap():
    """libc's mmap and munmap, which Python's mmap module does not give at a fixed address."""
    global _libc
    if _libc is None:
        c = ctypes.CDLL(None, use_errno=True)
        c.mmap.restype = ctypes.c_void_p
        c.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long]
        c.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        _libc = c
    return _libc


class _HostRange:
    """The CPU's _Range across processes: one reserved span of addresses
    with each piece's memfd mapped (MAP_SHARED | MAP_FIXED) side by side
    from its start, writable where this process owns the piece, read-only
    where it was imported (whose descriptor is closed once mapped);
    unmapped when no tensor over it is left.  Offsets and sizes are
    multiples of the page size."""

    def __init__(self, pieces: list):
        self.size = sum(p.nbytes for _, p in pieces)
        self.ptr = 0
        if not self.size:
            return
        c = _mmap()
        ptr = c.mmap(None, self.size, 0, _MAP_PRIVATE | _MAP_ANONYMOUS | _MAP_NORESERVE, -1, 0)
        if ptr in (None, ctypes.c_void_p(-1).value):
            raise MeshError(f"cannot reserve {self.size} B of addresses: errno {ctypes.get_errno()}")
        self.ptr = ptr
        weakref.finalize(self, c.munmap, ptr, self.size)
        for off, p in pieces:
            prot = _PROT_READ | (_PROT_WRITE if p.writable else 0)
            if c.mmap(ptr + off, p.nbytes, prot, _MAP_SHARED | _MAP_FIXED, p.fd, 0) != ptr + off:
                raise MeshError(f"cannot map a slab of {p.nbytes} B at offset {off}: errno {ctypes.get_errno()}")
            if not p.writable:
                p.close()

    def tensor(self, shape: tuple, card=None) -> torch.Tensor:
        """An int32 tensor of `shape` over the range from its start (it
        keeps this object alive)."""
        n = math.prod(shape)
        if not n:
            return torch.empty(shape, dtype=torch.int32)
        buf = (ctypes.c_char * self.size).from_address(self.ptr)
        buf.owner = self
        return torch.frombuffer(buf, dtype=torch.int32, count=n).view(shape)


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


def _agree(step: str, fn):
    """fn() in this process, then a word from every process of the job: a
    MeshError in any of them stops all of them, with its message (no
    process is left waiting at the next collective)."""
    from . import launch

    try:
        out, err = fn(), None
    except MeshError as e:
        out, err = None, str(e)
    bad = [(p, e) for p, e in enumerate(launch.all_gather(err)) if e]
    if bad:
        raise MeshError(f"sharing the mesh's slabs ({step}): " + "; ".join(f"process {p}: {e}" for p, e in bad))
    return out


def _meet(mesh: Mesh, gran: int):
    """The processes of the job, before they share slabs: this process's
    Mailbox and every process's (host, mailbox name, granularity),
    all-gathered; a dp row whose processes lie on two hosts stops them all
    (ipc.check_one_host)."""
    from . import ipc, launch

    rank, size, _ = launch.world()
    box = ipc.Mailbox(rank, size - 1)
    try:
        info = launch.all_gather((socket.gethostname(), box.name, gran))
        n_rows = mesh.per_process * size // mesh.idx
        ipc.check_one_host([{mesh.owner(r, s) for s in range(mesh.idx)} for r in range(n_rows)], [x[0] for x in info])
    except BaseException:
        box.close()
        raise
    return box, info


def _share(mesh: Mesh, meet, owned: dict, sizes: list, cuda: bool) -> dict:
    """The slabs of this process's dp rows that other processes own, from
    their owners, and this process's own slabs to the processes that map
    them: each piece (rows; on rb rows the escapes too: sizes[i][s] bytes
    of kind i in slab s) as one descriptor, exported (`_Phys.export`, or
    the memfd), sent, imported (`_Imported`, or mapped as `_HostImported`)
    and closed.  Returns (global row, s) -> [piece of each kind, None where
    it maps nothing]."""
    from . import launch

    box, info = meet
    rank, size, _ = launch.world()

    def pieces(row, s):
        return [(row, s, i) for i, sz in enumerate(sizes) if sz[s]]

    sends = {p: [k for row in mesh.rows_of(p) for s in range(mesh.idx) if mesh.owner(row, s) == rank
                 for k in pieces(row, s)] for p in range(size) if p != rank}
    sends = {p: keys for p, keys in sends.items() if keys}
    need = [k for row in mesh.rows_of(rank) for s in range(mesh.idx) if mesh.owner(row, s) != rank
            for k in pieces(row, s)]
    senders = {mesh.owner(row, s) for row, s, _ in need}
    fds: dict[int, list[int]] = {}

    def export():
        for p, keys in sends.items():
            fds[p] = []
            for row, s, i in keys:
                fds[p].append(owned[(str(mesh.grid[row - mesh.row0][s]), s)][i].export())

    def send():
        for p, keys in sends.items():
            box.send(info[p][1], keys, fds[p])

    try:
        _agree("export", export)
        _agree("send", send)
    finally:
        for f in fds.values():
            for fd in f:
                os.close(fd)
    out: dict = {}

    def receive():
        msgs = box.receive(len(senders))
        left = {fd for _, _, fd_list in msgs for fd in fd_list}  # closed here unless a piece takes it
        try:
            got = {tuple(k): (sender, fd) for sender, keys, fd_list in msgs for k, fd in zip(keys, fd_list)}
            if any(len(keys) != len(fd_list) for _, keys, fd_list in msgs) or set(got) != set(need):
                raise MeshError(f"expected slab pieces {sorted(need)} from processes {sorted(senders)}, got "
                                f"{[(sender, keys, len(fd_list)) for sender, keys, fd_list in msgs]}")
            for row, s, i in need:
                sender, fd = got[(row, s, i)]
                left.discard(fd)
                nbytes = sizes[i][s]
                piece = _Imported(fd, nbytes) if cuda else _HostImported(fd, nbytes)
                out.setdefault((row, s), [None] * len(sizes))[i] = piece
                log.info("imported slab %d of dp row %d (%s, %d B) from process %d", s, row,
                         "rows" if i == 0 else "escape sub-rows", nbytes, sender, func="mesh")
        finally:
            for fd in left:
                os.close(fd)

    _agree("import", receive)
    return out


def _row_key(mesh: Mesh, r: int) -> tuple:
    """Local dp row r's mapping key: dp rows of the same slots share one."""
    return tuple(str(d) if d is not None else f"row {mesh.row0 + r} slab {s}" for s, d in enumerate(mesh.grid[r]))


def _map_rows(mesh: Mesh, sizes: list, gran: int, cuda: bool, meet=None) -> tuple[dict, dict, dict]:
    """The mapped ranges of the rows (sizes[0], bytes a slab) and, on rb
    rows, of their escapes (sizes[1]): one of each a distinct dp row of
    this process's, each slab at its offset; one physical copy a (device,
    slab) of this process's slots, the other processes' slabs imported from
    them (`_share`, with `meet`).  Returns (key -> the row's ranges, (device,
    s) -> the pieces this process owns, (global row, s) -> the imported
    pieces)."""
    shared = meet is not None
    step = _agree if shared else (lambda what, fn: fn())
    owned: dict = {}

    def create():
        if cuda and shared:
            for d in mesh.distinct:
                ok = ctypes.c_int()
                kernels.vmm("handle_fd_ok", d.index, ctypes.byref(ok))
                if not ok.value:
                    raise MeshError(f"{d} cannot share its memory as POSIX file descriptors "
                                    "(CU_DEVICE_ATTRIBUTE_HANDLE_TYPE_POSIX_FILE_DESCRIPTOR_SUPPORTED is 0): an idx "
                                    "axis across processes needs them")
        for row in mesh.grid:
            for s, d in enumerate(row):
                if d is not None and (str(d), s) not in owned:
                    owned[(str(d), s)] = [(_Phys(d.index, sz[s], shared) if cuda else _HostPhys(sz[s])) if sz[s]
                                          else None for sz in sizes]

    step("create", create)
    imported = _share(mesh, meet, owned, sizes, cuda) if shared else {}
    ranges: dict = {}

    def map_all():
        for r, row in enumerate(mesh.grid):
            key = _row_key(mesh, r)
            if key in ranges:
                continue
            cards = sorted({d.index for d in row if d is not None})
            maps = []
            for i, sz in enumerate(sizes):
                pieces = [(sum(sz[:s]), owned[(str(d), s)][i] if d is not None else imported[(mesh.row0 + r, s)][i])
                          for s, d in enumerate(row) if sz[s]]
                maps.append(_Range(pieces, cards, gran) if cuda else _HostRange(pieces))
            ranges[key] = maps

    step("map", map_all)
    return ranges, owned, imported


def _check_peers(cards) -> None:
    """MeshError unless each card of `cards` (one dp row's, in this process)
    can read the memory of each other."""
    for a in cards:
        for b in set(cards) - {a}:
            can = ctypes.c_int()
            kernels.vmm("can_access", a, b, ctypes.byref(can))
            if not can.value:
                raise MeshError(f"cuda:{a} cannot read the memory of cuda:{b} (cuDeviceCanAccessPeer is 0): "
                                "the cards of a dp row must reach each other")


class ShardedRows:
    """An index's occ rows sharded over the idx axis of `mesh` (module
    docstring): an OccIndex's or a RunBlockIndex's, each slab copied from
    its table, or a HostBwtRows' (dense rows of a BWT in host memory), each
    slab built on the card that holds it from its part of the array.  `views[j]` is the ShardView of this process's j-th slot
    (row by row); `nb` the real rows, `nb_local` the rows a slab (a
    multiple of `unit`), `gran` the granularity in bytes, `nbytes` the
    tables this process holds.  `unit` is the CPU's mapping unit in rows;
    on the card it follows from the granularity.  Where a dp row spans
    processes (`mesh.shared`), each process creates and fills the slabs of
    its own slots and maps the others' from their owners: every process of
    the job builds its ShardedRows at the same point, and `imported` lists
    (global row, slab, owner, bytes) of what this one mapped from others."""

    def __init__(self, idx, mesh: Mesh, unit: int | None = None):
        self.mesh, self.layout, self.n, self.origin = mesh, idx.layout, idx.n, object()
        self.int64, self.mega_shift = idx.int64, idx.mega_shift
        self.is_rb = isinstance(idx, RunBlockIndex)
        self.S = idx.S if self.is_rb else None
        self.block_shift = self.S.bit_length() - 1 if self.is_rb else 6
        # a HostBwtRows has no table: each slab's rows are built on its card
        table = None if isinstance(idx, HostBwtRows) else idx.rows if self.is_rb else idx.occf
        self.nb, width = idx.shape if table is None else table.shape
        row_b = 4 * width
        cuda, shared = mesh.devices[0].type == "cuda", mesh.shared
        if cuda:
            if unit is not None:
                raise ValueError("on the card the mapping unit follows from the granularity")
            for row in mesh.grid:
                _check_peers({d.index for d in row if d is not None})
            self.gran = granularity([d.index for d in mesh.distinct], shared)
        else:  # across processes the memfds map at page-aligned offsets
            self.gran = math.lcm((unit or 1) * row_b, mmap.PAGESIZE) if shared else (unit or 1) * row_b
        t0 = time.perf_counter()
        meet = _meet(mesh, self.gran) if shared else None
        try:
            if shared:  # one plan in every process
                self.gran = max(x[2] for x in meet[1])
            self._place(idx, table, width, row_b, cuda, meet)
        finally:
            if meet is not None:
                meet[0].close()
        if shared:
            log.info("slabs shared across %d processes in %.3f s: %d imported (%d B), %d B owned", len(meet[1]),
                     time.perf_counter() - t0, len(self.imported), sum(x[3] for x in self.imported),
                     self.phys_bytes + self.host_bytes, func="mesh")

    def _place(self, idx, table, width: int, row_b: int, cuda: bool, meet) -> None:
        mesh = self.mesh
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
            if table is None:
                idx.fill(rows_t[: real[s]], s * nbl)
            else:
                rows_t[: real[s]] = table[s * nbl : s * nbl + real[s]].to(rows_t.device)
            rows_t[real[s] :] = 0
            if self.is_rb:
                rows_t[real[s] :, 6] = -1

        def fill_esc(esc_t, s):
            ids = cut[s][1]
            esc_t[: ids.numel()] = idx.esc[ids.to(idx.esc.device)].to(esc_t.device)
            esc_t[ids.numel() :] = 0

        # the ranges: one a distinct dp row of this process's (on the CPU in one process one host tensor for all)
        sizes = [row_bytes, esc_bytes][: 1 + self.is_rb]
        ranges = {}  # row key -> (rows over the range, escapes over it, its ranges)
        self.imported, self.host_bytes, self.phys_bytes = [], 0, 0
        if cuda or meet is not None:
            maps_of, owned, imported = _map_rows(mesh, sizes, self.gran, cuda, meet)
            for r, row in enumerate(mesh.grid):
                key = _row_key(mesh, r)
                if key not in ranges:
                    maps, home = maps_of[key], next(d for d in row if d is not None).index if cuda else None
                    ranges[key] = (maps[0].tensor((maps[0].size // row_b, width), home),
                                   maps[1].tensor((maps[1].size // esc_b, W4, 16), home) if self.is_rb else None,
                                   tuple(maps))
            own = sum(p.nbytes for ps in owned.values() for p in ps if p is not None)
            if cuda:
                self.phys_bytes = own
            else:
                self.host_bytes = own
            self.imported = [(row, s, mesh.owner(row, s), sum(p.nbytes for p in ps if p is not None))
                             for (row, s), ps in sorted(imported.items())]
            if meet is not None:
                _HELD.append([p for ps in owned.values() for p in ps if p is not None])  # an entry in every process
            froms = ", ".join(f"slab {s} of dp row {row} from process {o}" for row, s, o, _ in self.imported)
            self.placement = (f"{len(ranges)} mapping(s) of {len(owned)} physical slab(s)"
                              + (f" and {len(imported)} imported ({froms})" if imported else "")
                              + f", granularity {self.gran} B, {self.unit} rows a unit")
        else:
            host = (torch.empty((sum(row_bytes) // row_b, width), dtype=torch.int32),
                    torch.empty((sum(esc_bytes) // esc_b, W4, 16), dtype=torch.int32) if self.is_rb else None, ())
            ranges = {_row_key(mesh, r): host for r in range(mesh.dp)}
            self.host_bytes = sum(t.numel() * 4 for t in host[:2] if t is not None)
            self.placement = "one host tensor"
        # each slab its own view of its range; this process's slots uploaded once a (device, slab)
        filled, per_row = set(), {}
        for r, row in enumerate(mesh.grid):
            key = _row_key(mesh, r)
            if key in per_row:
                continue
            rows_r, esc_r, maps = ranges[key]
            slabs, e0 = [], 0
            for s, d in enumerate(row):
                part = rows_r[s * nbl : s * nbl + row_bytes[s] // row_b]
                esc = esc_r[e0 : e0 + esc_bytes[s] // esc_b] if self.is_rb else None
                if d is not None and (str(d), s) not in filled:
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
        if meet is not None:  # ... and before any process reads one
            from . import launch

            launch.barrier()
        self.views = [ShardView(self, r, dev, *per_row[_row_key(mesh, r)], *per_dev[str(dev)])
                      for r, row in enumerate(mesh.grid) for dev in row if dev is not None]

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
           "make_mesh", "mapped_bytes", "parse_mesh", "process_mesh", "rank6_sharded_plain", "replicate",
           "reset_mapped_peak", "settle", "slab_plan", "split_segments"]
