"""Fused occ rows on a torch device, with rank and bidirectional extension.

Port of ropebwt3_tpu/ops/rank.py.  The dense host index (index/dense.py) is
uploaded as ONE row table:
  occf : (n_blocks + 1, 12) int32 — 3 keyed bit-planes x 2 words (cols 0:6),
         then the counts of symbols 0..5 before the block (cols 6:12)
  acc  : (7,) int32 | int64 — cumulative symbol counts
so a rank is one 48-byte row load plus masks and popcounts.  Indexes below
MAX_N_INT32 symbols hold absolute int32 counts.  Larger ones (int64 mode)
hold uint32 counts relative to the containing megablock of 2^mega_shift
rows, whose int64 base counts are the small table `mega` (n_mega, 6).

`rank1a`, `extend`, `extend_c` and `set_intv` are the plain PyTorch versions
(the CPU path and the reference the CUDA routines are held against); torch
has no popcount and no uint32 shifts on the CPU, so they work in int64 with a
SWAR popcount.  `extend`, `extend_c` and `set_intv` take any index with a
`rank1a` method: this module's `OccIndex` or ops/runblock.py's
`RunBlockIndex`.  `rank1a_cuda` / `extend_c_cuda` wrap the occ_rank kernels
(csrc/occ_rank.cu), which run the device routines of csrc/occ.cuh and
csrc/rb.cuh that the SMEM kernel inlines.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..index.dense import BLOCK, BLOCKS_PER_SUPER, DenseFMIndex

ASIZE = 6
# bidirectional-extend complement order: the secondary coordinate accumulates
# sizes in the order 0,4,3,2,1,5 (rld_extend, rld0.c:495-500)
EXT_ORDER = (0, 4, 3, 2, 1, 5)
# KEY[sym] = position of sym in the complement order (== the nt6 complement).
# Bit-planes hold KEY[sym], not sym (ropebwt3_tpu/ops/rank.py:33-40).
KEY = np.zeros(ASIZE, dtype=np.uint8)
for _pos, _c in enumerate(EXT_ORDER):
    KEY[_c] = _pos
# indexes of this many symbols or more take int64 megablock rows, as the JAX
# package decides (ropebwt3_tpu/ops/rank.py:146)
MAX_N_INT32 = (1 << 31) - (1 << 20)
# rows per 2^32-symbol megablock (ropebwt3_tpu/ops/rank.py:66); a field of
# the index, so tests and the smoke can shrink it
MEGA_BLOCK_SHIFT = 32 - 6
U32 = 0xFFFFFFFF
FROM_BWT_BLOCKS = 1 << 18  # rows per chunk of OccIndex.from_bwt (16 M symbols)


def from_bwt_temp_bytes(n: int) -> int:
    """Bytes `OccIndex.from_bwt` holds at its peak for n symbols, beside the
    BWT and the rows it returns: one chunk's temporaries (< 32 B a symbol
    and three (rows, 6) int64 count tables) and the megablock bases."""
    nb = n // BLOCK + 2
    return (32 * BLOCK + 3 * 48) * min(nb, FROM_BWT_BLOCKS) + 48 * ((nb >> MEGA_BLOCK_SHIFT) + 1)


def n_rows(n: int) -> int:
    """Rows of an n-symbol index's dense table: one a 64-symbol block, the
    last padded, and the extra row (k = n)."""
    return (n + BLOCK - 1) // BLOCK + 1


def _check_host_bwt(bwt: np.ndarray) -> None:
    if bwt.dtype != np.uint8 or bwt.ndim != 1:
        raise ValueError("from_bwt takes a 1-D uint8 BWT")


def _blocks(bwt, b0: int, b1: int, dev) -> torch.Tensor:
    """The symbols of rows [b0, b1) of a BWT (a tensor, or a numpy array in
    host memory: a copy, as it may be a read-only map) on `dev`, (b1 - b0,
    64) uint8, the padding symbol 6 past n."""
    n = len(bwt)
    blk = torch.full(((b1 - b0) * BLOCK,), ASIZE, dtype=torch.uint8, device=dev)
    if b0 * BLOCK < n:
        a, b = b0 * BLOCK, min(b1 * BLOCK, n)
        blk[: b - a] = torch.from_numpy(np.array(bwt[a:b])).to(dev) if isinstance(bwt, np.ndarray) else bwt[a:b].to(dev)
    return blk.view(b1 - b0, BLOCK)


def _chunk_rows(blk: torch.Tensor, out: torch.Tensor, carry: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bit-planes of the blocks `blk` (rows, 64) into out[:, :6];
    returns (the counts before each row (rows, 6) int64, from `carry`, the
    counts before the first; the counts after the last)."""
    dev = blk.device
    key = torch.as_tensor(np.append(KEY, 0), dtype=torch.int64, device=dev)  # padding (6) keys as 0
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    keyed = key[blk.long()].view(blk.shape[0], 2, 32)
    for plane in range(3):
        words = (((keyed >> plane) & 1) << shifts).sum(-1)  # (rows, 2) in [0, 2^32)
        out[:, 2 * plane : 2 * plane + 2] = _as_int32(words)
    del keyed
    cnt = torch.stack([(blk == c).sum(1) for c in range(ASIZE)], 1)  # symbols in each block
    before = torch.cumsum(cnt, 0) - cnt + carry  # row i: the symbols before block i
    return before, before[-1] + cnt[-1]


def _count_cols(out: torch.Tensor, before: torch.Tensor, b0: int, mega: torch.Tensor | None, mega_shift: int) -> None:
    """out[:, 6:] of rows b0.. from the counts before each: absolute, or
    (mega given: int64 rows) relative to the base of the row's megablock."""
    if mega is None:
        out[:, 6:] = before
        return
    before = before - mega[torch.arange(b0, b0 + len(before), device=before.device) >> mega_shift]
    if int(before.max()) > U32:
        raise ValueError(f"a megablock of 2^{mega_shift} rows holds more than 2^32 symbols")
    out[:, 6:] = _as_int32(before)


def needs_int64(n: int) -> bool:
    return n >= MAX_N_INT32


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same 32 bits."""
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).int()


def pack_bitplanes(bwt_blocks: np.ndarray) -> np.ndarray:
    """(nb, 64) uint8 symbols -> (nb, 6) uint32 bit-planes of KEY[sym]:
    [p0_lo, p0_hi, p1_lo, p1_hi, p2_lo, p2_hi], plane i = bit i of the keyed
    symbol, lo = block positions 0..31, hi = 32..63."""
    keyed = KEY[bwt_blocks]
    out = np.empty((bwt_blocks.shape[0], 6), dtype=np.uint32)
    for plane in range(3):
        words = np.packbits((keyed >> plane) & 1, axis=1, bitorder="little").view("<u4")
        out[:, 2 * plane : 2 * plane + 2] = words
    return out


def rebase_mega(counts: np.ndarray, mega_shift: int) -> tuple[np.ndarray, np.ndarray]:
    """Absolute (nb, 6) int64 counts before each row -> (uint32 counts
    relative to the containing megablock of 2^mega_shift rows, viewed as
    int32; (n_mega, 6) int64 bases, each the count before its first row)."""
    mega = np.ascontiguousarray(counts[:: 1 << mega_shift])
    rel = counts - mega[np.arange(len(counts)) >> mega_shift]
    if rel.size and int(rel.max()) > U32:
        raise ValueError(f"a megablock of 2^{mega_shift} rows holds more than 2^32 symbols")
    return rel.astype(np.uint32).view(np.int32), mega


def build_occf(f: DenseFMIndex, int64: bool = False, mega_shift: int = MEGA_BLOCK_SHIFT) -> tuple[np.ndarray, np.ndarray | None]:
    """Host-side fused row table: (occf (nb, 12) int32, mega).  int32 mode:
    absolute counts, mega None.  int64 mode: uint32 counts relative to the
    megablock and the (n_mega, 6) int64 bases; chunked, so the int64
    temporaries stay small at terabase nb."""
    nb = len(f.occ_block)
    occf = np.empty((nb, 12), np.int32)
    occf[:, :6] = pack_bitplanes(f.bwt[: nb * BLOCK].reshape(nb, BLOCK)).view(np.int32)
    if not int64:
        occf[:, 6:] = np.repeat(f.occ_super, BLOCKS_PER_SUPER, axis=0)[:nb] + f.occ_block
        return occf, None
    mega_rows = 1 << mega_shift
    megas = []
    step = max(mega_rows, 1 << 20) // mega_rows * mega_rows  # whole megablocks per chunk
    for b0 in range(0, nb, step):
        b1 = min(b0 + step, nb)
        cnt = f.occ_super[np.arange(b0, b1) // BLOCKS_PER_SUPER] + f.occ_block[b0:b1]
        occf[b0:b1, 6:], m = rebase_mega(cnt, mega_shift)
        megas.append(m)
    return occf, np.concatenate(megas)


@dataclass(frozen=True)
class OccIndex:
    """The device-resident dense index: fused occ rows, cumulative counts,
    n, and in int64 mode the megablock bases."""

    occf: torch.Tensor  # (nb, 12) int32, contiguous
    acc: torch.Tensor  # (7,) int32 | int64
    n: int
    mega: torch.Tensor | None = None  # (n_mega, 6) int64 in int64 mode
    mega_shift: int = MEGA_BLOCK_SHIFT

    @property
    def device(self) -> torch.device:
        return self.occf.device

    @property
    def int64(self) -> bool:
        return self.mega is not None

    @property
    def dtype(self) -> torch.dtype:
        return self.acc.dtype

    @property
    def layout(self) -> str:
        return "dense64" if self.int64 else "dense32"

    @property
    def nbytes(self) -> int:
        """Bytes of the tables on the device."""
        return sum(t.numel() * t.element_size() for t in (self.occf, self.acc, self.mega) if t is not None)

    def kernel_tables(self) -> tuple:
        """(rows, esc, mega, acc, mega_shift, log2 block) as the C entry points take them."""
        return self.occf.data_ptr(), None, self.mega.data_ptr() if self.int64 else None, self.acc.data_ptr(), self.mega_shift, 6

    @classmethod
    def from_dense(cls, f: DenseFMIndex, device, int64: bool | None = None, mega_shift: int = MEGA_BLOCK_SHIFT) -> "OccIndex":
        """int64 None picks the width from n, as the JAX package does."""
        int64 = needs_int64(f.n) if int64 is None else int64
        occf, mega = build_occf(f, int64, mega_shift)
        return cls.from_jax_arrays(occf, f.acc, f.n, device, mega=mega, mega_shift=mega_shift)

    @classmethod
    def from_bwt(cls, bwt, device=None, int64: bool | None = None,
                 mega_shift: int = MEGA_BLOCK_SHIFT) -> "OccIndex":
        """The rows of a uint8 BWT, a tensor or a numpy array in host
        memory, built with torch ops on `device` (None: where the tensor
        lies), so a BWT on the card never visits the host: bit for bit
        `build_occf(DenseFMIndex.from_bwt(bwt))`, the padded last block and
        the extra row (k = n) included.  It goes FROM_BWT_BLOCKS rows a
        chunk: each chunk's symbols reach the device alone (a BWT in host
        memory never sits whole on the card), and the counts before each
        block are carried from chunk to chunk, so only one chunk's
        temporaries sit beside the rows.  int64 None picks the width from n."""
        if isinstance(bwt, np.ndarray):
            _check_host_bwt(bwt)
            dev = torch.device("cpu" if device is None else device)
        else:
            if bwt.dtype != torch.uint8 or bwt.dim() != 1:
                raise ValueError("from_bwt takes a 1-D uint8 BWT")
            dev = bwt.device if device is None else torch.device(device)
        n = len(bwt)
        int64 = needs_int64(n) if int64 is None else int64
        nb = n_rows(n)
        occf = torch.empty((nb, 12), dtype=torch.int32, device=dev)
        mega = torch.empty((((nb - 1) >> mega_shift) + 1, ASIZE), dtype=torch.int64, device=dev) if int64 else None
        carry = torch.zeros(ASIZE, dtype=torch.int64, device=dev)  # the symbols before the chunk
        for b0 in range(0, nb, FROM_BWT_BLOCKS):
            b1 = min(b0 + FROM_BWT_BLOCKS, nb)
            before, carry = _chunk_rows(_blocks(bwt, b0, b1, dev), occf[b0:b1], carry)
            if int64:  # the megablocks that start in this chunk take their bases here
                rows = 1 << mega_shift
                m0, m1 = -(-b0 // rows), ((b1 - 1) >> mega_shift) + 1
                mega[m0:m1] = before[torch.arange(m0, m1, device=dev) * rows - b0]
            _count_cols(occf[b0:b1], before, b0, mega, mega_shift)
        acc = torch.zeros(ASIZE + 1, dtype=torch.int64, device=dev)
        acc[1:] = torch.cumsum(carry, 0)
        if not int64:
            return cls(occf=occf, acc=acc.int(), n=n)
        return cls(occf=occf, acc=acc, n=n, mega=mega, mega_shift=int(mega_shift))

    @classmethod
    def from_jax_arrays(cls, occf: np.ndarray, acc: np.ndarray, n: int, device, mega: np.ndarray | None = None,
                        mega_shift: int = MEGA_BLOCK_SHIFT) -> "OccIndex":
        """From the arrays of a JAX `DeviceIndex` (`occf`, `acc`, and in int64
        mode `occ_super` as `mega`) as numpy."""
        occf = np.ascontiguousarray(occf)
        if occf.dtype != np.int32 or occf.ndim != 2 or occf.shape[1] != 12:
            raise ValueError(f"occf must be (nb, 12) int32, got {occf.shape} {occf.dtype}")
        nb = occf.shape[0]
        if np.shape(acc) != (ASIZE + 1,) or n < 0 or nb < n // BLOCK + 1:
            raise ValueError(f"inconsistent index: acc {np.shape(acc)}, n {n}, {nb} rows")
        if mega is None and needs_int64(n):
            raise ValueError(f"an index of {n} symbols needs int64 megablock rows")
        if mega is not None and np.shape(mega) != ((nb + (1 << mega_shift) - 1) >> mega_shift, ASIZE):
            raise ValueError(f"mega {np.shape(mega)} does not cover {nb} rows in megablocks of 2^{mega_shift}")
        return cls(
            occf=torch.tensor(occf, device=device),
            acc=torch.tensor(np.asarray(acc, dtype=np.int32 if mega is None else np.int64), device=device),
            n=int(n),
            mega=None if mega is None else torch.tensor(np.asarray(mega, np.int64), device=device),
            mega_shift=int(mega_shift),
        )

    def rank1a(self, k: torch.Tensor) -> torch.Tensor:
        k = k.long()
        return self.rank_row(k, self.occf[k >> 6])

    def rank_row(self, k: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
        """rank1a of int64 k from its row (..., 12) as gathered, the
        megablock base taken at k's global row k >> 6: sharded rows
        (parallel/mesh.py) gather it from the slab that owns it."""
        bi = k >> 6
        row = row.long()
        base = row[..., 6:12]
        if self.int64:  # uint32 megablock-relative: reinterpret, never sign-extend
            base = self.mega[bi >> self.mega_shift] + (base & U32)
        return base + _inblock_counts(row[..., :6] & U32, k & (BLOCK - 1))

    def sym_and_rank(self, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B[k], rank1a(k)) for each k in [0, n), as `lf` takes them."""
        return self.sym_at(k), self.rank1a(k)

    def sym_at(self, k: torch.Tensor) -> torch.Tensor:
        """The BWT symbol at each k in [0, n), from the row's bit-planes:
        bit k & 63 of the three planes is KEY[sym], and KEY is its own
        inverse (the nt6 complement).  Returns int64."""
        k = k.long()
        planes = self.occf[k >> 6][..., :6].long() & U32
        off = k & (BLOCK - 1)
        half = (off >= 32).long()
        key = torch.zeros_like(k)
        for plane in range(3):
            word = planes[..., 2 * plane : 2 * plane + 2].gather(-1, half[..., None])[..., 0]
            key |= ((word >> (off & 31)) & 1) << plane
        return torch.as_tensor(KEY, dtype=torch.int64, device=k.device)[key]


class HostBwtRows:
    """The dense rows of a BWT in host memory, built range by range on any
    device (`fill`), never whole: bit for bit the rows of
    `OccIndex.from_bwt`.  One pass over the array on the host (torch's
    bincount, FROM_BWT_BLOCKS rows a chunk) takes the counts before every
    FROM_BWT_BLOCKS-th row, so acc, the megablock bases (int64 rows) and the
    counts before any row (`counts_at`) cost one partial chunk's count; a
    range's rows are then from_bwt's chunked build started from the counts
    before its first row, its symbols uploaded chunk by chunk to the range's
    device.  It passes for an OccIndex with parallel/mesh.py ShardedRows,
    which fills each slab on the card that holds it (build --mesh on the
    host placement, construct/merge.py merge_host_mesh).  `filled` records
    (first row, rows, device, seconds) of each fill."""

    def __init__(self, bwt: np.ndarray, int64: bool | None = None, mega_shift: int = MEGA_BLOCK_SHIFT):
        _check_host_bwt(bwt)
        self.bwt, self.n, self.mega_shift = bwt, len(bwt), int(mega_shift)
        self.int64 = needs_int64(self.n) if int64 is None else int64
        self.shape = (n_rows(self.n), 12)
        step = FROM_BWT_BLOCKS * BLOCK
        marks = [np.zeros(ASIZE, np.int64)]  # marks[i]: the counts before symbol i x step
        for a in range(0, self.n, step):
            marks.append(marks[-1] + self._count(a, min(a + step, self.n)))
        self._marks = marks
        acc = np.zeros(ASIZE + 1, np.int64)
        acc[1:] = np.cumsum(marks[-1])
        self.acc = torch.from_numpy(acc if self.int64 else acc.astype(np.int32))
        n_mega = ((self.shape[0] - 1) >> self.mega_shift) + 1
        self.mega = torch.from_numpy(np.stack([self.counts_at(m << self.mega_shift) for m in range(n_mega)])) \
            if self.int64 else None
        self.filled: list[tuple[int, int, str, float]] = []

    @property
    def layout(self) -> str:
        return "dense64" if self.int64 else "dense32"

    def _count(self, a: int, b: int) -> np.ndarray:
        """Counts of each symbol in bwt[a:b]."""
        if b <= a:
            return np.zeros(ASIZE, np.int64)
        return torch.bincount(torch.from_numpy(np.array(self.bwt[a:b])), minlength=ASIZE)[:ASIZE].numpy()

    def counts_at(self, row: int) -> np.ndarray:
        """(6,) int64: the symbols before `row` (those of its blocks before it)."""
        pos = min(row * BLOCK, self.n)
        i = pos // (FROM_BWT_BLOCKS * BLOCK)
        return self._marks[i] + self._count(i * FROM_BWT_BLOCKS * BLOCK, pos)

    def fill(self, out: torch.Tensor, b0: int) -> None:
        """Rows [b0, b0 + len(out)) into `out` ((rows, 12) int32, on any
        device), built there, FROM_BWT_BLOCKS rows a chunk."""
        t = time.perf_counter()
        dev = out.device
        carry = torch.from_numpy(self.counts_at(b0)).to(dev)
        mega = self.mega.to(dev) if self.int64 else None
        for a in range(b0, b0 + len(out), FROM_BWT_BLOCKS):
            b = min(a + FROM_BWT_BLOCKS, b0 + len(out))
            part = out[a - b0 : b - b0]
            before, carry = _chunk_rows(_blocks(self.bwt, a, b, dev), part, carry)
            _count_cols(part, before, a, mega, self.mega_shift)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.filled.append((b0, len(out), str(dev), time.perf_counter() - t))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24


# FLIP[c, plane] = all ones where bit `plane` of keyed symbol c is 0: a plane
# word xor'ed with it has ones exactly where the keyed symbol's bit matches
FLIP = np.array([[0 if (c >> p) & 1 else U32 for p in range(3)] for c in range(ASIZE)], np.int64)
_FLIP_NT6 = FLIP[KEY]  # the same, row c for nt6 symbol c


def _inblock_counts(planes: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """planes: (..., 6) int64 words in [0, 2^32); off: (...,) int64 in
    [0, 63].  Returns (..., 6) int64 counts of each symbol below off."""
    one = torch.ones_like(off)
    masks = torch.stack(
        [(one << off.clamp(max=32)) - 1, (one << (off - 32).clamp(min=0)) - 1], dim=-1
    )  # (..., 2) lo/hi; off = 32 gives 2^32 - 1: all ones
    p = planes.unflatten(-1, (3, 2))[..., None, :, :]  # (..., 1, plane, half)
    eq = p ^ torch.as_tensor(_FLIP_NT6, device=planes.device)[:, :, None]  # (..., 6, plane, half)
    eq = eq[..., 0, :] & eq[..., 1, :] & eq[..., 2, :] & masks[..., None, :]
    return popcount32(eq).sum(-1)


def rank1a(idx, k: torch.Tensor) -> torch.Tensor:
    """occ[..., c] = |{i < k : B[i] = c}| for k in [0, n].  Returns int64."""
    return idx.rank1a(k)


def lf(idx, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LF step from each k in [0, n): (c = B[k], acc[c] + occ_c(k)),
    as index/dense.py DenseFMIndex.lf, on an index with `sym_and_rank`.
    Returns two int64 tensors."""
    c, occ = idx.sym_and_rank(k)
    return c, idx.acc.long()[c] + occ.gather(-1, c[..., None])[..., 0]


def _rank_pair(idx, prim: torch.Tensor, size: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """rank1a at prim and at prim + size, as one gather."""
    t = idx.rank1a(torch.stack([prim, prim + size]))
    return t[0], t[1] - t[0]


def _prim_sec(ik: torch.Tensor, is_back: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.where(is_back, ik[..., 0], ik[..., 1]), torch.where(is_back, ik[..., 1], ik[..., 0])


def extend(idx, ik: torch.Tensor, is_back: torch.Tensor) -> torch.Tensor:
    """Bidirectional extension of bi-intervals ik (..., 3) = (x0, x1, size)
    by every symbol; is_back (...,) bool per row.  Returns (..., 6, 3) int64."""
    ik = ik.long()
    prim, sec = _prim_sec(ik, is_back)
    tk, sz = _rank_pair(idx, prim, ik[..., 2])
    prim_out = idx.acc[:ASIZE].long() + tk
    key = torch.as_tensor(KEY, dtype=torch.int64, device=ik.device)
    before = key[None, :] < key[:, None]  # before[c, p]: p precedes c in the complement order
    sec_out = sec[..., None] + (sz[..., None, :] * before).sum(-1)
    back = is_back[..., None]
    return torch.stack([torch.where(back, prim_out, sec_out), torch.where(back, sec_out, prim_out), sz], dim=-1)


def extend_c(idx, ik: torch.Tensor, c: torch.Tensor, is_back: torch.Tensor) -> torch.Tensor:
    """Extension by ONE symbol c (...,) in 0..5 per row; same values as
    `extend(...)[..., c, :]`.  Returns (..., 3) int64."""
    ik, c = ik.long(), c.long()
    prim, sec = _prim_sec(ik, is_back)
    tk, sz = _rank_pair(idx, prim, ik[..., 2])
    key = torch.as_tensor(KEY, dtype=torch.int64, device=ik.device)
    before = key[None, :] < key[c][..., None]  # (..., 6)
    sec_out = sec + (sz * before).sum(-1)
    prim_out = idx.acc.long()[c] + tk.gather(-1, c[..., None])[..., 0]
    szc = sz.gather(-1, c[..., None])[..., 0]
    return torch.stack([torch.where(is_back, prim_out, sec_out), torch.where(is_back, sec_out, prim_out), szc], dim=-1)


def set_intv(idx, c: torch.Tensor) -> torch.Tensor:
    """Initial bi-interval (acc[c], acc[comp c], count of c) of each symbol
    c (...,) (fm-index.h:90-93).  Returns (..., 3) int64."""
    c = c.long()
    acc = idx.acc.long()
    comp = torch.where((c == 0) | (c == 5), c, 5 - c)
    return torch.stack([acc[c], acc[comp], acc[c + 1] - acc[c]], dim=-1)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/occ_rank.cu), one per layout: dense32, dense64, rb32, rb64
# ---------------------------------------------------------------------------


def check_positions(idx, k: torch.Tensor) -> None:
    if k.numel() and (int(k.min()) < 0 or int(k.max()) > idx.n):
        raise ValueError(f"rank position outside [0, {idx.n}]")


def rank1a_cuda(idx, k: torch.Tensor) -> torch.Tensor:
    """rank1a of k (N,) int64 through the occ_rank1a kernel of the index's
    layout: (N, 6) in the index's width.  A CPU tensor takes the plain
    version."""
    if k.device != idx.device or k.dtype != torch.int64 or k.dim() != 1:
        raise ValueError("k must be a 1-D int64 tensor on the index's device")
    check_positions(idx, k)
    if k.device.type == "cpu":
        return idx.rank1a(k).to(idx.dtype)
    k = k.contiguous()
    out = torch.empty((k.numel(), ASIZE), dtype=idx.dtype, device=k.device)
    if k.numel():
        kernels.launch(f"rb3c_occ_rank1a_{idx.layout}", k.device, *idx.kernel_tables(), k.data_ptr(), k.numel(), out.data_ptr())
        rank1a_cuda.launches[idx.layout] += 1
    return out


rank1a_cuda.launches = Counter()


def extend_c_cuda(idx, ik: torch.Tensor, c: torch.Tensor, is_back: torch.Tensor) -> torch.Tensor:
    """extend_c of ik (N, 3) in the index's width by c (N,) int32 in 0..5,
    is_back (N,) bool, through the occ_extend_c kernel of the index's
    layout: (N, 3) in the index's width.  Every interval must satisfy
    0 <= lo, lo + size <= n.  A CPU tensor takes the plain version."""
    N = ik.shape[0]
    if ik.shape != (N, 3) or c.shape != (N,) or is_back.shape != (N,):
        raise ValueError("extend_c_cuda takes ik (N, 3), c (N,), is_back (N,)")
    if ik.dtype != idx.dtype or c.dtype != torch.int32 or is_back.dtype != torch.bool:
        raise ValueError(f"extend_c_cuda takes {idx.dtype} ik, int32 c and a bool is_back")
    if not all(t.device == idx.device for t in (ik, c, is_back)):
        raise ValueError("extend_c_cuda: tensors must be on the index's device")
    prim, _ = _prim_sec(ik, is_back)
    check_positions(idx, torch.cat([prim.long(), prim.long() + ik[:, 2]]))
    if N and (int(c.min()) < 0 or int(c.max()) >= ASIZE):
        raise ValueError("extend_c_cuda: symbols must be nt6 codes 0..5")
    if ik.device.type == "cpu":
        return extend_c(idx, ik, c, is_back).to(idx.dtype)
    ik, c, is_back = ik.contiguous(), c.contiguous(), is_back.contiguous()
    out = torch.empty((N, 3), dtype=idx.dtype, device=ik.device)
    if N:
        kernels.launch(
            f"rb3c_occ_extend_c_{idx.layout}", ik.device, *idx.kernel_tables(), ik.data_ptr(), c.data_ptr(),
            is_back.data_ptr(), N, out.data_ptr(),
        )
        extend_c_cuda.launches[idx.layout] += 1
    return out


extend_c_cuda.launches = Counter()


def lf_cuda(idx, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`lf` of k (N,) int64 in [0, n) through the occ_lf kernel of the
    index's layout (the LF step K5's and K11's walks inline): (c (N,)
    int32, LF(k) (N,) in the index's width).  A CPU tensor takes the plain
    version."""
    if k.device != idx.device or k.dtype != torch.int64 or k.dim() != 1:
        raise ValueError("k must be a 1-D int64 tensor on the index's device")
    if k.numel() and (int(k.min()) < 0 or int(k.max()) >= idx.n):
        raise ValueError(f"LF position outside [0, {idx.n})")
    if k.device.type == "cpu":
        c, nk = lf(idx, k)
        return c.int(), nk.to(idx.dtype)
    k = k.contiguous()
    c = torch.empty(k.numel(), dtype=torch.int32, device=k.device)
    nk = torch.empty(k.numel(), dtype=idx.dtype, device=k.device)
    if k.numel():
        kernels.launch(f"rb3c_occ_lf_{idx.layout}", k.device, *idx.kernel_tables(), k.data_ptr(), k.numel(),
                       c.data_ptr(), nk.data_ptr())
        lf_cuda.launches[idx.layout] += 1
    return c, nk


lf_cuda.launches = Counter()
