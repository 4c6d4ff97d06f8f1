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
    BWT and the rows it returns: its (nb + 1, 6) int64 counts, room for a
    scan's copy of them, and one chunk's temporaries (< 32 B a symbol)."""
    nb = n // BLOCK + 2
    return 2 * 48 * nb + 32 * BLOCK * min(nb, FROM_BWT_BLOCKS)


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
    def from_bwt(cls, bwt: torch.Tensor, device=None, int64: bool | None = None,
                 mega_shift: int = MEGA_BLOCK_SHIFT) -> "OccIndex":
        """The rows of a uint8 BWT tensor, built with torch ops where it
        lies (or on `device`), so a BWT on the card never visits the host:
        bit for bit `build_occf(DenseFMIndex.from_bwt(bwt))`, the padded last
        block and the extra row (k = n) included.  Chunks of FROM_BWT_BLOCKS
        rows keep the int64 temporaries small.  int64 None picks the width
        from n."""
        bwt = bwt.to(device) if device is not None else bwt
        if bwt.dtype != torch.uint8 or bwt.dim() != 1:
            raise ValueError("from_bwt takes a 1-D uint8 BWT")
        dev, n = bwt.device, bwt.numel()
        int64 = needs_int64(n) if int64 is None else int64
        nb = (n + BLOCK - 1) // BLOCK + 1
        occf = torch.empty((nb, 12), dtype=torch.int32, device=dev)
        cnt = torch.zeros((nb + 1, ASIZE), dtype=torch.int64, device=dev)  # row i + 1: symbols in block i
        key = torch.as_tensor(np.append(KEY, 0), dtype=torch.int64, device=dev)  # padding (6) keys as 0
        shifts = torch.arange(32, dtype=torch.int64, device=dev)
        for b0 in range(0, nb, FROM_BWT_BLOCKS):
            b1 = min(b0 + FROM_BWT_BLOCKS, nb)
            blk = torch.full(((b1 - b0) * BLOCK,), ASIZE, dtype=torch.uint8, device=dev)
            part = bwt[b0 * BLOCK : min(b1 * BLOCK, n)]
            blk[: part.numel()] = part
            blk = blk.view(b1 - b0, BLOCK)
            keyed = key[blk.long()].view(b1 - b0, 2, 32)
            for plane in range(3):
                words = (((keyed >> plane) & 1) << shifts).sum(-1)  # (rows, 2) in [0, 2^32)
                occf[b0:b1, 2 * plane : 2 * plane + 2] = _as_int32(words)
            for c in range(ASIZE):
                cnt[b0 + 1 : b1 + 1, c] = (blk == c).sum(1)
            del blk, keyed  # before the next chunk's
        cnt.cumsum_(0)  # in place: row i counts the symbols before block i
        before = cnt[:nb]
        acc = torch.zeros(ASIZE + 1, dtype=torch.int64, device=dev)
        acc[1:] = torch.cumsum(cnt[nb], 0)
        if not int64:
            occf[:, 6:] = before
            return cls(occf=occf, acc=acc.int(), n=n)
        rows = 1 << mega_shift
        mega = before[::rows].clone()
        full = nb // rows * rows  # rebased in place, megablock by megablock
        before[:full].view(-1, rows, ASIZE).sub_(mega[: full // rows, None])
        before[full:].sub_(mega[-1])
        if int(before.max()) > U32:
            raise ValueError(f"a megablock of 2^{mega_shift} rows holds more than 2^32 symbols")
        occf[:, 6:] = before.view(torch.int32)[:, 0::2]  # the low 32 bits (little-endian), as _as_int32 gives them
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
        bi = k >> 6
        row = self.occf[bi].long()
        base = row[..., 6:12]
        if self.int64:  # uint32 megablock-relative: reinterpret, never sign-extend
            base = self.mega[bi >> self.mega_shift] + (base & U32)
        return base + _inblock_counts(row[..., :6] & U32, k & (BLOCK - 1))

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
    as index/dense.py DenseFMIndex.lf, on an index with `sym_at` and
    `rank1a`.  Returns two int64 tensors."""
    c = idx.sym_at(k)
    occ = idx.rank1a(k).gather(-1, c[..., None])[..., 0]
    return c, idx.acc.long()[c] + occ


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
