"""Fused occ rows on a torch device, with rank and bidirectional extension.

Port of ropebwt3_tpu/ops/rank.py (int32 mode).  The dense host index
(index/dense.py) is uploaded as ONE row table:
  occf : (n_blocks + 1, 12) int32 — 3 keyed bit-planes x 2 words (cols 0:6),
         then the counts of symbols 0..5 before the block (cols 6:12)
  acc  : (7,) int32 — cumulative symbol counts
so a rank is one 48-byte row load plus masks and popcounts.

`rank1a`, `extend`, `extend_c` and `set_intv` are the plain PyTorch versions
(the CPU path and the reference the CUDA routine is held against); torch has
no popcount and no uint32 shifts on the CPU, so they work in int64 with a
SWAR popcount.  `rank1a_cuda` / `extend_c_cuda` wrap the occ_rank kernels
(csrc/occ_rank.cu), which run the device routine of csrc/occ.cuh that the
SMEM kernel inlines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ropebwt3_tpu.index.dense import BLOCK, BLOCKS_PER_SUPER, DenseFMIndex

from .. import kernels

ASIZE = 6
# bidirectional-extend complement order: the secondary coordinate accumulates
# sizes in the order 0,4,3,2,1,5 (rld_extend, rld0.c:495-500)
EXT_ORDER = (0, 4, 3, 2, 1, 5)
# KEY[sym] = position of sym in the complement order (== the nt6 complement).
# Bit-planes hold KEY[sym], not sym (ropebwt3_tpu/ops/rank.py:33-40).
KEY = np.zeros(ASIZE, dtype=np.uint8)
for _pos, _c in enumerate(EXT_ORDER):
    KEY[_c] = _pos
# int32 row counts: the JAX package switches to int64 megablock rows here
# (ropebwt3_tpu/ops/rank.py:146); the port has only the int32 layout so far
MAX_N_INT32 = (1 << 31) - (1 << 20)
_U32 = 0xFFFFFFFF


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


def build_occf(f: DenseFMIndex) -> np.ndarray:
    """Host-side fused row table (nb, 12) int32 with absolute counts."""
    nb = len(f.occ_block)
    occf = np.empty((nb, 12), np.int32)
    occf[:, :6] = pack_bitplanes(f.bwt[: nb * BLOCK].reshape(nb, BLOCK)).view(np.int32)
    occf[:, 6:] = np.repeat(f.occ_super, BLOCKS_PER_SUPER, axis=0)[:nb] + f.occ_block
    return occf


@dataclass(frozen=True)
class OccIndex:
    """The device-resident index: fused occ rows, cumulative counts, n."""

    occf: torch.Tensor  # (nb, 12) int32, contiguous
    acc: torch.Tensor  # (7,) int32
    n: int

    @property
    def device(self) -> torch.device:
        return self.occf.device

    @classmethod
    def from_dense(cls, f: DenseFMIndex, device) -> "OccIndex":
        if f.n >= MAX_N_INT32:
            raise ValueError(f"index of {f.n} symbols needs int64 megablock rows, which the port does not have yet")
        return cls.from_jax_arrays(build_occf(f), f.acc, f.n, device)

    @classmethod
    def from_jax_arrays(cls, occf: np.ndarray, acc: np.ndarray, n: int, device) -> "OccIndex":
        """From the arrays of a JAX `DeviceIndex` (int32 mode) as numpy."""
        occf = np.ascontiguousarray(occf)
        if occf.dtype != np.int32 or occf.ndim != 2 or occf.shape[1] != 12:
            raise ValueError(f"occf must be (nb, 12) int32, got {occf.shape} {occf.dtype}")
        if np.shape(acc) != (ASIZE + 1,) or not 0 <= n < MAX_N_INT32 or occf.shape[0] < n // BLOCK + 1:
            raise ValueError(f"inconsistent index: acc {np.shape(acc)}, n {n}, {occf.shape[0]} rows")
        return cls(
            occf=torch.tensor(occf, device=device),
            acc=torch.tensor(np.asarray(acc, dtype=np.int32), device=device),
            n=int(n),
        )


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


# _FLIP[c, plane] = all ones where bit `plane` of KEY[c] is 0: a plane word
# xor'ed with it has ones exactly where the keyed symbol's bit matches
_FLIP = np.array([[0 if (int(KEY[c]) >> p) & 1 else _U32 for p in range(3)] for c in range(ASIZE)], np.int64)


def _inblock_counts(planes: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """planes: (..., 6) int64 words in [0, 2^32); off: (...,) int64 in
    [0, 63].  Returns (..., 6) int64 counts of each symbol below off."""
    one = torch.ones_like(off)
    masks = torch.stack(
        [(one << off.clamp(max=32)) - 1, (one << (off - 32).clamp(min=0)) - 1], dim=-1
    )  # (..., 2) lo/hi; off = 32 gives 2^32 - 1: all ones
    p = planes.unflatten(-1, (3, 2))[..., None, :, :]  # (..., 1, plane, half)
    eq = p ^ torch.as_tensor(_FLIP, device=planes.device)[:, :, None]  # (..., 6, plane, half)
    eq = eq[..., 0, :] & eq[..., 1, :] & eq[..., 2, :] & masks[..., None, :]
    return _popcount32(eq).sum(-1)


def rank1a(idx: OccIndex, k: torch.Tensor) -> torch.Tensor:
    """occ[..., c] = |{i < k : B[i] = c}| for k in [0, n].  Returns int64."""
    k = k.long()
    row = idx.occf[k >> 6].long()
    return row[..., 6:12] + _inblock_counts(row[..., :6] & _U32, k & (BLOCK - 1))


def _rank_pair(idx: OccIndex, prim: torch.Tensor, size: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """rank1a at prim and at prim + size, as one gather."""
    t = rank1a(idx, torch.stack([prim, prim + size]))
    return t[0], t[1] - t[0]


def _prim_sec(ik: torch.Tensor, is_back: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.where(is_back, ik[..., 0], ik[..., 1]), torch.where(is_back, ik[..., 1], ik[..., 0])


def extend(idx: OccIndex, ik: torch.Tensor, is_back: torch.Tensor) -> torch.Tensor:
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


def extend_c(idx: OccIndex, ik: torch.Tensor, c: torch.Tensor, is_back: torch.Tensor) -> torch.Tensor:
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


def set_intv(idx: OccIndex, c: torch.Tensor) -> torch.Tensor:
    """Initial bi-interval (acc[c], acc[comp c], count of c) of each symbol
    c (...,) (fm-index.h:90-93).  Returns (..., 3) int64."""
    c = c.long()
    acc = idx.acc.long()
    comp = torch.where((c == 0) | (c == 5), c, 5 - c)
    return torch.stack([acc[c], acc[comp], acc[c + 1] - acc[c]], dim=-1)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/occ_rank.cu)
# ---------------------------------------------------------------------------


def _check_k(idx: OccIndex, k: torch.Tensor) -> None:
    if k.numel() and (int(k.min()) < 0 or int(k.max()) > idx.n):
        raise ValueError(f"rank position outside [0, {idx.n}]")


def rank1a_cuda(idx: OccIndex, k: torch.Tensor) -> torch.Tensor:
    """rank1a of k (N,) int64 through the occ_rank1a kernel: (N, 6) int32.
    A CPU tensor takes the plain version."""
    if k.device != idx.device or k.dtype != torch.int64 or k.dim() != 1:
        raise ValueError("k must be a 1-D int64 tensor on the index's device")
    _check_k(idx, k)
    if k.device.type == "cpu":
        return rank1a(idx, k).int()
    k = k.contiguous()
    out = torch.empty((k.numel(), ASIZE), dtype=torch.int32, device=k.device)
    if k.numel():
        kernels.launch("rb3c_occ_rank1a", k.device, idx.occf.data_ptr(), k.data_ptr(), k.numel(), out.data_ptr())
        rank1a_cuda.launches += 1
    return out


rank1a_cuda.launches = 0


def extend_c_cuda(idx: OccIndex, ik: torch.Tensor, c: torch.Tensor, is_back: torch.Tensor) -> torch.Tensor:
    """extend_c of ik (N, 3) int32 by c (N,) int32 in 0..5, is_back (N,)
    bool, through the occ_extend_c kernel: (N, 3) int32.  Every interval
    must satisfy 0 <= lo, lo + size <= n.  A CPU tensor takes the plain
    version."""
    N = ik.shape[0]
    if ik.shape != (N, 3) or c.shape != (N,) or is_back.shape != (N,):
        raise ValueError("extend_c_cuda takes ik (N, 3), c (N,), is_back (N,)")
    if ik.dtype != torch.int32 or c.dtype != torch.int32 or is_back.dtype != torch.bool:
        raise ValueError("extend_c_cuda takes int32 ik and c and a bool is_back")
    if not all(t.device == idx.device for t in (ik, c, is_back)):
        raise ValueError("extend_c_cuda: tensors must be on the index's device")
    prim, _ = _prim_sec(ik, is_back)
    _check_k(idx, torch.cat([prim.long(), prim.long() + ik[:, 2]]))
    if N and (int(c.min()) < 0 or int(c.max()) >= ASIZE):
        raise ValueError("extend_c_cuda: symbols must be nt6 codes 0..5")
    if ik.device.type == "cpu":
        return extend_c(idx, ik, c, is_back).int()
    ik, c, is_back = ik.contiguous(), c.contiguous(), is_back.contiguous()
    out = torch.empty((N, 3), dtype=torch.int32, device=ik.device)
    if N:
        kernels.launch(
            "rb3c_occ_extend_c", ik.device, idx.occf.data_ptr(), idx.acc.data_ptr(), ik.data_ptr(), c.data_ptr(),
            is_back.data_ptr(), N, out.data_ptr(),
        )
        extend_c_cuda.launches += 1
    return out


extend_c_cuda.launches = 0
