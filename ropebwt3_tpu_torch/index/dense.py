"""Dense occurrence-checkpoint FM-index on the host, copied from
ropebwt3_tpu/index/dense.py: the BWT as one byte per symbol plus two-level
occurrence checkpoints (uint16 per-block counts every BLOCK symbols relative
to int64 superblock counts every SUPER symbols).  The port builds its device
rows (ops/rank.py, ops/runblock.py) and runs the native multi-locate
(native/locate.cpp) on these arrays; the `.dense` sidecar (sidecar.py)
stores them in the JAX package's format.  The tables are built natively
(native/rld_codec.cpp), as the JAX package does when its library loads.
The numpy rank, bidirectional extend and LF (`rank1a`, `extend`, ...) serve
the host algorithms: `--old-mem` (ops/smem_ref.py) and the Python BWA-SW DP
of the debug streams (align/bwasw.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .. import native

ASIZE = 6
BLOCK = 64
SUPER = 1 << 16
BLOCKS_PER_SUPER = SUPER // BLOCK


def runs_of_bwt(bwt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run-length encode a raw BWT array: (symbols uint8, lengths int64)."""
    if len(bwt) == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(bwt[1:] != bwt[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [len(bwt)]))
    return bwt[starts].copy(), (ends - starts).astype(np.int64)


@dataclass
class DenseFMIndex:
    bwt: np.ndarray  # uint8 [n_pad], padded with zeros beyond n
    n: int
    acc: np.ndarray  # int64 [7] cumulative symbol counts (C-array), acc[0]=0
    occ_block: np.ndarray  # uint16 [n_blocks+1, 6], counts in [super_start, block_start)
    occ_super: np.ndarray  # int64 [n_supers+1, 6], counts before superblock
    # lazily attached extras
    ssa: object | None = field(default=None, repr=False)
    sid: object | None = field(default=None, repr=False)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_bwt(cls, bwt: np.ndarray) -> "DenseFMIndex":
        bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
        n = len(bwt)
        n_blocks = (n + BLOCK - 1) // BLOCK
        n_pad = (n_blocks + 1) * BLOCK
        b = np.zeros(n_pad, dtype=np.uint8)
        b[:n] = bwt
        # one-pass native table build (ropebwt3_tpu/index/dense.py:47-69)
        n_supers = (n_blocks + BLOCKS_PER_SUPER - 1) // BLOCKS_PER_SUPER
        occ_block = np.empty((n_blocks + 1, ASIZE), dtype=np.uint16)
        occ_super = np.empty((n_supers + 1, ASIZE), dtype=np.int64)
        acc = np.zeros(ASIZE + 1, dtype=np.int64)
        native.lib().rb3t_dense_tables(b.ctypes.data, n, n_blocks, n_supers, occ_block.ctypes.data,
                                       occ_super.ctypes.data, acc.ctypes.data, os.cpu_count() or 1)
        return cls(bwt=b, n=n, acc=acc, occ_block=occ_block, occ_super=occ_super)

    @classmethod
    def from_runs(cls, syms: np.ndarray, lens: np.ndarray) -> "DenseFMIndex":
        syms = np.ascontiguousarray(syms, dtype=np.uint8)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        bwt = np.empty(int(lens.sum()), dtype=np.uint8)
        native.lib().rb3t_runs_expand(syms.ctypes.data, lens.ctypes.data, len(syms), bwt.ctypes.data)
        return cls.from_bwt(bwt)

    @property
    def n_runs(self) -> int:
        b = self.bwt[: self.n]
        if self.n == 0:
            return 0
        return int(1 + np.count_nonzero(b[1:] != b[:-1]))

    # -- rank, extend and LF on the host (ropebwt3_tpu/index/dense.py:159-242)
    def rank1a(self, k) -> np.ndarray:
        """occ[c] = |{i < k : B[i] = c}| for all c; vectorized over array k.

        Returns shape k.shape + (6,)."""
        k = np.minimum(np.asarray(k, dtype=np.int64), self.n)
        blk_i = k // BLOCK
        sup_i = blk_i // BLOCKS_PER_SUPER
        base = self.occ_super[sup_i] + self.occ_block[blk_i].astype(np.int64)
        blks = self.bwt[(blk_i[..., None] * BLOCK + np.arange(BLOCK)).reshape(-1)].reshape(*k.shape, BLOCK)
        off = (k % BLOCK)[..., None]
        inpref = np.arange(BLOCK) < off
        add = np.stack([((blks == c) & inpref).sum(axis=-1) for c in range(ASIZE)], axis=-1)
        return base + add

    def rank2a(self, k, l) -> tuple[np.ndarray, np.ndarray]:
        return self.rank1a(k), self.rank1a(l)

    def symbol_at(self, k) -> np.ndarray:
        return self.bwt[np.asarray(k, dtype=np.int64)]

    def extend(self, ik: np.ndarray, is_back: bool) -> np.ndarray:
        """ik: [..., 3] int64 rows (x0, x1, size) = (backward lo, forward lo, size).
        Returns ok: [..., 6, 3] for each next symbol, replicating the exact
        complement-order prefix sums of rld_extend (rld0.c:486-502)."""
        ik = np.asarray(ik, dtype=np.int64)
        prim = 0 if is_back else 1  # index of x[!is_back]
        sec = 1 - prim
        tk = self.rank1a(ik[..., prim])
        tl = self.rank1a(ik[..., prim] + ik[..., 2])
        sz = tl - tk  # [..., 6]
        ok = np.zeros(ik.shape[:-1] + (ASIZE, 3), dtype=np.int64)
        ok[..., :, prim] = self.acc[:ASIZE] + tk
        ok[..., :, 2] = sz
        o = ik[..., sec]
        for c, prev in ((0, None), (4, 0), (3, 4), (2, 3), (1, 2), (5, 1)):
            if prev is not None:
                o = o + sz[..., prev]
            ok[..., c, sec] = o
        return ok

    def set_intv(self, c: int) -> np.ndarray:
        """Initial bi-interval of single symbol c (fm-index.h:90-93)."""
        comp = 5 - c if 1 <= c <= 4 else c
        return np.array([self.acc[c], self.acc[comp], self.acc[c + 1] - self.acc[c]], dtype=np.int64)

    def lf(self, k) -> tuple[np.ndarray, np.ndarray]:
        """Return (symbol at k, LF(k)) vectorized."""
        k = np.asarray(k, dtype=np.int64)
        ok = self.rank1a(k)
        c = self.bwt[k].astype(np.int64)
        return c, self.acc[c] + np.take_along_axis(ok, c[..., None], axis=-1)[..., 0]

    def is_symmetric(self) -> bool:
        a = self.acc
        return (a[1] & 1) == 0 and a[2] - a[1] == a[5] - a[4] and a[3] - a[2] == a[4] - a[3]
