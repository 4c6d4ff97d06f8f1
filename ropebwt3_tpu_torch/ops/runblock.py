"""Run-block compressed occ rows on a torch device — the capacity format.

Port of ropebwt3_tpu/ops/runblock.py.  Per block of S symbols (S a power of
two in 256..8192, picked per index by `choose_S`) ONE 160-byte row:

    cols 0:6   counts of symbols 0..5 before the block (absolute int32 below
               MAX_N_INT32 symbols; above, uint32 relative to the containing
               megablock of 2^mega_shift rows, with int64 bases in `mega`)
    col  6     dense-escape row index, or -1 for a run-coded block
    col  7     pad
    cols 8:40  64 packed uint16 run records (cumulative in-block end << 3) |
               keyed symbol, padded with zero-length records

plus, for blocks of more than 64 split runs, a dense escape.  The host
format (`build_runblock_np`, the `.rb.npz` cache) keeps the JAX package's
three keyed bit-planes of S/32 int32 words (3S/8 B a block), so either
package reads a cache the other wrote.  The uploaded `RunBlockIndex`, on the
CPU as on the card, holds each escape as S/128 sub-rows of 64 B
(`pack_escapes`, S/2 B a block):

    words 0:3   six uint16 keyed counts of the block's symbols before the
                sub-row (at most S - 128 = 8064), two a word, low half first
    word  3     pad
    words 4:16  the four words of planes 0, 1, 2 that cover its 128 symbols

so an escape rank reads one 64-B sub-row, not the planes below its offset.
Dense rows cost 0.75 B/sym; these cost ~160/S B/sym plus escapes, some
0.02-0.3 B/sym on pangenomes.

Two faults of the JAX reference are fixed here, not copied:
  F1  a position k at a block boundary (k = n included) is ranked at offset
      S of block (k-1)//S, and k = 0 at block 0; no row past the table is
      read.  The reference ranks k = n at row n//S, which its gather clamps
      to the last row with offset 0, dropping that block when S divides n.
  F4  a record end of 0 decodes as S: a run reaching the end of an
      8192-symbol block stores 8192 << 3 = 65536, which uint16 keeps as 0.
      No real record ends at 0, since every run in a block has length >= 1.
The `.rb.npz` cache is used only when its n, S and width match and it is no
older than the index's sidecar (F3).

`RunBlockIndex.rank1a` is the plain decode, from the same sub-rows the card
reads, and `sym_and_rank` the symbol at k from two of its ranks; `extend`,
`extend_c`, `set_intv` and `lf` of ops/rank.py take this index as they take
`OccIndex`, and so do the kernel wrappers, which launch the rb32 / rb64
kernels (csrc/rb.cuh).  The host builder calls the native
`rb3t_runblock_count` / `_fill` (../native/rld_codec.cpp, the port's copy of
the JAX package's builder).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..index.dense import runs_of_bwt
from .rank import ASIZE, FLIP, KEY, U32, extend, extend_c, needs_int64, popcount32, rank1a, rebase_mega, set_intv

__all__ = ["RunBlockIndex", "rank1a", "extend", "extend_c", "set_intv", "choose_S", "build_runblock_np", "runs_from_dense",
           "pack_escapes", "pack_temp_bytes", "device_bytes", "shard_layout"]

RB_R = 64  # run records per row
RB_COLS = 40
SUB = 128  # symbols per escape sub-row
SUB_WORDS = 16  # int32 words per escape sub-row: 3 of counts, a pad, 3 planes x 4
PACK_WORDS = 1 << 22  # int64 words of temporaries per chunk of `pack_escapes`
S_CHOICES = (8192, 4096, 2048, 1024, 512, 256)


def default_mega_shift(S: int) -> int:
    """log2 of the rows in a 2^32-symbol megablock (the native builder's)."""
    return 32 - (S.bit_length() - 1)


@dataclass(frozen=True)
class RunBlockIndex:
    rows: torch.Tensor  # (nb, 40) int32
    esc: torch.Tensor  # (max(n_esc, 1), S / 128, 16) int32 escape sub-rows (`pack_escapes`)
    acc: torch.Tensor  # (7,) int32 | int64
    n: int
    S: int
    mega: torch.Tensor | None = None  # (n_mega, 6) int64 in int64 mode
    mega_shift: int = 0  # log2 rows per megablock (int64 mode)

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def int64(self) -> bool:
        return self.mega is not None

    @property
    def dtype(self) -> torch.dtype:
        return self.acc.dtype

    @property
    def layout(self) -> str:
        return "rb64" if self.int64 else "rb32"

    @property
    def n_esc(self) -> int:
        return int((self.rows[:, 6] >= 0).sum())

    @property
    def nbytes(self) -> int:
        """Bytes of the tables on the device."""
        return sum(t.numel() * t.element_size() for t in (self.rows, self.esc, self.acc, self.mega) if t is not None)

    def kernel_tables(self) -> tuple:
        """(rows, esc, mega, acc, mega_shift, log2 S) as the C entry points take them."""
        mega = self.mega.data_ptr() if self.int64 else None
        return self.rows.data_ptr(), self.esc.data_ptr(), mega, self.acc.data_ptr(), self.mega_shift, self.S.bit_length() - 1

    @classmethod
    def from_np(cls, d: dict, device) -> "RunBlockIndex":
        """Upload the pieces that `build_runblock_np` returns, the escape
        planes packed into sub-rows on the device."""
        S, n, rows = int(d["S"]), int(d["n"]), d["rows"]
        if S not in S_CHOICES or rows.shape != ((n + S - 1) // S, RB_COLS) or d["esc"].shape[1:] != (3 * S // 32,):
            raise ValueError(f"inconsistent rb rows: S {S}, n {n}, rows {rows.shape}, esc {d['esc'].shape}")
        if d["mega"] is None and needs_int64(n):
            raise ValueError(f"an index of {n} symbols needs int64 megablock rows")
        if len(rows) and not -1 <= int(rows[:, 6].min()) <= int(rows[:, 6].max()) < len(d["esc"]):
            raise ValueError("an escape row index points past the escape table")
        return cls(
            rows=torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(device),
            esc=pack_escapes(d["esc"], S, device),
            acc=torch.from_numpy(np.asarray(d["acc"], np.int64 if d["int64"] else np.int32)).to(device),
            n=n,
            S=S,
            mega=None if d["mega"] is None else torch.from_numpy(np.asarray(d["mega"], np.int64)).to(device),
            mega_shift=int(d["mega_shift"]),
        )

    @classmethod
    def from_dense(cls, f, device, S: int | None = None, int64: bool | None = None, mega_shift: int | None = None,
                   cache: str | bool | None = True) -> "RunBlockIndex":
        return cls.from_np(from_dense_np(f, S=S, int64=int64, mega_shift=mega_shift, cache=cache), device)

    def block_and_offset(self, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(row, offset in [0, S]) of positions k in [0, n]: a block
        boundary is the end of the block before it (F1)."""
        sh = self.S.bit_length() - 1
        bi = ((k - 1) >> sh).clamp(min=0)
        return bi, k - (bi << sh)

    def rank1a(self, k: torch.Tensor) -> torch.Tensor:
        k = k.long()
        return self.rank_row(k, self.rows[self.block_and_offset(k)[0]])

    def sym_at(self, k: torch.Tensor) -> torch.Tensor:
        """The BWT symbol at each k in [0, n) (int64)."""
        return self.sym_and_rank(k)[0]

    def sym_and_rank(self, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B[k], rank1a(k)) for each k in [0, n), as ops/rank.py `lf`
        takes them: the symbol is the one column where rank1a(k + 1) -
        rank1a(k) is 1 (csrc/rb.cuh decodes it from its block instead), both
        ranks in one gather.  Both int64."""
        k = k.long()
        r = self.rank1a(torch.stack([k, k + 1]))
        return (r[1] - r[0]).argmax(-1), r[0]

    def rank_row(self, k: torch.Tensor, row: torch.Tensor, sub: torch.Tensor | None = None) -> torch.Tensor:
        """rank1a of int64 k from its row (..., 40) as gathered, the offset
        and the megablock base taken at k's global row; an escape block from
        `sub`, its sub-rows (..., 16) as `escape_sub_rows` gathers them (any
        value where the row is run-coded), or else from this table's
        escapes.  Sharded rows (parallel/mesh.py) gather both from the slab
        that owns the row."""
        bi, off = self.block_and_offset(k)
        base = row[..., :6].long()
        if self.int64:  # uint32 megablock-relative: reinterpret, never sign-extend
            base = self.mega[bi >> self.mega_shift] + (base & U32)
        esc_i = row[..., 6].long()
        occk = run_counts_keyed(row[..., 8:], off, self.S)
        m = esc_i >= 0
        if sub is not None:
            occk = torch.where(m[..., None], sub_counts_keyed(sub, off, self.S // SUB), occk)
        elif bool(m.any()):
            occk[m] = dense_counts_keyed(self.esc, esc_i[m], off[m])
        return base + occk[..., torch.as_tensor(KEY, dtype=torch.int64, device=k.device)]

    def escape_sub_rows(self, esc_i: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        """The sub-row (..., 16) of escape esc_i (clamped into this table)
        that holds offset off, S/128 - 1 at off = S."""
        j = (off >> 7).clamp(max=self.esc.shape[1] - 1)
        return self.esc[esc_i.clamp(0, self.esc.shape[0] - 1), j]


def run_counts_keyed(recs: torch.Tensor, off: torch.Tensor, S: int) -> torch.Tensor:
    """recs: (..., 32) int32 words of 64 packed uint16 records; off: (...,)
    int64 in [0, S].  Returns (..., 6) int64 counts per KEYED symbol below
    off: each record covers [previous end, end)."""
    w = recs.long() & U32
    e16 = torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2)  # (..., 64) in record order
    end = e16 >> 3
    end = torch.where(end == 0, S, end)  # F4: 65536 wrapped to 0
    start = torch.cat([torch.zeros_like(end[..., :1]), end[..., :-1]], dim=-1)
    cov = (torch.minimum(off[..., None], end) - start).clamp(min=0)
    return torch.zeros(off.shape + (ASIZE,), dtype=torch.int64, device=off.device).scatter_add_(-1, e16 & 7, cov)


def dense_counts_keyed(esc: torch.Tensor, esc_i: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Counts per KEYED symbol below off (M,) int64 in [0, S] in escape rows
    esc_i (M,) of the packed escape table esc (n_esc, S/128, 16): (M, 6)
    int64, from ONE sub-row each, as the card ranks them (csrc/rb.cuh).  The
    sub-row is off's, and S/128 - 1 at off = S; its counts before it plus
    the plane bits below off in it."""
    j = (off >> 7).clamp(max=esc.shape[1] - 1)
    return sub_counts_keyed(esc[esc_i, j], off, esc.shape[1])


def sub_counts_keyed(sub: torch.Tensor, off: torch.Tensor, W4: int) -> torch.Tensor:
    """Counts per KEYED symbol below off (...,) in [0, S] from the escape
    sub-row sub (..., 16) that holds it (`dense_counts_keyed`), S = 128 W4:
    its counts before it plus the plane bits below off in it.  (..., 6) int64."""
    j = (off >> 7).clamp(max=W4 - 1)
    sub = sub.long() & U32
    out = torch.stack([sub[..., w // 2] >> (16 * (w % 2)) & 0xFFFF for w in range(ASIZE)], dim=-1)
    p = sub[..., 4:].unflatten(-1, (3, 4))  # (..., plane, word)
    rem = off - (j << 7)  # [0, 128]
    mask = (1 << (rem[..., None] - 32 * torch.arange(4, device=off.device)).clamp(0, 32)) - 1  # 32 gives all ones
    for kc in range(ASIZE):
        eq = mask
        for pl in range(3):
            eq = eq & (p[..., pl, :] ^ int(FLIP[kc, pl]))
        out[..., kc] += popcount32(eq).sum(-1)
    return out


def pack_escapes(planes: np.ndarray, S: int, device) -> torch.Tensor:
    """The escape table as the rank reads it: (n_esc, S/128, 16) int32
    sub-rows (module docstring) from the cache's (n_esc, 3 S/32) keyed
    bit-planes, built on `device` with torch ops in chunks of rows, so the
    temporaries stay ~PACK_WORDS words and the planes never sit whole on the
    device."""
    W4 = S // SUB
    if planes.shape[1:] != (3 * S // 32,):
        raise ValueError(f"escape planes {planes.shape} are not 3 x {S // 32} words a row")
    out = torch.empty((len(planes), W4, SUB_WORDS), dtype=torch.int32, device=device)
    step = max(1, PACK_WORDS // (3 * S // 32))
    flip = torch.as_tensor(FLIP, device=device)
    for a in range(0, len(planes), step):
        p = torch.from_numpy(np.ascontiguousarray(planes[a : a + step], np.int32)).to(device).unflatten(1, (3, W4, 4))
        out[a : a + step, :, 4:] = p.permute(0, 2, 1, 3).flatten(2)
        w = p.long() & U32  # (m, plane, sub-row, word)
        cnt = torch.stack([popcount32((w[:, 0] ^ flip[kc, 0]) & (w[:, 1] ^ flip[kc, 1]) & (w[:, 2] ^ flip[kc, 2])).sum(-1)
                           for kc in range(ASIZE)], dim=-1)  # (m, sub-row, 6) keyed counts in each sub-row
        before = cnt.cumsum(1) - cnt
        out[a : a + step, :, :3] = (before[..., 0::2] | (before[..., 1::2] << 16)).int()
        out[a : a + step, :, 3] = 0
    return out


def pack_temp_bytes(n_esc: int, S: int) -> int:
    """Bytes `pack_escapes` holds at its peak beside its output for n_esc
    escape blocks of S symbols: one chunk's planes, as uploaded and
    widened to int64, and the temporaries of its counts (< 64 B a word)."""
    step = max(1, PACK_WORDS // (3 * S // 32))
    return 64 * min(max(n_esc, 1), step) * (3 * S // 32)


def device_bytes(d: dict) -> int:
    """Bytes that the host rows `d` (`build_runblock_np`, the cache) take
    on the device once uploaded: `RunBlockIndex.from_np(d, dev).nbytes`,
    the escapes as S/2 B of sub-rows each."""
    return d["rows"].nbytes + len(d["esc"]) * d["S"] // 2 + np.asarray(d["acc"]).nbytes + (
        0 if d["mega"] is None else np.asarray(d["mega"]).nbytes)


def shard_layout(rows: torch.Tensor, nb_local: int, n_idx: int, align: int) -> tuple[torch.Tensor, list]:
    """The rb rows (nb, 40) cut into n_idx slabs of nb_local rows, laid out
    for one virtual range (parallel/mesh.py ShardedRows; the counterpart of
    the JAX package's runblock.shard_layout_np for the port's escape
    sub-rows): slab s carries the sub-rows of its own escapes, in row order,
    from escape row E_s of the range, E_0 = 0 and each E_s a multiple of
    `align` past the end of the slab before it, and column 6 of its rows is
    rebased to them.  Returns (the rows rebased, a new tensor; one (E_s, the
    global escape ids slab s carries (m,) int64) a slab), on the rows'
    device.  Pad rows past nb are the range's, with no escape."""
    out = rows.clone()
    e0, cut = 0, []
    for s in range(n_idx):
        part = out[s * nb_local : (s + 1) * nb_local]
        has = part[:, 6] >= 0
        ids = part[has, 6].long()
        part[has, 6] = torch.arange(e0, e0 + ids.numel(), dtype=part.dtype, device=part.device)
        cut.append((e0, ids))
        e0 += -(-ids.numel() // align) * align
    return out, cut


# ---------------------------------------------------------------------------
# host builder
# ---------------------------------------------------------------------------


def runs_from_dense(f) -> tuple[np.ndarray, np.ndarray]:
    """(syms, lens) of the global BWT runs of a DenseFMIndex."""
    return runs_of_bwt(np.asarray(f.bwt[: f.n]))


def _split_counts(lens: np.ndarray, S: int, n: int) -> np.ndarray:
    cnt = np.zeros((n + S - 1) // S, np.int32)
    native.lib().rb3t_runblock_count(lens.ctypes.data, len(lens), S, cnt.ctypes.data)
    return cnt


def choose_S(lens: np.ndarray, n: int) -> tuple[int, dict]:
    """The block size of fewest bytes in the JAX package's rule (160 B rows
    + 3S/8 B per escape, the cache's format); returns (S, {S: (bytes, escape
    share, bytes on the device)}), the last with the S/2 B escapes of
    `pack_escapes`."""
    lens = np.ascontiguousarray(lens, np.int64)
    stats = {}
    for S in S_CHOICES:
        cnt = _split_counts(lens, S, n)
        n_esc = int((cnt > RB_R).sum())
        stats[S] = (len(cnt) * 160 + n_esc * (3 * S // 8), n_esc / max(len(cnt), 1), len(cnt) * 160 + max(n_esc, 1) * S // 2)
    return min(S_CHOICES, key=lambda s: stats[s][0]), stats  # a tie keeps the larger S, as the JAX package does


def build_runblock_np(syms: np.ndarray, lens: np.ndarray, n: int | None = None, S: int | None = None,
                      int64: bool | None = None, mega_shift: int | None = None) -> dict:
    """The rb rows of the BWT given as runs (syms, lens), on the host:
    {rows, esc, mega | None, acc, n, S, int64, mega_shift}.  int64 None picks
    the width from n; mega_shift None takes 2^32-symbol megablocks, a smaller
    one re-bases the native builder's output into smaller megablocks."""
    syms = np.ascontiguousarray(syms, np.uint8)
    lens = np.ascontiguousarray(lens, np.int64)
    n = int(lens.sum()) if n is None else int(n)
    if S is None:
        S, _ = choose_S(lens, n)
    if S not in S_CHOICES:
        raise ValueError(f"S must be one of {S_CHOICES}")
    int64 = needs_int64(n) if int64 is None else bool(int64)
    native_shift = default_mega_shift(S)
    mega_shift = native_shift if mega_shift is None else int(mega_shift)
    if int64 and not 0 <= mega_shift <= native_shift:
        raise ValueError(f"mega_shift {mega_shift} outside [0, {native_shift}] for S = {S}")
    cnt = _split_counts(lens, S, n)
    nb = len(cnt)
    rows = np.zeros((nb, RB_COLS), np.int32)
    esc_blocks = np.flatnonzero(cnt > RB_R)
    rows[:, 6] = -1
    rows[esc_blocks, 6] = np.arange(len(esc_blocks), dtype=np.int32)
    esc = np.zeros((max(len(esc_blocks), 1), 3 * S // 32), np.int32)
    mega = np.zeros((((nb - 1) >> native_shift) + 1, ASIZE), np.int64) if int64 else None
    native.lib().rb3t_runblock_fill(syms.ctypes.data, lens.ctypes.data, len(lens), n, S, RB_R, rows.ctypes.data,
                                    esc.ctypes.data, mega.ctypes.data if int64 else None)
    if int64 and mega_shift != native_shift:
        absolute = mega[np.arange(nb) >> native_shift] + rows[:, :6].view(np.uint32)
        rows[:, :6], mega = rebase_mega(absolute, mega_shift)
    acc = np.zeros(ASIZE + 1, np.int64)
    np.add.at(acc[1:], syms, lens)
    acc = np.cumsum(acc)
    return dict(rows=rows, esc=esc, mega=mega, acc=acc.astype(np.int64 if int64 else np.int32), n=n, S=S,
                int64=int64, mega_shift=mega_shift if int64 else 0)


# ---------------------------------------------------------------------------
# sidecar cache `<index>.dense.rb.npz`, in the JAX package's format
# ---------------------------------------------------------------------------


def save_cache(path: str, d: dict) -> None:
    """Write rows built with the native megablocks (`mega_shift` None)."""
    if d["int64"] and d["mega_shift"] != default_mega_shift(d["S"]):
        raise ValueError("only rows with 2^32-symbol megablocks go to the cache")
    tmp = f"{path}.tmp.{os.getpid()}"  # np.savez appends .npz to a bare stem
    np.savez(tmp, rows=d["rows"], esc=d["esc"], mega=d["mega"] if d["int64"] else np.zeros(0, np.int64),
             acc=d["acc"], meta=np.array([d["n"], d["S"], int(d["int64"])], np.int64))
    os.replace(tmp + ".npz", path)


def load_cache(path: str, n: int, S: int | None = None, int64: bool | None = None, source: str | None = None) -> dict | None:
    """The cached rows, or None unless the cache exists, is no older than
    `source` (the index it was built from) and matches n, S (None: any) and
    the width (None: the one n picks)."""
    try:
        if source is not None and os.path.getmtime(path) < os.path.getmtime(source):
            return None
        with np.load(path, allow_pickle=False) as z:
            meta = [int(v) for v in z["meta"]]
            want64 = needs_int64(n) if int64 is None else int64
            if meta[0] != n or (S is not None and meta[1] != S) or bool(meta[2]) != want64:
                return None
            d = dict(rows=z["rows"], esc=z["esc"], mega=z["mega"] if want64 else None, acc=z["acc"], n=n, S=meta[1],
                     int64=want64, mega_shift=default_mega_shift(meta[1]) if want64 else 0)
    except (OSError, KeyError, ValueError):
        return None
    nb = (n + d["S"] - 1) // d["S"]
    if d["rows"].shape != (nb, RB_COLS) or (want64 and d["mega"].shape != (((nb - 1) >> d["mega_shift"]) + 1, ASIZE)):
        return None
    if nb and not -1 <= int(d["rows"][:, 6].min()) <= int(d["rows"][:, 6].max()) < len(d["esc"]):
        return None
    return d


def from_dense_np(f, S: int | None = None, int64: bool | None = None, mega_shift: int | None = None,
                  cache: str | bool | None = True) -> dict:
    """Host rows of a DenseFMIndex, through the cache.  cache True puts it
    next to the index's `.dense` sidecar (none without one); a string names
    it; None or False disables it.  A fresh build is cached only when it has
    the native megablocks."""
    source = getattr(f, "_sidecar_path", None)
    if cache is True:
        cache = source + ".rb.npz" if source else None
    if cache and mega_shift is None:
        got = load_cache(cache, int(f.n), S=S, int64=int64, source=source)
        if got is not None:
            return got
    d = build_runblock_np(*runs_from_dense(f), n=f.n, S=S, int64=int64, mega_shift=mega_shift)
    if cache and mega_shift is None:
        try:
            save_cache(cache, d)
        except OSError:
            pass
    return d
