"""FMR ("RB\\2") codec — the mrope B+-tree dump of ropebwt2/3.

Layout (mrope.c:152-177, rope.c:265-330): magic "RB\\2" + sort-order byte,
then six rope dumps (one per first-symbol bucket).  A rope dump is
max_nodes(i32) block_len(i32) followed by a recursive node dump: u8 is_bottom,
i16 n_children; bottom nodes store per child 6x i64 symbol counts then the
leaf block (u16 n_bytes + RLE data in the "43+3" codec, rle.h:39-75);
internal nodes recurse.  A copy of ropebwt3_tpu/formats/fmr.py: the writer
emits the same canonically packed tree (leaves filled to block_len - 2 -
RLE_MIN_SPACE, so the reference can insert into it in place).
"""

from __future__ import annotations

import struct
import sys

import numpy as np

from ..bufio import write_all

MAX_NODES_DEF = 64
BLOCK_LEN_DEF = 512
RLE_MIN_SPACE = 18
RLE_MAX_LEN = (1 << 43) - 1
SO_IO = 0  # input-order sort order (mrope.h:6-8)


def rle_enc1(c: int, l: int) -> bytes:
    if l < 1 << 4:
        return bytes([l << 3 | c])
    if l < 1 << 8:
        return bytes([0xC0 | (l >> 6) << 3 | c, 0x80 | (l & 0x3F)])
    if l < 1 << 19:
        return bytes([0xE0 | (l >> 18) << 3 | c, 0x80 | (l >> 12 & 0x3F), 0x80 | (l >> 6 & 0x3F), 0x80 | (l & 0x3F)])
    out = bytearray([0xF0 | (l >> 42) << 3 | c])
    shift = 36
    for _ in range(7):
        out.append(0x80 | (l >> shift & 0x3F))
        shift -= 6
    return bytes(out)


def _pack_leaves(syms, lens, block_len: int) -> list[tuple[bytes, np.ndarray]]:
    """Pack runs into leaf blocks; returns list of (data_bytes, counts[6])."""
    cap = block_len - 2 - RLE_MIN_SPACE
    leaves: list[tuple[bytes, np.ndarray]] = []
    buf = bytearray()
    cnt = np.zeros(6, dtype=np.int64)
    for c, l in zip(syms.tolist(), lens.tolist()):
        while l > 0:
            ll = min(l, RLE_MAX_LEN)
            code = rle_enc1(int(c), int(ll))
            if len(buf) + len(code) > cap and buf:
                leaves.append((bytes(buf), cnt))
                buf, cnt = bytearray(), np.zeros(6, dtype=np.int64)
            buf += code
            cnt[int(c)] += ll
            l -= ll
    if buf or not leaves:
        leaves.append((bytes(buf), cnt))
    return leaves


def _dump_rope(out: list[bytes], syms: np.ndarray, lens: np.ndarray, max_nodes: int, block_len: int) -> None:
    out.append(struct.pack("<ii", max_nodes, block_len))
    leaves = _pack_leaves(syms, lens, block_len)

    def dump_bottom(chunk) -> bytes:
        b = [struct.pack("<Bh", 1, len(chunk))]
        for data, cnt in chunk:
            b.append(cnt.astype("<i8").tobytes())
            b.append(struct.pack("<H", len(data)))
            b.append(data)
        return b"".join(b)

    # group leaves into bottom buckets, then build internal levels
    level: list[bytes] = [dump_bottom(leaves[i : i + max_nodes]) for i in range(0, len(leaves), max_nodes)]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), max_nodes):
            chunk = level[i : i + max_nodes]
            nxt.append(struct.pack("<Bh", 0, len(chunk)) + b"".join(chunk))
        level = nxt
    out.append(level[0])


def write_fmr_bytes(bucket_runs, so: int = SO_IO, max_nodes: int = MAX_NODES_DEF, block_len: int = BLOCK_LEN_DEF) -> bytes:
    """bucket_runs: list of 6 (syms, lens) pairs, one per first-symbol bucket."""
    out = [b"RB\x02", bytes([so])]
    for syms, lens in bucket_runs:
        _dump_rope(out, np.asarray(syms, dtype=np.uint8), np.asarray(lens, dtype=np.int64), max_nodes, block_len)
    return b"".join(out)


def split_runs_into_buckets(syms: np.ndarray, lens: np.ndarray):
    """Split whole-BWT runs at bucket boundaries given by the cumulative
    symbol counts (cf. rb3_enc_fmd2fmr, fm-index.c:56-85)."""
    syms = np.asarray(syms, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    tot = np.zeros(6, dtype=np.int64)
    np.add.at(tot, syms.astype(np.int64), lens)
    acc = np.concatenate(([0], np.cumsum(tot)))
    ends = np.cumsum(lens)
    starts = ends - lens
    buckets = []
    for a in range(6):
        lo, hi = int(acc[a]), int(acc[a + 1])
        if lo == hi:
            buckets.append((np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)))
            continue
        i0 = int(np.searchsorted(ends, lo, side="right"))
        i1 = int(np.searchsorted(starts, hi, side="left"))
        s = syms[i0:i1].copy()
        ln = lens[i0:i1].copy()
        ln[0] = min(int(ends[i0]), hi) - lo
        if i1 - 1 > i0:
            ln[-1] = hi - int(starts[i1 - 1])
        buckets.append((s, ln))
    return buckets


def write_fmr(fn: str, syms: np.ndarray, lens: np.ndarray) -> None:
    """The FMR of the runs to file `fn` ("-": stdout), at the default
    max_nodes and block_len."""
    data = write_fmr_bytes(split_runs_into_buckets(syms, lens))
    if fn == "-":
        write_all(sys.stdout.buffer, data)
    else:
        with open(fn, "wb") as fp:
            write_all(fp, data)


def rle_decode_block(data: bytes) -> list[tuple[int, int]]:
    runs = []
    i, n = 0, len(data)
    while i < n:
        b0 = data[i]
        c = b0 & 7
        if (b0 & 0x80) == 0:
            l = b0 >> 3
            i += 1
        elif b0 >> 5 == 6:
            l = (b0 & 0x18) << 3 | (data[i + 1] & 0x3F)
            i += 2
        else:
            nb = ((b0 & 0x10) >> 2) + 4
            l = (b0 >> 3) & 1
            for j in range(1, nb):
                l = l << 6 | (data[i + j] & 0x3F)
            i += nb
        runs.append((c, l))
    return runs


class _Cursor:
    def __init__(self, data: bytes, off: int = 0):
        self.data = data
        self.off = off

    def take(self, n: int) -> bytes:
        b = self.data[self.off : self.off + n]
        self.off += n
        return b

    def u8(self):
        return self.take(1)[0]

    def i16(self):
        return struct.unpack("<h", self.take(2))[0]

    def u16(self):
        return struct.unpack("<H", self.take(2))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]


def _read_node(cur: _Cursor, runs: list[tuple[int, int]]):
    is_bottom = cur.u8()
    n = cur.i16()
    if is_bottom:
        for _ in range(n):
            cur.take(48)  # per-leaf counts (recomputable)
            nb = cur.u16()
            data = cur.take(nb)
            runs.extend(rle_decode_block(data))
    else:
        for _ in range(n):
            _read_node(cur, runs)


def read_fmr_bytes(data: bytes) -> tuple[int, np.ndarray, np.ndarray]:
    """Returns (sort_order, run symbols uint8, run lengths int64) of the
    concatenated BWT (buckets in order), adjacent equal runs merged."""
    if data[:3] != b"RB\x02":
        raise ValueError("not an FMR (RB\\2) file")
    so = data[3]
    cur = _Cursor(data, 4)
    runs: list[tuple[int, int]] = []
    for _ in range(6):
        cur.i32()  # max_nodes
        cur.i32()  # block_len
        _read_node(cur, runs)
    syms: list[int] = []
    lens: list[int] = []
    for c, l in runs:
        if l == 0:
            continue
        if syms and syms[-1] == c:
            lens[-1] += l
        else:
            syms.append(c)
            lens.append(l)
    return so, np.asarray(syms, dtype=np.uint8), np.asarray(lens, dtype=np.int64)
