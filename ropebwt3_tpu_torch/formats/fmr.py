"""FMR ("RB\\2") reader — the mrope B+-tree dump of ropebwt2/3.

Layout (mrope.c:152-177, rope.c:265-330): magic "RB\\2" + sort-order byte,
then six rope dumps (one per first-symbol bucket).  A rope dump is
max_nodes(i32) block_len(i32) followed by a recursive node dump: u8 is_bottom,
i16 n_children; bottom nodes store per child 6x i64 symbol counts then the
leaf block (u16 n_bytes + RLE data in the "43+3" codec, rle.h:39-75);
internal nodes recurse.  The read side of ropebwt3_tpu/formats/fmr.py, copied.
"""

from __future__ import annotations

import struct

import numpy as np


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
