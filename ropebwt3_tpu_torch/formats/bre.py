"""BRE ("BRE\\1") codec — portable run-length BWT interchange (bre.c);
ropebwt3_tpu/formats/bre.py's reader and byte writer, copied.

Header (24 B): magic, b_per_sym(1), b_per_run(1), atype(1), mtype(1),
asize(u64 LE), l_aux(u64 LE), then l_aux bytes.  Records are fixed-width
little-endian (symbol, run_length); runs longer than (1<<8*b_per_run)-1 are
split.  Footer: an all-zero record followed by n_rec, n_sym, n_run (u64 each).
"""

from __future__ import annotations

import struct

import numpy as np

AT_UNKNOWN, AT_ASCII, AT_DNA6, AT_DNA16 = 0, 1, 2, 3


def write_bre_bytes(syms: np.ndarray, lens: np.ndarray, b_per_sym: int = 1, b_per_run: int = 2, atype: int = AT_DNA6) -> bytes:
    asize = {AT_ASCII: 128, AT_DNA6: 6, AT_DNA16: 16}.get(atype, 256)
    out = [b"BRE\x01", bytes([b_per_sym, b_per_run, atype, 0]), struct.pack("<QQ", asize, 0)]
    max_run = (1 << (8 * b_per_run)) - 1
    n_rec = n_sym = n_run = 0
    for c, l in zip(np.asarray(syms).tolist(), np.asarray(lens).tolist()):
        if l <= 0:
            continue
        n_run += 1
        rest = l
        while rest > 0:
            ll = min(rest, max_run)
            out.append(int(c).to_bytes(b_per_sym, "little"))
            out.append(int(ll).to_bytes(b_per_run, "little"))
            n_rec += 1
            n_sym += ll
            rest -= ll
    out.append(b"\x00" * (b_per_sym + b_per_run))
    out.append(struct.pack("<QQQ", n_rec, n_sym, n_run))
    return b"".join(out)


def read_bre_bytes(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    if data[:4] != b"BRE\x01":
        raise ValueError("not a BRE file")
    b_per_sym, b_per_run, _atype, _mtype = data[4], data[5], data[6], data[7]
    _asize, l_aux = struct.unpack_from("<QQ", data, 8)
    off = 24 + l_aux
    rec = b_per_sym + b_per_run
    syms: list[int] = []
    lens: list[int] = []
    n_rec = n_sym = 0
    while True:
        c = int.from_bytes(data[off : off + b_per_sym], "little")
        l = int.from_bytes(data[off + b_per_sym : off + rec], "little")
        off += rec
        if c == 0 and l == 0:
            break
        n_rec += 1
        n_sym += l
        if syms and syms[-1] == c:
            lens[-1] += l
        else:
            syms.append(c)
            lens.append(l)
    fr_rec, fr_sym, fr_run = struct.unpack_from("<QQQ", data, off)
    if fr_rec != n_rec or fr_sym != n_sym or fr_run != len(syms):
        raise ValueError("BRE footer inconsistency: n_rec=%d/%d n_sym=%d/%d n_run=%d/%d" % (n_rec, fr_rec, n_sym, fr_sym, len(syms), fr_run))
    return np.asarray(syms, dtype=np.uint8), np.asarray(lens, dtype=np.int64)
