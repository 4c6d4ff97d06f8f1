"""SSA ("SSA\\1") sampled suffix array — format I/O (ssa.c:198-241)."""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class SSA:
    ss: int  # sample 1 per 2**ss BWT positions
    ms: int  # low bits of each ssa[] entry hold the sequence id
    m: int  # number of sequences/sentinels
    r2i: np.ndarray  # uint64 [m]: sentinel rank -> sequence id
    ssa: np.ndarray  # uint64 [n_ssa]: (offset << ms) | seq_id

    @property
    def n_ssa(self) -> int:
        return len(self.ssa)


def write_ssa_bytes(sa: SSA) -> bytes:
    out = [b"SSA\x01", struct.pack("<II", sa.ss, sa.ms), struct.pack("<qq", sa.m, sa.n_ssa)]
    out.append(np.asarray(sa.r2i, dtype="<u8").tobytes())
    out.append(np.asarray(sa.ssa, dtype="<u8").tobytes())
    return b"".join(out)


def read_ssa_bytes(data: bytes) -> SSA:
    if data[:4] != b"SSA\x01":
        raise ValueError("not an SSA file")
    ss, ms = struct.unpack_from("<II", data, 4)
    m, n_ssa = struct.unpack_from("<qq", data, 12)
    r2i = np.frombuffer(data, dtype="<u8", count=m, offset=28).copy()
    ssa = np.frombuffer(data, dtype="<u8", count=n_ssa, offset=28 + 8 * m).copy()
    return SSA(ss, ms, m, r2i, ssa)


def write_ssa(fn: str, sa: SSA) -> None:
    import sys

    from ..bufio import write_all

    data = write_ssa_bytes(sa)
    if fn == "-":
        write_all(sys.stdout.buffer, data)
    else:
        with open(fn, "wb") as fp:
            write_all(fp, data)


def read_ssa(fn: str) -> SSA:
    with open(fn, "rb") as fp:
        return read_ssa_bytes(fp.read())
