"""Mmap-able dense-table sidecar — the analog of the reference's `-M` mmap
load (rld0.c:322-341).

The FMD run-length decode plus occ-table build costs seconds per gigabase;
queries only need the final dense arrays.  `<index>.dense` stores them raw
(little-endian sections) so a later load is a single mmap: the OS pages
tables in on first touch and shares them across processes.

Version 2 ("RB3TDNS2") aligns the bwt and occ_block sections to 2 MiB file
offsets and the reader maps the file at a 2 MiB-aligned address with
MADV_HUGEPAGE: on kernels with file-backed THP (large page-cache folios)
the whole index is then PMD-mapped — measured +17% native SMEM throughput
at the 1.34 Gsym index (PERF_NOTES round 4), because x86 drops prefetches
on TLB misses, so at multi-GB table footprints the interleaved LF-walk
engines' latency hiding only works when the TLB covers the tables.
Version 1 files (64-byte alignment) remain readable via plain np.memmap.
Copied from ropebwt3_tpu/index/sidecar.py, with its pline file
(`<index>.dense.pl`, `write_pline` / `read_pline`): both packages read and
write the same `.dense` and `.dense.pl` files.

Layout: magic "RB3TDNS1"/"RB3TDNS2" | int64 n, n_bwt, n_block_rows,
n_super_rows | int64 acc[7] | pad | bwt uint8[n_bwt] | pad |
occ_block uint16[rows,6] | pad | occ_super int64[rows,6]
(pad to 64 B in v1, to 2 MiB before bwt/occ_block in v2).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .dense import DenseFMIndex

MAGIC_V1 = b"RB3TDNS1"
MAGIC_V2 = b"RB3TDNS2"
_ALIGN = 64
_HUGE = 1 << 21


def _aligned(x: int, a: int = _ALIGN) -> int:
    return (x + a - 1) & ~(a - 1)


def write_sidecar(path: str, f: DenseFMIndex) -> None:
    header = np.zeros(_ALIGN * 2 // 8, dtype="<i8")
    header[1:5] = [f.n, len(f.bwt), f.occ_block.shape[0], f.occ_super.shape[0]]
    header[5:12] = f.acc
    hb = bytearray(header.tobytes())
    hb[:8] = MAGIC_V2
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fp:
        fp.write(hb)
        for arr, align in ((f.bwt, _HUGE), (f.occ_block, _HUGE), (f.occ_super, _ALIGN)):
            pad = _aligned(fp.tell(), align) - fp.tell()
            if pad:
                fp.write(b"\0" * pad)
            np.ascontiguousarray(arr).tofile(fp)
    os.replace(tmp, path)


class _HugeMap:
    """2 MiB-aligned read-only private mapping of a file with MADV_HUGEPAGE.

    Exposes the bytes as a numpy array (`arr`); the mapping lives as long as
    this object (referenced from the DenseFMIndex it backs)."""

    _libc = None

    def __init__(self, path: str):
        if _HugeMap._libc is None:
            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            libc.mmap.restype = ctypes.c_void_p
            libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long]
            libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            libc.madvise.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
            _HugeMap._libc = libc
        libc = _HugeMap._libc
        self.size = os.path.getsize(path)
        self._res = None
        self._res_sz = self.size + _HUGE
        fd = os.open(path, os.O_RDONLY)
        try:
            # reserve an anonymous PROT_NONE region, then fix the file map at
            # the first 2 MiB boundary inside it (PMD mappings need both the
            # file offset and the virtual address 2 MiB-aligned)
            res = libc.mmap(None, self._res_sz, 0, 0x22, -1, 0)  # MAP_PRIVATE|MAP_ANON
            if not res or res == ctypes.c_void_p(-1).value:
                raise OSError("mmap reserve failed")
            self._res = res
            base = (res + _HUGE - 1) & ~(_HUGE - 1)
            addr = libc.mmap(ctypes.c_void_p(base), self.size, 1, 0x12, fd, 0)  # PROT_READ, MAP_PRIVATE|MAP_FIXED
            if addr != base:
                raise OSError("mmap fixed failed")
            self.addr = addr
            huge_len = self.size & ~(_HUGE - 1)
            if huge_len:
                libc.madvise(ctypes.c_void_p(addr), huge_len, 14)  # MADV_HUGEPAGE
            self.arr = np.ctypeslib.as_array(
                ctypes.cast(ctypes.c_void_p(addr), ctypes.POINTER(ctypes.c_uint8)), shape=(self.size,)
            )
        finally:
            os.close(fd)

    # No __del__/munmap: numpy views of the mapping (index tables, pline
    # records) may outlive this object through caller references, and a
    # munmap under a live view is a segfault.  Mappings are file-backed,
    # read-only, and one-per-index — letting them live for the process is
    # the same contract as the reference's mmap -M (rld0.c:322-341).


def read_sidecar(path: str) -> DenseFMIndex | None:
    """Mmap the sidecar; returns None when absent/invalid."""
    try:
        with open(path, "rb") as fp:
            magic = fp.read(8)
    except OSError:
        return None
    if magic == MAGIC_V2:
        try:
            hm: object = _HugeMap(path)
            mm = hm.arr
        except Exception:
            try:
                mm = np.memmap(path, dtype=np.uint8, mode="r")
                hm = mm
            except (OSError, ValueError):
                return None
        align = _HUGE
    elif magic == MAGIC_V1:
        try:
            mm = np.memmap(path, dtype=np.uint8, mode="r")
            hm = mm
        except (OSError, ValueError):
            return None
        align = _ALIGN
    else:
        return None
    if len(mm) < _ALIGN * 2:
        return None
    header = np.frombuffer(mm, dtype="<i8", count=12)
    n, n_bwt, nb_rows, ns_rows = (int(x) for x in header[1:5])
    acc = np.array(header[5:12], dtype=np.int64)
    off = _aligned(_ALIGN * 2, align)
    bwt = np.frombuffer(mm, dtype=np.uint8, count=n_bwt, offset=off)
    off = _aligned(off + n_bwt, align)
    occ_block = np.frombuffer(mm, dtype="<u2", count=nb_rows * 6, offset=off).reshape(nb_rows, 6)
    off = _aligned(off + nb_rows * 12, _ALIGN)
    occ_super = np.frombuffer(mm, dtype="<i8", count=ns_rows * 6, offset=off).reshape(ns_rows, 6)
    if off + ns_rows * 48 > len(mm):
        return None
    f = DenseFMIndex(bwt=bwt, n=n, acc=acc, occ_block=occ_block, occ_super=occ_super)
    f._mm_ref = hm  # keep the mapping alive with the index
    f._sidecar_version = 2 if magic == MAGIC_V2 else 1
    f._sidecar_path = path  # the .rb.npz cache (F3) and the .pl file are checked against it
    return f


# ---- pline sidecar (`<index>.dense.pl`) ----------------------------------
# Persists the packed one-line rank records (ops/smem_native.pline_table:
# one 64 B record per 128 symbols) so each `mem --engine=native|hybrid` maps
# them hugepage-backed instead of building them again.
MAGIC_PL = b"RB3TPLN1"


def write_pline(path: str, n: int, recs: np.ndarray) -> None:
    header = np.zeros(_ALIGN // 8, dtype="<i8")
    header[1] = n
    header[2] = len(recs) // 64
    hb = bytearray(header.tobytes())
    hb[:8] = MAGIC_PL
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fp:
        fp.write(hb)
        fp.write(b"\0" * (_HUGE - fp.tell()))
        recs.tofile(fp)
    os.replace(tmp, path)


def read_pline(path: str, n: int) -> tuple[np.ndarray, object] | None:
    """Hugepage-mmap the pline records for an index of n symbols; returns
    (records, keepalive) (the caller must hold `keepalive` as long as the
    records are used) or None when absent or mismatched."""
    try:
        with open(path, "rb") as fp:
            head = fp.read(_ALIGN)
    except OSError:
        return None
    if head[:8] != MAGIC_PL:
        return None
    hdr = np.frombuffer(head, dtype="<i8", count=4)
    if int(hdr[1]) != n:
        return None
    n_recs = int(hdr[2])
    want = _HUGE + n_recs * 64
    if os.path.getsize(path) < want or n_recs != (n >> 7) + 1:
        return None
    try:
        hm: object = _HugeMap(path)
        mm = hm.arr
    except Exception:
        try:
            mm = np.memmap(path, dtype=np.uint8, mode="r")
            hm = mm
        except (OSError, ValueError):
            return None
    out = np.frombuffer(mm, dtype=np.uint8, count=n_recs * 64, offset=_HUGE)
    return out, hm
