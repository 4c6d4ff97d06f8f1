"""The native `mem` engine: SMEM-TG on the host's threads
(native/bwasw_core.cpp rb3t_smem_batch), a copy of
ropebwt3_tpu/ops/smem_native.py without its fused 128-B records
(RB3T_SMEM_FUSED, measured neutral-to-worse there and off by default) and
its switches RB3T_SMEM_PLINE and RB3T_SMEM_G: the pline records are used by
the batch-size rule alone, and each thread interleaves 16 reads.

The algorithm is ops/smem_ref.smem_tg's (fm-index.c:483-528): each thread
interleaves 16 reads as resumable state machines, so the rank fetches of
one read's LF chain overlap those of the others; reads are claimed one at
a time, and the output is in read order whatever the schedule.  `mem --engine=native` runs it alone, `--engine=hybrid` beside the
device engine (ops/smem.py BatchedSmemTG) on the rest of each batch.  The
library is a ctypes.CDLL, so a call releases the GIL for its whole run.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import native
from ..index.dense import DenseFMIndex
from .smem_ref import Mem


def pline_table(f: DenseFMIndex) -> np.ndarray:
    """Packed one-line rank records: one 64-byte record per 128 symbols
    (three 128-bit symbol bit-planes + six uint16 within-super counts), so a
    rank touches one random cache line instead of two or three.  A memory
    layout, not an algorithm change: every count is the split rows'.  An
    index mapped from its `.dense` sidecar keeps them in `<sidecar>.pl`
    (index/sidecar.py), the JAX package's file, read when it is no older
    than the sidecar."""
    cached = getattr(f, "_pline_recs", None)
    if cached is not None:
        return cached
    from ..index.sidecar import read_pline, write_pline

    sc_path = getattr(f, "_sidecar_path", None)
    pl_path = sc_path + ".pl" if sc_path else None
    if pl_path and os.path.exists(pl_path) and os.path.getmtime(pl_path) >= os.path.getmtime(sc_path):
        got = read_pline(pl_path, int(f.n))
        if got is not None:
            f._pline_recs, f._pline_mm = got
            return f._pline_recs
    n_recs = (int(f.n) >> 7) + 1
    out = np.empty(n_recs * 64, np.uint8)
    native.lib().rb3t_pline_build(f.bwt.ctypes.data, f.occ_block.ctypes.data, n_recs, len(f.bwt), out.ctypes.data,
                                  os.cpu_count() or 1)
    if pl_path:
        try:
            write_pline(pl_path, int(f.n), out)
            got = read_pline(pl_path, int(f.n))
            if got is not None:
                f._pline_recs, f._pline_mm = got
                return f._pline_recs
        except OSError:
            pass
    f._pline_recs = out
    return out


def smem_tg_flat_native(f: DenseFMIndex, flat: np.ndarray, seq_off: np.ndarray, min_occ: int, min_len: int,
                        n_threads: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """SMEMs of the reads packed in one flat nt6 buffer (read i =
    flat[seq_off[i]:seq_off[i+1]]) on n_threads host threads (default: one
    a core, at most one a read).  Returns (counts (n_reads,) int64, rows
    (sum(counts), 5) int64 [start, end, size, lo, lo_rc]) in read order, the
    contract of ops/smem.py BatchedSmemTG.run_flat.  A batch of at least one
    symbol per two 64-symbol blocks (seq_off[-1] * 2 >= len(occ_block))
    ranks through the pline records, built or mapped for it; a smaller one
    through them only when the index already holds them."""
    n_reads = len(seq_off) - 1
    if n_reads == 0:
        return np.zeros(0, np.int64), np.zeros((0, 5), np.int64)
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    big_batch = int(seq_off[-1]) * 2 >= len(f.occ_block)
    pline = pline_table(f) if big_batch else getattr(f, "_pline_recs", None)
    lib = native.lib()
    out_len = ctypes.c_int64(0)
    ptr = lib.rb3t_smem_batch(
        f.bwt.ctypes.data, f.occ_block.ctypes.data, f.occ_super.ctypes.data, f.acc.ctypes.data, int(f.n),
        int(min_occ), int(min_len), flat.ctypes.data, seq_off.ctypes.data, n_reads,
        min(n_threads or os.cpu_count() or 1, n_reads), ctypes.byref(out_len),
        pline.ctypes.data if pline is not None else None,
    )
    if not ptr:
        raise MemoryError("rb3t_smem_batch could not allocate its output")
    try:
        raw = ctypes.string_at(ptr, out_len.value)
    finally:
        lib.rb3t_buf_free(ptr)
    # blob: (n_reads+1) int64 offsets, then per read [n_mems][n_mems x 5 rows]
    words = np.frombuffer(raw, dtype=np.int64)
    offs = words[: n_reads + 1]
    counts = (np.diff(offs) - 8) // 40
    tail = words[n_reads + 1 :]
    keep = np.ones(len(tail), bool)
    keep[offs[:-1] // 8] = False  # drop the per-read count words
    return counts, tail[keep].reshape(-1, 5)


def smem_tg_batch_native(f: DenseFMIndex, seqs: list[np.ndarray], min_occ: int, min_len: int) -> list[list[Mem]]:
    """smem_tg_flat_native of a list of reads: each read's MEMs."""
    n_reads = len(seqs)
    if n_reads == 0:
        return []
    flat = np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs])
    seq_off = np.zeros(n_reads + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=seq_off[1:])
    counts, rows = smem_tg_flat_native(f, flat, seq_off, min_occ, min_len)
    rows_l = rows.tolist()
    out: list[list[Mem]] = []
    k = 0
    for c in counts.tolist():
        out.append([Mem(*r) for r in rows_l[k : k + c]])
        k += c
    return out
