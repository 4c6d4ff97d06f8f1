"""Chunked writes for multi-megabyte outputs.

On this class of VM a single large write(2) into a cold page cache can run
~100x slower than the same bytes in 4-16 MB chunks (transparent-hugepage
folio allocation stalls — the same family as the numpy MADV_HUGEPAGE hazard
handled in the package's ``__init__``; measured 19-127 MB/s for one 30-200 MB
write vs ~3.5 GB/s chunked).  Every potentially-large write in the package
goes through :func:`write_all`.  A copy of ropebwt3_tpu/bufio.py.
"""

from __future__ import annotations

CHUNK = 8 << 20


def write_all(fp, data, chunk: int = CHUNK) -> None:
    """Write ``data`` (bytes-like or str) to ``fp`` in ``chunk``-sized pieces.

    str chunks are sliced by character count — for the ASCII outputs this
    package emits that equals bytes; for anything else it merely changes the
    chunk boundary, not the content.
    """
    if isinstance(data, str):
        if len(data) <= chunk:
            fp.write(data)
            return
        for i in range(0, len(data), chunk):
            fp.write(data[i : i + chunk])
        return
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.nbytes <= chunk:
        fp.write(data)
        return
    mv = mv.cast("B")
    for i in range(0, mv.nbytes, chunk):
        fp.write(mv[i : i + chunk])
