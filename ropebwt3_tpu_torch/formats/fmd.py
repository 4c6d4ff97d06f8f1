"""FMD ("RLD\\3") decoder — bit-exact reader of the rld0 format.

Layout (rld0.c:222-243): magic "RLD\\3"; uint32 asize<<16|sbits; uint64 reserved;
uint64 n_bytes; uint64 n_frames; 6x uint64 marginal counts; n_bytes of data
words; n_frames * (asize+1) uint64 frame entries.

Data words hold small blocks of 2**sbits 64-bit words. Each block starts with
per-symbol counts of the *previous* block region (cumulative-since-last-header,
written in 16/32/64-bit flavors selected by magnitude; type in the top 2 bits
of the first word, rld0.c:107-135), followed by MSB-first Elias-delta codes of
(run_length, 3-bit symbol) pairs (rld0.c:45-51,137-151). Codes never span
blocks; remaining bits are zero. The last block in each 2**23-word segment has
one fewer usable word (rld0.h:81). A sparse "frame" rank index samples
cumulative counts every 2**ibits symbols (rld0.c:163-204).

The decode side of ropebwt3_tpu/formats/fmd.py: the runs come from the
native decoder, a copy of the JAX package's; the device rows are built from
them.
"""

from __future__ import annotations

import numpy as np

from .. import native


def decode_runs(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Decode an FMD byte string into (run symbols uint8, run lengths int64)
    with the native decoder (../native/rld_codec.cpp).  Adjacent
    equal-symbol runs split across blocks are merged, so the result is a
    maximal run-length encoding of the BWT."""
    lib = native.lib()
    n = lib.rb3t_fmd_decode(data, len(data), None, None, 0)
    if n < 0:
        raise ValueError("not an FMD (RLD\\3) file, or a malformed one")
    syms = np.empty(n, dtype=np.uint8)
    lens = np.empty(n, dtype=np.int64)
    if lib.rb3t_fmd_decode(data, len(data), syms.ctypes.data, lens.ctypes.data, n) != n:
        raise ValueError("malformed FMD data")
    return syms, lens
