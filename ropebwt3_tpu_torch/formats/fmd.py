"""FMD ("RLD\\3") codec — bit-exact reader and writer of the rld0 format.

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

ropebwt3_tpu/formats/fmd.py's codec on the port's native copy
(../native/rld_codec.cpp): the decoder, and the encoder (sbits 3, the one
ropebwt3 writes).  The JAX package's pure-Python `FMDEncoder` is not copied:
the native encoder writes the same bytes from the same runs.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native


def decode_runs(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Decode an FMD byte string into (run symbols uint8, run lengths int64)
    with the native decoder.  Adjacent equal-symbol runs split across blocks
    are merged, so the result is a maximal run-length encoding of the BWT."""
    lib = native.lib()
    n = lib.rb3t_fmd_decode(data, len(data), None, None, 0)
    if n < 0:
        raise ValueError("not an FMD (RLD\\3) file, or a malformed one")
    syms = np.empty(n, dtype=np.uint8)
    lens = np.empty(n, dtype=np.int64)
    if lib.rb3t_fmd_decode(data, len(data), syms.ctypes.data, lens.ctypes.data, n) != n:
        raise ValueError("malformed FMD data")
    return syms, lens


def encode_runs(syms: np.ndarray, lens: np.ndarray) -> bytes:
    """The FMD bytes of the runs (symbols 0..5, lengths >= 0; zero-length
    runs are skipped and adjacent runs of one symbol merge, as rld_enc
    does)."""
    syms = np.ascontiguousarray(syms, dtype=np.uint8)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if len(syms) != len(lens):
        raise ValueError(f"{len(syms)} run symbols for {len(lens)} run lengths")
    if len(syms) and (int(syms.max()) > 5 or int(lens.min()) < 0):
        raise ValueError("FMD runs take nt6 symbols 0..5 and lengths >= 0")
    lib = native.lib()
    out_size = ctypes.c_int64(0)
    ptr = lib.rb3t_fmd_encode(syms.ctypes.data, lens.ctypes.data, len(syms), ctypes.byref(out_size))
    if not ptr:
        raise MemoryError("rb3t_fmd_encode could not allocate its output")
    try:
        return ctypes.string_at(ptr, out_size.value)
    finally:
        lib.rb3t_free(ptr)
