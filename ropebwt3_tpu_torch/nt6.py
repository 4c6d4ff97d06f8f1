"""nt6 alphabet conventions shared with ropebwt3: $=0, A=1, C=2, G=3, T=4,
N (ambiguous) = 5.  The encoding table follows the reference (io.c:12-28):
bytes 0..4 map to themselves (already-encoded buffers pass through),
'A/C/G/T' upper or lower map to 1..4, everything else (including >= 128) maps
to 5.  Complement: c in 1..4 -> 5-c, else unchanged (fm-index.h:85-88).  A
copy of ropebwt3_tpu/nt6.py.
"""

from __future__ import annotations

import numpy as np

# Byte -> nt6 code lookup for all 256 byte values.
NT6_TABLE = np.full(256, 5, dtype=np.uint8)
NT6_TABLE[0:5] = [0, 1, 2, 3, 4]
for _i, _c in enumerate("ACGT"):
    NT6_TABLE[ord(_c)] = _i + 1
    NT6_TABLE[ord(_c.lower())] = _i + 1

# nt6 -> ASCII for printing ("$ACGTN").
NT6_TO_CHAR = np.frombuffer(b"$ACGTN", dtype=np.uint8).copy()

# Complement lookup over nt6 codes.
COMP_TABLE = np.array([0, 4, 3, 2, 1, 5], dtype=np.uint8)


def char2nt6(s: bytes | np.ndarray) -> np.ndarray:
    """Encode ASCII bytes to nt6 codes."""
    a = np.frombuffer(s, dtype=np.uint8) if isinstance(s, (bytes, bytearray)) else np.asarray(s, dtype=np.uint8)
    return NT6_TABLE[a]


def nt6_to_str(a: np.ndarray) -> str:
    return NT6_TO_CHAR[np.asarray(a, dtype=np.uint8)].tobytes().decode()


def revcomp(a: np.ndarray) -> np.ndarray:
    """Reverse complement of an nt6 sequence (io.c:30-40)."""
    return COMP_TABLE[np.asarray(a, dtype=np.uint8)[::-1]]
