"""nt6 alphabet conventions shared with ropebwt3: $=0, A=1, C=2, G=3, T=4,
N (ambiguous) = 5.  The encoding table follows the reference (io.c:12-28):
bytes 0..4 map to themselves (already-encoded buffers pass through),
'A/C/G/T' upper or lower map to 1..4, everything else (including >= 128) maps
to 5.  The encoder of ropebwt3_tpu/nt6.py, copied.
"""

from __future__ import annotations

import numpy as np

# Byte -> nt6 code lookup for all 256 byte values.
NT6_TABLE = np.full(256, 5, dtype=np.uint8)
NT6_TABLE[0:5] = [0, 1, 2, 3, 4]
for _i, _c in enumerate("ACGT"):
    NT6_TABLE[ord(_c)] = _i + 1
    NT6_TABLE[ord(_c.lower())] = _i + 1


def char2nt6(s: bytes | np.ndarray) -> np.ndarray:
    """Encode ASCII bytes to nt6 codes."""
    a = np.frombuffer(s, dtype=np.uint8) if isinstance(s, (bytes, bytearray)) else np.asarray(s, dtype=np.uint8)
    return NT6_TABLE[a]
