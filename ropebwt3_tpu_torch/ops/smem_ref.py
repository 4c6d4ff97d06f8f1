"""The SMEM algorithms read by read on the host, a copy of
ropebwt3_tpu/ops/smem_ref.py: the Travis-Gagie long-MEM algorithm
(fm-index.c:483-528) with its early-exit check `smem_present`, which the
Python BWA-SW DP's -j prefilter runs (align/bwasw.py), and the original
ropebwt2/fermi algorithm (fm-index.c:415-481), which `mem --old-mem` runs
(cli.py).  Both rank through DenseFMIndex.extend (numpy).  The device's
SMEM engine is ops/smem.py.

A MEM record is (start, end, size, lo, lo_rc) with query interval [start, end)
and SA bi-interval (lo, lo_rc, size).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..index.dense import DenseFMIndex
from ..nt6 import COMP_TABLE


@dataclass
class Mem:
    start: int
    end: int
    size: int
    lo: int
    lo_rc: int


def _extend1(f: DenseFMIndex, ik: np.ndarray, c: int, is_back: bool) -> np.ndarray:
    ok = f.extend(ik, is_back)
    return ok[c]


def smem_tg(f: DenseFMIndex, q: np.ndarray, min_occ: int = 1, min_len: int = 19) -> list[Mem]:
    """Long-MEM algorithm (default `mem` path)."""
    q = np.asarray(q, dtype=np.uint8)
    n = len(q)
    mems: list[Mem] = []
    x = 0
    while x < n:
        x = _smem1_tg(f, q, x, min_occ, min_len, mems)
    return mems


def _smem1_tg(f: DenseFMIndex, q: np.ndarray, x: int, min_occ: int, min_len: int, mems: list[Mem], check_long: bool = False) -> int:
    n = len(q)
    if n - x < min_len:
        return n
    ik = f.set_intv(int(q[x + min_len - 1]))
    i = x + min_len - 2
    while i >= x:
        ok = _extend1(f, ik, int(q[i]), True)
        if ok[2] < min_occ:
            break
        ik = ok
        i -= 1
    if i >= x:
        return i + 1  # the min_len window does not fully match
    if check_long:
        return -1
    j = x + min_len
    while j < n:
        c = int(COMP_TABLE[q[j]])
        ok = _extend1(f, ik, c, False)
        if ok[2] < min_occ:
            break
        ik = ok
        j += 1
    mems.append(Mem(x, j, int(ik[2]), int(ik[0]), int(ik[1])))
    if j == n:
        return n
    ik = f.set_intv(int(q[j]))
    i = j - 1
    while i > x:
        ok = _extend1(f, ik, int(q[i]), True)
        if ok[2] < min_occ:
            break
        ik = ok
        i -= 1
    return i + 1


def smem_present(f: DenseFMIndex, q: np.ndarray, min_len: int) -> bool:
    """Early-exit existence check (fm-index.c:530-538)."""
    q = np.asarray(q, dtype=np.uint8)
    n = len(q)
    x = 0
    while x < n:
        x = _smem1_tg(f, q, x, 1, min_len, [], check_long=True)
        if x < 0:
            return True
    return False


def smem_orig(f: DenseFMIndex, q: np.ndarray, min_occ: int = 1, min_len: int = 19) -> list[Mem]:
    """Original bidirectional SMEM algorithm (`--old-mem`)."""
    q = np.asarray(q, dtype=np.uint8)
    n = len(q)
    mems: list[Mem] = []
    x = 0
    while x < n:
        x = _smem1_orig(f, q, x, min_occ, min_len, mems)
    return mems


def _smem1_orig(f: DenseFMIndex, q: np.ndarray, x: int, min_occ: int, min_len: int, mems: list[Mem]) -> int:
    n = len(q)
    ik = f.set_intv(int(q[x]))
    ik_end = x + 1  # `info` of the reference
    if ik[2] == 0:
        return x + 1
    curr: list[tuple[np.ndarray, int]] = []  # (interval, end)
    i = x + 1
    while i < n:
        c = int(COMP_TABLE[q[i]])
        ok_all = f.extend(ik, False)
        ok = ok_all[c]
        if ok[2] != ik[2]:
            curr.append((ik.copy(), ik_end))
            if ok[2] < min_occ:
                break
        ik = ok
        ik_end = i + 1
        i += 1
    if i == n:
        curr.append((ik.copy(), ik_end))
    curr.reverse()
    ret = curr[0][1]
    prev = curr
    oldn = len(mems)
    i = x - 1
    while i >= -1:
        c = 0 if i < 0 else int(q[i])
        curr = []
        for p_ik, p_end in prev:
            ok_all = f.extend(p_ik, True)
            ok = ok_all[c] if c else None
            if c == 0 or ok_all[c][2] < min_occ:
                if len(curr) == 0 and p_end - i - 1 >= min_len and (len(mems) == oldn or i + 1 < mems[-1].start):
                    mems.append(Mem(i + 1, p_end, int(p_ik[2]), int(p_ik[0]), int(p_ik[1])))
            elif len(curr) == 0 or int(ok_all[c][2]) != curr[-1][0][2]:
                curr.append((ok_all[c].copy(), p_end))
        if not curr:
            break
        prev = curr
        i -= 1
    mems[oldn:] = mems[oldn:][::-1]
    return ret
