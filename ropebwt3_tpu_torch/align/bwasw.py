"""BWA-SW options and the native hapdiv DP: the part of
ropebwt3_tpu/align/bwasw.py that `hapdiv` runs (the flags, `SwOpt`,
`HapDiv`, `_opt_arr`, `_hapdiv_native`, `rb3_hapdiv_multi`).

The DP itself is native/bwasw_core.cpp (`rb3t_hapdiv_batch`), a copy of the
JAX package's native core: an exact re-implementation of the reference
bwa-sw.c:329-526.  The port has no pure-Python DP; `native.lib()` raises when
the library cannot be built.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field

import numpy as np

from ..nt6 import NT6_TABLE

RB3_SWF_E2E, RB3_SWF_HAPDIV, RB3_SWF_KEEP_RS = 1, 2, 4
RB2_SW_MAX_ED = 6


@dataclass
class SwOpt:
    flag: int = 0
    n_best: int = 25
    min_sc: int = 30
    end_len: int = 11
    min_mem_len: int = 0
    max_pos: int = 0
    match: int = 1
    mis: int = 3
    e2e_drop: int = -1
    gap_open: int = 5
    gap_ext: int = 2
    r2cache_size: int = 0x10000


@dataclass
class HapDiv:
    n_al: int = 0
    max_ed: int = 0
    n_hap: list = field(default_factory=lambda: [0] * (RB2_SW_MAX_ED + 1))


def _opt_arr(opt: SwOpt) -> np.ndarray:
    return np.array(
        [opt.flag, opt.n_best, opt.min_sc, opt.end_len, opt.match, opt.mis, opt.e2e_drop,
         opt.gap_open, opt.gap_ext, opt.min_mem_len],
        dtype=np.int32,
    )


def _hapdiv_native(opt: SwOpt, f, seqs: list[np.ndarray]) -> list[HapDiv | None]:
    from ..native import lib

    k = len(seqs[0])
    W = len(seqs)
    buf = np.ascontiguousarray(NT6_TABLE[np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs])])
    opt10 = _opt_arr(opt)
    out = np.zeros((W, 10), dtype=np.int64)
    P = ctypes.c_void_p
    lib().rb3t_hapdiv_batch(
        P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), P(f.occ_super.ctypes.data), P(f.acc.ctypes.data),
        int(f.n), P(opt10.ctypes.data), P(buf.ctypes.data), W, k, min(os.cpu_count() or 1, W), P(out.ctypes.data),
        None,
    )
    res: list[HapDiv | None] = []
    for w in range(W):
        if out[w, 0] >= opt.min_sc:
            a = HapDiv()
            a.n_al, a.max_ed = int(out[w, 1]), int(out[w, 2])
            a.n_hap = [int(x) for x in out[w, 3:10]]
            res.append(a)
        else:
            res.append(None)
    return res


def rb3_hapdiv_multi(opt: SwOpt, f, seqs: list[np.ndarray]) -> list[HapDiv | None]:
    """hapdiv of windows of equal length (nt6) on the native DP, threaded;
    None for a window whose best score is below opt.min_sc."""
    if not seqs:
        return []
    if any(len(s) != len(seqs[0]) for s in seqs):
        raise ValueError("rb3_hapdiv_multi takes windows of one length")
    return _hapdiv_native(opt, f, seqs)
