"""BWA-SW options and the native engine: the part of
ropebwt3_tpu/align/bwasw.py that `hapdiv` and `sw` run (the flags, `SwOpt`,
`HapDiv`, `SwHit`, `_opt_arr`, `_hapdiv_native`, `rb3_hapdiv_multi`,
`_attach_positions_multi`, `_parse_sw_blob`, `rb3_sw_batch`), and the
wrappers of the device sw engine's native staging and finish (`sw_stage`,
`sw_finish`).

The DP itself is native/bwasw_core.cpp (`rb3t_hapdiv_batch`,
`rb3t_sw_batch`), a copy of the JAX package's native core: an exact
re-implementation of the reference bwa-sw.c:329-526.  The port has no
pure-Python DP; `native.lib()` raises when the library cannot be built.
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
class SwHit:
    score: int = 0
    qlen: int = 0
    rlen: int = 0
    n_cigar: int = 0
    cs_len: int = 0
    blen: int = 0
    mlen: int = 0
    lo: int = 0
    hi: int = 0
    rseq: list = field(default_factory=list)
    cigar: list = field(default_factory=list)
    qoff: list = field(default_factory=list)
    cs: str = ""
    pos: list = field(default_factory=list)

    @property
    def n_qoff(self):
        return len(self.qoff)

    @property
    def n_pos(self):
        return len(self.pos)


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


P = ctypes.c_void_p


def _index_args(f) -> tuple:
    """The dense host index as the native entry points take it."""
    return P(f.bwt.ctypes.data), P(f.occ_block.ctypes.data), P(f.occ_super.ctypes.data), P(f.acc.ctypes.data), int(f.n)


def flat_reads(seqs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Reads (nt6) as one flat uint8 array and int64 offsets (n_reads + 1)."""
    flat = np.ascontiguousarray(NT6_TABLE[np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs])])
    seq_off = np.zeros(len(seqs) + 1, dtype=np.int64)
    seq_off[1:] = np.cumsum([len(s) for s in seqs])
    return flat, seq_off


def _threads(n: int) -> int:
    return max(1, min(os.cpu_count() or 1, n))


def _hapdiv_native(opt: SwOpt, f, seqs: list[np.ndarray]) -> list[HapDiv | None]:
    from ..native import lib

    k = len(seqs[0])
    W = len(seqs)
    buf = flat_reads(seqs)[0]
    opt10 = _opt_arr(opt)
    out = np.zeros((W, 10), dtype=np.int64)
    lib().rb3t_hapdiv_batch(*_index_args(f), P(opt10.ctypes.data), P(buf.ctypes.data), W, k, _threads(W),
                            P(out.ctypes.data), None)
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


def _attach_positions_multi(opt: SwOpt, f, hits_lists: list[list[SwHit]]) -> None:
    """Fill hit.pos via the sampled SA (bwa-sw.c:547-557) for many reads in
    ONE native locate call.

    len(ssa_multi(lo, hi, n)) == min(n, hi - lo) deterministically (every
    suffix locates), so the reference's sequential per-read `rest` budget can
    be computed upfront and every read's lookups batched together."""
    if f.ssa is None:
        return
    from ..ssa_ops import ssa_multi_batch

    reqs: list[tuple[int, int, int]] = []
    spans: list[tuple[int, int]] = []
    for hits in hits_lists:
        rest = opt.max_pos
        start = len(reqs)
        for hit in hits:
            n = rest if rest > 0 else 1
            reqs.append((hit.lo, hit.hi, n))
            rest -= min(n, hit.hi - hit.lo)
        spans.append((start, len(reqs)))
    if not reqs:
        return
    got = ssa_multi_batch(f, f.ssa, reqs)
    for hits, (a, b) in zip(hits_lists, spans):
        for hit, pos in zip(hits, got[a:b]):
            hit.pos = pos


def _parse_sw_blob(buf: bytes, n_reads: int) -> list[list[SwHit]]:
    off_table = np.frombuffer(buf, dtype=np.int64, count=n_reads + 1)
    base = (n_reads + 1) * 8
    mv = memoryview(buf)
    out: list[list[SwHit]] = []
    for r in range(n_reads):
        o = base + int(off_table[r])
        n_hits = int.from_bytes(mv[o : o + 8], "little")
        o += 8
        hits: list[SwHit] = []
        for _ in range(n_hits):
            score, qlen, rlen, mlen, blen, lo, hi, nc, nq, nrs, ncs = (
                int(v) for v in np.frombuffer(mv, dtype=np.int64, count=11, offset=o)
            )
            o += 88
            h = SwHit(score=score, qlen=qlen, rlen=rlen, n_cigar=nc, cs_len=ncs, blen=blen, mlen=mlen, lo=lo, hi=hi)
            h.cigar = np.frombuffer(mv, dtype=np.uint32, count=nc, offset=o).tolist()
            o += nc * 4
            h.qoff = np.frombuffer(mv, dtype=np.int32, count=nq, offset=o).tolist()
            o += nq * 4
            h.rseq = list(mv[o : o + nrs])
            o += nrs
            h.cs = bytes(mv[o : o + ncs]).decode()
            o += ncs
            o = (o + 7) & ~7
            hits.append(h)
        out.append(hits)
    return out


def _take_blob(lib, ptr, out_len: ctypes.c_int64, n_reads: int) -> list[list[SwHit]]:
    """The hits of a blob the library returned, which is then freed."""
    if not ptr:
        raise MemoryError("the native sw engine could not allocate its hit blob")
    try:
        raw = ctypes.string_at(ptr, out_len.value)
    finally:
        lib.rb3t_buf_free(ptr)
    return _parse_sw_blob(raw, n_reads)


def rb3_sw_batch(opt: SwOpt, f, seqs: list[np.ndarray], attach: bool = True) -> list[list[SwHit]]:
    """Reads (nt6) through the native full sw path (prefilter, DAWG, DP,
    backtrack), threaded; with `attach` each hit's positions too."""
    from ..native import lib

    if not seqs:
        return []
    flat, seq_off = flat_reads(seqs)
    opt10 = _opt_arr(opt)
    out_len = ctypes.c_int64(0)
    ptr = lib().rb3t_sw_batch(*_index_args(f), P(opt10.ctypes.data), P(flat.ctypes.data), P(seq_off.ctypes.data),
                              len(seqs), _threads(len(seqs)), ctypes.byref(out_len), None)
    hits_lists = _take_blob(lib(), ptr, out_len, len(seqs))
    if attach:
        _attach_positions_multi(opt, f, hits_lists)
    return hits_lists


def sw_stage(opt: SwOpt, f, flat: np.ndarray, seq_off: np.ndarray, ncap: int, pcap: int) -> tuple:
    """The device engine's staging (native `rb3t_sw_stage`) of the reads
    (flat, seq_off): per read the -j prefilter's verdict (bool), its DAWG's
    n_node and largest in-degree (int32), and for a DAWG of at most ncap
    nodes and in-degree pcap, node_c (R, ncap) and pre (R, ncap, pcap) int32
    (other reads' rows are not written)."""
    from ..native import lib

    R = len(seq_off) - 1
    ok = np.zeros(R, np.uint8)
    n_node, max_pre = np.zeros(R, np.int32), np.zeros(R, np.int32)
    node_c, pre = np.empty((R, ncap), np.int32), np.empty((R, ncap, pcap), np.int32)
    opt10 = _opt_arr(opt)
    lib().rb3t_sw_stage(*_index_args(f), P(opt10.ctypes.data), P(flat.ctypes.data), P(seq_off.ctypes.data), R,
                        _threads(R), ncap, pcap, P(ok.ctypes.data), P(n_node.ctypes.data), P(max_pre.ctypes.data),
                        P(node_c.ctypes.data), P(pre.ctypes.data))
    return ok.astype(bool), n_node, max_pre, node_c, pre


def sw_finish(opt: SwOpt, f, flat: np.ndarray, seq_off: np.ndarray, sel: np.ndarray, arch: tuple,
              arch_row: np.ndarray, best_sc: np.ndarray, best_pos: np.ndarray) -> list[list[SwHit]]:
    """The device engine's finish (native `rb3t_sw_finish`): the hits of
    reads sel (of flat, seq_off) from the kernel's archive arch = (lo, hi,
    rc, w) (T, n_best), each read's rows from row arch_row[i], and its
    best_sc / best_pos; positions are not attached."""
    from ..native import lib

    m = len(sel)
    if not m:
        return []
    sel = np.ascontiguousarray(sel, np.int64)
    lo, hi, rc, w = (np.ascontiguousarray(a) for a in arch)
    assert lo.dtype == hi.dtype == rc.dtype == np.int32 and w.dtype == np.int64 and lo.shape[1] == opt.n_best
    arch_row = np.ascontiguousarray(arch_row, np.int64)
    best_sc, best_pos = np.ascontiguousarray(best_sc, np.int32), np.ascontiguousarray(best_pos, np.int32)
    opt10 = _opt_arr(opt)
    out_len = ctypes.c_int64(0)
    ptr = lib().rb3t_sw_finish(*_index_args(f), P(opt10.ctypes.data), P(flat.ctypes.data), P(seq_off.ctypes.data),
                               P(sel.ctypes.data), m, _threads(m), P(lo.ctypes.data), P(hi.ctypes.data),
                               P(rc.ctypes.data), P(w.ctypes.data), P(arch_row.ctypes.data), P(best_sc.ctypes.data),
                               P(best_pos.ctypes.data), ctypes.byref(out_len))
    return _take_blob(lib(), ptr, out_len, m)
