"""BWA-SW, a copy of ropebwt3_tpu/align/bwasw.py: the options (`SwOpt`,
whose `dbg` carries the command's --dbg-* flags), `HapDiv`, `SwHit`, the
native engine's wrappers (`_hapdiv_native`, `rb3_hapdiv_multi`,
`_attach_positions_multi`, `_parse_sw_blob`, `rb3_sw_batch`), the device sw
engine's native staging and finish (`sw_stage`, `sw_finish`), and the
Python DP (`sw_core_multi`, `sw_backtrack`, `_rb3_sw_python`).

The native DP is native/bwasw_core.cpp (`rb3t_hapdiv_batch`,
`rb3t_sw_batch`), a copy of the JAX package's native core: an exact
re-implementation of the reference bwa-sw.c:329-526; `native.lib()` raises
when the library cannot be built.  The Python DP is the same DP in Python
(khashl_compat.py's hash set and heaps, bwtl.py's DAWG, DenseFMIndex.extend
for the ranks), and only it writes the debug streams: `DG` (the DAWG), `SW`
(each DP row) and `BT` (each backtrack step) lines on stderr.  As in the
JAX package, whose native core is skipped while its global `dbg_flag` is
set, a debug flag in `opt.dbg` sends `rb3_sw_batch` and
`rb3_hapdiv_multi` to the Python DP; here the flags live in the options,
so nothing carries over from one command to the next.
"""

from __future__ import annotations

import ctypes
import os
import sys
from dataclasses import dataclass, field

import numpy as np

from ..index.dense import DenseFMIndex
from ..nt6 import NT6_TABLE
from .bwtl import Dawg, bwtl_gen, dawg_gen, dawg_gen_linear
from .khashl_compat import KhashlSet, kh_hash_uint64, ks_heapdown, ks_heapsort, ks_heapup, ks_ksmall

DBG_DAWG, DBG_SW, DBG_QNAME, DBG_BT = 1, 2, 4, 8  # rb3_dbg_flag's bits (rb3priv.h:7-10)
DBG_OPTS = {"--dbg-dawg": DBG_DAWG, "--dbg-sw": DBG_SW, "--dbg-qname": DBG_QNAME, "--dbg-bt": DBG_BT}

SW_FROM_H, SW_FROM_E, SW_FROM_F = 0, 1, 2
SW_FROM_OPEN, SW_FROM_EXT = 0, 1
SW_F_UNSET = 0x3FFFFFF
UINT32_MAX = 0xFFFFFFFF
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
    dbg: int = 0  # DBG_* bits of --dbg-*: the Python DP and its traces


class Cell:
    __slots__ = ("H", "E", "F", "flt", "H_from", "E_from", "F_from", "F_from_off", "F_off_set", "H_from_pos", "E_from_pos", "rlen", "qlen", "lo", "hi", "lo_rc")

    def __init__(self):
        self.H = self.E = self.F = 0
        self.flt = 0
        self.H_from = self.E_from = self.F_from = 0
        self.F_from_off = 0
        self.F_off_set = 0
        self.H_from_pos = self.E_from_pos = 0
        self.rlen = self.qlen = 0
        self.lo = self.hi = self.lo_rc = 0

    def copy(self) -> "Cell":
        c = Cell.__new__(Cell)
        c.H = self.H
        c.E = self.E
        c.F = self.F
        c.flt = self.flt
        c.H_from = self.H_from
        c.E_from = self.E_from
        c.F_from = self.F_from
        c.F_from_off = self.F_from_off
        c.F_off_set = self.F_off_set
        c.H_from_pos = self.H_from_pos
        c.E_from_pos = self.E_from_pos
        c.rlen = self.rlen
        c.qlen = self.qlen
        c.lo = self.lo
        c.hi = self.hi
        c.lo_rc = self.lo_rc
        return c


def _cell_hash(c: Cell) -> int:
    return (kh_hash_uint64(c.lo) + kh_hash_uint64(c.hi)) & 0xFFFFFFFF


def _cell_eq(a: Cell, b: Cell) -> bool:
    return a.lo == b.lo and a.hi == b.hi


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


def _update_candset(h: KhashlSet, p: Cell) -> tuple[Cell, int]:
    """sw_update_candset (bwa-sw.c:265-284). Returns (stored cell, changed)."""
    itr, absent = h.put(p, copy_on_insert=True)
    if not absent:
        q = h.keys[itr]
        q.rlen = max(q.rlen, p.rlen)
        q.qlen = max(q.qlen, p.qlen)
        changed = 0
        if q.E < p.E:
            q.E, q.E_from, q.E_from_pos = p.E, p.E_from, p.E_from_pos
            changed |= 1 << 1
        if q.F < p.F:
            q.F, q.F_from = p.F, p.F_from
            changed |= 1 << 2
        if q.H < p.H:
            q.H, q.H_from = p.H, p.H_from
            changed |= 1 << 0
            if p.H_from == SW_FROM_H:
                q.H_from_pos = p.H_from_pos
        return q, changed
    return h.keys[itr], 7


def _heap_lt(a, b):  # reverse_lt on uint64-packed (score, id)
    return a > b


def _heap_insert1(heap: list, maxn: int, score: int, id_: int) -> int:
    x = (score << 32) | id_
    if len(heap) < maxn:
        heap.append(x)
        ks_heapup(heap, _heap_lt)
        return 1
    if x > heap[0]:
        heap[0] = x
        ks_heapdown(heap, 0, len(heap), _heap_lt)
        return 1
    return 0


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
    """hapdiv of windows of equal length (nt6) on the native DP, threaded,
    or with opt.dbg on the Python DP, all windows lock-step
    (sw_core_multi); None for a window whose best score is below
    opt.min_sc."""
    if not seqs:
        return []
    if any(len(s) != len(seqs[0]) for s in seqs):
        raise ValueError("rb3_hapdiv_multi takes windows of one length")
    if not opt.dbg:
        return _hapdiv_native(opt, f, seqs)
    gs = [dawg_gen_linear(s) for s in seqs]
    outs = sw_core_multi(opt, f, gs)
    res: list[HapDiv | None] = []
    for (rows, best_pos, best_score), g, seq in zip(outs, gs, seqs):
        if best_score >= opt.min_sc:
            _, anno = sw_backtrack(opt, f, g, seq, rows, best_pos, True)
            res.append(anno)
        else:
            res.append(None)
    return res


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
    backtrack), threaded, or with opt.dbg through the Python DP read by
    read; with `attach` each hit's positions too."""
    from ..native import lib

    if opt.dbg:
        return [_rb3_sw_python(opt, f, s, attach) for s in seqs]
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


# ---------------------------------------------------------------------------
# the Python DP (ropebwt3_tpu/align/bwasw.py:256-781)
# ---------------------------------------------------------------------------


def sw_core_multi(opt: SwOpt, f: DenseFMIndex, gs: list[Dawg]):
    """Lock-step DP over W same-shaped DAWGs (e.g. hapdiv windows): the
    per-cell H/E extends and the F-closure rounds of ALL windows batch into
    single vectorized ranks, while each window's heap/candset logic runs its
    exact scalar sequence (bit-identical to one-window processing).

    Returns [(rows, best_pos, best_score), ...] per window."""
    n_col = opt.n_best
    W = len(gs)
    n_node = gs[0].n_node
    assert all(g.n_node == n_node for g in gs)

    class WState:
        __slots__ = ("g", "rows", "h", "fpar", "last_p", "best_score", "best_pos")

    ws: list[WState] = []
    for g in gs:
        w = WState()
        w.g = g
        w.rows = [[] for _ in range(n_node)]
        root = Cell()
        root.lo, root.hi, root.lo_rc = 0, int(f.acc[6]), 0
        root.H_from = SW_FROM_H
        w.rows[0].append(root)
        w.h = KhashlSet(_cell_hash, _cell_eq)
        w.h.resize(opt.n_best * 4)
        w.fpar = []
        w.last_p = root  # reference keeps a dangling pointer to the last visited cell
        w.best_score, w.best_pos = 0, 0
        ws.append(w)

    def extend_batch(cells) -> np.ndarray:
        iks = np.array([[c.lo, c.lo_rc, c.hi - c.lo] for c in cells], dtype=np.int64)
        return f.extend(iks, True)  # (n, 6, 3)

    for i in range(1, n_node):
        # ---- per-window pruning bound + cell collection -------------------
        batch: list[tuple[WState, int, int, Cell]] = []
        mms: dict[int, int] = {}
        for wi, w in enumerate(ws):
            t = w.g.node[i]
            w.h.clear()
            max_min_sc = 0
            if len(t.pre) > 1:
                n_cell = sum(len(w.rows[p]) for p in t.pre)
                if n_cell > opt.n_best:
                    ks_a = []
                    for pid in t.pre:
                        ks_a.extend(c.H for c in w.rows[pid])
                    max_min_sc = ks_ksmall(ks_a, opt.n_best, lt=lambda a, b: a > b)
                max_min_sc -= max(opt.gap_open + opt.gap_ext, opt.mis)
                if max_min_sc < 0:
                    max_min_sc = 0
            mms[wi] = max_min_sc
            for pid in t.pre:
                for k, p in enumerate(w.rows[pid]):
                    batch.append((w, pid, k, p))
        ok_batch = extend_batch([p for _, _, _, p in batch]) if batch else None

        # ---- H and E (scalar per window, batched extends) ------------------
        widx = {id(w): mms[x] for x, w in enumerate(ws)}
        for bi, (w, pid, k, p) in enumerate(batch):
            t = w.g.node[i]
            h = w.h
            max_min_sc = widx[id(w)]
            w.last_p = p
            if p.H + opt.match < max_min_sc:
                continue
            ok = ok_batch[bi]
            r = Cell()
            r.F_from_off = SW_F_UNSET
            r.H_from, r.H_from_pos, r.E_from_pos = SW_FROM_H, pid * n_col + k, UINT32_MAX
            for c in range(1, 6):
                sc = opt.match if (c == t.c and c != 5) else -opt.mis
                if ok[c][2] == 0:
                    continue
                if p.H + sc <= 0 or p.H + sc < max_min_sc:
                    continue
                if c != t.c and p.qlen < opt.end_len:
                    continue
                r.lo, r.hi, r.lo_rc = int(ok[c][0]), int(ok[c][0] + ok[c][2]), int(ok[c][1])
                r.H = p.H + sc
                r.rlen, r.qlen = p.rlen + 1, p.qlen + 1
                _update_candset(h, r)
            # E (insertion in query)
            if p.H - opt.gap_open > p.E:
                r.E_from, r.E = SW_FROM_OPEN, p.H - opt.gap_open
            else:
                r.E_from, r.E = SW_FROM_EXT, p.E
            r.E -= opt.gap_ext
            if r.E > 0 and r.E >= max_min_sc and p.qlen >= opt.end_len:
                # NB: the reference only sets lo/hi here; lo_rc keeps the
                # stale value from the last H candidate (bwa-sw.c:418)
                r.lo, r.hi = p.lo, p.hi
                r.H = r.E
                r.H_from = SW_FROM_E
                r.E_from_pos, r.H_from_pos = pid * n_col + k, UINT32_MAX
                r.rlen, r.qlen = p.rlen, p.qlen + 1
                _update_candset(h, r)

        # ---- top-n selection + F closure (lock-step rounds) ----------------
        class FCtx:
            __slots__ = ("heap", "fstack", "n_fpar", "fpar_base", "pending_z", "pending_r", "pending_min")

        fctxs: dict[int, FCtx] = {}
        for w in ws:
            w.rows[i] = []
            if w.h.count == 0:
                continue
            heap: list[int] = []
            for itr in w.h:
                _heap_insert1(heap, opt.n_best, w.h.keys[itr].H, itr)
            ks_heapsort(heap, _heap_lt)
            w.rows[i] = [w.h.keys[x & UINT32_MAX].copy() for x in heap]
            heap.reverse()  # remains a heap
            fc = FCtx()
            fc.heap = heap
            fc.n_fpar = 0
            fc.fpar_base = len(w.fpar)
            fc.pending_z = None
            fc.pending_r = None
            if w.last_p.qlen >= opt.end_len:
                fc.fstack = [w.rows[i][j].copy() for j in range(len(w.rows[i]) - 1, -1, -1) if w.rows[i][j].H > opt.gap_open + opt.gap_ext]
            else:
                fc.fstack = []
            fctxs[id(w)] = fc

        # rounds: each active window advances to its next extend-needing pop
        active = [w for w in ws if id(w) in fctxs and fctxs[id(w)].fstack]
        while active:
            todo: list[tuple[WState, FCtx]] = []
            for w in active:
                fc = fctxs[id(w)]
                while fc.fstack:
                    z = fc.fstack.pop()
                    minv = 0 if len(fc.heap) < opt.n_best else fc.heap[0] >> 32
                    r = Cell()
                    r.H_from_pos = r.E_from_pos = UINT32_MAX
                    r.F_from_off = SW_F_UNSET
                    if z.H - opt.gap_open > z.F:
                        r.F_from, r.F = SW_FROM_OPEN, z.H - opt.gap_open
                    else:
                        r.F_from, r.F = SW_FROM_EXT, z.F
                    r.F -= opt.gap_ext
                    r.H, r.H_from = r.F, SW_FROM_F
                    r.rlen, r.qlen = z.rlen + 1, z.qlen
                    if r.H <= minv:
                        continue
                    fc.pending_z, fc.pending_r, fc.pending_min = z, r, minv
                    todo.append((w, fc))
                    break
            if not todo:
                break
            oks = extend_batch([fc.pending_z for _, fc in todo])
            for (w, fc), ok in zip(todo, oks):
                z, r = fc.pending_z, fc.pending_r
                for c in range(1, 6):
                    if ok[c][2] == 0:
                        continue
                    r.lo, r.hi, r.lo_rc = int(ok[c][0]), int(ok[c][0] + ok[c][2]), int(ok[c][1])
                    q, changed = _update_candset(w.h, r)
                    if changed & (1 << 2):  # q->F has been updated
                        _heap_insert1(fc.heap, opt.n_best, r.H, UINT32_MAX)
                        w.fpar.append((z.lo, z.hi))
                        q.F_from, q.F_from_off = r.F_from, fc.fpar_base + fc.n_fpar
                        fc.n_fpar += 1
                        # NB: compares against the heap min captured at pop
                        # time, exactly like the scalar loop (bwa-sw.c:453,476)
                        if r.H - opt.gap_ext > fc.pending_min:
                            fc.fstack.append(q.copy())
            active = [w for w in ws if id(w) in fctxs and fctxs[id(w)].fstack]

        # ---- rebuild heap/row, track F, best, dedup ------------------------
        for w in ws:
            if id(w) not in fctxs:
                continue
            fc = fctxs[id(w)]
            heap = []
            for itr in w.h:
                _heap_insert1(heap, opt.n_best, w.h.keys[itr].H, itr)
            ks_heapsort(heap, _heap_lt)
            assert heap
            w.rows[i] = [w.h.keys[x & UINT32_MAX].copy() for x in heap]
            if fc.n_fpar > 0:
                _track_F(w.h, w.fpar, w.rows[i])
            if w.rows[i][0].H > w.best_score:
                w.best_score, w.best_pos = w.rows[i][0].H, i * n_col
            if i == n_node - 1:
                _cell_dedup(w.rows[i])
            if opt.dbg & DBG_SW:
                t = w.g.node[i]
                sys.stderr.write(
                    "SW\t%d\t[%d,%d)\t%d\t%s\t%s\n"
                    % (i, t.lo, t.hi, len(w.rows[i]), ",".join(str(p) for p in t.pre),
                       ",".join("%d(%d)" % (cl.H, cl.qlen - cl.rlen) for cl in w.rows[i]))
                )
    return [(w.rows, w.best_pos, w.best_score) for w in ws]


def _track_F(h: KhashlSet, fpar: list, row: list[Cell]) -> None:
    """Compute F_from_off as a row-column index (bwa-sw.c:301-324)."""
    h.clear()
    for j, cell in enumerate(row):
        r = cell.copy()
        r.H = j  # reuse H as index
        h.put(r)
    for p in row:
        if p.F == 0 or p.F_from_off == SW_F_UNSET:
            continue
        r = Cell()
        r.lo, r.hi = fpar[p.F_from_off]
        k = h.get(r)
        if k != h.end():
            p.F_from_off = h.keys[k].H
            p.F_off_set = 1
        else:
            assert p.H_from != SW_FROM_F
            p.F_from_off = SW_F_UNSET


def _cell_dedup(row: list[Cell]) -> None:
    """Containment dedup of the final row (bwa-sw.c:197-216)."""
    if len(row) <= 1:
        return
    a = [0]
    for i in range(1, len(row)):
        p = row[i]
        contained = False
        for j in a:
            q = row[j]
            if q.lo_rc <= p.lo_rc and q.lo_rc + (q.hi - q.lo) >= p.lo_rc + (p.hi - p.lo):
                contained = True
                break
            if q.lo <= p.lo and q.hi >= p.hi:
                contained = True
                break
        if not contained:
            a.append(i)
        else:
            p.flt = 1


# ---------------------------------------------------------------------------
# Backtrack
# ---------------------------------------------------------------------------


def _ref_base(f: DenseFMIndex, lo: int) -> int:
    for c in range(1, 7):
        if f.acc[c] > lo:
            return c - 1
    return 5


def _backtrack1_core(opt: SwOpt, f: DenseFMIndex, g: Dawg, rows, pos: int, hit: SwHit, len_only: bool) -> int:
    n_col = opt.n_best
    last, last_op, ed = 0, -1, 0
    hit.score = rows[pos // n_col][pos % n_col].H
    hit.n_cigar = hit.rlen = hit.qlen = 0
    cig: list[int] = []
    rseq: list[int] = []
    while pos > 0:
        r = pos // n_col
        p = rows[r][pos % n_col]
        if opt.dbg & DBG_BT:
            sys.stderr.write("BT\t%d\t%d\t%d\n" % (r, pos % n_col, p.H))
        x = p.H_from | p.E_from << 2 | p.F_from << 3
        state = (x & 0x3) if last == 0 else last
        ext = (x >> (state + 1)) & 1 if state in (1, 2) else 0
        c = _ref_base(f, p.lo)
        op = state
        if state == SW_FROM_H:
            op = 7 if c == g.node[r].c else 8
            pos = p.H_from_pos
            ed += op == 8
        elif state == SW_FROM_E:
            assert p.E > 0 and p.E_from_pos != UINT32_MAX
            pos = p.E_from_pos
            ed += 1
        else:  # SW_FROM_F
            assert p.F > 0 and p.F_off_set
            pos = r * n_col + p.F_from_off
            ed += 1
        # push state
        if not len_only:
            # sw_push_state writes rseq[rlen] BEFORE bumping rlen
            # (bwa-sw.c:63): an insertion (op 1) leaves rlen unchanged, so its
            # base is overwritten by the next reference-consuming op and never
            # appears in rseq
            if hit.rlen == len(rseq):
                rseq.append(c)
            else:
                rseq[hit.rlen] = c
            if last_op == op:
                cig[-1] += 1 << 4
            else:
                cig.append(1 << 4 | op)
        else:
            hit.n_cigar += 0 if last_op == op else 1
        if op in (7, 8):
            hit.qlen += 1
            hit.rlen += 1
        elif op == 1:
            hit.qlen += 1
        elif op == 2:
            hit.rlen += 1
        last_op = op
        last = state if (state in (1, 2) and ext) else 0
    if not len_only:
        hit.cigar = cig
        hit.rseq = rseq[: hit.rlen]  # drop a trailing insertion's write
        hit.n_cigar = len(cig)
    return ed


def _cs_core(hit: SwHit, qseq: np.ndarray) -> None:
    CH = "$acgtn"
    out = []
    x, y = 0, hit.qoff[0]
    for cval in hit.cigar:
        op, ln = cval & 0xF, cval >> 4
        if op == 7:
            out.append(f":{ln}")
            x += ln
            y += ln
        elif op == 8:
            for i in range(ln):
                out.append(f"*{CH[qseq[y+i]]}{CH[hit.rseq[x+i]]}")
            x += ln
            y += ln
        elif op == 1:
            out.append("+" + "".join(CH[qseq[y + i]] for i in range(ln)))
            y += ln
        elif op == 2:
            out.append("-" + "".join(CH[hit.rseq[x + i]] for i in range(ln)))
            x += ln
    hit.cs = "".join(out)
    hit.cs_len = len(hit.cs)


def _backtrack1(opt: SwOpt, f: DenseFMIndex, g: Dawg, qseq: np.ndarray, rows, pos: int) -> SwHit:
    hit = SwHit()
    n_col = opt.n_best
    p = g.node[pos // n_col]
    q = rows[pos // n_col][pos % n_col]
    hit.lo, hit.hi = q.lo, q.hi
    if p.hi >= 0:  # [lo,hi) is a SA interval on the query
        hit.qoff = [int(g.bwt.sa[k]) for k in range(p.lo, p.hi)]
    else:
        hit.qoff = [p.lo]
    # the reference walks twice (length-only then fill, bwa-sw.c:176-179);
    # replicate so --dbg-bt traces match byte-for-byte
    _backtrack1_core(opt, f, g, rows, pos, hit, True)
    _backtrack1_core(opt, f, g, rows, pos, hit, False)
    _cs_core(hit, qseq)
    hit.mlen = hit.blen = 0
    for cval in hit.cigar:
        op, ln = cval & 0xF, cval >> 4
        hit.blen += ln
        if op == 7:
            hit.mlen += ln
    return hit


def sw_backtrack(opt: SwOpt, f: DenseFMIndex, g: Dawg, qseq: np.ndarray, rows, best_pos: int, want_anno: bool):
    """Returns (list[SwHit] | None, HapDiv | None)."""
    n_col = opt.n_best
    if opt.flag & (RB3_SWF_E2E | RB3_SWF_HAPDIV):
        prow = rows[g.n_node - 1]
        if not prow:
            return ([] if not want_anno else None), (HapDiv() if want_anno else None)
        H0 = prow[0].H
        sel = [
            (i, q)
            for i, q in enumerate(prow)
            if not q.flt and q.H_from == SW_FROM_H and q.H >= opt.min_sc and (opt.e2e_drop < 0 or H0 - q.H <= opt.e2e_drop)
        ]
        if not sel:
            return ([] if not want_anno else None), (HapDiv() if want_anno else None)
        if want_anno:
            a = HapDiv()
            a.n_al = len(sel)
            tmp = SwHit()
            for i, q in sel:
                ed = _backtrack1_core(opt, f, g, rows, (g.n_node - 1) * n_col + i, tmp, True)
                a.max_ed = max(a.max_ed, ed)
                a.n_hap[min(ed, RB2_SW_MAX_ED)] += q.hi - q.lo
            return None, a
        hits = [_backtrack1(opt, f, g, qseq, rows, (g.n_node - 1) * n_col + i) for i, q in sel]
        return hits, None
    return [_backtrack1(opt, f, g, qseq, rows, best_pos)], None


def _rb3_sw_python(opt: SwOpt, f, seq: np.ndarray, attach: bool = True) -> list[SwHit]:
    """One read (nt6) through the Python DP: the -j prefilter, its DAWG (a
    chain with -e), the DP and the backtrack; with `attach` its hits'
    positions."""
    from ..ops.smem_ref import smem_present

    if opt.min_mem_len > 0 and opt.min_mem_len > opt.end_len:
        if not smem_present(f, seq, opt.min_mem_len):
            return []
    if opt.flag & RB3_SWF_E2E:
        g = dawg_gen_linear(seq)
    else:
        g = dawg_gen(bwtl_gen(seq), bool(opt.dbg & DBG_DAWG))
    ((rows, best_pos, best_score),) = sw_core_multi(opt, f, [g])
    hits: list[SwHit] = []
    if best_score >= opt.min_sc:
        hits, _ = sw_backtrack(opt, f, g, seq, rows, best_pos, False)
        hits = hits or []
    if attach:
        _attach_positions_multi(opt, f, [hits])
    return hits


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
