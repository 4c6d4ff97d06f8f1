"""The `sw` and `hapdiv` command loops.  `sw`: reads in batches through the sw
engine, hits written as PAF or (--all-e2e, -g) as QS/QH records, as
search.c writes them.  `hapdiv`: windows of each sequence, batched across
sequences, through the DP, and the run-length merged rows.  A copy of
ropebwt3_tpu/align/cli_hooks.py's `_iter_named`, `_opt_from_dict`,
`_pos_stranded`, `write_paf`, `write_all_hits`, `_emit_sw`, `run_sw_cli`
and `run_hapdiv_cli`, with the port's device engines (align/sw.py,
align/hapdiv.py) in place of the JAX ones and without the JAX package's
resident server.  `--mesh=N` splits each batch over N devices
(`MeshEngines`; align/hapdiv_jax.py:313-341 and sw_jax.py:686-692 place the
windows and reads over `dp` with the tables replicated), and under torchrun
each process takes its share (parallel/launch.py `DistList`).

The engine, as the JAX package chooses it: `auto` and `jax` the device
engine (`--mesh` makes `auto` `jax`), `native` the native DP, `hybrid` each
batch split between the two (`HybridEngine`).  A debug flag (`--dbg-*`, in
sw_opts["dbg"]) sends the native DP to the Python DP (bwasw.py), which
writes the traces: `auto` and `native` then run it alone, `sw` read by read
and `hapdiv` in batches of 64 windows; `hybrid` runs it as its native half;
`jax` writes only the `Q` lines (--dbg-qname), its engine's reruns staying
native."""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import log
from ..nt6 import char2nt6, revcomp
from ..seqio import iter_flat_batches, read_seqs
from .bwasw import (DBG_QNAME, RB3_SWF_E2E, RB3_SWF_HAPDIV, RB3_SWF_KEEP_RS, HapDiv, SwOpt, rb3_hapdiv_multi,
                    rb3_sw_batch)

NATIVE_CAP = 16384  # windows a native DP call
PYTHON_CAP = 64  # windows a Python DP call (lock-step, sw_core_multi)
SW_BATCH = 4096  # reads an sw engine call
# --engine=hybrid: (variable, its default) of the device's share at the
# start, and the floor of the share re-set after each batch; the ceiling is
# SPLIT_MAX for the DPs (ropebwt3_tpu/align/cli_hooks.py:176, 206, 305, 332)
# and MEM_SPLIT_MAX for mem's SMEM engines (ropebwt3_tpu/cli.py:1418, 1442)
SW_SPLIT, HAPDIV_SPLIT = ("RB3TPU_SW_SPLIT", "0.01", 0.002), ("RB3TPU_HAPDIV_SPLIT", "0.05", 0.02)
SPLIT_MAX = 0.5
MEM_SPLIT, MEM_SPLIT_MAX = ("RB3TPU_MEM_SPLIT", "0.35", 0.05), 0.8
_CIG = "MIDNSHP=X"
_NT = "$ACGTN"


def _iter_named(fn: str, is_line: bool):
    """(name, nt6 array) records via the vectorized flat reader when the
    input qualifies, else the streaming parser."""
    fb = iter_flat_batches(fn, is_line, 1 << 28)
    if fb is not None:
        for names, flat, offs in fb:
            for i in range(len(names)):
                yield names[i], flat[offs[i] : offs[i + 1]]
    else:
        for rec in read_seqs(fn, is_line):
            yield rec.name, char2nt6(rec.seq)


def _opt_from_dict(d: dict) -> SwOpt:
    o = SwOpt()
    o.n_best = d["n_best"]
    o.min_sc = d["min_sc"]
    o.match = d["match"]
    o.mis = d["mis"]
    o.gap_open = d["gap_open"]
    o.gap_ext = d["gap_ext"]
    o.end_len = d["end_len"]
    o.min_mem_len = d["min_mem_len"]
    o.e2e_drop = d["e2e_drop"]
    o.r2cache_size = d["r2cache_size"]
    o.max_pos = d["max_pos"]
    o.dbg = d.get("dbg", 0)
    if d["e2e"]:
        o.flag |= RB3_SWF_E2E
    if d["keep_rs"]:
        o.flag |= RB3_SWF_KEEP_RS
    return o


def _pos_stranded(sid, pos_entry, rlen):
    psid, ppos = pos_entry
    clen = int(sid.lens[psid >> 1])
    if (psid & 1) == 0:
        st, en = ppos, ppos + rlen
    else:
        st, en = clen - (ppos + rlen), clen - ppos
    return clen, st, en


def write_paf(out, f, h, name: str, qlen: int, keep_rs: bool) -> None:
    line = [f"{name}\t{qlen}\t{h.qoff[0]}\t{h.qoff[0] + h.qlen}"]
    if h.n_pos > 0:
        psid, ppos = h.pos[0]
        if f.sid is not None:
            clen, st, en = _pos_stranded(f.sid, h.pos[0], h.rlen)
            line.append(f"\t{'+-'[psid & 1]}\t{f.sid.names[psid >> 1]}\t{clen}\t{st}\t{en}")
        else:
            line.append(f"\t+\t{psid}\t*\t{ppos}\t{ppos + h.rlen}")
    else:
        line.append(f"\t*\t*\t{h.rlen}\t*\t*")
    line.append(f"\t{h.mlen}\t{h.blen}\t0")
    line.append(f"\tAS:i:{h.score}\tqh:i:{h.n_qoff}\trh:i:{h.hi - h.lo}\tcg:Z:")
    line.append("".join(f"{c >> 4}{_CIG[c & 0xF]}" for c in h.cigar))
    line.append(f"\tcs:Z:{h.cs}")
    if keep_rs:
        line.append("\trs:Z:" + "".join(_NT[c] for c in h.rseq))
    if h.n_pos > 1:
        tag = "ap" if f.sid is not None else "aq"
        line.append(f"\t{tag[0]}{tag[1]}:Z:")
        for pe in h.pos[1:]:
            psid, ppos = pe
            if f.sid is not None:
                _, st, _ = _pos_stranded(f.sid, pe, h.rlen)
                line.append(f"{f.sid.names[psid >> 1]},{'+-'[psid & 1]},{st};")
            else:
                line.append(f"{psid},{ppos};")
    out.write("".join(line) + "\n")


def write_all_hits(out, name: str, qlen: int, hits, strand: str, max_all_out: int) -> None:
    if max_all_out <= 0:
        max_all_out = 1 << 62
    tot = sum(h.hi - h.lo for h in hits)
    n_out = 0
    for h in hits:
        n_out += h.hi - h.lo
        if n_out >= max_all_out:
            break
    out.write(f"QS\t{name}\t{qlen}\t{len(hits)}\t{strand}\t{n_out}\t{tot}\n")
    n_out = 0
    for h in hits:
        out.write(f"QH\t{h.hi - h.lo}\t{h.score}\t{h.blen - h.mlen}\t{h.cs}\n")
        n_out += h.hi - h.lo
        if n_out >= max_all_out:
            break
    out.write("//\n")


def _emit_sw(out, f, sw_opts, name, q, hits, minus_hits) -> None:
    if sw_opts["write_all"]:
        write_all_hits(out, name, len(q), hits, "+", sw_opts["max_all_out"])
        if sw_opts["both_dir"]:
            write_all_hits(out, name, len(q), minus_hits, "-", sw_opts["max_all_out"])
    else:
        if hits:
            for h in hits:
                write_paf(out, f, h, name, len(q), sw_opts["keep_rs"])
        elif sw_opts["write_unmap"]:
            out.write(f"{name}\t{len(q)}\t*\t*\t*\t*\t*\t*\t*\t0\t0\t0\n")


class MeshEngines:
    """One DP engine a device of `devices` (`--mesh=N`: the first device of
    each dp row), made by `make(device, idx)`, over f's dense rows
    replicated: one copy a distinct device, so [cuda:0] * 2 uploads once.
    `run` splits the items (sw's reads, hapdiv's windows) into contiguous
    shares by count, one a device, runs each on its engine (a thread a
    distinct device) and returns the results in input order; the engines'
    counts add up, and so do their seconds in `seconds` after each run."""

    def __init__(self, f, devices, make):
        from ..cli import check_card
        from ..ops.rank import OccIndex

        for d in {str(d): d for d in devices}.values():  # before any rows are built: one copy a distinct device
            check_card(48 * len(f.occ_block), d, f"the replicated occ rows of a mesh ({d})", "dense")
        rows = {}
        for d in devices:
            rows.setdefault(str(d), OccIndex.from_dense(f, d))
        self.engines = [make(d, rows[str(d)]) for d in devices]
        self.seconds = Counter()

    def run(self, items: list) -> list:
        n = len(self.engines)
        cuts = np.arange(n + 1) * len(items) // n
        by_dev: dict[str, list[int]] = {}
        for j, e in enumerate(self.engines):
            by_dev.setdefault(str(e.device), []).append(j)
        res: dict[int, list] = {}
        before = [Counter(e.seconds) for e in self.engines]

        def run(js):
            for j in js:
                res[j] = self.engines[j].run(items[cuts[j] : cuts[j + 1]])

        if len(by_dev) == 1:
            run(range(n))
        else:
            with ThreadPoolExecutor(len(by_dev)) as ex:
                for fut in [ex.submit(run, js) for js in by_dev.values()]:
                    fut.result()
        for e, b in zip(self.engines, before):
            self.seconds.update(e.seconds - b)
        return [r for j in range(n) for r in res[j]]

    @property
    def idx(self):
        return self.engines[0].idx

    def __getattr__(self, name):  # n_bad, n_card, n_reads, n_shape: summed
        if name.startswith("n_"):
            return sum(getattr(e, name) for e in self.engines)
        raise AttributeError(name)


class HybridEngine:
    """`--engine=hybrid`: each batch's first int(n * share) items (sw's
    reads, hapdiv's windows, mem's reads) on the device engine `dev`, on one
    worker thread, and the rest at the same time on `native`; the results
    in input order, the device's first.  After each batch, the share is
    re-set to the device's measured rate over the sum of both rates, clipped
    to [floor, ceiling] (ropebwt3_tpu/align/cli_hooks.py:183-206, 310-334;
    ropebwt3_tpu/cli.py:1404-1448).  `run` takes a list (`dev.run`, and
    `native` a function of a list: the native DP, or with a debug flag the
    Python DP); `run_flat` a flat batch of reads (`dev.run_flat`, and
    `native` a function of (flat, seq_off)), each half returning (counts,
    rows), as mem's engines do.  n_items and n_dev count the items and the
    device's; the engine's other attributes are dev's."""

    def __init__(self, dev, native, split, ceiling: float = SPLIT_MAX):
        var, default, self.floor = split
        self.dev, self.native, self.share, self.ceiling = dev, native, float(os.environ.get(var, default)), ceiling
        self.rates = {"dev": None, "nat": None}
        self.n_items = self.n_dev = 0
        self.pool = ThreadPoolExecutor(1)

    @staticmethod
    def _timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return time.perf_counter() - t0, out

    def _split(self, n: int, cut, dev_fn, nat_fn):
        """dev_fn on the worker thread and nat_fn here on the halves of a
        batch of n items, cut(nd) giving each one's arguments; (dev's result
        or None when it got no item, native's result)."""
        nd = int(n * self.share)
        dev_args, nat_args = cut(nd)
        fut = self.pool.submit(self._timed, dev_fn, *dev_args) if nd else None
        nat_s, nat = self._timed(nat_fn, *nat_args)
        if n > nd:
            self.rates["nat"] = (n - nd) / max(nat_s, 1e-6)
        dev = None
        if fut is not None:
            dev_s, dev = fut.result()
            self.rates["dev"] = nd / max(dev_s, 1e-6)
        if self.rates["dev"] and self.rates["nat"]:
            self.share = min(self.ceiling, max(self.floor, self.rates["dev"] / (self.rates["dev"] + self.rates["nat"])))
        self.n_items += n
        self.n_dev += nd
        return dev, nat

    def run(self, items: list) -> list:
        dev, nat = self._split(len(items), lambda nd: ((items[:nd],), (items[nd:],)), self.dev.run, self.native)
        return list(dev or []) + list(nat)

    def run_flat(self, flat: np.ndarray, seq_off: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        def cut(nd):
            a = seq_off[nd]
            return (flat[:a], seq_off[: nd + 1]), (flat[a:], seq_off[nd:] - a)

        dev, nat = self._split(len(seq_off) - 1, cut, self.dev.run_flat, self.native)
        if dev is None:
            return nat
        return np.concatenate([dev[0], nat[0]]), np.concatenate([dev[1], nat[1]])

    def close(self) -> None:
        self.pool.shutdown()

    def __getattr__(self, name):
        if name == "dev":  # not set yet
            raise AttributeError(name)
        return getattr(self.dev, name)


def _device_engine(cls, f, opt, device, rows, mesh, hybrid=None):
    """The CLI's DP engine: cls on `device`, over `rows` when given, or over
    the devices of `mesh` (MeshEngines), with the options but the debug
    flags (the device engines write no trace); with `hybrid` = (native,
    split) a HybridEngine over it; under torchrun, each process on its share
    (parallel/launch.py DistList)."""
    opt = dataclasses.replace(opt, dbg=0)
    if mesh is None:
        eng = cls(f, opt, device, idx=rows)
    else:
        eng = MeshEngines(f, mesh, lambda d, idx: cls(f, opt, d, idx=idx))
        log.info("%s over %d devices (%s), the rows replicated on %d", cls.__name__, len(mesh),
                 ", ".join(str(d) for d in mesh), len({str(d) for d in mesh}), func="mesh")
    if hybrid is not None:
        eng = HybridEngine(eng, *hybrid)
    from ..parallel.launch import DistList, world

    return DistList(eng) if world()[1] > 1 else eng


def auto_on_card(f, device, func: str) -> bool:
    """Whether `--engine=auto` runs the DP on the card for index f: not
    where ops/smem.py `resolve_occ` would pick rb rows for it (mem's rule:
    dense rows past AUTO_RB_SHARE of the card, or RB3TPU_DEVICE_OCC=rb),
    nor where the dense rows pass the card's free bytes (cli.card_bytes).
    The JAX package's auto runs the native DP at every index size, so this
    choice places the work and hides no kernel; a native choice is logged
    with the rows' bytes and the budget."""
    import torch

    from ..cli import card_bytes
    from ..ops.smem import auto_rb_budget, resolve_occ

    need, free = 48 * len(f.occ_block), card_bytes(torch.device(device))
    if resolve_occ("auto", f.n, device) == "rb":
        why = f"rb rows by mem's rule (dense rows past {auto_rb_budget(device):.0f} B, or RB3TPU_DEVICE_OCC=rb)"
    elif free is not None and need > free:
        why = f"past the card's {free} B"
    else:
        return True
    log.info("auto runs the native DP: the dense rows need %d B, %s", need, why, func=func)
    return False


def _engine_kind(engine: str, opt: SwOpt, device, mesh, f=None, rows=None, func: str = "sw") -> str:
    """What runs the DP: "device", "hybrid", "native" or "python" (the
    Python DP alone: a debug flag on auto or native, as the JAX package's
    engine choice has it, where --mesh makes auto jax).  Auto without
    rows already on the card (f given) is the native DP where
    `auto_on_card` says the dense rows do not belong there."""
    if mesh is not None and engine == "auto":
        engine = "jax"
    if device is None or engine == "native":
        return "python" if opt.dbg else "native"
    if engine == "hybrid":
        return "hybrid"
    if opt.dbg and engine == "auto":
        return "python"
    if engine == "auto" and rows is None and f is not None and not auto_on_card(f, device, func):
        return "native"
    return "device"


def log_hybrid(e, what: str, func: str) -> None:
    """The hybrid's line (what ran on the card, its share at the end); then
    its worker thread is shut down."""
    log.info("hybrid: %d of %d %s on the card, the card's share at the end %.4f", e.n_dev, e.n_items, what, e.share,
             func=func)
    e.close()


def run_sw_cli(f, files, is_line, sw_opts, device=None, rows=None, mesh=None, engine="auto") -> int:
    """sw of every read of `files`: on `device` ("cuda" or "cpu") through the
    device engine (align/sw.py), over `rows` (a prebuilt OccIndex of f on
    it) when given, on the devices of `mesh` (a list, one a share) when
    given, or on the native engine alone when None; `engine` as
    `_engine_kind` reads it.  Batches of SW_BATCH reads; the engine runs one
    batch ahead of the writer.  The Python DP alone runs read by read, each
    read written before the next is read."""
    from ..cli import seq_openable

    opt = _opt_from_dict(sw_opts)
    out = sys.stdout
    if sw_opts["write_all"]:
        out.write("CC\tQS  queryName  queryLen  numHap\n")
        out.write("CC\tQH  refCount   score     editDist   cs   strand   nOut   totAln\n")
        out.write("CC\n")
    both = sw_opts["write_all"] and sw_opts["both_dir"]
    kind = _engine_kind(engine, opt, device, mesh, f, rows, "sw")
    dev_engine = None
    if kind in ("device", "hybrid"):
        from .sw import SwDeviceEngine

        hybrid = ((lambda qs: rb3_sw_batch(opt, f, qs)), SW_SPLIT) if kind == "hybrid" else None
        dev_engine = _device_engine(SwDeviceEngine, f, opt, device, rows, mesh, hybrid)

    def _sw_batch(qs):
        return rb3_sw_batch(opt, f, qs) if dev_engine is None else dev_engine.run(qs)

    def compute(batch):
        qs = [q for _, q in batch]
        if both:
            allh = _sw_batch(qs + [revcomp(q) for q in qs])
            return allh[: len(qs)], allh[len(qs) :]
        return _sw_batch(qs), [None] * len(qs)

    write_s = 0.0

    def emit(batch, fwd, rev):
        nonlocal write_s
        t0 = time.perf_counter()
        for (name, q), hits, mh in zip(batch, fwd, rev):
            _emit_sw(out, f, sw_opts, name, q, hits, mh)
        write_s += time.perf_counter() - t0

    # pipeline like hapdiv: the engine (GIL-released native code, the card)
    # of batch i+1 overlaps batch i's PAF emit
    _ex = ThreadPoolExecutor(1)
    inflight: list = []

    def flush(batch):
        inflight.append((batch, _ex.submit(compute, batch)))
        while len(inflight) > 1:
            b0, fut = inflight.pop(0)
            emit(b0, *fut.result())

    batch: list = []
    seq_id = 0
    for fn in files:
        if not seq_openable(fn):
            # search.c:571-575: report and stop processing further files
            print(f"ERROR: failed to load the sequence file '{fn}'", file=sys.stderr)
            break
        for name0, q in _iter_named(fn, is_line):
            seq_id += 1
            name = name0 if name0 else f"seq{seq_id}"
            if opt.dbg & DBG_QNAME:
                sys.stderr.write(f"Q\t{name}\t0\n")
            if kind == "python":  # the Python DP: each read's traces, then its output
                hits = rb3_sw_batch(opt, f, [q, revcomp(q)] if both else [q])
                _emit_sw(out, f, sw_opts, name, q, hits[0], hits[1] if both else None)
                continue
            batch.append((name, q))
            if len(batch) >= SW_BATCH:
                flush(batch)
                batch = []
    if batch:
        flush(batch)
    while inflight:
        b0, fut = inflight.pop(0)
        emit(b0, *fut.result())
    _ex.shutdown()
    if dev_engine is not None:
        from .sw import SwDeviceEngine, sw_cuda

        e = dev_engine
        lay = e.idx.layout if e.idx is not None else "dense32"
        log.info("%d sw launches (%s); %d of %d reads on the card, %d flagged bad and %d of a DAWG the card does not "
                 "take, both rerun on the native engine", sw_cuda.launches[lay], lay, e.n_card, e.n_reads, e.n_bad,
                 e.n_shape, func="sw")
        log.info("wall seconds by piece (the engine's overlap the writer's): %s, write %.3f",
                 ", ".join(f"{k} {e.seconds[k]:.3f}" for k in SwDeviceEngine.PIECES),
                 write_s, func="sw")
        if kind == "hybrid":
            log_hybrid(e, "reads", "sw")
    return 0


def run_hapdiv_cli(f, files, is_line, sw_opts, k, w, device=None, rows=None, mesh=None, engine="auto") -> int:
    """hapdiv of every k-mer at step w of each sequence of `files`: on
    `device` ("cuda" or "cpu") through the device engine, over `rows` (a
    prebuilt OccIndex of f on it) when given, on the devices of `mesh` (a
    list, one a share) when given, or on the native DP alone when None;
    `engine` as `_engine_kind` reads it."""
    from ..cli import seq_openable

    opt = _opt_from_dict(sw_opts)
    opt.flag |= RB3_SWF_E2E | RB3_SWF_HAPDIV
    out = sys.stdout
    seq_id = n_win = 0
    # Windows are batched ACROSS reads into one DP call: short reads
    # contribute only 1-2 windows each.  Window results are run-length
    # merged per sequence (search.c:327-353); batching cannot change any row.
    # A batch closes once it holds CAP windows or more: the Python DP's
    # traces interleave the windows of a batch, so its batches are cut as
    # the JAX package cuts them (ropebwt3_tpu/align/cli_hooks.py:282)
    kind = _engine_kind(engine, opt, device, mesh, f, rows, "hapdiv")
    CAP = PYTHON_CAP if kind == "python" else NATIVE_CAP
    dev_engine = None
    if kind in ("device", "hybrid"):
        from .hapdiv import LANES, HapdivDeviceEngine

        hybrid = ((lambda ws: rb3_hapdiv_multi(opt, f, ws)), HAPDIV_SPLIT) if kind == "hybrid" else None
        dev_engine = _device_engine(HapdivDeviceEngine, f, opt, device, rows, mesh, hybrid)
        CAP = LANES if hybrid is None else 4 * LANES

    def _compute(batch_wins):
        if dev_engine is None:
            return rb3_hapdiv_multi(opt, f, batch_wins)
        return dev_engine.run(batch_wins)

    pend: list[tuple[str, list[int]]] = []
    wins: list = []
    # pipeline: the DP runs in a worker thread, so the previous batch's emit
    # and the next one's window staging overlap its compute
    _ex = ThreadPoolExecutor(1)
    _inflight: list = []  # [(pend, future)]

    def _emit(done_pend, rs):
        t0 = time.perf_counter()
        pos = 0
        for name, offs in done_pend:
            results = []
            for j in offs:
                r = rs[pos]
                pos += 1
                if r is None:
                    r = HapDiv()
                results.append((j, (r.n_al, r.max_ed, tuple(r.n_hap))))
            # merge identical consecutive windows
            i0 = 0
            for i1 in range(1, len(results) + 1):
                if i1 == len(results) or results[i1][1] != results[i0][1]:
                    off0 = results[i0][0]
                    off_last = results[i1 - 1][0]
                    n_al, max_ed, n_hap = results[i0][1]
                    row = f"{name}\t{off0}\t{off_last + k}\t{n_al}\t{max_ed}\t" + "\t".join(str(x) for x in n_hap)
                    out.write(row + "\n")
                    i0 = i1
        if dev_engine is not None:
            dev_engine.seconds["write"] += time.perf_counter() - t0

    def flush():
        nonlocal pend, wins
        if not pend:
            return
        _inflight.append((pend, _ex.submit(_compute, wins)))
        pend, wins = [], []
        while len(_inflight) > 1:  # emit everything but the batch in flight
            done_pend, fut = _inflight.pop(0)
            _emit(done_pend, fut.result())

    for fn in files:
        if not seq_openable(fn):
            print(f"ERROR: failed to load the sequence file '{fn}'", file=sys.stderr)
            break
        for name0, q in _iter_named(fn, is_line):
            seq_id += 1
            name = name0 if name0 else f"seq{seq_id}"
            if len(q) < k:
                continue
            t0 = time.perf_counter()
            offs = list(range(0, len(q) - k + 1, w))
            pend.append((name, offs))
            n_win += len(offs)
            wins.extend(q[j : j + k] for j in offs)
            if dev_engine is not None:
                dev_engine.seconds["cut"] += time.perf_counter() - t0
            if len(wins) >= CAP:
                flush()
    flush()
    while _inflight:
        done_pend, fut = _inflight.pop(0)
        _emit(done_pend, fut.result())
    _ex.shutdown()
    if dev_engine is not None:
        from .hapdiv import hapdiv_cuda

        lay = dev_engine.idx.layout if dev_engine.idx is not None else "dense32"
        log.info("%d hapdiv launches (%s); %d of %d windows flagged bad, rerun on the native DP",
                 hapdiv_cuda.launches[lay], lay, dev_engine.n_bad, n_win, func="hapdiv")
        log.info("wall seconds by piece (the engine's overlap the cut and the write): %s",
                 ", ".join(f"{p} {dev_engine.seconds[p]:.3f}" for p in HapdivDeviceEngine.PIECES), func="hapdiv")
        if kind == "hybrid":
            log_hybrid(dev_engine, "windows", "hapdiv")
    return 0
