"""The `hapdiv` driver: windows of each sequence, batched across sequences,
through the DP, and the run-length merged rows written as search.c writes
them.  A copy of ropebwt3_tpu/align/cli_hooks.py's `_iter_named`,
`_opt_from_dict` and `run_hapdiv_cli`, with the port's device engine
(align/hapdiv.py) in place of the JAX one and without the JAX package's
hybrid pool, mesh and resident server."""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

from .. import log
from ..nt6 import char2nt6
from ..seqio import iter_flat_batches, read_seqs
from .bwasw import RB3_SWF_E2E, RB3_SWF_HAPDIV, RB3_SWF_KEEP_RS, HapDiv, SwOpt, rb3_hapdiv_multi

NATIVE_CAP = 16384  # windows a native DP call


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
    if d["e2e"]:
        o.flag |= RB3_SWF_E2E
    if d["keep_rs"]:
        o.flag |= RB3_SWF_KEEP_RS
    return o


def run_hapdiv_cli(f, files, is_line, sw_opts, k, w, device=None) -> int:
    """hapdiv of every k-mer at step w of each sequence of `files`: on
    `device` ("cuda" or "cpu") through the device engine, or on the native
    DP alone when None."""
    from ..cli import seq_openable

    opt = _opt_from_dict(sw_opts)
    opt.flag |= RB3_SWF_E2E | RB3_SWF_HAPDIV
    out = sys.stdout
    seq_id = n_win = 0
    # Windows are batched ACROSS reads into one DP call: short reads
    # contribute only 1-2 windows each.  Window results are run-length
    # merged per sequence (search.c:327-353); batching cannot change any row.
    CAP = NATIVE_CAP
    dev_engine = None
    if device is not None:
        from .hapdiv import LANES, HapdivDeviceEngine

        dev_engine = HapdivDeviceEngine(f, opt, device)
        CAP = LANES

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
            offs = list(range(0, len(q) - k + 1, w))
            pend.append((name, offs))
            n_win += len(offs)
            wins.extend(q[j : j + k] for j in offs)
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
    return 0
