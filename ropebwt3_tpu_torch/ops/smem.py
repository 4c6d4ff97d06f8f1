"""Batched SMEM-TG (the `mem` engine) on a torch device.

Port of ropebwt3_tpu/ops/smem.py + ops/smem_fsm.py.  Reads arrive as one
flat nt6 buffer plus int64 offsets (read r = flat[seq_off[r]:seq_off[r+1]],
the native engine's contract, ropebwt3_tpu/ops/smem_native.py:99-103), so
nothing is padded.  Every function takes either occ layout (ops/rank.py
`OccIndex`, ops/runblock.py `RunBlockIndex`) in either width.

A chain is one run of the SMEM-TG state machine over one read.  Its state at
START is a function of x alone, x strictly increases, and each window emits
at most once with st = x.  So a read can run as several chains, LANES
(read, x0, x_stop): a lane starts at START x0, stops at the first START
x >= x_stop (or the read's end) and logs every START x it passes.  Two lanes
that log the same START x coincide from there on.  `smem_tg` cuts each read
longer than CHUNK symbols at multiples of CHUNK, lets each lane run MARGIN
symbols into the next chunk, and `stitch`es the lanes' emits into the
serial answer:

  m_0 = 0; m_t = the first START x >= m_{t-1} logged by both lane t-1 and
  lane t; lane t contributes its emits with st in [m_t, m_{t+1}).

A read with a boundary where the two lanes never meet (`n_unmerged`) is
rerun as chunk lanes with twice the margin, and whole by one thread only if
its lanes still do not meet (`n_whole`); a read whose lane buffers overflow
(more than max_mems emits) is rerun through the same kernel with a buffer
of the true count (`n_rerun`).  Every rerun is a launch of the card's
kernels.  The stitch holds for any margin: m_t >= m_{t-1} by construction,
so a margin past the next chunk's start keeps the ranges in lane order.

`smem_tg_plain` is a lock-step lane loop in PyTorch, the plain version of
the CUDA kernels (csrc/smem_tg.cu) that `smem_tg_cuda` (one thread per read)
and `smem_tgc_cuda` (one thread per lane) launch, one variant per layout.
A CPU tensor takes the plain version; a CUDA tensor launches or raises.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels, log
from ..index.dense import DenseFMIndex
from .rank import OccIndex, extend_c, set_intv
from .runblock import RunBlockIndex

# `occ=auto` takes rb rows when dense rows (0.75 B/sym) would pass this share
# of the card's memory: the JAX package's 12e9 bytes of a 16 GB TPU chip
# (ropebwt3_tpu/ops/smem.py:157), which stays the budget on the CPU
AUTO_RB_SHARE = 0.75
AUTO_RB_BYTES_CPU = 12e9

PH_START, PH_BACK1, PH_FWD, PH_BACK2, PH_DONE = range(5)
MAX_MEMS = 64  # MEM buffer rows per chain, the JAX engine's default

# The longest lane sets smem_tgc's time.  Its trips do not fall in step with
# CHUNK: a window's forward extension runs to the end of its MEM, past the
# lane's stop, and BACK2 walks back over it, so where long MEMs overlap (a
# read against many similar genomes) single windows cost thousands of
# extensions.  Measured on bench.py's batch on an H100 (PERF.md; exact at
# each; smem_tgc, then the engine): CHUNK 1024 / MARGIN 512 7.4 / 12.4 ms,
# 512 / 256 5.1 / 9.7 ms, 256 / 128 3.9 / 7.3 ms, 128 / 64 3.5 / 41 ms (4 reads
# whose lanes did not meet, all resolved at twice the margin) and 64 / 32
# 3.0 / 224 ms (714, 10 of them rerun whole): the stitch and the reruns cost
# more than the shorter lanes save.
CHUNK, MARGIN = 256, 128
# START log entries per lane at MARGIN: one per 3 symbols of a lane's span.
# A fuller log drops the rest; a boundary whose meeting point it dropped
# does not meet.
LOG_LEN = 128
NO_STOP = (1 << 31) - 1  # x_stop of a lane that runs to its read's end


class Chains(NamedTuple):
    """What the SMEM kernels and their plain version return, per chain."""

    mems: torch.Tensor  # (L, M, 5) (start, end, size, lo, lo_rc) in emit order, the index's width
    n_mem: torch.Tensor  # (L,) int32 TRUE emit counts; past M the last slot holds the latest emit
    log: torch.Tensor | None  # (L, log_len) int32 START log: each START x, then END = read length + 1
    n_log: torch.Tensor | None  # (L,) int32 TRUE log counts; entries past log_len are dropped
    trips: torch.Tensor | None  # (L,) int32 extensions (dependent steps), where asked
    one_row: torch.Tensor | None = None  # (L,) int32 extensions whose two ranks fall in one dense row (plain only)


class SmemOut(NamedTuple):
    counts: torch.Tensor  # (R,) int64 MEMs per read
    rows: torch.Tensor  # (sum(counts), 5) in read order, then emit order
    n_rerun: int  # reads rerun for a MEM buffer overflow
    n_unmerged: int  # reads whose lanes never met, rerun with twice the margin
    n_whole: int  # of those, reads whose lanes did not meet at twice the margin either, rerun whole


def pack_reads(queries: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Reads as (flat uint8 nt6 buffer, int64 seq_off), read r being
    flat[seq_off[r]:seq_off[r+1]]."""
    seq_off = np.zeros(len(queries) + 1, np.int64)
    np.cumsum([len(q) for q in queries], out=seq_off[1:])
    flat = np.concatenate([np.asarray(q, np.uint8) for q in queries]) if queries else np.zeros(0, np.uint8)
    return flat, seq_off


def read_lanes(seq_off: torch.Tensor) -> torch.Tensor:
    """One lane per read, x = 0 to its end: (R, 3) int64 (read, x0, x_stop)."""
    R = seq_off.numel() - 1
    r = torch.arange(R, device=seq_off.device)
    return torch.stack([r, torch.zeros_like(r), torch.full_like(r, NO_STOP)], dim=1)


def chunk_lanes(seq_off: torch.Tensor, chunk: int = CHUNK, margin: int = MARGIN) -> torch.Tensor:
    """Lanes of reads cut at multiples of `chunk`: lane t of a read starts at
    t * chunk and stops at (t + 1) * chunk + margin, the last one at the
    read's end.  (L, 3) int64 (read, x0, x_stop), a read's lanes in order."""
    if chunk < 1 or margin < 0:
        raise ValueError(f"need chunk >= 1 and margin >= 0, got {chunk}, {margin}")
    dev = seq_off.device
    n_lanes = ((seq_off.diff() + chunk - 1) // chunk).clamp(min=1)
    read = torch.repeat_interleave(torch.arange(n_lanes.numel(), device=dev), n_lanes)
    first = torch.cumsum(n_lanes, 0) - n_lanes
    t = torch.arange(read.numel(), device=dev) - first[read]
    stop = torch.where(t == n_lanes[read] - 1, NO_STOP, (t + 1) * chunk + margin)
    return torch.stack([read, t * chunk, stop], dim=1)


def lane_order(lanes: torch.Tensor, seq_off: torch.Tensor) -> torch.Tensor:
    """The order smem_tgc takes the lanes in: heaviest first by span (x_stop -
    x0, x_stop cut at the read's end), ties in lane order.  (L,) int64, on
    the lanes' device."""
    read = lanes[:, 0]
    span = torch.minimum(lanes[:, 2], seq_off[read + 1] - seq_off[read]) - lanes[:, 1]
    return torch.sort(span, descending=True, stable=True).indices


def _check_args(idx, flat: torch.Tensor, seq_off: torch.Tensor, min_len: int, max_mems: int) -> None:
    if flat.dtype != torch.uint8 or flat.dim() != 1 or seq_off.dtype != torch.int64 or seq_off.dim() != 1:
        raise ValueError("flat must be 1-D uint8 and seq_off 1-D int64")
    if flat.device != idx.device or seq_off.device != idx.device:
        raise ValueError("flat and seq_off must be on the index's device")
    if min_len < 1 or max_mems < 1:
        raise ValueError("min_len and max_mems must be >= 1")
    lens = seq_off.diff()
    if seq_off.numel() < 1 or int(seq_off[0]) != 0 or int(seq_off[-1]) != flat.numel() or bool((lens < 0).any()):
        raise ValueError("seq_off must rise from 0 to len(flat)")
    if lens.numel() and int(lens.max()) >= NO_STOP - 1:
        raise ValueError("reads must be shorter than 2^31 - 2 symbols")
    if flat.numel() and int(flat.max()) > 5:
        raise ValueError("reads must hold nt6 codes 0..5")


def _check_lanes(lanes: torch.Tensor, seq_off: torch.Tensor, log_len: int) -> None:
    if lanes.dtype != torch.int64 or lanes.dim() != 2 or lanes.shape[1] != 3 or lanes.device != seq_off.device:
        raise ValueError("lanes must be (L, 3) int64 on the reads' device")
    if log_len < 1:
        raise ValueError("log_len must be >= 1")
    if lanes.numel():
        lo, hi = lanes.amin(0).tolist(), lanes.amax(0).tolist()
        if lo[0] < 0 or hi[0] >= seq_off.numel() - 1 or lo[1] < 0 or hi[1] > NO_STOP or lo[2] < 0 or hi[2] > NO_STOP:
            raise ValueError("lanes: read ids, starts and stops out of range")


def _check_order(order: torch.Tensor, lanes: torch.Tensor) -> None:
    L = lanes.shape[0]
    if order.dtype != torch.int64 or order.dim() != 1 or order.numel() != L or order.device != lanes.device:
        raise ValueError("order must be (L,) int64 on the lanes' device")
    if L and (int(order.min()) < 0 or int(order.max()) >= L
              or not bool((torch.bincount(order, minlength=L) == 1).all())):
        raise ValueError("order must be a permutation of the lanes")


def _emit(mems, n_mem, m, st, en, ik) -> None:
    """Append (st, en, size, lo, lo_rc) to the masked lanes' buffers; past
    the last slot the last slot is overwritten, and n_mem keeps counting."""
    r = m.nonzero().squeeze(1)
    if r.numel():
        slot = n_mem[r].clamp(max=mems.shape[1] - 1)
        mems[r, slot] = torch.stack([st[r], en[r], ik[r, 2], ik[r, 0], ik[r, 1]], dim=1).to(mems.dtype)
        n_mem[r] += 1


def _note(logt, n_log, m, v) -> None:
    """Log v for the masked lanes; past log_len only the count grows."""
    r = m.nonzero().squeeze(1)
    if r.numel():
        k = n_log[r]
        w = k < logt.shape[1]
        logt[r[w], k[w]] = v[r[w]].int()
        n_log[r] += 1


def smem_tg_plain(
    idx, flat: torch.Tensor, seq_off: torch.Tensor, *, min_occ: int, min_len: int, max_mems: int,
    lanes: torch.Tensor | None = None, log_len: int = 1,
) -> Chains:
    """SMEM-TG for every lane (default: one per read, `read_lanes`), all
    lanes in lock-step: each trip resolves the transitions that need no rank,
    then extends every live lane by one symbol.  The CUDA kernels' state
    machine, START log and trip count, and the count of extensions whose
    two ranks fall in one 64-symbol row of dense rows (0 on rb rows)."""
    _check_args(idx, flat, seq_off, min_len, max_mems)
    if lanes is None:
        lanes = read_lanes(seq_off)
    _check_lanes(lanes, seq_off, log_len)
    dev = flat.device
    L = lanes.shape[0]
    mems = torch.zeros((L, max_mems, 5), dtype=idx.dtype, device=dev)
    n_mem = torch.zeros(L, dtype=torch.int64, device=dev)
    logt = torch.zeros((L, log_len), dtype=torch.int32, device=dev)
    n_log = torch.zeros(L, dtype=torch.int64, device=dev)
    trips = torch.zeros(L, dtype=torch.int64, device=dev)
    one_row = torch.zeros(L, dtype=torch.int64, device=dev)
    dense = "dense" in idx.layout
    base = seq_off[lanes[:, 0]]
    qlen = seq_off[lanes[:, 0] + 1] - base
    x_stop = lanes[:, 2]
    q = flat.long()
    last = max(flat.numel() - 1, 0)

    def sym(pos):  # clamped: lanes that do not use the symbol may point anywhere
        return q[(base + pos).clamp(0, last)] if flat.numel() else torch.zeros_like(pos)

    ph = torch.full((L,), PH_START, dtype=torch.int64, device=dev)
    x = lanes[:, 1].clone()
    i = torch.zeros_like(x)
    j = torch.zeros_like(x)
    ik = torch.zeros((L, 3), dtype=torch.int64, device=dev)
    while True:
        # ---- transitions that need no rank --------------------------------
        m = (ph == PH_BACK2) & (i <= x)  # backward re-extension reached x
        x = torch.where(m, i + 1, x)
        ph = torch.where(m, PH_START, ph)
        m = ph == PH_START
        end = m & (qlen - x < min_len)
        _note(logt, n_log, m, torch.where(end, qlen + 1, x))
        ph = torch.where(end | (m & (x >= x_stop)), PH_DONE, ph)  # the read's end, or the lane's stop
        m = ph == PH_START  # new window [x, x + min_len)
        ik = torch.where(m[:, None], set_intv(idx, sym(x + min_len - 1)), ik)
        i = torch.where(m, x + min_len - 2, i)
        ph = torch.where(m, PH_BACK1, ph)
        m = m & (i < x)  # min_len == 1: nothing to extend backward
        j = torch.where(m, x + min_len, j)
        ph = torch.where(m, PH_FWD, ph)
        m = (ph == PH_FWD) & (j >= qlen)  # forward extension reached the read end
        _emit(mems, n_mem, m, x, qlen, ik)
        _note(logt, n_log, m, qlen + 1)
        ph = torch.where(m, PH_DONE, ph)
        live = ph != PH_DONE
        if not bool(live.any()):
            break
        trips += live
        # ---- one extension per live lane ----------------------------------
        b1, fw, b2 = ph == PH_BACK1, ph == PH_FWD, ph == PH_BACK2
        c = sym(torch.where(fw, j, i))
        c = torch.where(fw & (c >= 1) & (c <= 4), 5 - c, c)
        ok = extend_c(idx, torch.where(live[:, None], ik, 0), c, ~fw)
        if dense:
            prim = torch.where(fw, ik[:, 1], ik[:, 0])
            one_row += live & ((prim >> 6) == ((prim + ik[:, 2]) >> 6))
        succ = ok[:, 2] >= min_occ
        m = b1 & succ
        ik = torch.where(m[:, None], ok, ik)
        i = torch.where(m, i - 1, i)
        m = m & (i < x)
        j = torch.where(m, x + min_len, j)
        ph = torch.where(m, PH_FWD, ph)
        m = b1 & ~succ
        x = torch.where(m, i + 1, x)
        ph = torch.where(m, PH_START, ph)
        m = fw & succ
        ik = torch.where(m[:, None], ok, ik)
        j = torch.where(m, j + 1, j)
        m = fw & ~succ  # emit the MEM [x, j), then re-extend backward from j
        _emit(mems, n_mem, m, x, j, ik)
        ik = torch.where(m[:, None], set_intv(idx, sym(j)), ik)
        i = torch.where(m, j - 1, i)
        ph = torch.where(m, PH_BACK2, ph)
        m = b2 & succ
        ik = torch.where(m[:, None], ok, ik)
        i = torch.where(m, i - 1, i)
        m = b2 & ~succ
        x = torch.where(m, i + 1, x)
        ph = torch.where(m, PH_START, ph)
    return Chains(mems, n_mem.int(), logt, n_log.int(), trips.int(), one_row.int())


def smem_tg_cuda(
    idx, flat: torch.Tensor, seq_off: torch.Tensor, *, min_occ: int, min_len: int, max_mems: int, trips: bool = False
) -> Chains:
    """One chain per read through the smem_tg kernel of the index's layout
    (csrc/smem_tg.cu), one thread each; no START log.  A CPU tensor takes
    `smem_tg_plain`."""
    if flat.device.type == "cpu":
        ch = smem_tg_plain(idx, flat, seq_off, min_occ=min_occ, min_len=min_len, max_mems=max_mems)
        return Chains(ch.mems, ch.n_mem, None, None, ch.trips if trips else None)
    _check_args(idx, flat, seq_off, min_len, max_mems)
    return launch_tg(idx, flat.contiguous(), seq_off.contiguous(), min_occ=min_occ, min_len=min_len, max_mems=max_mems,
                     trips=trips)


def launch_tg(idx, flat, seq_off, *, min_occ: int, min_len: int, max_mems: int, trips: bool = False) -> Chains:
    """`smem_tg_cuda` on contiguous CUDA tensors that its checks have passed,
    counting the launch.  Timing loops call this: the checks read back to
    the host."""
    R = seq_off.numel() - 1
    dev = flat.device
    mems = torch.empty((R, max_mems, 5), dtype=idx.dtype, device=dev)
    n_mem = torch.empty(R, dtype=torch.int32, device=dev)
    tr = torch.empty(R, dtype=torch.int32, device=dev) if trips else None
    if R:
        kernels.launch(
            f"rb3c_smem_tg_{idx.layout}", dev, *idx.kernel_tables(), flat.data_ptr(), seq_off.data_ptr(), R,
            int(min_occ), int(min_len), int(max_mems), mems.data_ptr(), n_mem.data_ptr(),
            tr.data_ptr() if trips else None,
        )
        kernels.count(smem_tg_cuda.launches, idx.layout)
    return Chains(mems, n_mem, None, None, tr)


smem_tg_cuda.launches = Counter()


def smem_tgc_cuda(
    idx, flat: torch.Tensor, seq_off: torch.Tensor, lanes: torch.Tensor, *, min_occ: int, min_len: int,
    max_mems: int, log_len: int = LOG_LEN, trips: bool = False, order: torch.Tensor | None = None,
) -> Chains:
    """One chain per lane (read, x0, x_stop) through the smem_tgc kernel of
    the index's layout, with its START log: a grid of resident blocks whose
    threads take the lanes in `order` (default `lane_order`, heaviest
    first), each lane's outputs at its own index.  A CPU tensor takes
    `smem_tg_plain`, which runs every lane at once (the order is checked,
    not used)."""
    if order is not None:
        _check_order(order, lanes)
    if flat.device.type == "cpu":
        ch = smem_tg_plain(idx, flat, seq_off, min_occ=min_occ, min_len=min_len, max_mems=max_mems, lanes=lanes,
                           log_len=log_len)
        return ch._replace(trips=ch.trips if trips else None, one_row=None)
    _check_args(idx, flat, seq_off, min_len, max_mems)
    _check_lanes(lanes, seq_off, log_len)
    lanes, seq_off = lanes.contiguous(), seq_off.contiguous()
    order = lane_order(lanes, seq_off) if order is None else order.contiguous()
    return launch_tgc(idx, flat.contiguous(), seq_off, lanes, order, min_occ=min_occ, min_len=min_len,
                      max_mems=max_mems, log_len=log_len, trips=trips)


def launch_tgc(idx, flat, seq_off, lanes, order, *, min_occ: int, min_len: int, max_mems: int,
               log_len: int = LOG_LEN, trips: bool = False) -> Chains:
    """`smem_tgc_cuda` on contiguous CUDA tensors that its checks have
    passed, counting the launch (for timing loops, as `launch_tg`)."""
    L = lanes.shape[0]
    dev = flat.device
    mems = torch.empty((L, max_mems, 5), dtype=idx.dtype, device=dev)
    n_mem = torch.empty(L, dtype=torch.int32, device=dev)
    logt = torch.empty((L, log_len), dtype=torch.int32, device=dev)
    n_log = torch.empty(L, dtype=torch.int32, device=dev)
    tr = torch.empty(L, dtype=torch.int32, device=dev) if trips else None
    if L:
        nxt = torch.empty(1, dtype=torch.int64, device=dev)  # the queue's counter
        kernels.launch(
            f"rb3c_smem_tgc_{idx.layout}", dev, *idx.kernel_tables(), flat.data_ptr(), seq_off.data_ptr(),
            lanes.data_ptr(), order.data_ptr(), L, int(min_occ), int(min_len), int(max_mems), int(log_len),
            mems.data_ptr(), n_mem.data_ptr(), logt.data_ptr(), n_log.data_ptr(), tr.data_ptr() if trips else None,
            nxt.data_ptr(),
        )
        kernels.count(smem_tgc_cuda.launches, idx.layout)
    return Chains(mems, n_mem, logt, n_log, tr)


smem_tgc_cuda.launches = Counter()


def stitch(lanes: torch.Tensor, ch: Chains, n_reads: int, max_mems: int):
    """The serial emits of every read from its lanes' chains (the rule in the
    module docstring).  Returns (counts (R,) int64, rows (N, 5) of the reads
    that came out whole, unresolved (R,) bool: a boundary whose lanes never
    met, need (R,) int64: the true count of the read's fullest lane where one
    overflowed, else 0).  Unresolved and overflowed reads get no rows."""
    dev = lanes.device
    read = lanes[:, 0]
    L = read.numel()
    big = 1 << 62
    lo = torch.zeros(L, dtype=torch.int64, device=dev)  # the range [lo, hi) of st each lane contributes
    hi = torch.full((L,), big, dtype=torch.int64, device=dev)
    unres = torch.zeros(n_reads, dtype=torch.bool, device=dev)
    bnd = (read[1:] == read[:-1]).nonzero().squeeze(1) + 1  # lane b continues lane b - 1's read
    if bnd.numel():
        kk = torch.arange(ch.log.shape[1], device=dev)
        a = torch.where(kk < ch.n_log[bnd - 1, None], ch.log[bnd - 1].long(), big)
        b = torch.where(kk < ch.n_log[bnd, None], ch.log[bnd].long(), big + 1)
        pos = torch.searchsorted(b, a).clamp(max=kk.numel() - 1)
        meet = torch.where(b.gather(1, pos) == a, a, big)  # the STARTs both lanes logged, ascending
        follows = torch.zeros_like(bnd, dtype=torch.bool)
        follows[1:] = bnd[1:] == bnd[:-1] + 1  # the boundary before it is the same read's
        lb = torch.zeros_like(bnd)
        while True:  # m_t: the first meeting point at or past m_{t-1}
            m = torch.where(meet >= lb[:, None], meet, big).amin(1)
            prev = torch.zeros_like(lb)
            prev[1:] = m[:-1]
            prev = torch.where(follows, prev, 0)
            if torch.equal(prev, lb):
                break
            lb = prev
        unres[read[bnd[m >= big]]] = True
        lo[bnd] = m
        hi[bnd - 1] = m
    n_mem = ch.n_mem.long()
    need = torch.zeros(n_reads, dtype=torch.int64, device=dev).scatter_reduce_(
        0, read, torch.where(n_mem > max_mems, n_mem, 0), "amax")
    bad = unres | (need > 0)
    st = ch.mems[:, :, 0].long()
    keep = torch.arange(max_mems, device=dev) < n_mem.clamp(max=max_mems)[:, None]
    keep &= (st >= lo[:, None]) & (st < hi[:, None]) & ~bad[read][:, None]
    counts = torch.zeros(n_reads, dtype=torch.int64, device=dev).index_add_(0, read, keep.sum(1))
    return counts, ch.mems[keep], unres, need


def _subset(flat: torch.Tensor, seq_off: torch.Tensor, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reads `ids` as their own (flat, seq_off)."""
    st = seq_off[ids]
    ln = seq_off[ids + 1] - st
    off = torch.zeros(ids.numel() + 1, dtype=torch.int64, device=flat.device)
    torch.cumsum(ln, 0, out=off[1:])
    src = torch.repeat_interleave(st - off[:-1], ln) + torch.arange(int(off[-1]), device=flat.device)
    return flat[src], off


def _place(n_reads: int, parts: list, dtype, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge parts (read ids, their counts, their rows in id order) into
    (counts (R,), rows in read order)."""
    counts = torch.zeros(n_reads, dtype=torch.int64, device=dev)
    for ids, c, _ in parts:
        counts[ids] = c
    off = torch.cumsum(counts, 0) - counts
    rows = torch.empty((int(counts.sum()), 5), dtype=dtype, device=dev)
    for ids, c, r in parts:
        if r.shape[0]:
            shift = torch.repeat_interleave(off[ids] - (torch.cumsum(c, 0) - c), c)
            rows[shift + torch.arange(r.shape[0], device=dev)] = r
    return counts, rows


def smem_tg(
    idx, flat: torch.Tensor, seq_off: torch.Tensor, *, min_occ: int, min_len: int, max_mems: int = MAX_MEMS,
    chunk: int = CHUNK, margin: int = MARGIN, log_len: int = LOG_LEN,
) -> SmemOut:
    """Every read's MEMs, exact: one smem_tgc launch over the chunk lanes,
    `stitch`, then reruns on the card until every read came out whole
    (unresolved reads as lanes with twice the margin, then one thread each;
    overflowed ones through the kernel that gave them, with a buffer of
    their true count).  A lane's START log takes log_len entries at `margin`
    and grows with its span at twice the margin."""
    R = seq_off.numel() - 1
    dev = flat.device
    kw = dict(min_occ=min_occ, min_len=min_len)
    # (read ids, None: all; buffer rows; pass: 0 lanes at margin, 1 at twice the margin, 2 one thread a read)
    todo = [(None, max_mems, 0)]
    parts, n_rerun, unmet = [], 0, [0, 0]
    while todo:
        ids, M, p = todo.pop()
        if ids is None:
            f, o, ids = flat, seq_off, torch.arange(R, device=dev)
        else:
            f, o = _subset(flat, seq_off, ids)
        if p < 2:
            W = margin << p
            lanes = chunk_lanes(o, chunk, W)
            ch = smem_tgc_cuda(idx, f, o, lanes, max_mems=M, log_len=log_len * (chunk + W) // (chunk + margin), **kw)
        else:
            lanes = read_lanes(o)
            ch = smem_tg_cuda(idx, f, o, max_mems=M, **kw)
        counts, rows, unres, need = stitch(lanes, ch, ids.numel(), M)
        ok = ~unres & (need == 0)
        parts.append((ids[ok], counts[ok], rows))
        if bool(unres.any()):
            todo.append((ids[unres], max_mems, p + 1))
            unmet[p] += int(unres.sum())
        over = ~unres & (need > 0)
        if bool(over.any()):
            todo.append((ids[over], int(need[over].max()), p))
            n_rerun += int(over.sum())
    counts, rows = _place(R, parts, idx.dtype, dev)
    return SmemOut(counts, rows, n_rerun, *unmet)


def auto_rb_budget(device) -> float:
    """The bytes of dense rows past which `occ=auto` takes rb rows on
    `device`: AUTO_RB_SHARE of the card's memory, AUTO_RB_BYTES_CPU on the CPU."""
    dev = torch.device(device)
    return AUTO_RB_SHARE * torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else AUTO_RB_BYTES_CPU


def resolve_occ(occ: str, n: int, device) -> str:
    """"dense" or "rb" for `occ` auto|dense|rb, as the JAX package resolves
    it (ropebwt3_tpu/ops/smem.py:154-157), the RB3TPU_DEVICE_OCC override
    included; auto takes rb rows when dense rows would pass AUTO_RB_SHARE of
    the card's memory."""
    if occ == "auto":
        occ = os.environ.get("RB3TPU_DEVICE_OCC", "auto")
    if occ not in ("auto", "dense", "rb"):
        raise ValueError(f"invalid occ '{occ}' (auto|dense|rb)")
    if occ == "auto":
        occ = "rb" if n * 0.75 > auto_rb_budget(device) else "dense"
    return occ


class BatchedSmemTG:
    """The `mem` engine: occ rows resident on `device`; `run_flat` finds the
    MEMs of one batch with `smem_tg` (one chunked launch, plus the reruns it
    needs).  `occ` picks the rows: dense, rb (run-block compressed, from the
    `.rb.npz` cache when it is fresh) or auto (`resolve_occ`); the width
    follows n.  `rows`, f's rows already on `device` (a resident server's),
    stand in for building them.  With `mesh` (parallel/mesh.py Mesh) the
    rows are sharded over its idx axis (auto decided per shard) and mapped
    into one range a dp row, and each batch's reads are split over its
    cards, one share a card (parallel/smem_sharded.py); `device` is then
    unused.  `n_rerun` and `n_unmerged` add up over
    batches."""

    def __init__(self, f: DenseFMIndex, min_occ: int = 1, min_len: int = 19, max_mems: int = MAX_MEMS, *, device,
                 occ: str = "auto", rows: OccIndex | RunBlockIndex | None = None, mesh=None):
        self.sharded = None
        if mesh is not None:
            from ..parallel.mesh import ShardedRows

            if rows is not None:
                raise ValueError("BatchedSmemTG takes prebuilt rows or a mesh, not both")
            self.sharded = ShardedRows.from_dense(f, mesh, occ)
            self.idx = self.sharded.views[0]
            log.info("occ layout %s (%s)", self.idx.layout, self.sharded.describe(), func="mem")
        else:
            if rows is None:
                rows = RunBlockIndex.from_dense(f, device) if resolve_occ(occ, f.n, device) == "rb" else OccIndex.from_dense(f, device)
            self.idx = rows
            s = f"S {rows.S}, {rows.n_esc} escape blocks, " if rows.layout.startswith("rb") else ""
            log.info("occ layout %s (%s%s rows): %d bytes on %s", self.idx.layout, s, "int64" if self.idx.int64 else "int32",
                     self.idx.nbytes, self.idx.device, func="mem")
        self.min_occ = int(min_occ)
        self.min_len = int(min_len)
        self.max_mems = int(max_mems)
        self.n_rerun = 0
        self.n_unmerged = 0
        self.n_whole = 0

    def run_flat(self, flat: np.ndarray, seq_off: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(counts (R,) int64, rows (sum(counts), 5)) of the reads
        flat[seq_off[r]:seq_off[r+1]], as the native engine's flat call
        returns them."""
        if self.sharded is not None:
            from ..parallel.smem_sharded import smem_mesh

            out = smem_mesh(self.sharded.views, flat, seq_off, min_occ=self.min_occ, min_len=self.min_len,
                            max_mems=self.max_mems)
            self.n_rerun += out.n_rerun
            self.n_unmerged += out.n_unmerged
            self.n_whole += out.n_whole
            return out.counts, out.rows
        dev = self.idx.device
        out = smem_tg(self.idx, torch.from_numpy(np.ascontiguousarray(flat, np.uint8)).to(dev),
                      torch.from_numpy(np.ascontiguousarray(seq_off, np.int64)).to(dev),
                      min_occ=self.min_occ, min_len=self.min_len, max_mems=self.max_mems)
        self.n_rerun += out.n_rerun
        self.n_unmerged += out.n_unmerged
        self.n_whole += out.n_whole
        return out.counts.cpu().numpy(), out.rows.cpu().numpy()
