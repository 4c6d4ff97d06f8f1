"""Batched SMEM-TG (the `mem` engine) on a torch device.

Port of ropebwt3_tpu/ops/smem.py + ops/smem_fsm.py.  Reads arrive as one
flat nt6 buffer plus int64 offsets (read r = flat[seq_off[r]:seq_off[r+1]],
the native engine's contract, ropebwt3_tpu/ops/smem_native.py:99-103), so
nothing is padded.  Both versions take either occ layout (ops/rank.py
`OccIndex`, ops/runblock.py `RunBlockIndex`) in either width and return
(mems (R, M, 5) rows (start, end, size, lo, lo_rc) in emit order, in the
index's width (int64 mode: lo exceeds 2^31), n_mem (R,) int32 TRUE counts);
a read with n_mem > M overflowed, its last slot holds its latest emit, and
`BatchedSmemTG` reruns it on the native host engine.

`smem_tg_plain` is a lock-step lane loop in PyTorch — the plain twin of the
CUDA kernel (csrc/smem_tg.cu) that `smem_tg_cuda` launches, one variant per
layout.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from ropebwt3_tpu import log
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.ops.smem_native import smem_tg_batch_native
from ropebwt3_tpu.ops.smem_ref import Mem

from .. import kernels
from .rank import OccIndex, extend_c, set_intv
from .runblock import RunBlockIndex

# `occ=auto` takes rb rows when dense rows (0.75 B/sym) would pass this share
# of the card's memory: the JAX package's 12e9 bytes of a 16 GB TPU chip
# (ropebwt3_tpu/ops/smem.py:157), which stays the budget on the CPU
AUTO_RB_SHARE = 0.75
AUTO_RB_BYTES_CPU = 12e9

PH_START, PH_BACK1, PH_FWD, PH_BACK2, PH_DONE = range(5)


def pack_reads(queries: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Reads as (flat uint8 nt6 buffer, int64 seq_off), read r being
    flat[seq_off[r]:seq_off[r+1]]."""
    seq_off = np.zeros(len(queries) + 1, np.int64)
    np.cumsum([len(q) for q in queries], out=seq_off[1:])
    flat = np.concatenate([np.asarray(q, np.uint8) for q in queries]) if queries else np.zeros(0, np.uint8)
    return flat, seq_off


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
    if lens.numel() and int(lens.max()) >= 1 << 31:
        raise ValueError("reads must be shorter than 2^31 symbols")
    if flat.numel() and int(flat.max()) > 5:
        raise ValueError("reads must hold nt6 codes 0..5")


def _emit(mems, n_mem, m, st, en, ik) -> None:
    """Append (st, en, size, lo, lo_rc) to the masked lanes' buffers; past
    the last slot the last slot is overwritten, and n_mem keeps counting."""
    r = m.nonzero().squeeze(1)
    if r.numel():
        slot = n_mem[r].clamp(max=mems.shape[1] - 1)
        mems[r, slot] = torch.stack([st[r], en[r], ik[r, 2], ik[r, 0], ik[r, 1]], dim=1).to(mems.dtype)
        n_mem[r] += 1


def smem_tg_plain(
    idx, flat: torch.Tensor, seq_off: torch.Tensor, *, min_occ: int, min_len: int, max_mems: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """SMEM-TG for every read, one lane per read, all lanes in lock-step:
    each trip resolves the transitions that need no rank, then extends every
    live lane by one symbol.  Same state machine as the CUDA kernel."""
    _check_args(idx, flat, seq_off, min_len, max_mems)
    dev = flat.device
    R = seq_off.numel() - 1
    mems = torch.zeros((R, max_mems, 5), dtype=idx.dtype, device=dev)
    n_mem = torch.zeros(R, dtype=torch.int64, device=dev)
    base = seq_off[:-1]
    qlen = seq_off[1:] - base
    q = flat.long()
    last = max(flat.numel() - 1, 0)

    def sym(pos):  # clamped: lanes that do not use the symbol may point anywhere
        return q[(base + pos).clamp(0, last)] if flat.numel() else torch.zeros_like(pos)

    ph = torch.full((R,), PH_START, dtype=torch.int64, device=dev)
    x = torch.zeros(R, dtype=torch.int64, device=dev)
    i = torch.zeros_like(x)
    j = torch.zeros_like(x)
    ik = torch.zeros((R, 3), dtype=torch.int64, device=dev)
    while True:
        # ---- transitions that need no rank --------------------------------
        m = (ph == PH_BACK2) & (i <= x)  # backward re-extension reached x
        x = torch.where(m, i + 1, x)
        ph = torch.where(m, PH_START, ph)
        ph = torch.where((ph == PH_START) & (qlen - x < min_len), PH_DONE, ph)
        m = ph == PH_START  # new window [x, x + min_len)
        ik = torch.where(m[:, None], set_intv(idx, sym(x + min_len - 1)), ik)
        i = torch.where(m, x + min_len - 2, i)
        ph = torch.where(m, PH_BACK1, ph)
        m = m & (i < x)  # min_len == 1: nothing to extend backward
        j = torch.where(m, x + min_len, j)
        ph = torch.where(m, PH_FWD, ph)
        m = (ph == PH_FWD) & (j >= qlen)  # forward extension reached the read end
        _emit(mems, n_mem, m, x, qlen, ik)
        ph = torch.where(m, PH_DONE, ph)
        live = ph != PH_DONE
        if not bool(live.any()):
            break
        # ---- one extension per live lane ----------------------------------
        b1, fw, b2 = ph == PH_BACK1, ph == PH_FWD, ph == PH_BACK2
        c = sym(torch.where(fw, j, i))
        c = torch.where(fw & (c >= 1) & (c <= 4), 5 - c, c)
        ok = extend_c(idx, torch.where(live[:, None], ik, 0), c, ~fw)
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
    return mems, n_mem.int()


def smem_tg_cuda(
    idx, flat: torch.Tensor, seq_off: torch.Tensor, *, min_occ: int, min_len: int, max_mems: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """SMEM-TG through the smem_tg kernel of the index's layout
    (csrc/smem_tg.cu), one thread per read.  Same contract as
    `smem_tg_plain`, which a CPU tensor takes."""
    if flat.device.type == "cpu":
        return smem_tg_plain(idx, flat, seq_off, min_occ=min_occ, min_len=min_len, max_mems=max_mems)
    _check_args(idx, flat, seq_off, min_len, max_mems)
    R = seq_off.numel() - 1
    flat, seq_off = flat.contiguous(), seq_off.contiguous()
    mems = torch.empty((R, max_mems, 5), dtype=idx.dtype, device=flat.device)
    n_mem = torch.empty(R, dtype=torch.int32, device=flat.device)
    if R:
        kernels.launch(
            f"rb3c_smem_tg_{idx.layout}", flat.device, *idx.kernel_tables(), flat.data_ptr(), seq_off.data_ptr(), R,
            int(min_occ), int(min_len), int(max_mems), mems.data_ptr(), n_mem.data_ptr(),
        )
        smem_tg_cuda.launches[idx.layout] += 1
    return mems, n_mem


smem_tg_cuda.launches = Counter()


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
        dev = torch.device(device)
        budget = AUTO_RB_SHARE * torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else AUTO_RB_BYTES_CPU
        occ = "rb" if n * 0.75 > budget else "dense"
    return occ


class BatchedSmemTG:
    """The `mem` engine: occ rows resident on `device`, one kernel launch
    per `run`.  `occ` picks the rows: dense, rb (run-block compressed, from
    the `.rb.npz` cache when it is fresh) or auto (`resolve_occ`); the width
    follows n.  Reads whose MEM buffer overflows (n_mem > max_mems) are rerun
    on the native host engine in one call and counted in `n_rerun`."""

    def __init__(self, f: DenseFMIndex, min_occ: int = 1, min_len: int = 19, max_mems: int = 64, *, device,
                 occ: str = "auto"):
        if resolve_occ(occ, f.n, device) == "rb":
            self.idx = RunBlockIndex.from_dense(f, device)
            s = f"S {self.idx.S}, {self.idx.n_esc} escape blocks, "
        else:
            self.idx = OccIndex.from_dense(f, device)
            s = ""
        log.info("occ layout %s (%s%s rows): %d bytes on %s", self.idx.layout, s, "int64" if self.idx.int64 else "int32",
                 self.idx.nbytes, self.idx.device, func="mem")
        self._dense = f
        self.min_occ = int(min_occ)
        self.min_len = int(min_len)
        self.max_mems = int(max_mems)
        self.n_rerun = 0

    def run(self, queries: list[np.ndarray]) -> list[list[Mem]]:
        if not queries:
            return []
        dev = self.idx.device
        flat, seq_off = (torch.from_numpy(a).to(dev) for a in pack_reads(queries))
        mems, n_mem = smem_tg_cuda(
            self.idx, flat, seq_off, min_occ=self.min_occ, min_len=self.min_len, max_mems=self.max_mems
        )
        M = self.max_mems
        n_mem = n_mem.cpu().numpy()
        counts = np.where(n_mem <= M, n_mem, 0)  # overflowed reads keep no device rows
        keep = torch.arange(M, device=dev)[None, :] < torch.from_numpy(counts).to(dev)[:, None]
        rows = mems[keep].cpu().tolist()
        out: list[list[Mem]] = []
        k = 0
        for c in counts.tolist():
            out.append([Mem(*r) for r in rows[k : k + c]])
            k += c
        over = np.flatnonzero(n_mem > M).tolist()
        if over:
            redo = smem_tg_batch_native(self._dense, [queries[t] for t in over], self.min_occ, self.min_len)
            for t, o in zip(over, redo):
                out[t] = o
            self.n_rerun += len(over)
        return out
