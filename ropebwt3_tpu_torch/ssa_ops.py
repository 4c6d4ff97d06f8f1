"""Sampled suffix array generation on a torch device.

Port of ropebwt3_tpu/ssa_ops.py `ssa_gen_device`.  Every sequence walks LF
from its sentinel row (lanes 0..m-1, m = acc[1]) to the sentinel that ends
it; at each step whose new row r is sampled, (r - m) & (2^ss - 1) == 0 with
a non-sentinel symbol, the slot (r - m) >> ss records the step and the lane.
The host then turns (ssa_l, ssa_lane, death_l, final_k) into the SSA, as
ssa_ops.py:200-207 does, and returns formats.ssa.SSA.

`ssa_gen_plain` is the lock-step body of ssa_ops.py:127-147 in PyTorch (the
CPU path and the reference for the kernel); `ssa_gen_cuda` wraps the CUDA
kernel of csrc/ssa_gen.cu, one thread per lane.  Both take the dense occ rows
of ops/rank.py `OccIndex` (dense32 or dense64): the symbol at k comes from
the rows' bit-planes, so no BWT array goes to the device.

`ssa_multi_batch` is the host side of `mem -p`: the native batched
multi-locate (native/locate.cpp), as ropebwt3_tpu/ssa_ops.py runs it.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from . import kernels, native
from .formats.ssa import SSA
from .index.dense import DenseFMIndex
from .ops.rank import OccIndex, lf

MAX_SHIFT = 62  # positions are int64; a larger -s samples nothing past row m


def sid_bits(m: int) -> int:
    """ms: the least value >= 1 with 2^ms >= m (ssa_ops.py:115-118)."""
    ms = 1
    while (1 << ms) < m:
        ms += 1
    return ms


def n_slots(idx: OccIndex, m: int, ssa_shift: int) -> int:
    return (int(idx.acc[6]) - m + (1 << ssa_shift) - 1) >> ssa_shift


def check_walk(idx: OccIndex, m: int, ssa_shift: int) -> None:
    """The bounds a walk relies on (ROADMAP F2): dense rows; every symbol an
    nt6 code (acc[6] = n: the rows count symbols 0..5 only); lanes 0..m-1
    that are the sentinel rows, m = acc[1], with lane ids in int32; a shift
    in [0, MAX_SHIFT].  Steps fit the index's width: a lane walks at most n
    steps, and dense32 holds n < 2^31."""
    if not isinstance(idx, OccIndex):
        raise TypeError(f"SSA generation takes dense occ rows (OccIndex), not {type(idx).__name__}")
    acc = idx.acc.tolist()
    if acc[6] != idx.n or any(a > b for a, b in zip(acc, acc[1:])):
        raise ValueError(f"acc {acc} does not count n = {idx.n} nt6 symbols")
    if m != acc[1] or m >= 1 << 31:
        raise ValueError(f"m = {m} must be acc[1] = {acc[1]} and below 2^31")
    if not 0 <= ssa_shift <= MAX_SHIFT:
        raise ValueError(f"sample shift {ssa_shift} outside [0, {MAX_SHIFT}]")


def ssa_gen_plain(idx: OccIndex, m: int, ssa_shift: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All m lanes in lock-step, one LF step per trip, as ssa_ops.py:127-147:
    (ssa_l (n_ssa,) int64, ssa_lane (n_ssa,) int32 with -1 where no lane hit,
    death_l (m,) int64, final_k (m,) int64)."""
    check_walk(idx, m, ssa_shift)
    dev = idx.device
    n_ssa = n_slots(idx, m, ssa_shift)
    mask = (1 << ssa_shift) - 1
    lanes = torch.arange(m, dtype=torch.int64, device=dev)
    k, alive = lanes.clone(), torch.ones(m, dtype=torch.bool, device=dev)
    # slot n_ssa is the dummy that non-hit lanes scatter into
    ssa_l = torch.zeros(n_ssa + 1, dtype=torch.int64, device=dev)
    ssa_lane = torch.full((n_ssa + 1,), -1, dtype=torch.int32, device=dev)
    death_l = torch.zeros(m, dtype=torch.int64, device=dev)
    final_k = torch.zeros(m, dtype=torch.int64, device=dev)
    l = 0
    while bool(alive.any()):
        c, nk = lf(idx, k)
        l += 1
        nz = c != 0
        hit = alive & nz & (((nk - m) & mask) == 0)
        x = torch.where(hit, (nk - m) >> ssa_shift, n_ssa)
        ssa_l[x] = l
        ssa_lane[x] = lanes.int()
        died = alive & ~nz
        death_l = torch.where(died, l, death_l)
        final_k = torch.where(died, nk, final_k)
        alive = alive & nz
        k = torch.where(alive, nk, k)
    return ssa_l[:n_ssa], ssa_lane[:n_ssa], death_l, final_k


def ssa_gen_cuda(idx: OccIndex, m: int, ssa_shift: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The walk through the ssa_gen kernel of the index's layout: the same
    four tensors as `ssa_gen_plain`, ssa_l, death_l and final_k in the
    index's width.  A CPU index takes the plain version."""
    check_walk(idx, m, ssa_shift)
    if idx.device.type == "cpu":
        return ssa_gen_plain(idx, m, ssa_shift)
    return launch_walk(idx, m, ssa_shift)


def launch_walk(idx: OccIndex, m: int, ssa_shift: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ssa_gen_cuda` on a CUDA index that `check_walk` has passed, counting
    the launch: timing loops call this, as the check reads acc back to the
    host."""
    n_ssa = n_slots(idx, m, ssa_shift)
    dev, dt = idx.device, idx.dtype
    ssa_l = torch.zeros(n_ssa, dtype=dt, device=dev)
    ssa_lane = torch.full((n_ssa,), -1, dtype=torch.int32, device=dev)
    death_l = torch.zeros(m, dtype=dt, device=dev)
    final_k = torch.zeros(m, dtype=dt, device=dev)
    if m:
        kernels.launch(
            f"rb3c_ssa_gen_{idx.layout}", dev, *idx.kernel_tables(), m, ssa_shift, ssa_l.data_ptr(),
            ssa_lane.data_ptr(), death_l.data_ptr(), final_k.data_ptr(),
        )
        ssa_gen_cuda.launches[idx.layout] += 1
    return ssa_l, ssa_lane, death_l, final_k


ssa_gen_cuda.launches = Counter()


def assemble(m: int, ssa_shift: int, ssa_l, ssa_lane, death_l, final_k) -> SSA:
    """The SSA from a walk's four arrays (ssa_ops.py:200-207): r2i maps each
    sentinel rank to its lane, and a filled slot holds the lane and the
    steps left to the lane's sentinel."""
    ssa_l, ssa_lane, death_l, final_k = (t.cpu().numpy() for t in (ssa_l, ssa_lane, death_l, final_k))
    ms = sid_bits(m)
    r2i = np.zeros(m, dtype=np.uint64)
    r2i[final_k.astype(np.int64)] = np.arange(m, dtype=np.uint64)
    ssa = np.zeros(len(ssa_l), dtype=np.uint64)
    filled = ssa_lane >= 0
    lanes = ssa_lane[filled].astype(np.int64)
    offs = (death_l[lanes].astype(np.int64) - 1 - ssa_l[filled].astype(np.int64)).astype(np.uint64)
    ssa[filled] = (offs << np.uint64(ms)) | lanes.astype(np.uint64)
    return SSA(ssa_shift, ms, m, r2i, ssa)


def ssa_gen(f: DenseFMIndex, ssa_shift: int = 8, device="cuda", occ: OccIndex | None = None) -> SSA:
    """The SSA of `f`, byte-equal to ropebwt3_tpu.ssa_ops.ssa_gen_native.
    `occ` is f's dense rows already on the device (default: built on
    `device`, int64 from n >= 2^31 - 2^20 on); on a CUDA device the walk
    runs the kernel, on the CPU the plain version."""
    idx = OccIndex.from_dense(f, device) if occ is None else occ
    m = int(f.acc[1])
    return assemble(m, ssa_shift, *ssa_gen_cuda(idx, m, ssa_shift))


def ssa_multi_batch(f: DenseFMIndex, sa: SSA, reqs: list[tuple[int, int, int]]) -> list[list[tuple[int, int]]]:
    """Up to max_sa (sid, pos) pairs of each request (lo, hi, max_sa), in
    rb3_ssa_multi's order (ssa.c:158-192): ropebwt3_tpu/ssa_ops.py
    `ssa_multi_batch` on the port's native copy, threaded over requests."""
    n_req = len(reqs)
    if not n_req:
        return []
    lo, hi, cap = (np.array(c, np.int64) for c in zip(*reqs))
    cap = np.clip(np.minimum(cap, hi - lo), 0, None)
    off = np.zeros(n_req + 1, np.int64)
    np.cumsum(cap, out=off[1:])
    out_sid, out_pos = np.empty(int(off[-1]), np.int64), np.empty(int(off[-1]), np.int64)
    n_out = np.zeros(n_req, np.int64)
    native.lib().rb3t_ssa_multi_batch(
        f.bwt.ctypes.data, f.occ_block.ctypes.data, f.occ_super.ctypes.data, f.acc.ctypes.data, f.n, sa.ss, sa.ms,
        sa.r2i.ctypes.data, sa.ssa.ctypes.data, n_req, lo.ctypes.data, hi.ctypes.data, cap.ctypes.data,
        off.ctypes.data, out_sid.ctypes.data, out_pos.ctypes.data, n_out.ctypes.data, os.cpu_count() or 1,
    )
    sid_l, pos_l = out_sid.tolist(), out_pos.tolist()
    return [list(zip(sid_l[o : o + k], pos_l[o : o + k])) for o, k in zip(off.tolist(), n_out.tolist())]
