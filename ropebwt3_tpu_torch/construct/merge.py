"""Merging a partial BWT B2 into an index B1, on a torch device (K6).

Port of ropebwt3_tpu/construct/merge.py, Algorithm 2 of the ropebwt3 paper
as the JAX package reformulates it (fm-index.c:143-175, 279-303):
  1. `lf2_packed`: B2's own LF table, packed with its symbols:
     rec[i] = (lf2[i] << 3) | B2[i], lf2[i] = acc2[B2[i]] + occ2_{B2[i]}(i)
     (rb3t_lf2_packed, bwasw_core.cpp:2022-2043), torch ops;
  2. the merge rank: one lane per B2 sequence walks it backwards on B2's LF
     and B1's rank at once; each B2 position is visited once and its rec
     becomes ins, the count of B1 symbols before it in the merged BWT.
     `merge_rank_cuda` runs the kernel of csrc/merge_rank.cu (one thread per
     lane, each to its own end); `merge_rank_plain` is the lock-step
     PyTorch version (the CPU path, and the reference on the card);
  3. `merge_apply`: B2[i] lands at ins[i] + i, B1 fills the gaps in order
     (ins is nondecreasing: the merge keeps each BWT's order), in chunks of
     the merged array so no temporary is a full int64 array.
`merge_plain` runs the three on B1's dense rows (ops/rank.py OccIndex) and
returns the merged BWT, on B1's device; its rows come from
`OccIndex.from_bwt` when the next merge needs them.

Capacity: a merge holds B1 (1 B a symbol), its rows (0.75 B) and B2 (1 B),
with lf2_packed's int64 temporaries (~33 B a B2 symbol), then rec and the
merged positions (16 B a B2 symbol) beside the merged BWT (1 B a symbol of
either) and a chunk's temporaries: `merge_bytes` counts it all.  The largest
merged index a card holds is therefore about its free memory / 2.75 in
symbols, less the last batch's ~34 B a symbol (an 80 GB NVIDIA H100: ~27 G
symbols).  Run-block B1 rows for merges are not ported (ROADMAP queue 1
item 8).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import kernels
from ..ops.rank import ASIZE, OccIndex

APPLY_CHUNK = 1 << 25  # merged positions per chunk of merge_apply


def merge_bytes(n1: int, n2: int) -> int:
    """Card bytes at a merge's peak, B1, its rows and B2 included: the
    larger of lf2_packed's temporaries and (rec, merged positions, merged
    BWT, a chunk's ~10 B a position) taken together, as an upper bound."""
    return n1 + (3 * n1) // 4 + n2 + 33 * n2 + n1 + n2 + 10 * APPLY_CHUNK


def lf2_table(seq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(acc2 (7,) int64, lf2 (n,) int64) of a plain BWT `seq` (uint8):
    lf2[i] = acc2[seq[i]] + |{j < i : seq[j] = seq[i]}| (merge.py:21-53),
    by one cumsum per symbol."""
    s = seq.long()
    acc2 = torch.zeros(ASIZE + 1, dtype=torch.int64, device=seq.device)
    acc2[1:] = torch.cumsum(torch.bincount(s, minlength=ASIZE)[:ASIZE], 0)
    lf2 = acc2[s]
    for c in range(ASIZE):
        hit = s == c
        lf2 += torch.where(hit, torch.cumsum(hit, 0) - 1, 0)
    return acc2, lf2


def lf2_packed(seq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(acc2, rec): rec[i] = (lf2[i] << 3) | seq[i], as rb3t_lf2_packed makes it."""
    acc2, lf2 = lf2_table(seq)
    return acc2, lf2 << 3 | seq.long()


def check_merge(idx: OccIndex, rec: torch.Tensor, m2: int) -> None:
    if not isinstance(idx, OccIndex):
        raise TypeError(f"the merge rank takes dense occ rows (OccIndex), not {type(idx).__name__}")
    if rec.dtype != torch.int64 or rec.dim() != 1 or rec.device != idx.device or not rec.is_contiguous():
        raise ValueError("rec must be a contiguous 1-D int64 tensor on the index's device")
    if not 0 <= m2 <= rec.numel():
        raise ValueError(f"{m2} lanes for {rec.numel()} B2 symbols")
    if int(idx.acc[6]) != idx.n:
        raise ValueError("B1's rows must count n nt6 symbols")


def merge_rank_plain(idx: OccIndex, rec: torch.Tensor, m2: int) -> torch.Tensor:
    """All m2 lanes in lock-step, one LF step a trip (merge.py:56-91 on
    packed records): rec becomes ins, in place, and is returned."""
    check_merge(idx, rec, m2)
    acc = idx.acc.long()
    kb = torch.arange(m2, dtype=torch.int64, device=rec.device)
    ka = acc[1].repeat(m2)
    while kb.numel():
        r = rec[kb]
        c = r & 7
        rec[kb] = ka
        live = c != 0
        kb, ka, r, c = kb[live], ka[live], r[live], c[live]
        ka = acc[c] + idx.rank1a(ka).gather(-1, c[:, None])[:, 0]
        kb = r >> 3
    return rec


def merge_rank_cuda(idx: OccIndex, rec: torch.Tensor, m2: int) -> torch.Tensor:
    """The merge rank through the merge_rank kernel of the index's layout
    (dense32 or dense64): rec becomes ins, in place, and is returned.  A CPU
    index takes the plain version."""
    check_merge(idx, rec, m2)
    if idx.device.type == "cpu":
        return merge_rank_plain(idx, rec, m2)
    return launch_merge_rank(idx, rec, m2)


def launch_merge_rank(idx: OccIndex, rec: torch.Tensor, m2: int) -> torch.Tensor:
    """`merge_rank_cuda` on a CUDA index that `check_merge` has passed,
    counting the launch: timing loops call this, as the check reads acc
    back to the host."""
    if m2:
        kernels.launch(f"rb3c_merge_rank_{idx.layout}", idx.device, *idx.kernel_tables(), rec.data_ptr(), m2)
        merge_rank_cuda.launches[idx.layout] += 1
    return rec


merge_rank_cuda.launches = Counter()


def merge_apply(bwt1: torch.Tensor, seq2: torch.Tensor, ins: torch.Tensor) -> torch.Tensor:
    """The merged BWT: B2[i] at ins[i] + i, B1 in order in the other places
    (merge.py:236-261), chunk by chunk of the merged array."""
    n1, n2 = bwt1.numel(), seq2.numel()
    if n2 and (int(ins[0]) < 0 or int(ins[-1]) > n1 or bool((ins[1:] < ins[:-1]).any())):
        raise ValueError("insertion ranks must be nondecreasing within [0, n1]")
    n = n1 + n2
    pos2 = ins + torch.arange(n2, dtype=torch.int64, device=ins.device)  # strictly increasing
    merged = torch.empty(n, dtype=torch.uint8, device=bwt1.device)
    for p0 in range(0, n, APPLY_CHUNK):
        p1 = min(p0 + APPLY_CHUNK, n)
        i0, i1 = (int(x) for x in torch.searchsorted(pos2, torch.tensor([p0, p1], device=pos2.device)))
        at = pos2[i0:i1] - p0
        seg = merged[p0:p1]
        mark = torch.zeros(p1 - p0, dtype=torch.bool, device=bwt1.device)
        mark[at] = True
        seg[at] = seq2[i0:i1]
        seg.masked_scatter_(~mark, bwt1[p0 - i0 : p1 - i1])
    return merged


def merge_plain(idx: OccIndex, bwt1: torch.Tensor, seq2: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Merge the plain partial BWT seq2 (B2) into B1, given as its BWT bwt1
    and its dense rows idx, on idx's device; returns the merged BWT."""
    if isinstance(seq2, np.ndarray):
        seq2 = torch.from_numpy(np.ascontiguousarray(seq2, dtype=np.uint8))
    seq2 = seq2.to(idx.device)
    if bwt1.device != idx.device or bwt1.numel() != idx.n or bwt1.dtype != torch.uint8 or seq2.dtype != torch.uint8:
        raise ValueError("bwt1 must be the uint8 BWT of idx's rows, on its device, and seq2 a uint8 BWT")
    if not seq2.numel():
        return bwt1.clone()
    acc2, rec = lf2_packed(seq2)
    ins = merge_rank_cuda(idx, rec, int(acc2[1]))
    return merge_apply(bwt1, seq2, ins)
