"""Merging a partial BWT B2 into an index B1, on a torch device (K6).

Port of ropebwt3_tpu/construct/merge.py, Algorithm 2 of the ropebwt3 paper
as the JAX package reformulates it (fm-index.c:143-175, 279-303):
  1. `lf2_packed`: B2's own LF table, packed with its symbols:
     rec[i] = (lf2[i] << 3) | B2[i], lf2[i] = acc2[B2[i]] + occ2_{B2[i]}(i)
     (rb3t_lf2_packed, bwasw_core.cpp:2022-2043), torch ops;
  2. the merge rank: each B2 sequence is walked backwards on B2's LF and
     B1's rank at once; each B2 position is visited once and its rec
     becomes ins, the count of B1 symbols before it in the merged BWT.
     The walks run as segments from every sentinel row and every S-th B2
     position, which bracket B1's rank between a lower and an upper walk
     until the two meet, then hand over to the segment before them
     (csrc/merge_rank.cu says how).  `merge_rank_cuda` runs that kernel;
     `merge_rank_chunked_plain` is its lock-step PyTorch version (the CPU
     path, and the reference on the card); `merge_rank_plain`, one lane
     per sequence, is the walk as the JAX package defines it;
  3. `merge_apply`: B2[i] lands at ins[i] + i, B1 fills the gaps in order
     (ins is nondecreasing: the merge keeps each BWT's order), in chunks of
     the merged array so no temporary is a full int64 array.
`merge_plain` runs the three on B1's dense rows (ops/rank.py OccIndex) and
returns the merged BWT, on B1's device; its rows come from
`OccIndex.from_bwt` when the next merge needs them.

Capacity: a merge holds B1 (1 B a symbol), its rows (0.75 B) and B2 (1 B)
throughout; beside them, in turn, `OccIndex.from_bwt`'s temporaries (1.5 B
a B1 symbol and a chunk's), lf2_packed's (~33 B a B2 symbol), the kernel's
records and ins (16 B a B2 symbol) and segments, and merge_apply's positions (24 B a B2 symbol) with
the merged BWT (1 B a symbol of either) and a chunk's temporaries:
`merge_bytes` counts the largest.  The largest merged index a card holds is
therefore about its free memory / 3.25 in symbols, less the last batch's
~34 B a symbol (an 80 GB NVIDIA H100: ~24 G symbols).  Run-block B1 rows for
merges are not ported (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import kernels
from ..ops.rank import ASIZE, OccIndex, from_bwt_temp_bytes

APPLY_CHUNK = 1 << 25  # merged positions per chunk of merge_apply
# The segment stride S of the merge rank: a power of two, short enough to
# give each SM LANES_PER_SM lanes (the threads an SM keeps resident), and
# at least MIN_STRIDE (from 128 on, chip_smoke's stride sweep is within
# ~10% of its best on both bench.py's genomes and its short reads, PERF.md)
MIN_STRIDE, LANES_PER_SM = 128, 2048
SEG_ROWS = 5  # per segment: meet, len, end_pos, end_ka, hand (csrc/merge_rank.cu)
NEVER = (1 << 63) - 1  # meet of a segment that did not meet


def merge_bytes(n1: int, n2: int, m2: int) -> int:
    """Card bytes at a merge's peak: B1, its rows and B2, and the largest of
    what is held beside them in turn: OccIndex.from_bwt's temporaries,
    lf2_packed's (~33 B a B2 symbol), the merge rank's records, ins and
    segments, and merge_apply's positions, merged BWT and chunk."""
    keep = n1 + 48 * (n1 // 64 + 2) + n2
    rank = 16 * n2 + 8 * SEG_ROWS * segments(n2, m2, MIN_STRIDE)[1]
    apply = 24 * n2 + n1 + n2 + 24 * min(APPLY_CHUNK, n1 + n2)
    return keep + max(from_bwt_temp_bytes(n1), 33 * n2, rank, apply)


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


def stride(n2: int, device) -> int:
    """The segment stride for n2 B2 symbols on `device` (one SM on the CPU)."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count if device.type == "cuda" else 1
    want = -(-n2 // (sms * LANES_PER_SM))
    return max(MIN_STRIDE, 1 << max(0, want - 1).bit_length())


def segments(n2: int, m2: int, S: int) -> tuple[int, int]:
    """(first, n_seg): the segments are the m2 sentinel rows, then the
    multiples of S from first * S = the first one >= m2, below n2.  No
    sentinel, no walk: m2 == 0 gives none."""
    if not isinstance(S, int) or S < 1:
        raise ValueError(f"the segment stride must be a positive int, not {S!r}")
    if not m2:
        return 0, 0
    first = -(-m2 // S)
    return first, m2 + max(0, -(-n2 // S) - first)


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


def merge_rank_chunked_plain(idx: OccIndex, rec: torch.Tensor, m2: int, S: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two passes, each over all its lanes in lock-step: rec
    becomes ins, in place.  Returns (rec, seg), seg (5, n_seg) int64 as the
    kernel fills it."""
    check_merge(idx, rec, m2)
    n2, dev = rec.numel(), rec.device
    first, n_seg = segments(n2, m2, S)
    acc = idx.acc.long()
    seg = torch.full((SEG_ROWS, n_seg), -1, dtype=torch.int64, device=dev)
    seg[4] = 0

    def lf1(ka, c):
        return acc[c] + idx.rank1a(ka).gather(-1, c[:, None])[:, 0]

    def is_start(kb):
        return (kb >= m2) & (kb % S == 0)

    # pass 1: one lane a segment, lo and hi from [acc1[1], acc1[1]] or [0, n1]
    g = torch.arange(n_seg, dtype=torch.int64, device=dev)
    kb = torch.where(g < m2, g, (first + g - m2) * S)
    lo = torch.where(g < m2, acc[1], 0)
    hi = torch.where(g < m2, acc[1], idx.n)
    meet = torch.where(lo == hi, 0, NEVER)
    t = torch.zeros_like(g)
    while g.numel():
        r = rec[kb]
        c = r & 7
        met = lo == hi
        rec[kb[met]] = lo[met]
        t += 1
        kb = torch.where(c == 0, -1, r >> 3)
        lohi = lf1(torch.cat([lo, hi]), c.repeat(2))  # a `$` lane's step is dropped
        lo, hi = torch.where(c == 0, lo, lohi[: g.numel()]), torch.where(c == 0, hi, lohi[g.numel() :])
        meet = torch.where(~met & (lo == hi), t, meet)
        done = (c == 0) | is_start(kb)
        if done.any():
            d = g[done]
            seg[0, d], seg[1, d], seg[2, d] = meet[done], t[done], kb[done]
            seg[3, d] = torch.where((kb[done] >= 0) & (lo[done] == hi[done]), lo[done], -1)
            keep = ~done
            g, kb, lo, hi, meet, t = g[keep], kb[keep], lo[keep], hi[keep], meet[keep], t[keep]

    # pass 2: each segment whose end is exact writes on through the unmet
    # prefixes of the segments after it
    g = torch.nonzero((seg[2] >= 0) & (seg[3] >= 0))[:, 0]
    kb, ka = seg[2, g], seg[3, g]
    mt = seg[0, m2 + kb // S - first]
    t, steps = torch.zeros_like(g), torch.zeros_like(g)
    stop = t == mt
    while True:
        if stop.any():
            seg[4, g[stop]] = steps[stop]
            go = ~stop
            g, kb, ka, mt, t, steps = g[go], kb[go], ka[go], mt[go], t[go], steps[go]
        if not g.numel():
            break
        r = rec[kb]
        c = r & 7
        rec[kb] = ka
        steps += 1
        t += 1
        kb, ka = r >> 3, lf1(ka, c)
        # into the next segment, unless this one met on its last step (its
        # own lane hands over)
        move = (c != 0) & is_start(kb) & (t != mt)
        if move.any():
            mt = torch.where(move, seg[0, torch.where(move, m2 + kb // S - first, 0)], mt)
            t = torch.where(move, 0, t)
        stop = (c == 0) | (t == mt)
    return rec, seg


def merge_rank_cuda(idx: OccIndex, rec: torch.Tensor, m2: int, S: int | None = None) -> torch.Tensor:
    """The merge rank through the merge_rank kernel of the index's layout
    (dense32 or dense64): returns ins, a new tensor (the kernel reads the
    records and writes ins apart from them; over them it runs ~5x slower,
    PERF.md).  S, the segment stride, is derived from n2 and the card
    (`stride`); the tests pass small ones (any positive int on the CPU, a
    power of two on the card).  A CPU index takes the plain version, which
    writes ins over rec."""
    check_merge(idx, rec, m2)
    S = stride(rec.numel(), idx.device) if S is None else S
    if idx.device.type == "cpu":
        return merge_rank_chunked_plain(idx, rec, m2, S)[0]
    return launch_merge_rank(idx, rec, torch.empty_like(rec), m2, S)[0]


def launch_merge_rank(idx: OccIndex, rec: torch.Tensor, ins: torch.Tensor, m2: int,
                      S: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`merge_rank_cuda` on a CUDA index that `check_merge` has passed: the
    kernel reads lf2_packed's records `rec` and writes ins into `ins`, an
    int64 tensor of rec's shape apart from it, at the stride S (a power of
    two).  Returns (ins, seg) and counts the launch.  Timing loops call
    this, as the check reads acc back to the host."""
    first, n_seg = segments(rec.numel(), m2, S)
    if S & (S - 1):
        raise ValueError(f"the kernel takes a power-of-two stride, not {S}")
    if not rec.dtype == ins.dtype == torch.int64 or rec.dim() != 1 or ins.shape != rec.shape or \
            not rec.is_contiguous() or not ins.is_contiguous() or not rec.device == ins.device == idx.device:
        raise ValueError("rec and ins must be contiguous 1-D int64 tensors of one shape, on the index's device")
    if rec.numel() and ins.untyped_storage().data_ptr() == rec.untyped_storage().data_ptr():
        raise ValueError("ins must not share the records' memory: the kernel reads them as it writes ins")
    seg = torch.empty((SEG_ROWS, n_seg), dtype=torch.int64, device=ins.device)
    if n_seg:
        kernels.launch(f"rb3c_merge_rank_{idx.layout}", idx.device, *idx.kernel_tables(), rec.data_ptr(),
                       ins.data_ptr(), m2, S.bit_length() - 1, first, n_seg, seg.data_ptr())
        merge_rank_cuda.launches[idx.layout] += 1
    return ins, seg


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
    del rec  # apart from ins on the card: freed before merge_apply's peak
    return merge_apply(bwt1, seq2, ins)
