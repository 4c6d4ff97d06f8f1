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
`OccIndex.from_bwt` when the next merge needs them.  Over a mesh (`build
--mesh`), B1's rows are sharded over its idx axis and the segments of the
merge rank split over all its devices (`merge_rank_mesh`, the port of
ropebwt3_tpu/parallel/merge_sharded.py; `merge_mesh_bytes` counts what it
puts on each device).

Placement (`placement`): a merge runs on the card, B1 and the merged BWT
there (`merge_plain`), while `merge_bytes` fits the card's budget and B1's
rows are dense; otherwise on the host (`merge_host`): B1 and the merged
BWT stay in host memory, and the card holds only B1's rows (the layout
ops/smem.py `resolve_occ` picks for n1: dense, or rb where dense rows pass
0.75 of the card), B2, lf2_packed's temporaries, the records and ins.  K6
runs on the card on both (merge_rank_rb32 / rb64 over rb rows, csrc/rb.cuh
`Rb<T>::rank1` / `rank2`); ins comes down (8 B a B2 symbol) and the native
`rb3t_merge_apply` writes the merged BWT.  B1's rows never put B1 whole on
the card: dense ones are built chunk by chunk (`OccIndex.from_bwt` of the
host array), rb ones on the host from B1's runs (`build_runblock_np`).
`merge_host_bytes` counts the host path's card bytes; past the budget it
stops with a CapacityError before any upload.  On the CPU device the
budget is CPU_BUDGET (None: no limit), which the tests set.

Capacity on the card path: a merge holds B1 (1 B a symbol), its rows (0.75 B) and B2 (1 B)
throughout; beside them, in turn, `OccIndex.from_bwt`'s temporaries (a
chunk's), lf2_packed's (~33 B a B2 symbol), the kernel's
records and ins (16 B a B2 symbol) and segments, and merge_apply's positions (24 B a B2 symbol) with
the merged BWT (1 B a symbol of either) and a chunk's temporaries:
`merge_bytes` counts the largest.  The largest merged index a card holds on
that path is therefore about its free memory / 3.25 in symbols, less the
last batch's ~34 B a symbol (an 80 GB NVIDIA H100: ~24 G symbols).  On the
host path the card holds B1's rows beside one batch's ~34 B a symbol:
dense rows up to 0.75 of the card (~80 G symbols on 80 GB), then rb rows,
160/S B a symbol plus S/2 B an escape block; host memory holds B1, the
merged BWT and ins (8 B a B2 symbol).

Over a mesh (`build --mesh`) the card path holds B1 and its whole rows on
the first device (`merge_mesh_bytes`).  Past any device's budget the merge
runs on the host placement over the mesh (`merge_host_mesh`), as the JAX
package's mesh merge does (ropebwt3_tpu/construct/merge.py:201-236): B1
and the merged BWT in host memory, B1's dense rows built slab by slab, each
on the card that holds it, from its part of the host array
(ops/rank.py HostBwtRows through parallel/mesh.py ShardedRows), B2,
lf2_packed and the records on the first device, K6 over the mapped slabs,
ins down and the native interleave.  No card holds B1 or the whole table,
so the index is bounded by host memory and the idx axis's card memory for
the rows (`merge_mesh_host_bytes`, each device's peak); rb rows over a mesh
are ROADMAP item 8's.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from .. import kernels, log, native
from ..index.dense import runs_of_bwt
from ..ops import runblock
from ..ops.rank import ASIZE, HostBwtRows, OccIndex, from_bwt_temp_bytes
from ..ops.runblock import RunBlockIndex
from ..parallel import launch
from ..parallel.mesh import ShardedRows, ShardView, granularity, slab_plan

APPLY_CHUNK = 1 << 25  # merged positions per chunk of merge_apply
# The segment stride S of the merge rank: a power of two, short enough to
# give each SM LANES_PER_SM lanes (the threads an SM keeps resident), and
# at least MIN_STRIDE (from 128 on, chip_smoke's stride sweep is within
# ~10% of its best on both bench.py's genomes and its short reads, PERF.md)
MIN_STRIDE, LANES_PER_SM = 128, 2048
SEG_ROWS = 5  # per segment: meet, len, end_pos, end_ka, hand (csrc/merge_rank.cu)
NEVER = (1 << 63) - 1  # meet of a segment that did not meet
WALK, HAND_OVER = 1, 2  # the passes of rb3c_merge_rank_* (csrc/merge_rank.cu)
# The card's budget for a merge where the device is the CPU (cli.card_bytes
# gives none there): None, no limit.  The tests set it to force the host
# placement.
CPU_BUDGET: int | None = None


def merge_bytes(n1: int, n2: int, m2: int) -> int:
    """Card bytes at a merge's peak: B1, its rows and B2, and the largest of
    what is held beside them in turn: OccIndex.from_bwt's temporaries,
    lf2_packed's (~33 B a B2 symbol), the merge rank's records, ins and
    segments, and merge_apply's positions, merged BWT and chunk."""
    keep = n1 + dense_rows_bytes(n1) + n2
    apply = 24 * n2 + n1 + n2 + 24 * min(APPLY_CHUNK, n1 + n2)
    return keep + max(from_bwt_temp_bytes(n1), 33 * n2, rank_bytes(n2, m2), apply)


def dense_rows_bytes(n: int) -> int:
    """Bytes of an n-symbol index's dense rows on the device (OccIndex)."""
    return 48 * (n // 64 + 2)


def rank_bytes(n2: int, m2: int) -> int:
    """Bytes of the merge rank's records and ins (8 B each a B2 symbol) and
    segment records at the smallest stride."""
    return 16 * n2 + 8 * SEG_ROWS * segments(n2, m2, MIN_STRIDE)[1]


def merge_host_bytes(n2: int, m2: int, rows: int, build: int) -> int:
    """Card bytes at a host-placed merge's peak: B1's rows (`rows` B) and
    B2, and the largest of what is held beside them in turn: the rows'
    build (`build` B: from_bwt's chunk, or pack_escapes'), lf2_packed's
    temporaries (~33 B a B2 symbol), and the merge rank's records, ins and
    segments.  B1 and the merged BWT stay in host memory."""
    return rows + n2 + max(build, 33 * n2, rank_bytes(n2, m2))


def budget(dev) -> int | None:
    """The card bytes a merge on `dev` may take (cli.card_bytes), or
    CPU_BUDGET on the CPU."""
    from ..cli import card_bytes

    got = card_bytes(torch.device(dev))
    return CPU_BUDGET if got is None else got


def placement(n1: int, n2: int, m2: int, dev, mesh=None) -> tuple[str, str]:
    """("card" or "host", why) for merging n2 symbols (m2 sequences) into
    an index of n1 on `dev`: the card while `merge_bytes` fits its budget
    and B1's rows are dense (ops/smem.py resolve_occ for n1, the
    RB3TPU_DEVICE_OCC override included), the host otherwise.  Over `mesh`
    (dense rows only): the card while `merge_mesh_bytes` fits every
    device's budget, the host otherwise."""
    from ..ops.smem import resolve_occ

    if mesh is not None:
        need = merge_mesh_bytes(n1, n2, m2, mesh)
        have, over = over_budget(need)
        d = over[0] if over else str(mesh.devices[0])
        of = f"~{need[d]} B of {d}'s {'unlimited' if have[d] is None else have[d]} B"
        return ("host" if over else "card"), f"the card path over the {mesh.dp}x{mesh.idx} mesh needs {of}"
    need, have = merge_bytes(n1, n2, m2), budget(dev)
    of = f"~{need} B of the card's {'unlimited' if have is None else have} B"
    if resolve_occ("auto", n1, dev) == "rb":
        return "host", f"B1's rows are rb (the card path, dense rows only, would need {of})"
    if have is not None and need > have:
        return "host", f"the card path needs {of}"
    return "card", f"the card path needs {of}"


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


def check_merge(idx, rec: torch.Tensor, m2: int) -> None:
    """B1's rows (an OccIndex or a RunBlockIndex, or a ShardView of dense
    rows on a mesh), the records on their device, 0 <= m2 <= n2, and rows
    that count n symbols."""
    if not (isinstance(idx, (OccIndex, RunBlockIndex)) or isinstance(idx, ShardView) and not idx.is_rb):
        raise TypeError(f"the merge rank takes occ rows (OccIndex, RunBlockIndex, or a dense ShardView), not "
                        f"{getattr(idx, 'layout', type(idx).__name__)}")
    if rec.dtype != torch.int64 or rec.dim() != 1 or rec.device != idx.device or not rec.is_contiguous():
        raise ValueError("rec must be a contiguous 1-D int64 tensor on the index's device")
    if not 0 <= m2 <= rec.numel():
        raise ValueError(f"{m2} lanes for {rec.numel()} B2 symbols")
    if int(idx.acc[6]) != idx.n:
        raise ValueError("B1's rows must count n nt6 symbols")


def sm_count(device) -> int:
    """The SMs of `device` (one on the CPU)."""
    device = torch.device(device)
    return torch.cuda.get_device_properties(device).multi_processor_count if device.type == "cuda" else 1


def stride(n2: int, device) -> int:
    """The segment stride for n2 positions to walk on `device`: the merge
    rank's B2 symbols, ssa_ops.walk_stride's rows past the heads."""
    want = -(-n2 // (sm_count(device) * LANES_PER_SM))
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


def merge_rank_plain(idx, rec: torch.Tensor, m2: int) -> torch.Tensor:
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


def merge_rank_chunked_plain(idx, rec: torch.Tensor, m2: int, S: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two passes, each over all its lanes in lock-step: rec
    becomes ins, in place.  Returns (rec, seg), seg (5, n_seg) int64 as the
    kernel fills it.  idx: an OccIndex, a RunBlockIndex or, over a mesh, a
    dense ShardView (its rank `rank6_sharded_plain`)."""
    check_merge(idx, rec, m2)
    n_seg = segments(rec.numel(), m2, S)[1]
    seg = torch.full((SEG_ROWS, n_seg), -1, dtype=torch.int64, device=rec.device)
    merge_walk_plain(idx, rec, rec, m2, S, seg, 0, n_seg)
    merge_hand_over_plain(idx, rec, rec, m2, S, seg, 0, n_seg)
    return rec, seg


def merge_walk_plain(idx, rec: torch.Tensor, ins: torch.Tensor, m2: int, S: int, seg: torch.Tensor, g0: int,
                     g1: int) -> None:
    """Pass 1 over the segments [g0, g1), in lock-step: each lane walks its
    segment and writes ins from its meeting step on (ins may be rec: each
    position is read before it is written, by its one writer) and its
    columns of seg (5, n_seg), hand 0."""
    n2, dev = rec.numel(), rec.device
    first = segments(n2, m2, S)[0]
    acc = idx.acc.long()
    seg[4, g0:g1] = 0

    def lf1(ka, c):
        return acc[c] + idx.rank1a(ka).gather(-1, c[:, None])[:, 0]

    # one lane a segment, lo and hi from [acc1[1], acc1[1]] or [0, n1]
    g = torch.arange(g0, g1, dtype=torch.int64, device=dev)
    kb = torch.where(g < m2, g, (first + g - m2) * S)
    lo = torch.where(g < m2, acc[1], 0)
    hi = torch.where(g < m2, acc[1], idx.n)
    meet = torch.where(lo == hi, 0, NEVER)
    t = torch.zeros_like(g)
    while g.numel():
        r = rec[kb]
        c = r & 7
        met = lo == hi
        ins[kb[met]] = lo[met]
        t += 1
        kb = torch.where(c == 0, -1, r >> 3)
        lohi = lf1(torch.cat([lo, hi]), c.repeat(2))  # a `$` lane's step is dropped
        lo, hi = torch.where(c == 0, lo, lohi[: g.numel()]), torch.where(c == 0, hi, lohi[g.numel() :])
        meet = torch.where(~met & (lo == hi), t, meet)
        done = (c == 0) | ((kb >= m2) & (kb % S == 0))
        if done.any():
            d = g[done]
            seg[0, d], seg[1, d], seg[2, d] = meet[done], t[done], kb[done]
            seg[3, d] = torch.where((kb[done] >= 0) & (lo[done] == hi[done]), lo[done], -1)
            keep = ~done
            g, kb, lo, hi, meet, t = g[keep], kb[keep], lo[keep], hi[keep], meet[keep], t[keep]


def merge_hand_over_plain(idx, rec: torch.Tensor, ins: torch.Tensor, m2: int, S: int, seg: torch.Tensor, g0: int,
                          g1: int) -> None:
    """Pass 2 over the segments [g0, g1), once every segment's pass 1 is in
    seg: each whose end is exact writes on through the unmet prefixes of
    the segments after it (any segment's meeting step is read), and its
    hand in seg."""
    first = segments(rec.numel(), m2, S)[0]
    acc = idx.acc.long()

    def is_start(kb):
        return (kb >= m2) & (kb % S == 0)

    g = g0 + torch.nonzero((seg[2, g0:g1] >= 0) & (seg[3, g0:g1] >= 0))[:, 0]
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
        ins[kb] = ka
        steps += 1
        t += 1
        kb, ka = r >> 3, acc[c] + idx.rank1a(ka).gather(-1, c[:, None])[:, 0]
        # into the next segment, unless this one met on its last step (its
        # own lane hands over)
        move = (c != 0) & is_start(kb) & (t != mt)
        if move.any():
            mt = torch.where(move, seg[0, torch.where(move, m2 + kb // S - first, 0)], mt)
            t = torch.where(move, 0, t)
        stop = (c == 0) | (t == mt)


def merge_rank_cuda(idx, rec: torch.Tensor, m2: int, S: int | None = None) -> torch.Tensor:
    """The merge rank through the merge_rank kernel of the index's layout
    (dense32, dense64, rb32 or rb64): returns ins, a new tensor (the kernel reads the
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


def launch_merge_rank(idx, rec: torch.Tensor, ins: torch.Tensor, m2: int,
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
                       ins.data_ptr(), m2, S.bit_length() - 1, first, n_seg, 0, n_seg, WALK | HAND_OVER,
                       seg.data_ptr())
        merge_rank_cuda.launches[idx.layout] += 1
    return ins, seg


merge_rank_cuda.launches = Counter()

LOW = -(1 << 63)  # a segment record no share wrote: below every written value


def merge_rank_mesh(views: list, rec: torch.Tensor, m2: int, S: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The merge rank over a mesh (the port of ropebwt3_tpu/parallel/
    merge_sharded.py merge_rank_sharded_fn): `views` are the ShardViews of
    B1's dense rows sharded over the mesh's idx axis (parallel/mesh.py
    ShardedRows), one a device, and each distinct card takes one contiguous
    range of the segments, as long as its mesh slots' share (this process's
    share under torchrun, launch.card_ranges).  The stride S and the
    segments are the whole B2's (`stride` on the first view's device), not a
    share's.  Pass 1 runs on each card over its range into its own ins (-1
    where unwritten) and segment records; the records are gathered onto
    every card (a hand-over reads the meeting step of a successor another
    range holds); pass 2 runs over the same ranges; the shares merge by a
    max onto the first view's device (launch.merge_shares: each position
    has one writer).  On CUDA views each pass is one launch a card of
    merge_rank_<layout> over the mapped rows, counted; on the CPU the plain
    passes run over the view's rank (rank6_sharded_plain).  Returns (ins,
    seg): ins (n2,) int64 apart from rec, seg (5, n_seg) as
    merge_rank_chunked_plain's."""
    check_merge(views[0], rec, m2)
    if any(v.origin is not views[0].origin for v in views):
        raise ValueError("the views must be one ShardedRows' (one a device of its mesh)")
    S = stride(rec.numel(), views[0].device) if S is None else S
    if views[0].device.type == "cuda" and S & (S - 1):
        raise ValueError(f"the kernel takes a power-of-two stride, not {S}")
    return launch_merge_mesh(views, rec, m2, S)


def launch_merge_mesh(views: list, rec: torch.Tensor, m2: int, S: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`merge_rank_mesh` on views and records that it has checked, at the
    stride S: no read back to the host on one card, so timing loops call
    this."""
    n2 = rec.numel()
    n_seg = segments(n2, m2, S)[1]
    cards = [(views[j], g0, g1) for j, g0, g1 in launch.card_ranges(n_seg, [v.device for v in views])]
    recs = [rec.to(v.device) for v, _, _ in cards]
    ins = [torch.full((n2,), -1, dtype=torch.int64, device=v.device) for v, _, _ in cards]

    def run(passes, segs):
        for (v, g0, g1), r, x, sg in zip(cards, recs, ins, segs):
            if v.device.type == "cpu":
                (merge_walk_plain if passes == WALK else merge_hand_over_plain)(v, r, x, m2, S, sg, g0, g1)
            else:
                launch_merge_range(v, r, x, m2, S, sg, g0, g1, passes)

    segs = [torch.full((SEG_ROWS, n_seg), LOW, dtype=torch.int64, device=v.device) for v, _, _ in cards]
    run(WALK, segs)
    full = launch.merge_shares(segs)
    del segs
    fulls = [full.to(v.device) for v, _, _ in cards]  # every range's records on every card
    run(HAND_OVER, fulls)
    seg = launch.merge_shares(fulls)  # each card's hand-over counts
    return launch.merge_shares(ins), seg


def launch_merge_range(view, rec: torch.Tensor, ins: torch.Tensor, m2: int, S: int, seg: torch.Tensor, g0: int,
                       g1: int, passes: int) -> None:
    """One launch of merge_rank_<layout> on the view's card, counted:
    `passes` (WALK, HAND_OVER or both) over the segments [g0, g1) of seg (5,
    n_seg), at the power-of-two stride S; nothing for an empty range."""
    first, n_seg = segments(rec.numel(), m2, S)
    if g1 > g0:
        kernels.launch(f"rb3c_merge_rank_{view.layout}", view.device, *view.kernel_tables(), rec.data_ptr(),
                       ins.data_ptr(), m2, S.bit_length() - 1, first, n_seg, g0, g1, passes, seg.data_ptr())
        kernels.count(merge_rank_cuda.launches, view.layout)


def merge_mesh_bytes(n1: int, n2: int, m2: int, mesh) -> dict[str, int]:
    """Card bytes a merge over `mesh` (parallel/mesh.py Mesh) holds on each
    distinct device at its peak, str(device) -> bytes: on the first, the
    merge's own (`merge_bytes`: B1, its rows, B2, the records, merge_apply's
    positions); on each, the physical slabs of B1's rows this process
    owns there (mesh.ShardedRows: one a (device, slab) of its slots, its
    real rows rounded up to the granularity; outside PyTorch's allocator;
    a slab that another process owns and this one maps is its owner's),
    one ins and one set of segment records, the gathered records, and the
    records themselves (the first device's are merge_bytes')."""
    n_seg = segments(n2, m2, MIN_STRIDE)[1]
    first = str(mesh.devices[0])
    return {d: (merge_bytes(n1, n2, m2) if d == first else 8 * n2) + 8 * n2 + 2 * 8 * SEG_ROWS * n_seg + slab
            for d, slab in slab_bytes(n1, mesh).items()}


def slab_bytes(n1: int, mesh) -> dict[str, int]:
    """str(device) -> the physical bytes of the slabs of B1's dense rows
    this process owns on each distinct device of `mesh`."""
    cuda = [d.index for d in mesh.distinct if d.type == "cuda"]
    sizes = slab_plan(n1 // 64 + 2, mesh.idx, 48, granularity(cuda, mesh.shared) if cuda else 48)[3]
    slabs = {(str(d), s) for row in mesh.grid for s, d in enumerate(row) if d is not None}
    return {d: sum(sizes[s] for dd, s in slabs if dd == d) for d in map(str, mesh.distinct)}


def over_budget(need: dict[str, int]) -> tuple[dict, list[str]]:
    """(each device's `budget`, the devices whose `need` passes it)."""
    have = {d: budget(d) for d in need}
    return have, [d for d in need if have[d] is not None and need[d] > have[d]]


def merge_mesh_host_bytes(n1: int, n2: int, m2: int, mesh) -> dict[str, int]:
    """Card bytes a host-placed merge over `mesh` (`merge_host_mesh`) holds
    on each distinct device at its peak, str(device) -> bytes: the slabs of
    B1's dense rows this process owns there (as merge_mesh_bytes counts
    them), and beside them on the first device `merge_host_bytes` with no
    rows (B2, then in turn a slab's build, lf2_packed's temporaries, the
    records, ins and segments), on every other the larger of a slab's build
    and the merge rank's share; on each, one ins and the segment records
    twice (merge_mesh_bytes' share).  B1 and the merged BWT stay in host
    memory."""
    n_seg = segments(n2, m2, MIN_STRIDE)[1]
    first, build, share = str(mesh.devices[0]), from_bwt_temp_bytes(n1), 16 * n2 + 2 * 8 * SEG_ROWS * n_seg
    return {d: (merge_host_bytes(n2, m2, 0, build) + share if d == first else max(build, share)) + slab
            for d, slab in slab_bytes(n1, mesh).items()}


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


def merge_plain(idx, bwt1: torch.Tensor, seq2: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Merge the plain partial BWT seq2 (B2) into B1, given as its BWT bwt1
    and its dense rows idx (an OccIndex, or the list of a mesh's ShardViews
    of them: the merge rank then runs over the mesh, `merge_rank_mesh`), on
    the rows' (first) device; returns the merged BWT."""
    mesh = isinstance(idx, list)
    home = idx[0] if mesh else idx
    if isinstance(seq2, np.ndarray):
        seq2 = torch.from_numpy(np.ascontiguousarray(seq2, dtype=np.uint8))
    seq2 = seq2.to(home.device)
    if bwt1.device != home.device or bwt1.numel() != home.n or bwt1.dtype != torch.uint8 or seq2.dtype != torch.uint8:
        raise ValueError("bwt1 must be the uint8 BWT of idx's rows, on its device, and seq2 a uint8 BWT")
    if not seq2.numel():
        return bwt1.clone()
    acc2, rec = lf2_packed(seq2)
    ins = merge_rank_mesh(idx, rec, int(acc2[1]))[0] if mesh else merge_rank_cuda(idx, rec, int(acc2[1]))
    del rec  # apart from ins on the card: freed before merge_apply's peak
    return merge_apply(bwt1, seq2, ins)


def apply_host(bwt1: np.ndarray, seq2: np.ndarray, ins: np.ndarray) -> np.ndarray:
    """`merge_apply` in host memory, by the native interleave
    (rb3t_merge_apply): B2[i] at ins[i] + i, B1 in order in the other places."""
    n1, n2 = len(bwt1), len(seq2)
    bwt1, seq2 = np.ascontiguousarray(bwt1, np.uint8), np.ascontiguousarray(seq2, np.uint8)
    ins = np.ascontiguousarray(ins, np.int64)
    if ins.shape != (n2,) or n2 and (ins[0] < 0 or ins[-1] > n1 or bool((ins[1:] < ins[:-1]).any())):
        raise ValueError("insertion ranks must be nondecreasing within [0, n1], one a B2 symbol")
    merged = np.empty(n1 + n2, np.uint8)
    native.lib().rb3t_merge_apply(bwt1.ctypes.data, n1, seq2.ctypes.data, ins.ctypes.data, n2, merged.ctypes.data)
    return merged


def merge_host(bwt1: np.ndarray, seq2, dev, layout: str | None = None, pieces: dict | None = None) -> np.ndarray:
    """Merge the plain partial BWT seq2 (B2: a uint8 tensor, on `dev` or
    the host, or a numpy array) into B1, whose BWT bwt1 lies in host
    memory; returns the merged BWT in host memory.  B1's rows go to `dev`
    in `layout` (None: resolve_occ's for n1): dense ones chunk by chunk
    (`OccIndex.from_bwt` of the host array), rb ones built on the host from
    B1's runs and uploaded (`RunBlockIndex.from_np`), after a check of
    `merge_host_bytes` against the budget (a CapacityError naming the
    bytes).  lf2_packed and K6 run on `dev`, ins comes down, and the native
    interleave writes the merged BWT.  Logs the layout, S, the card bytes
    and the seconds of each piece, and puts them in `pieces` when given."""
    from ..cli import CapacityError
    from ..ops.smem import resolve_occ

    dev = torch.device(dev)
    n1, n2 = len(bwt1), len(seq2)
    layout = resolve_occ("auto", n1, dev) if layout is None else layout
    sec, t = {}, time.perf_counter()

    def lap(piece):
        nonlocal t
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sec[piece], t = time.perf_counter() - t, time.perf_counter()

    seq2_h = seq2.cpu().numpy() if torch.is_tensor(seq2) else np.ascontiguousarray(seq2, np.uint8)
    m2 = int(np.count_nonzero(seq2_h == 0))
    if layout == "rb":
        host = runblock.build_runblock_np(*runs_of_bwt(np.asarray(bwt1)), n=n1)
        rows_b, build_b = runblock.device_bytes(host), runblock.pack_temp_bytes(len(host["esc"]), host["S"])
        lap("rows on the host")
    else:
        rows_b, build_b = dense_rows_bytes(n1), from_bwt_temp_bytes(n1)
    need, have = merge_host_bytes(n2, m2, rows_b, build_b), budget(dev)
    if have is not None and need > have:
        raise CapacityError(f"merging {n2} symbols into an index of {n1} in host memory needs ~{need} B of {dev} "
                            f"(B1's {layout} rows {rows_b} B, a batch's ~34 B a symbol), which has {have} B")
    idx = RunBlockIndex.from_np(host, dev) if layout == "rb" else OccIndex.from_bwt(np.asarray(bwt1), dev)
    lap("rows")
    seq2_d = seq2.to(dev) if torch.is_tensor(seq2) else torch.from_numpy(seq2_h).to(dev)
    acc2, rec = lf2_packed(seq2_d)
    del seq2_d
    ins = merge_rank_cuda(idx, rec, int(acc2[1]))
    lap("lf2 and K6")
    desc = (f"{idx.layout} rows (" + (f"S {idx.S}, {idx.n_esc} escape blocks, " if layout == "rb" else "")
            + f"{idx.nbytes} B on {dev})")
    del rec, idx
    ins = ins.cpu().numpy()
    lap("ins download")
    merged = apply_host(bwt1, seq2_h, ins)
    lap("native apply")
    log.info("merge in host memory over B1's %s: ~%d B of the card's %s B; seconds by piece: %s", desc, need,
             "unlimited" if have is None else have, ", ".join(f"{k} {v:.3f}" for k, v in sec.items()), func="merge")
    if pieces is not None:
        pieces.update(sec, layout=desc, card_bytes=need)
    return merged


def merge_host_mesh(bwt1: np.ndarray, seq2, mesh, pieces: dict | None = None) -> np.ndarray:
    """Merge the plain partial BWT seq2 (B2: a uint8 tensor or a numpy
    array) into B1, whose BWT bwt1 lies in host memory, with the merge rank
    over `mesh`; returns the merged BWT in host memory.  After a check of
    `merge_mesh_host_bytes` against each device's budget (a CapacityError
    naming the device and the bytes; every process of a torchrun job stops
    with it), the counts of B1's symbols are taken on the host
    (HostBwtRows), B1's dense rows are built slab by slab on the cards of
    the mesh's idx axis (ShardedRows: this process's slabs, the others'
    mapped from their owners), lf2_packed runs on the first device and K6
    over the slabs (`merge_rank_mesh`), ins comes down, and the native
    interleave writes the merged BWT.  Logs the slabs, S, the card bytes
    and the seconds of each piece, and puts them in `pieces` when given."""
    from ..cli import CapacityError

    dev = mesh.devices[0]
    n1, n2 = len(bwt1), len(seq2)
    sec, t = {}, time.perf_counter()

    def lap(piece):
        nonlocal t
        for d in mesh.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        sec[piece], t = time.perf_counter() - t, time.perf_counter()

    seq2_h = seq2.cpu().numpy() if torch.is_tensor(seq2) else np.ascontiguousarray(seq2, np.uint8)
    m2 = int(np.count_nonzero(seq2_h == 0))
    need = merge_mesh_host_bytes(n1, n2, m2, mesh)
    have, over = over_budget(need)
    err = (f"merging {n2} symbols into an index of {n1} in host memory over the {mesh.dp}x{mesh.idx} mesh needs "
           f"~{need[over[0]]} B of {over[0]} (its slabs of B1's dense rows, a batch's ~34 B a symbol), which has "
           f"{have[over[0]]} B") if over else None
    errs = [e for e in launch.all_gather(err) if e]
    if errs:
        raise CapacityError(errs[0])
    rows = HostBwtRows(np.asarray(bwt1))
    lap("counts on the host")
    sharded = ShardedRows(rows, mesh)
    lap("rows by slab")
    seq2_d = seq2.to(dev) if torch.is_tensor(seq2) else torch.from_numpy(seq2_h).to(dev)
    acc2, rec = lf2_packed(seq2_d)
    del seq2_d
    ins = merge_rank_mesh(sharded.views, rec, int(acc2[1]))[0]
    lap("lf2 and K6")
    desc = sharded.describe()
    del rec, sharded
    ins = ins.cpu().numpy()
    lap("ins download")
    merged = apply_host(bwt1, seq2_h, ins)
    lap("native apply")
    slabs = ", ".join(f"rows {b0}+{nb} on {d} {s:.3f} s" for b0, nb, d, s in rows.filled)
    cards = ", ".join(f"~{need[d]} B of {d}'s {'unlimited' if have[d] is None else have[d]} B" for d in need)
    log.info("merge in host memory over B1's %s; slabs built here: %s; %s; seconds by piece: %s", desc,
             slabs or "none", cards, ", ".join(f"{k} {v:.3f}" for k, v in sec.items()), func="merge")
    if pieces is not None:
        pieces.update(sec, layout=desc, card_bytes=need, slabs=rows.filled)
    return merged
