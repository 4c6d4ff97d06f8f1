"""Sampled suffix array generation on a torch device.

Port of ropebwt3_tpu/ssa_ops.py `ssa_gen_device`.  Every sequence walks LF
from its sentinel row (lanes 0..m-1, m = acc[1]) to the sentinel that ends
it; at each step whose new row r is sampled, (r - m) & (2^ss - 1) == 0 with
a non-sentinel symbol, the slot (r - m) >> ss records the step and the lane.
The host then turns (ssa_l, ssa_lane, death_l, final_k) into the SSA, as
ssa_ops.py:200-207 does, and returns formats.ssa.SSA.

The walks run as segments (csrc/ssa_gen.cu says how): one from each
sentinel row and one from every S-th row past them, walked at once and
ranked along their walks by pointer jumping.  `ssa_gen_cuda` runs the three
passes of that kernel; `ssa_gen_seg_plain` is their lock-step PyTorch
version (the CPU path, and the reference on the card); `ssa_gen_plain`, all
m lanes in lock-step, is the body of ssa_ops.py:127-147 as the JAX package
defines it.  All take the dense occ rows of ops/rank.py `OccIndex` (dense32
or dense64) or, where those do not fit the card, the run-block rows of
ops/runblock.py `RunBlockIndex` (rb32 or rb64): the symbol at k comes from
the rows, so no BWT array goes to the device.

`ssa_gen_mesh` (`ssa --mesh`) splits the segments over the devices of a
mesh: pass 1 of each range on its device, the shares merged, passes 2 and
3 once (`walk_mesh`; the port of the mesh branch of ssa_gen_device).

`ssa_multi_batch` is the host side of `mem -p`: the native batched
multi-locate (native/locate.cpp), as ropebwt3_tpu/ssa_ops.py runs it.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from . import kernels, native
from .construct.merge import LANES_PER_SM, LOW, sm_count, stride
from .formats.ssa import SSA
from .index.dense import DenseFMIndex
from .ops.rank import OccIndex, lf
from .ops.runblock import RunBlockIndex
from .parallel import launch
from .parallel.mesh import replicate

MAX_SHIFT = 62  # positions are int64; a larger -s samples nothing past row m
SEG_ROWS = 3  # per segment: d, nxt, term (csrc/ssa_gen.cu)
ALLOC_ROUND, ALLOC_SPLIT = 512, 1 << 20  # PyTorch's caching allocator: its unit; a rest it does not split off
# Walks shorter than this many strides on average run as their heads alone:
# pass 1's longest segment is ~S ln(n_seg), 10-15 S at 10^4-10^6 segments,
# so cutting them saves little and pass 2 costs more (on the short reads'
# index, ~151 steps a walk at S = 128, the cut walk lost to the heads, PERF.md)
MIN_WALK_STRIDES = 16


def sid_bits(m: int) -> int:
    """ms: the least value >= 1 with 2^ms >= m (ssa_ops.py:115-118)."""
    ms = 1
    while (1 << ms) < m:
        ms += 1
    return ms


def n_slots(idx: OccIndex | RunBlockIndex, m: int, ssa_shift: int) -> int:
    return (int(idx.acc[6]) - m + (1 << ssa_shift) - 1) >> ssa_shift


def heads_only(n: int) -> int:
    """A stride above n: the walk's segments are the m heads alone."""
    return 1 << n.bit_length()


def walk_stride(n: int, m: int, device) -> int:
    """The segment stride S of a walk of n rows with m heads on `device`:
    construct/merge.py's `stride` rule on the n - m rows past the heads, or
    heads only when the m heads alone give every SM LANES_PER_SM lanes or
    the mean walk is shorter than MIN_WALK_STRIDES strides."""
    S = stride(n - m, device)
    if m >= sm_count(device) * LANES_PER_SM or n - m < MIN_WALK_STRIDES * S * m:
        return heads_only(n)
    return S


def jump_rounds(n_seg: int, m: int) -> int:
    """Pass 2's rounds: a walk's chain is its head and at most n_seg - m
    strided segments, so after bit_length(n_seg - m) rounds every head
    points past its last; none with the heads alone."""
    return (n_seg - m).bit_length()


def segments(n: int, m: int, S: int) -> int:
    """n_seg: the m heads (segments 0..m-1, at the sentinel rows), then one
    segment from each row m + j S below n (segment m + j), none when
    S > n - m.  No sentinel, no walk: m == 0 gives none."""
    if not isinstance(S, int) or S < 1:
        raise ValueError(f"the segment stride must be a positive int, not {S!r}")
    if not m:
        return 0
    return m + (-(-(n - m) // S) if S <= n - m else 0)


def check_walk(idx: OccIndex | RunBlockIndex, m: int, ssa_shift: int, S: int | None = None,
               kernel: bool = False) -> None:
    """The bounds a walk relies on (ROADMAP F2): dense or rb rows; every
    symbol an nt6 code (acc[6] = n: the rows count symbols 0..5 only); lanes
    0..m-1 that are the sentinel rows, m = acc[1], with lane ids in int32; a
    shift in [0, MAX_SHIFT].  Steps fit the index's width: a lane walks at
    most n steps, and dense32 and rb32 hold n < 2^31.  With a stride S:
    segment ids in int32, and for the kernel S a power of two (a mask in
    each step) of at most 2^62."""
    if not isinstance(idx, (OccIndex, RunBlockIndex)):
        raise TypeError(f"SSA generation takes occ rows (OccIndex, RunBlockIndex), not {type(idx).__name__}")
    acc = idx.acc.tolist()
    if acc[6] != idx.n or any(a > b for a, b in zip(acc, acc[1:])):
        raise ValueError(f"acc {acc} does not count n = {idx.n} nt6 symbols")
    if m != acc[1] or m >= 1 << 31:
        raise ValueError(f"m = {m} must be acc[1] = {acc[1]} and below 2^31")
    if not 0 <= ssa_shift <= MAX_SHIFT:
        raise ValueError(f"sample shift {ssa_shift} outside [0, {MAX_SHIFT}]")
    if S is not None:
        check_segments(idx.n, m, S, kernel)


def check_segments(n: int, m: int, S: int, kernel: bool) -> None:
    n_seg = segments(n, m, S)
    if n_seg >= 1 << 31:
        raise ValueError(f"{n_seg} segments at stride {S}: segment ids must fit int32")
    if kernel and (S & (S - 1) or S > 1 << MAX_SHIFT):
        raise ValueError(f"the kernel takes a power-of-two stride of at most 2^{MAX_SHIFT}, not {S}")


def ssa_bytes(n: int, m: int, ssa_shift: int, S: int, mega_shift: int | None = None,
              rb: RunBlockIndex | None = None) -> int:
    """Card bytes of a walk at its peak: the index's rows (48 B a 64
    symbols, the padded last block and the extra row; int64 rows
    (`mega_shift` given) add a 48-B base a megablock of 2^mega_shift rows;
    or the arrays of `rb`, its rows, escape sub-rows and megablock bases:
    `RunBlockIndex.nbytes`, acc apart), acc, the slot arrays, death_l,
    final_k and lane_of, and the segment
    records: three int64 a segment, double-buffered (48 B; 0.375 B a symbol
    at S = 128).  Each array as PyTorch's caching allocator counts it:
    rounded up to 512 B, and one of 1 MiB or more may hold a rest of up to
    1 MiB that the allocator does not split off."""
    w = 8 if (rb.int64 if rb is not None else mega_shift is not None) else 4
    nb = n // 64 + 2
    n_ssa = (n - m + (1 << ssa_shift) - 1) >> ssa_shift
    arrays = [7 * w, w * n_ssa, 4 * n_ssa, w * m, w * m, 4 * m, 2 * SEG_ROWS * 8 * segments(n, m, S)]
    if rb is not None:
        arrays += [t.numel() * t.element_size() for t in (rb.rows, rb.esc, rb.mega) if t is not None]
    else:
        arrays.append(48 * nb)
        if mega_shift is not None:
            arrays.append(48 * ((nb + (1 << mega_shift) - 1) >> mega_shift))
    return sum(-(-a // ALLOC_ROUND) * ALLOC_ROUND + (ALLOC_SPLIT if a >= ALLOC_SPLIT else 0) for a in arrays)


def ssa_gen_plain(idx: OccIndex | RunBlockIndex, m: int,
                  ssa_shift: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
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


def ssa_gen_seg_plain(idx, m: int, ssa_shift: int,
                      S: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's three passes at stride S (any positive int), each over
    all its segments in lock-step: the four arrays of `ssa_gen_plain` (int64
    and int32, slots no lane reaches -1 / 0), then the segment records
    (4, n_seg) int64: pass 1's length of each segment, then d, nxt and term
    after pass 2, the three rows the kernel leaves."""
    check_walk(idx, m, ssa_shift, S)
    ssa_l, ssa_lane, rec = ssa_walk_plain(idx, m, ssa_shift, S, 0, segments(idx.n, m, S))
    length = rec[0].clone()
    *out, rec = ssa_finish_plain(m, ssa_l, ssa_lane, rec)
    return *out, torch.cat([length[None], rec])


def ssa_walk_plain(idx: OccIndex | RunBlockIndex, m: int, ssa_shift: int, S: int, g0: int,
                   g1: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 over the segments [g0, g1), in lock-step: (ssa_l (n_ssa,)
    int64 with 0 and ssa_lane (n_ssa,) int32 with -1 where no segment of the
    range hit, the records (3, n_seg) int64, d, nxt and term in the range's
    columns and LOW in the others), as the kernel's pass 1 fills them."""
    dev = idx.device
    n_ssa, n_seg = n_slots(idx, m, ssa_shift), segments(idx.n, m, S)
    mask = (1 << ssa_shift) - 1
    # slot n_ssa is the dummy that non-hit segments scatter into
    ssa_l = torch.zeros(n_ssa + 1, dtype=torch.int64, device=dev)
    ssa_lane = torch.full((n_ssa + 1,), -1, dtype=torch.int32, device=dev)
    rec = torch.full((SEG_ROWS, n_seg), LOW, dtype=torch.int64, device=dev)
    rec[1:, g0:g1] = -1
    # a strided start row that is sampled takes step 0; each segment walks
    # to a `$` step or to the next start row
    g = torch.arange(g0, g1, dtype=torch.int64, device=dev)
    r0 = (g - m) * S
    hit = (g >= m) & ((r0 & mask) == 0)
    ssa_lane[r0[hit] >> ssa_shift] = g[hit].int()
    k = torch.where(g < m, g, m + r0)
    t = 0
    while g.numel():
        c, nk = lf(idx, k)
        t += 1
        r = nk - m
        end = c == 0
        at_start = ~end & (r % S == 0) & (n_seg > m)
        hit = ~end & ~at_start & ((r & mask) == 0)
        x = torch.where(hit, r >> ssa_shift, n_ssa)
        ssa_l[x] = t
        ssa_lane[x] = g.int()
        done = end | at_start
        if not bool(done.any()):
            k = nk
            continue
        rec[0, g[done]] = t
        rec[2, g[end]] = nk[end]
        rec[1, g[at_start]] = m + r[at_start] // S
        g, k = g[~done], nk[~done]
    return ssa_l[:n_ssa], ssa_lane[:n_ssa], rec


def ssa_finish_plain(m: int, ssa_l: torch.Tensor, ssa_lane: torch.Tensor,
                     rec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Passes 2 and 3 over every segment's pass 1 (the slots and records
    `ssa_walk_plain` gives, or the shares of a mesh merged): the four arrays
    of `ssa_gen_plain` and the records (3, n_seg) after pointer jumping.
    ssa_l and ssa_lane are rewritten in place."""
    dev = rec.device
    d, nxt, term = rec.clone()
    n_seg = d.numel()
    seg_ids = torch.arange(n_seg, dtype=torch.int64, device=dev)
    # pass 2: pointer jumping
    for _ in range(jump_rounds(n_seg, m)):
        go = nxt >= 0
        j = torch.where(go, nxt, seg_ids)
        d, nxt, term = torch.where(go, d + d[j], d), nxt[j], term[j]
    # pass 3: lanes, then slots; a slot of a segment no lane reaches is cleared
    death_l, final_k = d[:m].clone(), term[:m].clone()
    lane_of = torch.empty(m, dtype=torch.int64, device=dev)
    lane_of[final_k] = torch.arange(m, dtype=torch.int64, device=dev)
    f = torch.nonzero(ssa_lane >= 0)[:, 0]
    gs = ssa_lane[f].long()
    reached = nxt[gs] < 0
    lane = lane_of[term[gs].clamp(min=0)]
    ssa_l[f] = torch.where(reached, death_l[lane] - (d[gs] - ssa_l[f]), 0)
    ssa_lane[f] = torch.where(reached, lane, -1).int()
    return ssa_l, ssa_lane, death_l, final_k, torch.stack([d, nxt, term])


def ssa_gen_cuda(idx: OccIndex | RunBlockIndex, m: int, ssa_shift: int,
                 S: int | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The walk through the ssa_gen kernel of the index's layout: the same
    four tensors as `ssa_gen_plain`, ssa_l, death_l and final_k in the
    index's width.  S, the segment stride, is derived from n, m and the card
    (`walk_stride`); the tests pass small ones (any positive int on the CPU,
    a power of two on the card).  A CPU index takes the plain version; on
    the card the walk's `ssa_bytes` must fit the card's budget
    (cli.CapacityError before any launch)."""
    S = walk_stride(idx.n, m, idx.device) if S is None else S
    check_walk(idx, m, ssa_shift, S, kernel=idx.device.type != "cpu")
    if idx.device.type == "cpu":
        return ssa_gen_seg_plain(idx, m, ssa_shift, S)[:4]
    from .cli import CapacityError, card_bytes

    budget = card_bytes(idx.device)
    rb = idx if isinstance(idx, RunBlockIndex) else None
    need = ssa_bytes(idx.n, m, ssa_shift, S, idx.mega_shift if idx.int64 else None, rb=rb)
    if budget is not None and need > budget:
        raise CapacityError(f"ssa: the walk on {idx.layout} rows at stride {S} needs ~{need} B of the card, which "
                            f"has {budget} B")
    return launch_walk(idx, m, ssa_shift, S)[:4]


def launch_walk(idx: OccIndex | RunBlockIndex, m: int, ssa_shift: int, S: int,
                marks: list | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`ssa_gen_cuda` on a CUDA index that `check_walk` has passed at the
    stride S: the four arrays and the segment records (3, n_seg) int64, d,
    nxt and term after pass 2 (rows 1-3 of `ssa_gen_seg_plain`'s).  Counts
    one launch a walk.  `marks`, four CUDA events, are recorded before pass
    1 and after each pass.  Timing loops call this, as the check reads acc
    back to the host."""
    n_ssa, n_seg = n_slots(idx, m, ssa_shift), segments(idx.n, m, S)
    ssa_l = torch.zeros(n_ssa, dtype=idx.dtype, device=idx.device)
    ssa_lane = torch.full((n_ssa,), -1, dtype=torch.int32, device=idx.device)
    seg = torch.empty((2, SEG_ROWS, n_seg), dtype=torch.int64, device=idx.device)
    marks = marks or [None] * 4
    if n_seg:
        if marks[0] is not None:
            marks[0].record()
        launch_walk_range(idx, m, ssa_shift, S, 0, n_seg, ssa_l, ssa_lane, seg[0])
        ssa_gen_cuda.launches[idx.layout] += 1
    return launch_finish(idx.layout, m, ssa_l, ssa_lane, seg, marks[1:])


def launch_walk_range(idx: OccIndex | RunBlockIndex, m: int, ssa_shift: int, S: int, g0: int, g1: int, ssa_l: torch.Tensor,
                      ssa_lane: torch.Tensor, rec: torch.Tensor) -> None:
    """Pass 1 (rb3c_ssa_walk_<layout>) over the segments [g0, g1) at the
    power-of-two stride S into ssa_l (n_ssa,) in the index's width,
    ssa_lane (n_ssa,) int32 and the records rec (3, n_seg) int64, all
    contiguous on the index's device; uncounted (the callers count)."""
    kernels.launch(f"rb3c_ssa_walk_{idx.layout}", idx.device, *idx.kernel_tables(), m, ssa_shift, S.bit_length() - 1,
                   rec.shape[1], g0, g1, ssa_l.data_ptr(), ssa_lane.data_ptr(), rec.data_ptr())


def launch_finish(layout: str, m: int, ssa_l: torch.Tensor, ssa_lane: torch.Tensor, seg: torch.Tensor,
                  marks: list | None = None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Passes 2 (rb3c_ssa_jump) and 3 (rb3c_ssa_finish_<layout>) over every
    segment's pass 1, whose records lie in seg[0] of seg (2, 3, n_seg) int64
    (seg[1] is scratch), on their device: the four arrays (ssa_l and
    ssa_lane rewritten in place) and the records after pass 2.  `marks`,
    three CUDA events or None, are recorded before pass 2 and after each."""
    dev, dt, n_seg = seg.device, ssa_l.dtype, seg.shape[2]
    death_l = torch.zeros(m, dtype=dt, device=dev)
    final_k = torch.zeros(m, dtype=dt, device=dev)
    rounds = jump_rounds(n_seg, m)
    if n_seg:
        lane_of = torch.empty(m, dtype=torch.int32, device=dev)
        passes = (("rb3c_ssa_jump", seg.data_ptr(), n_seg, rounds),
                  (f"rb3c_ssa_finish_{layout}", seg[rounds % 2].data_ptr(), n_seg, m, ssa_l.numel(), ssa_l.data_ptr(),
                   ssa_lane.data_ptr(), death_l.data_ptr(), final_k.data_ptr(), lane_of.data_ptr()))
        marks = marks or [None] * 3
        for ev, (name, *args) in zip(marks, passes):
            if ev is not None:
                ev.record()
            kernels.launch(name, dev, *args)
        if marks[2] is not None:
            marks[2].record()
    return ssa_l, ssa_lane, death_l, final_k, seg[rounds % 2]


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


def ssa_gen(f: DenseFMIndex, ssa_shift: int = 8, device="cuda", occ: OccIndex | RunBlockIndex | None = None) -> SSA:
    """The SSA of `f`, byte-equal to ropebwt3_tpu.ssa_ops.ssa_gen_native.
    `occ` is f's dense or rb rows already on the device (default: dense
    rows built on `device`, int64 from n >= 2^31 - 2^20 on); on a CUDA
    device the walk runs the kernel, on the CPU the plain version."""
    idx = OccIndex.from_dense(f, device) if occ is None else occ
    m = int(f.acc[1])
    return assemble(m, ssa_shift, *ssa_gen_cuda(idx, m, ssa_shift))


def ssa_gen_mesh(f: DenseFMIndex, ssa_shift: int, mesh, S: int | None = None) -> SSA:
    """The SSA of `f` over `mesh` (parallel/mesh.py Mesh), byte-equal to
    `ssa_gen`'s: the dense rows once on each distinct device of the mesh
    (no idx split: the JAX package's mesh branch replicates its tables), the
    walk's segments split over every device of the mesh (`walk_mesh`).  S is
    the whole index's stride (`walk_stride` on the mesh's first device), not
    a device's share's: the output is the same either way, the segments and
    so each device's chains are not."""
    dev = mesh.devices[0]
    reps = replicate(OccIndex.from_dense(f, dev), mesh.devices)
    m = int(f.acc[1])
    S = walk_stride(f.n, m, dev) if S is None else S
    check_walk(reps[0], m, ssa_shift, S, kernel=dev.type != "cpu")
    return assemble(m, ssa_shift, *walk_mesh(reps, m, ssa_shift, S)[:4])


ssa_gen_mesh.launches = Counter()


def walk_mesh(reps: list, m: int, ssa_shift: int,
              S: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The walk over a mesh, the port of the mesh branch of
    ropebwt3_tpu/ssa_ops.py ssa_gen_device (:163-199, lanes over `dp`, the
    slots merged by a pmax): reps[j] is the dense rows on the mesh's j-th
    device (`replicate`), and each distinct card takes one contiguous range
    of the segments, as long as its mesh slots' share (this process's share
    under torchrun, launch.card_ranges).  Pass 1 runs on each card over its
    range into its own slots and records; every slot and record has one
    writer globally, so the shares merge by a max (launch.merge_shares:
    ssa_lane -1, ssa_l 0 and the records LOW where unwritten; slot n_ssa,
    the plain version's dummy, is never merged) onto the first device, where
    passes 2 and 3 run once over every segment (F7: a segment on a
    `$`-free cycle clears its slots there, whichever card wrote them).  On
    CUDA each card's range is one launch of rb3c_ssa_walk_<layout>, counted
    in `ssa_gen_mesh.launches`; on the CPU the plain passes run.  Returns
    the four arrays and the records (3, n_seg) after pass 2, as
    `launch_walk`."""
    home = reps[0]
    n_ssa, n_seg = n_slots(home, m, ssa_shift), segments(home.n, m, S)
    plain = home.device.type == "cpu"
    seg = None if plain else torch.empty((2, SEG_ROWS, n_seg), dtype=torch.int64, device=home.device)
    shares = []
    for i, (j, g0, g1) in enumerate(launch.card_ranges(n_seg, [x.device for x in reps])):
        x = reps[j]
        if plain:
            shares.append(ssa_walk_plain(x, m, ssa_shift, S, g0, g1))
            continue
        rec = seg[0] if i == 0 else torch.empty((SEG_ROWS, n_seg), dtype=torch.int64, device=x.device)
        share = (torch.zeros(n_ssa, dtype=x.dtype, device=x.device),
                 torch.full((n_ssa,), -1, dtype=torch.int32, device=x.device), rec.fill_(LOW))
        if g1 > g0:
            launch_walk_range(x, m, ssa_shift, S, g0, g1, *share)
            kernels.count(ssa_gen_mesh.launches, x.layout)
        shares.append(share)
    ssa_l, ssa_lane, rec = (launch.merge_shares([sh[i] for sh in shares]) for i in range(3))
    if plain:
        return ssa_finish_plain(m, ssa_l, ssa_lane, rec)
    return launch_finish(home.layout, m, ssa_l, ssa_lane, seg)


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
