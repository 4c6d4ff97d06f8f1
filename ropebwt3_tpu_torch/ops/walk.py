"""`get`'s LF walk and `suffix`'s backward search on the device's occ rows.

The JAX package runs both on the host: `get` through DenseFMIndex.retrieve
(ropebwt3_tpu/index/dense.py:244-278, its native rb3t_retrieve walk), and
`suffix` through main_suffix's lock-step `flush` (ropebwt3_tpu/cli.py:799-829,
one rank1a_fast of every active read's k and l a step).  Here each has a
plain PyTorch version, the reference and the CPU path, and a CUDA wrapper
around its kernel in csrc/walk.cu: K11 `retrieve_seg` and K12 `suffix_walk`,
each in every layout (dense rows, or rb rows where dense ones do not fit
the card).  The segment stride S of a retrieve walk is not an rb row's
block size (`RunBlockIndex.S`).  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.

A retrieve walk runs as segments (csrc/walk.cu says how): one from each
queried k (the heads) and one from every S-th row past the sentinel rows,
walked at once, ranked along their walks by pointer jumping (ssa_gen.cu's
rb3c_ssa_jump), then walked again to write each head's symbols, forward,
into one buffer per end row.  A head on an LF cycle with no `$` gives n
symbols and ends at LF^n(k), as the reference's max_len = n does.
`retrieve_cuda` runs the kernel's passes; `retrieve_seg_plain` is their
lock-step PyTorch version (the CPU path and the reference on the card);
`retrieve_plain` is its heads-only case.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import kernels
from ..construct.merge import LANES_PER_SM, sm_count, stride
from ..ssa_ops import MAX_SHIFT, MIN_WALK_STRIDES, SEG_ROWS, heads_only, jump_rounds
from .rank import lf


def segments(n: int, m: int, q: int, S: int) -> int:
    """n_seg: the q heads (segments 0..q-1), then one segment from each row
    m + j S below n (segment q + j), none when S > n - m."""
    if not isinstance(S, int) or S < 1:
        raise ValueError(f"the segment stride must be a positive int, not {S!r}")
    return q + (-(-(n - m) // S) if S <= n - m else 0)


def walk_stride(n: int, m: int, q: int, device) -> int:
    """The segment stride of a `get` of q heads on an index of n rows with m
    sentinels: construct/merge.py's `stride` rule on the n - m rows past
    the sentinels, or heads only when the q heads alone give every SM
    LANES_PER_SM lanes or the mean sequence, (n - m) / m, is shorter than
    MIN_WALK_STRIDES strides (ssa_ops.walk_stride's rule, with q heads).
    The walks' lengths are unknown before the walk, so the rule cannot see
    a short request: a `get` of one short sequence of a large index still
    walks every row in pass 1 (and pass 3 only the segments it writes),
    ~3 ms at 64 M rows on an H100 (K5's pass 1) and ~100x that at 6.2 G,
    where the heads alone would take its length x ~0.5 us."""
    S = stride(n - m, device)
    if q >= sm_count(device) * LANES_PER_SM or n - m < MIN_WALK_STRIDES * S * max(m, 1):
        return heads_only(n)
    return S


def check_retrieve(idx, ks, S: int, kernel: bool) -> tuple[torch.Tensor, int]:
    """The bounds the walk relies on (ROADMAP F2), before any launch: occ
    rows of a kernel layout (kernels.LAYOUTS) whose acc counts n nt6
    symbols; ks a 1-D list of positions in [0, n); a positive stride, for
    the kernel a power of two of at most 2^MAX_SHIFT; segment ids below
    2^31.  Returns (ks as an int64 tensor
    on the index's device, m = acc[1])."""
    if getattr(idx, "layout", None) not in kernels.LAYOUTS:
        raise ValueError(f"the retrieve walk runs on {kernels.LAYOUTS} rows, not "
                         f"{getattr(idx, 'layout', type(idx).__name__)}")
    acc = idx.acc.tolist()
    if acc[6] != idx.n or any(a > b for a, b in zip(acc, acc[1:])):
        raise ValueError(f"acc {acc} does not count n = {idx.n} nt6 symbols")
    k = np.asarray(ks)
    if k.ndim != 1 or (k.size and k.dtype.kind not in "iu"):
        raise ValueError("retrieve takes a 1-D list of integer positions")
    k = k.astype(np.int64)
    if k.size and (int(k.min()) < 0 or int(k.max()) >= idx.n):
        raise ValueError(f"retrieve position outside [0, {idx.n})")
    m = acc[1]
    n_seg = segments(idx.n, m, len(k), S)
    if n_seg >= 1 << 31:
        raise ValueError(f"{n_seg} segments at stride {S}: segment ids must stay below 2^31")
    if kernel and (S & (S - 1) or S > 1 << MAX_SHIFT):
        raise ValueError(f"the kernel takes a power-of-two stride of at most 2^{MAX_SHIFT}, not {S}")
    return torch.from_numpy(k).to(idx.device), m


def _layout(d: torch.Tensor, nxt: torch.Tensor, term: torch.Tensor, n: int):
    """The output buffer from the heads' records after pass 2 (CPU int64):
    (terms (u,) the distinct end rows of the heads that reach a `$`,
    ascending; lmax (u,) each one's longest head; base (u,) its offset;
    cyc (n_cyc,) the heads on a `$`-free cycle, each given n bytes after
    the rest; the buffer's bytes)."""
    fin = nxt < 0
    terms, inv = torch.unique(term[fin], return_inverse=True)
    lmax = torch.zeros(terms.numel(), dtype=torch.int64).scatter_reduce_(0, inv, d[fin], "amax")
    base = torch.cumsum(lmax, 0) - lmax
    cyc = torch.nonzero(~fin)[:, 0]
    return terms, lmax, base, cyc, int(lmax.sum()) + cyc.numel() * n


def _slice(out: np.ndarray, d, nxt, term, terms, base, cyc_end, n: int) -> tuple[list[np.ndarray], np.ndarray]:
    """Each head's symbols (views of the downloaded buffer `out`) and end
    row, from the heads' records and `_layout`'s terms and base; cyc_end
    (n_cyc,) the cycle heads' end rows."""
    d, nxt, term, terms, base, cyc_end = (x.numpy() for x in (d, nxt, term, terms, base, cyc_end))
    j = np.searchsorted(terms, term)
    cyc0 = len(out) - len(cyc_end) * n
    seqs, ends, ci = [], term.copy(), 0
    for i in range(len(d)):
        if nxt[i] < 0:
            seqs.append(out[base[j[i]] : base[j[i]] + d[i]])
        else:
            seqs.append(out[cyc0 + ci * n : cyc0 + (ci + 1) * n])
            ends[i] = cyc_end[ci]
            ci += 1
    return seqs, ends


def retrieve_seg_plain(idx, ks, S: int) -> tuple[list[np.ndarray], np.ndarray, torch.Tensor]:
    """The kernel's passes at stride S (any positive int), each over all its
    segments in lock-step with ops/rank.py `lf`: (each k's symbols, forward,
    as uint8 arrays; its end row; the segment records (4, n_seg) int64:
    pass 1's length of each segment, then d, nxt and term after pass 2)."""
    k0, m = check_retrieve(idx, ks, S, kernel=False)
    dev, n, q = idx.device, idx.n, k0.numel()
    n_seg = segments(n, m, q, S)
    g = torch.arange(n_seg, dtype=torch.int64, device=dev)
    start = torch.cat([k0, m + (g[q:] - q) * S])
    d, nxt, term = torch.zeros_like(g), torch.full_like(g, -1), torch.full_like(g, -1)

    # pass 1: to a `$`, a strided start row, or (a head) back to its start
    ids, k, t = g, start, 0
    while ids.numel():
        c, nk = lf(idx, k)
        end = c == 0
        r = nk - m
        at_start = ~end & (r % S == 0) & (n_seg > q)
        back = ~end & ~at_start & (nk == start[ids])
        done = end | at_start | back
        d[ids[end]] = t
        d[ids[at_start | back]] = t + 1
        term[ids[end]] = k[end]
        nxt[ids[at_start]] = q + r[at_start] // S
        nxt[ids[back]] = ids[back]
        ids, k, t = ids[~done], nk[~done], t + 1
    length = d.clone()

    # pass 2: pointer jumping
    for _ in range(jump_rounds(n_seg, q)):
        go = nxt >= 0
        j = torch.where(go, nxt, g)
        d, nxt, term = torch.where(go, d + d[j], d), nxt[j], term[j]

    head = [x[:q].cpu() for x in (d, nxt, term)]
    terms, lmax, base, cyc, size = _layout(*head, n)
    out = torch.zeros(size, dtype=torch.uint8, device=dev)

    # pass 3: every segment that ends at a head's end row and reaches below
    # its longest head walks again, writing symbol t at d - 1 - t
    if terms.numel():
        terms_d, lmax_d, base_d = (x.to(dev) for x in (terms, lmax, base))
        j = torch.searchsorted(terms_d, term).clamp(max=terms.numel() - 1)
        cap = lmax_d[j]
        hit = (nxt < 0) & (terms_d[j] == term) & (d - length < cap) & (length > 0)
        ids = torch.nonzero(hit)[:, 0]
        k, t = start[ids], 0
        while ids.numel():
            c, nk = lf(idx, k)
            pos = d[ids] - 1 - t
            w = pos < cap[ids]
            out[(base_d[j[ids]] + pos)[w]] = c[w].to(torch.uint8)
            t += 1
            go = length[ids] > t
            ids, k = ids[go], nk[go]

    # pass 4: a cycle head's lap into the last P bytes of its n, its end row
    # n mod P steps on, then the lap tiled over the rest
    n_cyc = cyc.numel()
    period = torch.zeros(n_cyc, dtype=torch.int64, device=dev)
    cyc_end = k0[cyc.to(dev)]
    if n_cyc:
        co = out[size - n_cyc * n:].view(n_cyc, n)
        live, k, t = torch.arange(n_cyc, device=dev), cyc_end.clone(), 0
        while live.numel():
            c, nk = lf(idx, k)
            co[live, n - 1 - t] = c.to(torch.uint8)
            t += 1
            back = nk == cyc_end[live]
            period[live[back]] = t
            live, k = live[~back], nk[~back]
        rem = n % period
        live = torch.nonzero(rem > 0)[:, 0]
        k, t = cyc_end[live], 0
        while live.numel():
            _, k = lf(idx, k)
            t += 1
            go = rem[live] > t
            cyc_end[live[~go]] = k[~go]
            live, k = live[go], k[go]
        x = torch.arange(n, device=dev)
        for i in range(n_cyc):
            co[i] = co[i][n - 1 - (n - 1 - x) % period[i]]
    seqs, ends = _slice(out.cpu().numpy(), *head, terms, base, cyc_end.cpu(), n)
    return seqs, ends, torch.stack([length, d, nxt, term])


def retrieve_plain(idx, ks) -> tuple[list[np.ndarray], np.ndarray]:
    """DenseFMIndex.retrieve of each k of `ks` on `idx`: retrieve_seg_plain
    with the heads alone, one lock-step lane a k (each walk's symbols,
    forward; the row it ends at)."""
    return retrieve_seg_plain(idx, ks, heads_only(idx.n))[:2]


def retrieve_cuda(idx, ks, S: int | None = None) -> tuple[list[np.ndarray], np.ndarray]:
    """retrieve_seg_plain through the retrieve_seg kernel of the index's
    layout: each k's symbols and end row.  S, the segment stride, is
    derived from n, m, the number of ks and the card (`walk_stride`); the
    tests pass small ones (any positive int on the CPU, a power of two on
    the card).  A CPU index takes the plain version."""
    if S is None:
        S = walk_stride(idx.n, int(idx.acc[1]), len(ks), idx.device)
    k, m = check_retrieve(idx, ks, S, kernel=idx.device.type != "cpu")
    if idx.device.type == "cpu":
        return retrieve_seg_plain(idx, ks, S)[:2]
    return launch_retrieve(idx, k, m, S)[:2]


retrieve_cuda.launches = Counter()


def _fits(dev, need: int, what: str) -> None:
    """Raise cli.CapacityError unless `need` bytes fit the card's budget
    (none off the card)."""
    from ..cli import CapacityError, card_bytes

    budget = card_bytes(dev)
    if budget is not None and need > budget:
        raise CapacityError(f"get: {what} need ~{need} B of the card, which has {budget} B")


def launch_retrieve(idx, k: torch.Tensor, m: int, S: int,
                    marks: list | None = None) -> tuple[list[np.ndarray], np.ndarray, torch.Tensor]:
    """`retrieve_cuda` on a CUDA index that `check_retrieve` has passed (k
    its ks on the card, m = acc[1]) at the stride S: each k's symbols, its
    end row, and the segment records (4, n_seg) int64 as retrieve_seg_plain
    gives them.  Counts one launch a walk.  The records, then the symbol
    buffer, are checked against the card's memory before they are
    allocated.  `marks`, six CUDA events, are recorded before pass 1, after
    passes 1 and 2, then (after the host reads the heads' records) before
    pass 3 and after passes 3 and 4."""
    dev, n, q = idx.device, idx.n, k.numel()
    n_seg = segments(n, m, q, S)
    rounds = jump_rounds(n_seg, q)
    _fits(dev, (2 * SEG_ROWS + 1) * 8 * n_seg, f"the segment records of {n_seg} segments at stride {S}")
    seg = torch.empty((2, SEG_ROWS, n_seg), dtype=torch.int64, device=dev)
    length = torch.empty(n_seg, dtype=torch.int64, device=dev)
    shift = S.bit_length() - 1
    marks = marks or [None] * 6

    def mark(i: int) -> None:
        if marks[i] is not None:
            marks[i].record()

    mark(0)
    if n_seg:
        kernels.launch(f"rb3c_retrieve_seg_walk_{idx.layout}", dev, *idx.kernel_tables(), k.data_ptr(), q, m, shift,
                       n_seg, seg.data_ptr(), length.data_ptr())
    mark(1)
    if rounds:
        kernels.launch("rb3c_ssa_jump", dev, seg.data_ptr(), n_seg, rounds)
    mark(2)
    rec = seg[rounds % 2]
    head = list(rec[:, :q].cpu())
    terms, lmax, base, cyc, size = _layout(*head, n)
    n_cyc = cyc.numel()
    _fits(dev, size + 8 * (3 * terms.numel() + 3 * n_cyc), f"the symbols of {q} walks ({n_cyc} on `$`-free cycles)")
    out = torch.empty(size, dtype=torch.uint8, device=dev)
    tab = torch.cat([terms, lmax, base, cyc]).to(dev)
    u = terms.numel()
    period, cyc_end = torch.empty((2, n_cyc), dtype=torch.int64, device=dev)
    mark(3)
    if u:
        kernels.launch(f"rb3c_retrieve_seg_write_{idx.layout}", dev, *idx.kernel_tables(), k.data_ptr(), q, m, shift,
                       n_seg, rec.data_ptr(), length.data_ptr(), tab.data_ptr(), tab[u:].data_ptr(),
                       tab[2 * u:].data_ptr(), u, out.data_ptr())
    mark(4)
    if n_cyc:
        kernels.launch(f"rb3c_retrieve_seg_cycle_{idx.layout}", dev, *idx.kernel_tables(), k.data_ptr(),
                       tab[3 * u:].data_ptr(), n_cyc, n, out[size - n_cyc * n:].data_ptr(), period.data_ptr(),
                       cyc_end.data_ptr())
    mark(5)
    retrieve_cuda.launches[idx.layout] += 1
    seqs, ends = _slice(out.cpu().numpy(), *head, terms, base, cyc_end.cpu(), n)
    return seqs, ends, torch.cat([length[None], rec])


def suffix_plain(idx, flat: torch.Tensor, off: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """main_suffix's backward search of each read flat[off[r]:off[r+1]]
    (nt6 codes), lock-step: from (k, l) = (0, n) and the read's last symbol
    down, k = acc[c] + occ_c(k), l = acc[c] + occ_c(l), until the interval
    is empty or the read is used up.  Returns (start, last) (R,) int64: i + 1
    where the walk stopped (0 for a read that matches whole or is empty)
    and the size of the last non-empty interval (0 if none)."""
    dev = flat.device
    R = off.numel() - 1
    off = off.long()
    acc = idx.acc.long()
    k = torch.zeros(R, dtype=torch.int64, device=dev)
    l = torch.full((R,), int(acc[6]), dtype=torch.int64, device=dev)
    i = off[1:] - off[:-1] - 1
    last = torch.zeros(R, dtype=torch.int64, device=dev)
    ids = (i >= 0).nonzero()[:, 0]
    while ids.numel():
        na = ids.numel()
        r = idx.rank1a(torch.cat([k[ids], l[ids]]))
        c = flat[off[ids] + i[ids]].long()
        nk = acc[c] + r[:na].gather(1, c[:, None])[:, 0]
        nl = acc[c] + r[na:].gather(1, c[:, None])[:, 0]
        alive = nl > nk
        ids, nk, nl = ids[alive], nk[alive], nl[alive]
        k[ids], l[ids], last[ids] = nk, nl, nl - nk
        i[ids] -= 1
        ids = ids[i[ids] >= 0]
    return i + 1, last


def suffix_cuda(idx, flat: torch.Tensor, off: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """suffix_plain through the suffix_walk kernel of the index's layout:
    flat (L,) uint8 nt6 codes 0..5, off (R + 1,) int64 from 0, non-
    decreasing, to at most L.  CPU tensors take the plain version."""
    if flat.dtype != torch.uint8 or flat.dim() != 1 or off.dtype != torch.int64 or off.dim() != 1 or off.numel() < 1:
        raise ValueError("suffix takes flat (L,) uint8 and off (R + 1,) int64")
    if flat.device != idx.device or off.device != idx.device:
        raise ValueError("suffix: flat and off must be on the index's device")
    if int(off[0]) != 0 or int(off[-1]) > flat.numel() or bool((off[1:] < off[:-1]).any()):
        raise ValueError("suffix: off must rise from 0 to at most len(flat)")
    if flat.numel() and int(flat.max()) > 5:
        raise ValueError("suffix: symbols must be nt6 codes 0..5")
    if flat.device.type == "cpu":
        return suffix_plain(idx, flat, off)
    R = off.numel() - 1
    start = torch.empty(R, dtype=torch.int64, device=flat.device)
    last = torch.empty(R, dtype=torch.int64, device=flat.device)
    if R:
        launch_suffix(idx, flat.contiguous(), off.contiguous(), start, last)
        suffix_cuda.launches[idx.layout] += 1
    return start, last


suffix_cuda.launches = Counter()


def launch_suffix(idx, flat, off, start, last) -> None:
    """One suffix_walk launch on checked, contiguous inputs, uncounted
    (timing)."""
    kernels.launch(f"rb3c_suffix_walk_{idx.layout}", flat.device, *idx.kernel_tables(), flat.data_ptr(), off.data_ptr(),
                   off.numel() - 1, start.data_ptr(), last.data_ptr())
