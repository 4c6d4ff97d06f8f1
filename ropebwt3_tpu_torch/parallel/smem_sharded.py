"""SMEM-TG over a mesh: every card of the mesh takes a share of each
batch's reads and runs the chunked engine (ops/smem.py `smem_tg`: the chunk
lanes, the heaviest-first queue, `stitch` and the reruns) against its dp
row's rows, mapped into one range (parallel/mesh.py ShardView).

Port of ropebwt3_tpu/parallel/smem_sharded.py.  There, reads are sharded
over `dp` and a psum over `idx` makes each rank whole inside the lock-step
loop; here the idx devices of a dp row take reads too, so no card of a dp
row sits idle, and a rank reads its row wherever it lies.  A share is a run
of whole reads, cut where the batch's symbols are split evenly
(`split_reads`), one a mesh slot; a card takes its slots' shares as one
contiguous share (mesh.by_card), so it runs one engine (one smem_tgc launch
and its reruns) however often the mesh names it.  A read's chunk lanes stay
on one card, and so does its stitch.  The shares' counts and rows are put
back in read order.  The cards' shares run at once (a thread a card).  On
the CPU (views whose device is the CPU) the same split runs `smem_tg_plain`
over `rank6_sharded_plain`.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..ops.smem import MAX_MEMS, smem_tg
from .mesh import by_card


def split_reads(seq_off: np.ndarray, parts: int) -> np.ndarray:
    """Cut points (parts + 1,) of the reads flat[seq_off[r]:seq_off[r+1]]:
    share j is reads [cuts[j], cuts[j+1]), ending at the first read
    boundary at or past (j + 1) / parts of the symbols.  Reads stay whole."""
    R = len(seq_off) - 1
    t = np.arange(1, parts, dtype=np.int64) * int(seq_off[-1]) // parts
    return np.concatenate([[0], np.searchsorted(seq_off, t, side="left").clip(0, R), [R]]).astype(np.int64)


class MeshOut(NamedTuple):
    counts: np.ndarray  # (R,) int64
    rows: np.ndarray  # (sum(counts), 5) in read order
    n_rerun: int
    n_unmerged: int
    n_whole: int


def smem_mesh(views: list, flat: np.ndarray, seq_off: np.ndarray, *, min_occ: int, min_len: int,
              max_mems: int = MAX_MEMS) -> MeshOut:
    """The MEMs of the reads flat[seq_off[r]:seq_off[r+1]] over the mesh's
    views (one a device of the mesh): each distinct card on its share
    (`split_reads` over the slots, `by_card`), through its first view."""
    shares = by_card([v.device for v in views], split_reads(seq_off, len(views)))

    def one(share):
        j, a, b = share
        v = views[j]
        o = seq_off[a : b + 1] - seq_off[a]
        f = flat[seq_off[a] : seq_off[b]]
        out = smem_tg(v, torch.from_numpy(np.ascontiguousarray(f, np.uint8)).to(v.device),
                      torch.from_numpy(np.ascontiguousarray(o, np.int64)).to(v.device),
                      min_occ=min_occ, min_len=min_len, max_mems=max_mems)
        return out.counts.cpu().numpy(), out.rows.cpu().numpy(), out.n_rerun, out.n_unmerged, out.n_whole

    if len(shares) == 1:
        parts = [one(shares[0])]
    else:
        with ThreadPoolExecutor(len(shares)) as ex:
            parts = list(ex.map(one, shares))
    return MeshOut(np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]),
                   *(sum(p[i] for p in parts) for i in (2, 3, 4)))
