"""The multi-string BWT of a construction batch by prefix doubling, on a
torch device (K7).

A batch is a concatenation of nt6 sequences, each ended by a 0 separator
(the last symbol is one).  Suffixes are ordered as in the reference's batch
builder (sais-ss.c:50-56 over libsais_gsa): each separator is a distinct
symbol, ranked by its position and below every base, so the BWT is
B[j] = T[SA[j] - 1], wrapping at 0 to the final separator.  The same BWT as
ropebwt3_tpu/construct/sa.py `gsa_bwt` (native SA-IS) and sa_jax.py
`gsa_bwt_jax`, whose rounds this ports.

Initial ranks: a separator gets its index among the separators, a base s
gets m - 1 + s (m separators).  Round at offset k = 1, 2, 4, ...: sort the
suffixes by (rank[i], rank[i + k] + 1, or 0 past the end); the new rank of
sorted suffix j is the count of key changes up to j; stop once every rank is
distinct (the last new rank is n - 1).  Below PACKED_MAX symbols the pair is
one 64-bit key (rank << 32 | rank2) and a round is ONE torch.sort; above,
two stable sorts, by rank2 then by rank.  Ties within a round change no
rank, and the last round has none, so the sort need not be stable.

The passes around the library sort and scan are `sa_keys`, `sa_flags`,
`sa_scatter` and `sa_bwt`: each a kernel of csrc/sa_round.cu for a CUDA
tensor (`*_cuda`, counting its launches) and its plain PyTorch version for a
CPU tensor (`*_plain`).  `gsa_bwt` runs the kernels' wrappers,
`gsa_bwt_plain` the plain versions on any device.

Capacity: at a round's peak, inside torch.sort, the card holds rank, the
keys, the sorted keys and the permutation (8 B a symbol each) and the
sort's own index input and scratch.  A one-batch `build` of 64,000,032
symbols peaked at 65.24 B a symbol (NVIDIA H100 80GB HBM3, 700 W;
chip_smoke `[construct]`): SA_BYTES_PER_SYMBOL, the figure `build` sizes
its batches by.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import kernels

# n below this: the packed one-key round (ranks and rank + 1 fit 32 bits)
PACKED_MAX = (1 << 31) - 1
# card bytes a batch symbol needs at a round's peak (see the docstring)
SA_BYTES_PER_SYMBOL = 66


def initial_ranks(seq: torch.Tensor) -> torch.Tensor:
    """Separators rank by position among themselves, below every base:
    int64 ranks of a uint8 batch (sa_jax.py:40-48)."""
    s = seq.long()
    is_sep = s == 0
    sep_order = torch.cumsum(is_sep, 0) - 1
    m = sep_order[-1] + 1
    return torch.where(is_sep, sep_order, m - 1 + s)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def sa_keys_plain(rank: torch.Tensor, k: int, packed: bool) -> torch.Tensor:
    n = rank.numel()
    r2 = torch.zeros_like(rank)
    if k < n:
        r2[: n - k] = rank[k:] + 1
    return rank << 32 | r2 if packed else r2


def sa_flags_plain(a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    neq = torch.zeros_like(a)
    d = a[1:] != a[:-1]
    if b is not None:
        d |= b[1:] != b[:-1]
    neq[1:] = d
    return neq


def sa_scatter_plain(sa: torch.Tensor, nr: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    rank[sa] = nr
    return rank


def sa_bwt_plain(seq: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    return seq[torch.where(sa == 0, sa.numel() - 1, sa - 1)]


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/sa_round.cu); a CPU tensor takes the plain version
# ---------------------------------------------------------------------------


def _check(name: str, *ts: torch.Tensor) -> None:
    n = ts[0].numel()
    for t in ts:
        if t.dtype != torch.int64 or t.dim() != 1 or t.numel() != n or t.device != ts[0].device:
            raise ValueError(f"{name} takes 1-D int64 tensors of one length on one device")


def _launch(name: str, device, *args) -> None:
    kernels.launch(f"rb3c_{name}", device, *args)
    SA_LAUNCHES[name] += 1


# launches of each pass's kernel
SA_LAUNCHES: Counter = Counter()


def sa_keys_cuda(rank: torch.Tensor, k: int, packed: bool) -> torch.Tensor:
    """key[i] = rank[i] << 32 | r2[i] (packed) or r2[i], r2[i] = rank[i + k] + 1
    or 0 past the end; packed keys need ranks below 2^31 - 1."""
    _check("sa_keys", rank)
    if k < 1:
        raise ValueError(f"offset {k} must be >= 1")
    if rank.device.type == "cpu":
        return sa_keys_plain(rank, k, packed)
    rank = rank.contiguous()
    key = torch.empty_like(rank)
    if rank.numel():
        _launch("sa_keys", rank.device, rank.data_ptr(), rank.numel(), k, int(packed), key.data_ptr())
    return key


def sa_flags_cuda(a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """neq[j] = 1 where sorted a (or b) at j differs from j - 1; neq[0] = 0."""
    _check("sa_flags", a, *(() if b is None else (b,)))
    if a.device.type == "cpu":
        return sa_flags_plain(a, b)
    a = a.contiguous()
    b = None if b is None else b.contiguous()
    neq = torch.empty_like(a)
    if a.numel():
        _launch("sa_flags", a.device, a.data_ptr(), None if b is None else b.data_ptr(), a.numel(), neq.data_ptr())
    return neq


def sa_scatter_cuda(sa: torch.Tensor, nr: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """rank[sa[j]] = nr[j], in place; sa must be a permutation of 0..n-1
    (torch.sort's indices are)."""
    _check("sa_scatter", sa, nr, rank)
    if sa.device.type == "cpu":
        return sa_scatter_plain(sa, nr, rank)
    if not rank.is_contiguous():
        raise ValueError("sa_scatter writes into a contiguous rank")
    sa, nr = sa.contiguous(), nr.contiguous()
    if sa.numel():
        _launch("sa_scatter", sa.device, sa.data_ptr(), nr.data_ptr(), sa.numel(), rank.data_ptr())
    return rank


def sa_bwt_cuda(seq: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """bwt[j] = seq[sa[j] - 1], seq[n - 1] where sa[j] = 0; sa must be a
    permutation of 0..n-1."""
    _check("sa_bwt", sa)
    if seq.dtype != torch.uint8 or seq.shape != sa.shape or seq.device != sa.device:
        raise ValueError("sa_bwt takes a uint8 batch and its int64 suffix array on one device")
    if sa.device.type == "cpu":
        return sa_bwt_plain(seq, sa)
    seq, sa = seq.contiguous(), sa.contiguous()
    bwt = torch.empty_like(seq)
    if sa.numel():
        _launch("sa_bwt", sa.device, seq.data_ptr(), sa.data_ptr(), sa.numel(), bwt.data_ptr())
    return bwt


PLAIN = (sa_keys_plain, sa_flags_plain, sa_scatter_plain, sa_bwt_plain)
CUDA = (sa_keys_cuda, sa_flags_cuda, sa_scatter_cuda, sa_bwt_cuda)


# ---------------------------------------------------------------------------
# the rounds
# ---------------------------------------------------------------------------


def sa_round(rank: torch.Tensor, k: int, passes=CUDA) -> tuple[torch.Tensor, bool]:
    """One round at offset k over int64 ranks: returns (sa, done).  Unless
    done (every new rank distinct), rank is renumbered in place."""
    keys, flags, scatter, _ = passes
    n = rank.numel()
    if n < PACKED_MAX:
        key = keys(rank, k, True)
        key_s, sa = torch.sort(key)
        del key
        neq = flags(key_s, None)
        del key_s
    else:  # rank and rank2 do not fit one key: two stable sorts, rank2 first
        rank2 = keys(rank, k, False)
        p1 = torch.sort(rank2, stable=True).indices
        sa = p1[torch.sort(rank[p1], stable=True).indices]
        del p1
        neq = flags(rank[sa], rank2[sa])
        del rank2
    nr = torch.cumsum(neq, 0)
    del neq
    done = int(nr[-1]) == n - 1
    if not done:
        scatter(sa, nr, rank)
    return sa, done


def _doubling(seq: torch.Tensor, passes) -> tuple[torch.Tensor, torch.Tensor]:
    n = seq.numel()
    if n < 2:
        return seq.clone(), torch.arange(n, device=seq.device)
    if int(seq[-1]) != 0:
        raise ValueError("a construction batch must end with a separator")
    rank = initial_ranks(seq)
    k = 1
    while True:
        sa, done = sa_round(rank, k, passes)
        if done:
            break
        k *= 2
        if k > 2 * n:  # cannot happen: every suffix ends at a distinct separator
            raise RuntimeError("prefix doubling failed to converge")
    return passes[3](seq, sa), sa


def gsa_bwt(seq: torch.Tensor | np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(BWT uint8, SA int64) of a batch, on `device`: the kernels of
    csrc/sa_round.cu on a CUDA device, the plain versions on the CPU."""
    if isinstance(seq, np.ndarray):
        seq = torch.from_numpy(np.ascontiguousarray(seq, dtype=np.uint8))
    seq = seq.to(device)
    if seq.dtype != torch.uint8 or seq.dim() != 1:
        raise ValueError("a construction batch is a 1-D uint8 tensor")
    return _doubling(seq, CUDA)


def gsa_bwt_plain(seq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`gsa_bwt` through the plain passes, on the tensor's own device."""
    return _doubling(seq, PLAIN)
