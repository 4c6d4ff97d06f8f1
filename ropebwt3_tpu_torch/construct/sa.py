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
distinct (the last new rank is n - 1).

Below PACKED_MAX symbols (the packed path) ranks, flags, new ranks and the
suffix array are int32, and the pair is one key over the round's live bits:
rank << b2 | rank2, b1 = bit_length(top) and b2 = bit_length(top + 1) for
ranks at most `top` (m + 4 before the first round, then the last round's
top rank, which the host reads anyway), a 32-bit word where b1 + b2 <= 32.
A round sorts it with `sa_sort`, a stable LSD radix sort of ceil((b1 +
b2) / 8) digit passes (csrc/sa_sort.cu).  Above PACKED_MAX (the wide path)
ranks are int64 and a round is two stable torch.sorts, by rank2 then by
rank.  Ties within a round change no rank, and the last round has none, so
the final suffix array is the same whichever sort is stable; `gsa_bwt`
returns it as int64.

The passes around the sort and the scan are `sa_keys`, `sa_sort`,
`sa_flags`, `sa_scatter` and `sa_bwt`: each a kernel of csrc/sa_round.cu
or csrc/sa_sort.cu for a CUDA tensor (`*_cuda`, counting its launches in
SA_LAUNCHES) and its plain PyTorch version for a CPU tensor (`*_plain`).
`gsa_bwt` runs the kernels' wrappers, `gsa_bwt_plain` the plain versions on
any device.

Capacity: the packed rounds work in one SortSpace a batch: on the card
two 8-B key words and two int32 values a symbol, the int32 rank and the
batch, and the sort's status words (~0.5 B); the plain passes use only
the first key word.  A round's flags and new ranks go into
the key word that does not hold the sorted keys.  SA_BYTES_PER_SYMBOL is
the peak of a one-batch `build` of 64,000,032 symbols (chip_smoke
`[construct]`, which fails above it), the figure `build` sizes its
batches by: 29.55 B a symbol, the batch included (NVIDIA H100 80GB HBM3,
700 W; chip_smoke and python -m ropebwt3_tpu_torch.sa_time), against 65.2
for the int64 rounds around torch.sort.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import kernels

# n below this: the packed one-key round (ranks and rank + 1 fit 32 bits)
PACKED_MAX = (1 << 31) - 1
# card bytes a batch symbol needs at a round's peak (see the docstring)
SA_BYTES_PER_SYMBOL = 30
# the same on the wide path (int64 ranks, two torch.sorts): the int64 rounds
# around one torch.sort took 65.24 B a symbol (NVIDIA H100 80GB HBM3,
# n = 64,000,032); the wide path itself needs a card of more than 140 GB
WIDE_BYTES_PER_SYMBOL = 66


def bytes_per_symbol(n: int) -> int:
    """Card bytes a symbol that `gsa_bwt` of an n-symbol batch needs at its peak."""
    return SA_BYTES_PER_SYMBOL if n < PACKED_MAX else WIDE_BYTES_PER_SYMBOL


def initial_ranks(seq: torch.Tensor) -> torch.Tensor:
    """Separators rank by position among themselves, below every base:
    the ranks of a uint8 batch (sa_jax.py:40-48), int32 on the packed path
    (n < PACKED_MAX), int64 on the wide one."""
    dt = torch.int32 if seq.numel() < PACKED_MAX else torch.int64
    s = seq.to(dt)
    is_sep = s == 0
    sep_order = torch.cumsum(is_sep, 0, dtype=dt) - 1
    m = sep_order[-1] + 1
    return torch.where(is_sep, sep_order, m - 1 + s)


def live_bits(top: int) -> tuple[int, int]:
    """(shift, bits) of a packed round whose ranks are at most `top`: the key
    rank << shift | r2, with r2 <= top + 1 below 2^shift, has `bits` live
    bits; it is a 32-bit word where bits <= 32."""
    shift = (top + 1).bit_length()
    return shift, top.bit_length() + shift


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def sa_keys_plain(rank: torch.Tensor, k: int, shift: int | None = None, key32: bool = False,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    n = rank.numel()
    r2 = torch.zeros_like(rank)
    if k < n:
        r2[: n - k] = rank[k:] + 1
    if shift is None:
        key = r2
    else:
        dt = torch.int32 if key32 else torch.int64
        key = rank.to(dt) << shift | r2.to(dt)
    return key if out is None else out.copy_(key)


def sa_sort_plain(key: torch.Tensor, bits: int, space=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys, int32 permutation) of keys whose `bits` low bits are live,
    read as unsigned words: LSD passes, a stable argsort of each 8-bit digit,
    the kernel's passes.  The permutation is torch.sort(key, stable=True)'s
    indices (for bits < the word's width)."""
    perm = torch.arange(key.numel(), device=key.device)
    for d in range(0, bits, 8):
        perm = perm[torch.argsort((key[perm] >> d) & 255, stable=True)]
    return key[perm], perm.int()


def sa_flags_plain(a: torch.Tensor, b: torch.Tensor | None, out: torch.Tensor | None = None) -> torch.Tensor:
    d = a[1:] != a[:-1]
    if b is not None:
        d |= b[1:] != b[:-1]
    neq = torch.zeros(a.numel(), dtype=torch.int32 if b is None else a.dtype, device=a.device) if out is None else out
    neq[0] = 0
    neq[1:] = d
    return neq


def sa_scatter_plain(sa: torch.Tensor, nr: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    rank[sa] = nr
    return rank


def sa_bwt_plain(seq: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    return seq[torch.where(sa == 0, sa.numel() - 1, sa - 1)]


class SortSpace:
    """The packed rounds' buffers, allocated once a batch and reused every
    round: an 8-B key word a symbol (sa_keys' output), and, from the first
    `sort_buffers()` (sa_sort_cuda's), the sort's second key word (its
    double buffer), two int32 values (its permutation), and its digit
    histograms, tile counters and look-back status words
    (`rb3c_sa_sort_status_len`).  The key word not holding the sorted keys
    takes neq and nr as int32 halves."""

    def __init__(self, n: int, device):
        self.n = n
        self.keys = [torch.empty(n, dtype=torch.int64, device=device)]
        self.device = self.keys[0].device
        self.vals = self.hist = self.status = None

    def sort_buffers(self) -> SortSpace:
        if self.vals is None:
            dev, n = self.device, self.n
            self.keys.append(torch.empty(n, dtype=torch.int64, device=dev))
            self.vals = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
            self.hist = torch.empty(8 * 256 + 8, dtype=torch.int32, device=dev)
            self.status = torch.empty(kernels.lib().rb3c_sa_sort_status_len(n), dtype=torch.int64, device=dev)
        return self

    def key(self, i: int, key32: bool) -> torch.Tensor:
        return self.keys[i].view(torch.int32)[: self.n] if key32 else self.keys[i]

    def spare(self, key_s: torch.Tensor) -> torch.Tensor:
        """The key buffer that does not hold key_s (the first where key_s is
        not the space's, as a plain sort's is), as 2n int32 words."""
        b = self.keys[1] if key_s.data_ptr() == self.keys[0].data_ptr() else self.keys[0]
        return b.view(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/sa_round.cu, csrc/sa_sort.cu); a CPU tensor takes the
# plain version
# ---------------------------------------------------------------------------


def _check(name: str, dtypes, *ts: torch.Tensor) -> None:
    """1-D contiguous tensors of one length on one device, each of one of
    `dtypes`."""
    n = ts[0].numel()
    for t in ts:
        if t.dtype not in dtypes or t.dim() != 1 or t.numel() != n or t.device != ts[0].device or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous 1-D tensors of one length on one device, of {dtypes}")


def _check_out(name: str, out: torch.Tensor | None, n: int, dtype, device) -> torch.Tensor:
    if out is None:
        return torch.empty(n, dtype=dtype, device=device)
    _check(name, (dtype,), out)
    if out.numel() != n or out.device != device:
        raise ValueError(f"{name} writes {n} {dtype} on {device}")
    return out


def _launch(name: str, entry: str, device, *args) -> None:
    kernels.launch(f"rb3c_{entry}", device, *args)
    SA_LAUNCHES[name] += 1


# launches of each pass's kernel
SA_LAUNCHES: Counter = Counter()
_INTS = (torch.int32, torch.int64)  # the packed path's ranks and 32-bit keys, the wide path's and 64-bit keys


def sa_keys_cuda(rank: torch.Tensor, k: int, shift: int | None = None, key32: bool = False,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """key[i] = rank[i] << shift | r2[i] (int32 ranks: the packed path's
    32-bit words if key32, else 64-bit) or r2[i] (int64 ranks, shift None:
    the wide path), r2[i] = rank[i + k] + 1 or 0 past the end; written into
    `out` where given."""
    _check("sa_keys", _INTS, rank)
    if k < 1:
        raise ValueError(f"offset {k} must be >= 1")
    packed = rank.dtype == torch.int32
    if packed != (shift is not None) or (packed and not 0 <= shift < (32 if key32 else 64)):
        raise ValueError("sa_keys packs int32 ranks at a shift below the key's width, and takes no shift for int64")
    dt = torch.int32 if packed and key32 else torch.int64
    out = _check_out("sa_keys", out, rank.numel(), dt, rank.device)
    if rank.device.type == "cpu":
        return sa_keys_plain(rank, k, shift, key32, out)
    n = rank.numel()
    if n and packed:
        _launch("sa_keys", "sa_keys_packed", rank.device, rank.data_ptr(), n, k, shift, int(not key32), out.data_ptr())
    elif n:
        _launch("sa_keys", "sa_keys", rank.device, rank.data_ptr(), n, k, out.data_ptr())
    return out


def sa_sort_cuda(key: torch.Tensor, bits: int, space: SortSpace | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys, int32 permutation) of int32 or int64 keys whose `bits`
    low bits are live, read as unsigned words: csrc/sa_sort.cu's stable LSD
    radix sort, ceil(bits / 8) digit passes, in the buffers of `space`
    (allocated for this call where None; key may be its key(0, ...)).  The
    results are views of space's buffers."""
    _check("sa_sort", _INTS, key)
    n = key.numel()
    if not 1 <= bits <= 8 * key.element_size() or n >= PACKED_MAX:
        raise ValueError(f"sa_sort sorts fewer than 2^31 - 1 keys over 1 to {8 * key.element_size()} live bits")
    if key.device.type == "cpu":
        return sa_sort_plain(key, bits)
    if space is None or space.n != n or space.device != key.device:
        space = SortSpace(n, key.device)
    space.sort_buffers()
    if key.untyped_storage().data_ptr() in {t.untyped_storage().data_ptr() for t in (space.keys[1], *space.vals)}:
        raise ValueError("sa_sort's keys may share only the space's first key buffer")
    key32 = key.dtype == torch.int32
    if n:
        _launch("sa_sort", "sa_sort", key.device, key.data_ptr(), space.keys[0].data_ptr(), space.keys[1].data_ptr(),
                space.vals[0].data_ptr(), space.vals[1].data_ptr(), n, bits, int(not key32), space.hist.data_ptr(),
                space.status.data_ptr(), space.status.numel())
    r = -(-bits // 8) % 2  # digit pass p writes buffer (p + 1) % 2
    return space.key(r, key32), space.vals[r]


def sa_flags_cuda(a: torch.Tensor, b: torch.Tensor | None, out: torch.Tensor | None = None) -> torch.Tensor:
    """neq[j] = 1 where sorted a (or b) at j differs from j - 1; neq[0] = 0.
    One packed key a (b None): int32 neq, written into `out` where given;
    the wide path's two int64 arrays: int64 neq."""
    _check("sa_flags", _INTS if b is None else (torch.int64,), a, *(() if b is None else (b,)))
    out = _check_out("sa_flags", out, a.numel(), torch.int32 if b is None else torch.int64, a.device)
    if a.device.type == "cpu":
        return sa_flags_plain(a, b, out)
    if a.numel() and b is None:
        _launch("sa_flags", "sa_flags_packed", a.device, a.data_ptr(), a.numel(), int(a.dtype == torch.int64),
                out.data_ptr())
    elif a.numel():
        _launch("sa_flags", "sa_flags", a.device, a.data_ptr(), b.data_ptr(), a.numel(), out.data_ptr())
    return out


def sa_scatter_cuda(sa: torch.Tensor, nr: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """rank[sa[j]] = nr[j], in place, all int32 (packed) or all int64 (wide);
    sa must be a permutation of 0..n-1 (the sorts' are)."""
    _check("sa_scatter", _INTS, sa, nr, rank)
    if not sa.dtype == nr.dtype == rank.dtype:
        raise ValueError("sa_scatter takes sa, nr and rank of one dtype")
    if sa.device.type == "cpu":
        return sa_scatter_plain(sa, nr, rank)
    if sa.numel():
        entry = "sa_scatter_packed" if sa.dtype == torch.int32 else "sa_scatter"
        _launch("sa_scatter", entry, sa.device, sa.data_ptr(), nr.data_ptr(), sa.numel(), rank.data_ptr())
    return rank


def sa_bwt_cuda(seq: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """bwt[j] = seq[sa[j] - 1], seq[n - 1] where sa[j] = 0; sa (int32 or
    int64) must be a permutation of 0..n-1."""
    _check("sa_bwt", _INTS, sa)
    if seq.dtype != torch.uint8 or seq.shape != sa.shape or seq.device != sa.device or not seq.is_contiguous():
        raise ValueError("sa_bwt takes a contiguous uint8 batch and its suffix array on one device")
    if sa.device.type == "cpu":
        return sa_bwt_plain(seq, sa)
    bwt = torch.empty_like(seq)
    if sa.numel():
        entry = "sa_bwt_packed" if sa.dtype == torch.int32 else "sa_bwt"
        _launch("sa_bwt", entry, sa.device, seq.data_ptr(), sa.data_ptr(), sa.numel(), bwt.data_ptr())
    return bwt


PLAIN = (sa_keys_plain, sa_sort_plain, sa_flags_plain, sa_scatter_plain, sa_bwt_plain)
CUDA = (sa_keys_cuda, sa_sort_cuda, sa_flags_cuda, sa_scatter_cuda, sa_bwt_cuda)


# ---------------------------------------------------------------------------
# the rounds
# ---------------------------------------------------------------------------


def sa_round(rank: torch.Tensor, k: int, top: int, passes, space: SortSpace | None) -> tuple[torch.Tensor, int]:
    """One round at offset k over ranks at most `top`: returns (sa, the new
    ranks' top); every new rank is distinct (done) where that is n - 1.
    Unless done, rank is renumbered in place.  The packed path (int32 ranks)
    works in `space`; the wide path takes None."""
    keys, sort, flags, scatter, _ = passes
    n = rank.numel()
    if n < PACKED_MAX:
        shift, bits = live_bits(top)
        key32 = bits <= 32
        key = keys(rank, k, shift, key32, out=space.key(0, key32))
        key_s, sa = sort(key, bits, space)
        del key
        spare = space.spare(key_s)
        neq = flags(key_s, None, out=spare[:n])
        del key_s
        nr = torch.cumsum(neq, 0, dtype=torch.int32, out=spare[n:])
    else:  # rank and rank2 do not fit one key: two stable sorts, rank2 first
        rank2 = keys(rank, k)
        p1 = torch.sort(rank2, stable=True).indices
        sa = p1[torch.sort(rank[p1], stable=True).indices]
        del p1
        neq = flags(rank[sa], rank2[sa])
        del rank2
        nr = torch.cumsum(neq, 0)
    del neq
    top = int(nr[-1])
    if top < n - 1:
        scatter(sa, nr, rank)
    return sa, top


def _doubling(seq: torch.Tensor, passes) -> tuple[torch.Tensor, torch.Tensor]:
    n = seq.numel()
    if n < 2:
        return seq.clone(), torch.arange(n, device=seq.device)
    if int(seq[-1]) != 0:
        raise ValueError("a construction batch must end with a separator")
    rank = initial_ranks(seq)
    top = int(rank[-1]) + 5  # the last symbol is a separator, ranked m - 1; a base ranks at most m + 4
    space = SortSpace(n, seq.device) if n < PACKED_MAX else None
    k = 1
    while True:
        sa, top = sa_round(rank, k, top, passes, space)
        if top == n - 1:
            break
        k *= 2
        if k > 2 * n:  # cannot happen: every suffix ends at a distinct separator
            raise RuntimeError("prefix doubling failed to converge")
    del rank, space
    return passes[4](seq, sa), sa.long()


def gsa_bwt(seq: torch.Tensor | np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(BWT uint8, SA int64) of a batch, on `device`: the kernels of
    csrc/sa_round.cu and csrc/sa_sort.cu on a CUDA device, the plain
    versions on the CPU."""
    if isinstance(seq, np.ndarray):
        seq = torch.from_numpy(np.ascontiguousarray(seq, dtype=np.uint8))
    seq = seq.to(device)
    if seq.dtype != torch.uint8 or seq.dim() != 1:
        raise ValueError("a construction batch is a 1-D uint8 tensor")
    return _doubling(seq.contiguous(), CUDA)


def gsa_bwt_plain(seq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`gsa_bwt` through the plain passes, on the tensor's own device."""
    return _doubling(seq, PLAIN)
