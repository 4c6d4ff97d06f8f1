"""`kount`'s trie, a level at a time, on the device's occ rows (dense, or
rb where dense ones do not fit the card).

A level of the trie is a frontier of BWT intervals [k, l), one a node and
index.  A node's children are acc[a] + occ_a(k) .. acc[a] + occ_a(l) for
a = A, C, G, T (nt6 1..4), and a child lives when its size reaches -m in
any index.  `kount_rank_cuda` ranks a whole frontier in one launch of
csrc/kount.cu (one thread a node, both ends, the four bases only; ok and
size come out symbol-major, (4, N)); `kount_rank_plain` is its plain
PyTorch version over the index's `rank1a`, the CPU path and the reference on
the card.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises.

`kount_levels` keeps every frontier symbol-major: all A-children, then C,
G, T, each group in its parents' order.  In that order each index's
frontier is sorted by k and its intervals are disjoint (l_i <= k_i+1): the
root [0, n) is; occ_a is monotone, so the a-children of sorted, disjoint
parents stay sorted and disjoint inside [acc[a], acc[a+1]); and the groups
come in ascending a.  So the nodes of a warp read neighbouring rows.  The
output does not depend on this order: `cli.main_kount` sorts the k-mers
into the reference's DFS order at the end.
"""

from __future__ import annotations

from collections import Counter

import torch

from .. import kernels

BASES = 4  # nt6 1..4: the symbols a k-mer of kount may hold


def kount_rank_plain(idx, k: torch.Tensor, l: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ok, size), each (4, N) in the index's width: ok[a - 1] = occ_a(k)
    and size[a - 1] = occ_a(l) - occ_a(k) for a = 1..4."""
    r = idx.rank1a(torch.stack([k, l]))[..., 1 : 1 + BASES]  # (2, N, 4) int64
    ok = r[0].t()
    return ok.to(idx.dtype).contiguous(), (r[1].t() - ok).to(idx.dtype).contiguous()


def check_kount(idx, k: torch.Tensor, l: torch.Tensor) -> None:
    """Raise unless idx has rows of a kernel layout (kernels.LAYOUTS) and
    k, l are 1-D tensors of one length, of the index's width and on its
    device, with 0 <= k <= l <= n."""
    if idx.layout not in kernels.LAYOUTS:
        raise ValueError(f"kount_rank takes {kernels.LAYOUTS} occ rows, not {idx.layout}")
    if k.dim() != 1 or k.shape != l.shape:
        raise ValueError("kount_rank takes k and l of shape (N,)")
    if k.dtype != idx.dtype or l.dtype != idx.dtype or k.device != idx.device or l.device != idx.device:
        raise ValueError(f"kount_rank takes {idx.dtype} k and l on the index's device ({idx.device})")
    if k.numel() and bool(((k < 0) | (k > l) | (l > idx.n)).any()):
        raise ValueError(f"kount_rank needs 0 <= k <= l <= {idx.n}")


def launch_kount_rank(idx, k, l, ok, size) -> None:
    """One kount_rank launch on checked, contiguous inputs, uncounted
    (timing)."""
    kernels.launch(f"rb3c_kount_rank_{idx.layout}", k.device, *idx.kernel_tables(), k.data_ptr(), l.data_ptr(),
                   k.numel(), ok.data_ptr(), size.data_ptr())


def kount_rank_cuda(idx, k: torch.Tensor, l: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """kount_rank_plain's (ok, size) through csrc/kount.cu on CUDA tensors;
    CPU tensors take the plain version."""
    check_kount(idx, k, l)
    if k.device.type == "cpu":
        return kount_rank_plain(idx, k, l)
    k, l = k.contiguous(), l.contiguous()
    ok = torch.empty((BASES, k.numel()), dtype=idx.dtype, device=k.device)
    size = torch.empty_like(ok)
    if k.numel():
        launch_kount_rank(idx, k, l, ok, size)
        kount_rank_cuda.launches[idx.layout] += 1
    return ok, size


kount_rank_cuda.launches = Counter()


def kount_levels(idxs: list, depth: int, min_occ: int, on_level=None) -> tuple[torch.Tensor, torch.Tensor] | None:
    """The k-mers of length `depth` whose every prefix (the symbols chosen
    so far) occurs at least `min_occ` times in one of the indexes (occ
    rows on one device), expanded a level at a time: one kount_rank a
    level and index, the frontier kept on the device, symbol-major.
    `on_level(d, ks, ls, chars)`, when given, sees each level's frontier
    before it is ranked (tuples of each index's k and l, and the (nodes, d)
    uint8 symbols chosen so far).  Returns (chars (nodes, depth) uint8,
    counts (nodes, indexes) in the index's width) of the last level, or None
    when a level before it is empty."""
    dev = idxs[0].device
    # in the rows' width: a size never passes n, so n + 1 stands for more
    mins = [max(0, min(min_occ, x.n + 1)) for x in idxs]
    ks = [torch.zeros(1, dtype=x.dtype, device=dev) for x in idxs]
    ls = [torch.full((1,), x.n, dtype=x.dtype, device=dev) for x in idxs]
    chars = torch.zeros((1, 0), dtype=torch.uint8, device=dev)
    for d in range(depth):
        if on_level is not None:
            on_level(d, tuple(ks), tuple(ls), chars)
        rr = [kount_rank_cuda(x, k, l) for x, k, l in zip(idxs, ks, ls)]
        keep = rr[0][1] >= mins[0]
        for (_, size), m in zip(rr[1:], mins[1:]):
            keep |= size >= m  # a branch lives when any index reaches min_occ
        a_i, node_i = keep.nonzero(as_tuple=True)  # symbol-major
        chars = torch.cat([chars[node_i], (a_i + 1).to(torch.uint8)[:, None]], dim=1)
        if d == depth - 1:
            return chars, torch.stack([size[a_i, node_i] for _, size in rr], dim=1)
        if len(node_i) == 0:
            return None
        for i, ((ok, size), x) in enumerate(zip(rr, idxs)):
            ks[i] = x.acc[a_i + 1] + ok[a_i, node_i]
            ls[i] = ks[i] + size[a_i, node_i]
    return None
