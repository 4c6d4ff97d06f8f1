"""`get`'s LF walk and `suffix`'s backward search on the device's occ rows.

The JAX package runs both on the host: `get` through DenseFMIndex.retrieve
(ropebwt3_tpu/index/dense.py:244-278, its native rb3t_retrieve walk), and
`suffix` through main_suffix's lock-step `flush` (ropebwt3_tpu/cli.py:799-829,
one rank1a_fast of every active read's k and l a step).  Here each has a
plain PyTorch version, the reference and the CPU path, and a CUDA wrapper
around its kernel in csrc/walk.cu: K11 `retrieve_walk` (dense rows) and K12
`suffix_walk` (every layout).  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.

A retrieve walk is resumable: `retrieve_chunk_*` take at most `steps` steps
of every lane not yet done, writing step s of lane t at out[s, t], and
leave each lane's k and done flag for the next chunk; `retrieve_plain` /
`retrieve_cuda` append the chunks until every lane is done.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import kernels
from .rank import lf

CHUNK_STEPS = 1 << 16  # steps a lane takes in one retrieve launch at most
CHUNK_BYTES = 1 << 28  # and the (steps, m) symbol buffer's bytes at most


def retrieve_chunk_plain(idx, k: torch.Tensor, done: torch.Tensor, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to `steps` LF steps (ops/rank.py `lf`) of every lane not done,
    lock-step: a lane that reads symbol 0 stops there and is done, its k
    left at the row that holds the sentinel.  k (m,) int64 and done (m,)
    uint8 are updated in place.  Returns (out (steps, m) uint8: step s of
    lane t at out[s, t], zero past the lane's count; n (m,) int32 counts)."""
    m = k.numel()
    out = torch.zeros((steps, m), dtype=torch.uint8, device=k.device)
    n = torch.zeros(m, dtype=torch.int32, device=k.device)
    ids = (done == 0).nonzero()[:, 0]
    for s in range(steps):
        if ids.numel() == 0:
            break
        c, nk = lf(idx, k[ids])
        go = c != 0
        done[ids[~go]] = 1
        ids, c, nk = ids[go], c[go], nk[go]
        out[s, ids] = c.to(torch.uint8)
        k[ids] = nk
        n[ids] += 1
    return out, n


def _check_walk(idx, k: torch.Tensor, done: torch.Tensor, steps: int) -> None:
    if idx.layout not in ("dense32", "dense64"):
        raise ValueError(f"the retrieve walk runs on dense rows, not {idx.layout}")
    if k.dtype != torch.int64 or k.dim() != 1 or done.dtype != torch.uint8 or done.shape != k.shape:
        raise ValueError("retrieve takes k (m,) int64 and done (m,) uint8")
    if k.device != idx.device or done.device != idx.device:
        raise ValueError("retrieve: k and done must be on the index's device")
    if not 1 <= steps < (1 << 31):
        raise ValueError(f"steps {steps} outside [1, 2^31)")
    live = k[done == 0]
    if live.numel() and (int(live.min()) < 0 or int(live.max()) >= idx.n):
        raise ValueError(f"retrieve position outside [0, {idx.n})")


def retrieve_chunk_cuda(idx, k: torch.Tensor, done: torch.Tensor, steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """retrieve_chunk_plain through the retrieve_walk kernel of the index's
    dense layout; out past a lane's count is left unwritten.  CPU tensors
    take the plain version."""
    _check_walk(idx, k, done, steps)
    if k.device.type == "cpu":
        return retrieve_chunk_plain(idx, k, done, steps)
    m = k.numel()
    out = torch.empty((steps, m), dtype=torch.uint8, device=k.device)
    n = torch.empty(m, dtype=torch.int32, device=k.device)
    if m:
        launch_retrieve(idx, k, done, steps, out, n)
        retrieve_chunk_cuda.launches[idx.layout] += 1
    return out, n


retrieve_chunk_cuda.launches = Counter()


def launch_retrieve(idx, k, done, steps: int, out, n) -> None:
    """One retrieve_walk launch on checked inputs, uncounted (timing)."""
    kernels.launch(f"rb3c_retrieve_walk_{idx.layout}", k.device, *idx.kernel_tables(), k.data_ptr(), done.data_ptr(),
                   k.numel(), steps, out.data_ptr(), n.data_ptr())


def _retrieve(idx, ks, chunk) -> tuple[list[np.ndarray], np.ndarray]:
    """Walk from each k of `ks` (in [0, n)) with `chunk` until every lane
    reads symbol 0: (the symbols of each walk, reversed, as uint8 arrays;
    the k where each stopped)."""
    m = len(ks)
    k = torch.as_tensor(np.asarray(ks, dtype=np.int64), device=idx.device).clone()
    done = torch.zeros(m, dtype=torch.uint8, device=idx.device)
    steps = max(1, min(CHUNK_STEPS, CHUNK_BYTES // max(m, 1)))
    parts: list[list[np.ndarray]] = [[] for _ in range(m)]
    while m and not bool(done.all()):
        out, n = chunk(idx, k, done, steps)
        n = n.cpu().numpy()
        out = out[: int(n.max())].cpu().numpy()
        for t in np.flatnonzero(n):
            parts[t].append(out[: n[t], t])
    seqs = [np.concatenate(p)[::-1].copy() if p else np.zeros(0, np.uint8) for p in parts]
    return seqs, k.cpu().numpy()


def retrieve_plain(idx, ks) -> tuple[list[np.ndarray], np.ndarray]:
    """DenseFMIndex.retrieve of each k of `ks` on `idx`, lock-step over
    ops/rank.py `lf`: (each walk's symbols, reversed; the k it stopped at)."""
    return _retrieve(idx, ks, retrieve_chunk_plain)


def retrieve_cuda(idx, ks) -> tuple[list[np.ndarray], np.ndarray]:
    """retrieve_plain through the retrieve_walk kernel, a launch a chunk
    (the plain version on a CPU index)."""
    return _retrieve(idx, ks, retrieve_chunk_cuda)


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
