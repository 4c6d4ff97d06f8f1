"""`kount`'s level rank (ops/kount.py, csrc/kount.cu) on the CPU: the plain
version against the JAX package's host rank (DenseFMIndex.rank1a, numpy)
on every level's frontier of the corpus index, in both orders and both
widths; the symbol-major frontier sorted and disjoint; the wrapper's
checks; csrc/kount.cu's node routine built for the host with g++; and
kount_time's node-major order against the trie as it was expanded before
(node-major, over rank1a of cat([k, l]))."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.nt6 import char2nt6, revcomp
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch import kernels
from ropebwt3_tpu_torch.kernels import CSRC
from ropebwt3_tpu_torch.kount_time import level_stats, node_major
from ropebwt3_tpu_torch.ops import kount, runblock
from ropebwt3_tpu_torch.ops.rank import OccIndex

from .test_torch_cuda import corpus_index  # noqa: F401  (fixture reuse)
from .test_torch_runblock import HOST_SHIM
from .test_torch_walk import OtherLayout

DEPTH, MIN_OCC = 8, 2  # the corpus index's frontier peaks at 10,544 nodes (level 7)


@pytest.fixture(scope="module")
def first_genome_index(corpus):
    """The corpus's first genome alone, double strand (other counts)."""
    s = char2nt6(next(iter(read_seqs(str(corpus / "genomes.fa")))).seq)
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate([s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)])))


def occ_index(f, layout):
    """dense32, or dense64 with megablocks of 2^6 rows (several on the
    corpus); rb32 or rb64 at S = 256 (mostly run-coded), rb64 in megablocks
    of 4 blocks."""
    if layout.startswith("rb"):
        return runblock.RunBlockIndex.from_dense(f, "cpu", S=256, int64=layout == "rb64", mega_shift=2, cache=None)
    return OccIndex.from_dense(f, "cpu", int64=layout == "dense64", mega_shift=6)


def frontiers(idxs, depth=DEPTH, min_occ=MIN_OCC):
    """Every level's (ks, ls, chars) as kount_levels ranks them."""
    out = []
    kount.kount_levels(idxs, depth, min_occ, on_level=lambda d, ks, ls, chars: out.append((ks, ls, chars)))
    return out


def node_major_frontiers(idx, depth=DEPTH, min_occ=MIN_OCC):
    """The trie expanded as `kount` did before kount_rank: rank1a of
    cat([k, l]), children taken node by node (keep.nonzero over (node,
    symbol)).  Every level's (k, l) as int64."""
    k, l = torch.zeros(1, dtype=torch.int64), torch.full((1,), idx.n, dtype=torch.int64)
    out = []
    for _ in range(depth):
        out.append((k, l))
        r = idx.rank1a(torch.cat([k, l]))
        ok, occ = r[: len(k)], r[len(k) :] - r[: len(k)]
        node_i, a_i = (occ[:, 1:5] >= min_occ).nonzero(as_tuple=True)
        a = a_i + 1
        k = idx.acc.long()[a] + ok[node_i, a]
        l = k + occ[node_i, a]
    return out


@pytest.mark.parametrize("order", ["symbol", "node"])
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
def test_kount_rank_plain_matches_jax_host_rank(corpus_index, layout, order):  # noqa: F811
    """kount_rank_plain on every level's frontier (symbol-major, and the
    same nodes node-major) equals the JAX package's numpy rank1a: occ of
    A, C, G, T at k, and their counts in [k, l)."""
    idx = occ_index(corpus_index, layout)
    assert idx.layout == layout
    levels = frontiers([idx])
    assert max(len(ks[0]) for ks, _, _ in levels) > 10_000
    for ks, ls, chars in levels:
        k, l = ks[0], ls[0]
        if order == "node":
            perm = node_major(chars)
            k, l = k[perm], l[perm]
        ok, size = kount.kount_rank_plain(idx, k, l)
        assert ok.dtype == size.dtype == idx.dtype and ok.shape == size.shape == (4, len(k))
        rk, rl = corpus_index.rank1a(k.numpy()), corpus_index.rank1a(l.numpy())
        assert np.array_equal(ok.numpy(), rk[:, 1:5].T)
        assert np.array_equal(size.numpy(), (rl - rk)[:, 1:5].T)


@pytest.mark.parametrize("two", [False, True])
def test_symbol_major_frontier_sorted_and_disjoint(corpus_index, first_genome_index, two):  # noqa: F811
    """Each index's frontier, at every level, is sorted by k with l_i <=
    k_i+1 (and k <= l): one index, and two (where a branch lives when
    either index reaches -m, so one index's intervals may be empty)."""
    fs = [corpus_index, first_genome_index] if two else [corpus_index]
    levels = frontiers([OccIndex.from_dense(f, "cpu") for f in fs])
    assert len(levels) == DEPTH
    for ks, ls, _ in levels:
        for k, l in zip(ks, ls):
            k, l = k.long(), l.long()
            assert bool((k <= l).all())
            assert bool((k[1:] >= k[:-1]).all()) and bool((l[:-1] <= k[1:]).all())


@pytest.mark.parametrize("layout", ["dense32", "dense64"])
def test_node_major_is_the_old_expansion(corpus_index, layout):  # noqa: F811
    """node_major(chars) puts each symbol-major level in the order the trie
    had when kount ranked cat([k, l]) node by node: kount_time's variant A
    is the old frontier."""
    idx = occ_index(corpus_index, layout)
    for (ks, ls, chars), (k_old, l_old) in zip(frontiers([idx]), node_major_frontiers(idx)):
        perm = node_major(chars)
        assert torch.equal(ks[0][perm].long(), k_old) and torch.equal(ls[0][perm].long(), l_old)


@pytest.mark.parametrize("case", ["k_below_0", "l_above_n", "k_above_l", "dtype", "device", "shape", "rb"])
def test_kount_rank_checks(corpus_index, case):  # noqa: F811
    """The wrapper raises, before any launch, on a position outside [0, n],
    on k > l, on a dtype or device other than the index's, on k and l of
    other shapes, and on rows of no kernel layout (rb rows are one: they
    rank, as the plain version on the CPU)."""
    idx = OccIndex.from_dense(corpus_index, "cpu")
    n = idx.n
    k = torch.tensor([0, 5, 100], dtype=torch.int32)
    l = torch.tensor([n, 9, 100], dtype=torch.int32)
    if case == "k_below_0":
        k[0] = -1
    elif case == "l_above_n":
        l[0] = n + 1
    elif case == "k_above_l":
        k[1] = 10
    elif case == "dtype":
        k, l = k.long(), l.long()
    elif case == "device":
        k, l = k.to("meta"), l.to("meta")
    elif case == "shape":
        l = l[:2]
    else:
        rb = runblock.RunBlockIndex.from_dense(corpus_index, "cpu", cache=None)
        for a, b in zip(kount.kount_rank_cuda(rb, k, l), kount.kount_rank_plain(idx, k, l)):
            assert torch.equal(a, b)
        idx = OtherLayout(rb)
    before = dict(kount.kount_rank_cuda.launches)
    with pytest.raises(ValueError):
        kount.kount_rank_cuda(idx, k, l)
    assert dict(kount.kount_rank_cuda.launches) == before


def test_kount_rank_cpu_takes_plain(corpus_index):  # noqa: F811
    """On CPU tensors the wrapper gives the plain version's counts, N = 0
    included, and counts no launch."""
    idx = OccIndex.from_dense(corpus_index, "cpu")
    k = torch.tensor([0, 0, 64, idx.n], dtype=torch.int32)
    l = torch.tensor([idx.n, 63, 130, idx.n], dtype=torch.int32)
    before = dict(kount.kount_rank_cuda.launches)
    for a, b in zip(kount.kount_rank_cuda(idx, k, l), kount.kount_rank_plain(idx, k, l)):
        assert torch.equal(a, b)
    ok, size = kount.kount_rank_cuda(idx, k[:0], l[:0])
    assert ok.shape == size.shape == (4, 0)
    assert dict(kount.kount_rank_cuda.launches) == before


KOUNT_HOST = """
#include "kount.cu"
#define KOUNT_ALL(name, L)                                                                                        \\
  extern "C" void kount_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int ms,       \\
                               int bs, const void* k, const void* l, int64_t n, void* ok, void* size) {             \\
    using T = L::T;                                                                                                \\
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                       \\
    for (int64_t t = 0; t < n; ++t)                                                                                \\
      rb3c::kount::kount_node<T>(ix, static_cast<const T*>(k), static_cast<const T*>(l), n, t, static_cast<T*>(ok), \\
                                 static_cast<T*>(size));                                                           \\
  }
RB3C_LAYOUTS(KOUNT_ALL)
"""


@pytest.fixture(scope="module")
def kount_host(tmp_path_factory):
    """csrc/kount.cu's node routine (the text before `#ifdef __CUDACC__`)
    built for the host with g++, one node after another."""
    d = tmp_path_factory.mktemp("kount_host")
    (d / "kount_host.cpp").write_text(HOST_SHIM[: HOST_SHIM.index('#include "rb.cuh"')] + KOUNT_HOST)
    so = d / "libkount_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so), str(d / "kount_host.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("case", ["frontier", "random", "edges"])
@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32", "rb64"])
def test_kount_cu_on_the_host(kount_host, corpus_index, layout, case):  # noqa: F811
    """The card's node routine of each layout, built for the host, equals
    kount_rank_plain on every level's frontier, on random unsorted (k, l)
    pairs, and on the edges: 0, n, and both sides of every row, block and
    megablock boundary (multiples of 64)."""
    idx = occ_index(corpus_index, layout)
    n, rng = idx.n, np.random.default_rng(17)
    if case == "frontier":
        pairs = [(ks[0], ls[0]) for ks, ls, _ in frontiers([idx])]
    elif case == "random":
        a, b = rng.integers(0, n + 1, (2, 50_000))
        pairs = [tuple(torch.from_numpy(v).to(idx.dtype) for v in (np.minimum(a, b), np.maximum(a, b)))]
    else:
        e = np.unique(np.clip(np.concatenate([np.arange(0, n + 1, 64) + d for d in (-1, 0, 1)] + [[0, n]]), 0, n))
        pairs = [(torch.from_numpy(e).to(idx.dtype), torch.from_numpy(np.full_like(e, n)).to(idx.dtype)),
                 (torch.zeros(len(e), dtype=idx.dtype), torch.from_numpy(e).to(idx.dtype))]
    fn = getattr(kount_host, f"kount_{layout}")
    fn.argtypes = [*kernels._TABLES, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    for k, l in pairs:
        k, l = k.contiguous(), l.contiguous()
        ok, size = (torch.empty((4, len(k)), dtype=idx.dtype) for _ in range(2))
        fn(*idx.kernel_tables(), k.data_ptr(), l.data_ptr(), len(k), ok.data_ptr(), size.data_ptr())
        want_ok, want_size = kount.kount_rank_plain(idx, k, l)
        assert torch.equal(ok, want_ok) and torch.equal(size, want_size)


def test_level_stats_counts_rows_and_bytes(corpus_index):  # noqa: F811
    """kount_time's bound counts each distinct row once (48 B), k and l in
    the rows' width, four ok and four size words a node; occ_rank1a's,
    int64 positions and six counts a position; row fetches are the
    distinct rows of each warp of 32 positions (occ_rank1a) or nodes
    (kount_rank)."""
    idx = OccIndex.from_dense(corpus_index, "cpu")
    k = torch.tensor([0, 64, 128] + [640] * 30, dtype=torch.int32)
    l = torch.tensor([10, 70, 300] + [700] * 30, dtype=torch.int32)
    st = level_stats(idx, k, l, torch.arange(len(k)))
    assert st["nodes"] == 33 and st["rows"] == 5  # rows 0, 1, 2, 4, 10
    # C: node warps 0..31 (rows 0, 1, 2, 4, 10) and 32 (10); B, the
    # positions k then l: warps k 0..31 (0, 1, 2, 10), k 32 and l 0..30
    # (10, 0, 1, 4), l 31..32 (10)
    assert st["warp_rows"] == {"A": 9, "B": 9, "C": 6}
    assert st["bytes"]["C"] == 5 * 48 + 2 * 33 * 4 + 8 * 33 * 4
    assert st["bytes"]["A"] == st["bytes"]["B"] == 5 * 48 + 66 * 8 + 66 * 6 * 4
