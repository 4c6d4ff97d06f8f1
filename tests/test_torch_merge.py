"""The port's merge (ropebwt3_tpu_torch/construct/merge.py: lf2_table,
lf2_packed, merge_rank_plain, merge_apply, merge_plain) against the JAX
package's construct/merge.py (lf2_table, merge_rank_plain, the native
merge_rank_native and rb3t_lf2_packed, _merge_apply), on B1 rows built by
`OccIndex.from_bwt` in int32 and in int64 megablock mode.  Every comparison
is exact (tolerance 0): inputs from a numpy seed."""

import ctypes

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct import merge as jmerge
from ropebwt3_tpu.construct.sa import gsa_bwt as jgsa
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.native import get_sw_lib
from ropebwt3_tpu_torch.construct import merge as tmerge
from ropebwt3_tpu_torch.ops.rank import OccIndex

from .test_torch_construct import strands


def seqs(rng, m, lo, hi):
    return [rng.integers(1, 5, int(rng.integers(lo, hi))).astype(np.uint8) for _ in range(m)]


@pytest.fixture(scope="module")
def cases():
    """(B1 BWT, B2 BWT) pairs: many short sequences, a few long ones, and B2
    holding a single sequence (single strand)."""
    rng = np.random.default_rng(23)
    base = rng.integers(1, 5, 4000).astype(np.uint8)
    longs = []
    for _ in range(5):
        s = base.copy()
        mut = rng.random(len(s)) < 0.02
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        longs.append(s)
    one = np.concatenate([longs[4][:2500], np.zeros(1, np.uint8)])
    out = {
        "many_short": (strands(seqs(rng, 300, 0, 60)), strands(seqs(rng, 200, 0, 60))),
        "few_long": (strands(longs[:3]), strands(longs[3:])),
        "single_b2": (strands(longs[:2]), one),
    }
    return {k: (jgsa(a, backend="native"), jgsa(b, backend="native")) for k, (a, b) in out.items()}


def test_lf2_matches_jax(cases):
    for b1, b2 in cases.values():
        for x in (b1, b2):
            acc2, lf2 = tmerge.lf2_table(torch.from_numpy(x))
            want_acc2, want_lf2 = jmerge.lf2_table(x)
            assert np.array_equal(acc2.numpy(), want_acc2) and np.array_equal(lf2.numpy(), want_lf2)
            acc2, rec = tmerge.lf2_packed(torch.from_numpy(x))
            want = np.empty(len(x), np.int64)
            want_acc2 = np.zeros(7, np.int64)
            get_sw_lib().rb3t_lf2_packed(ctypes.c_void_p(x.ctypes.data), len(x), ctypes.c_void_p(want_acc2.ctypes.data),
                                         ctypes.c_void_p(want.ctypes.data))
            assert np.array_equal(rec.numpy(), want) and np.array_equal(acc2.numpy(), want_acc2)


@pytest.mark.parametrize("case", ["many_short", "few_long", "single_b2"])
@pytest.mark.parametrize("int64", [False, True], ids=["dense32", "dense64"])
def test_merge_rank_matches_jax(cases, case, int64):
    b1, b2 = cases[case]
    f1 = DenseFMIndex.from_bwt(b1)
    idx = OccIndex.from_bwt(torch.from_numpy(b1), int64=int64, mega_shift=2 if int64 else 26)
    assert idx.layout == ("dense64" if int64 else "dense32")
    acc2, rec = tmerge.lf2_packed(torch.from_numpy(b2))
    m2 = int(acc2[1])
    launched = sum(tmerge.merge_rank_cuda.launches.values())
    ins = tmerge.merge_rank_cuda(idx, rec, m2)  # a CPU index: the plain version
    assert ins is rec and sum(tmerge.merge_rank_cuda.launches.values()) == launched
    assert np.array_equal(ins.numpy(), jmerge.merge_rank_plain(f1, b2)[1])
    assert np.array_equal(ins.numpy(), jmerge.merge_rank_native(f1, b2)[1])


@pytest.mark.parametrize("case", ["many_short", "few_long", "single_b2"])
def test_merge_plain_matches_jax(cases, monkeypatch, case):
    """The merged BWT equals _merge_apply's, in merge_apply chunks shrunk to
    97 positions, and is the BWT of the two batches sorted as one."""
    b1, b2 = cases[case]
    f1 = DenseFMIndex.from_bwt(b1)
    want = jmerge._merge_apply(f1, b2, jmerge.merge_rank_native(f1, b2)[1])
    bwt1 = torch.from_numpy(b1)
    got = tmerge.merge_plain(OccIndex.from_bwt(bwt1), bwt1, b2)
    assert np.array_equal(got.numpy(), want.bwt[: want.n])
    monkeypatch.setattr(tmerge, "APPLY_CHUNK", 97)
    assert torch.equal(tmerge.merge_plain(OccIndex.from_bwt(bwt1), bwt1, torch.from_numpy(b2)), got)
    assert np.array_equal(got.numpy(), jmerge.merge_plain(f1, b2).bwt[: len(b1) + len(b2)])


def test_merge_apply_checks_ranks():
    bwt1, seq2 = torch.tensor([1, 0, 2], dtype=torch.uint8), torch.tensor([3, 0], dtype=torch.uint8)
    assert tmerge.merge_apply(bwt1, seq2, torch.tensor([0, 3])).tolist() == [3, 1, 0, 2, 0]
    for bad in ([2, 1], [0, 4], [-1, 0]):
        with pytest.raises(ValueError):
            tmerge.merge_apply(bwt1, seq2, torch.tensor(bad))
    empty = torch.zeros(0, dtype=torch.uint8)
    idx = OccIndex.from_bwt(bwt1)
    assert torch.equal(tmerge.merge_plain(idx, bwt1, empty), bwt1)
