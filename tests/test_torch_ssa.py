"""The port's SSA generation (ropebwt3_tpu_torch/ssa_ops.py) and its LF step
(ops/rank.py `sym_at`, `lf`) against the JAX package: `ssa_gen_device` run
on the CPU, the native engine `ssa_gen_native`, the numpy `ssa_gen` and
`DenseFMIndex.lf`.  Dense rows in int32 and in int64 megablock mode with the
megablocks shrunk.  SSA files: byte-equal; LF: exact at every k."""

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.formats.ssa import write_ssa_bytes
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.ssa_ops import ssa_gen as ssa_gen_np
from ropebwt3_tpu.ssa_ops import ssa_gen_device, ssa_gen_native
from ropebwt3_tpu_torch import ssa_ops
from ropebwt3_tpu_torch.ops import rank, runblock

from .test_torch_cuda import corpus_index, short_seqs_index  # noqa: F401  (fixture reuse)

INPUTS = ("tiny", "corpus", "m64", "m65")
MEGA_SHIFT = 6  # int64 rows: megablocks of 64 symbols, one per row


def tiny_index():
    """test_ssa_props.py's `tiny`: 9 random sequences of 30-120 bases."""
    rng = np.random.default_rng(7)
    parts = []
    for s in [rng.integers(1, 5, int(rng.integers(30, 120))).astype(np.uint8) for _ in range(9)]:
        parts += [s, np.zeros(1, np.uint8)]
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts), backend="numpy"))


@pytest.fixture(scope="module")
def indexes(corpus_index):
    """tiny; the double-strand corpus; 64 and 65 short sequences, where ms
    (the least ms >= 1 with 2^ms >= m) is 6 and then 7."""
    return {"tiny": tiny_index(), "corpus": corpus_index, "m64": short_seqs_index(64, lo=5, hi=60),
            "m65": short_seqs_index(65, lo=5, hi=60)}


@pytest.mark.parametrize("ss", [2, 3, 4, 8])
@pytest.mark.parametrize("which", INPUTS)
def test_ssa_matches_jax_native_numpy(indexes, which, ss):
    f = indexes[which]
    want = write_ssa_bytes(ssa_gen_native(f, ss))
    assert write_ssa_bytes(ssa_gen_device(f, ss)) == want
    assert write_ssa_bytes(ssa_gen_np(f, ss)) == want
    for occ in (rank.OccIndex.from_dense(f, "cpu"), rank.OccIndex.from_dense(f, "cpu", int64=True, mega_shift=MEGA_SHIFT)):
        assert write_ssa_bytes(ssa_ops.ssa_gen(f, ss, occ=occ)) == want, occ.layout
    assert ssa_ops.ssa_gen_cuda.launches.total() == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("int64", [False, True], ids=["dense32", "dense64"])
@pytest.mark.parametrize("which", INPUTS)
def test_lf_at_every_k(indexes, which, int64):
    f = indexes[which]
    idx = rank.OccIndex.from_dense(f, "cpu", int64=int64, mega_shift=MEGA_SHIFT)
    k = np.arange(f.n)
    c, nk = f.lf(k)
    assert np.array_equal(idx.sym_at(torch.from_numpy(k)).numpy(), f.bwt[: f.n])
    got_c, got_nk = rank.lf(idx, torch.from_numpy(k))
    assert np.array_equal(got_c.numpy(), c) and np.array_equal(got_nk.numpy(), nk)


def test_plain_walk_arrays(indexes):
    """The four arrays of one walk: each lane dies at its length + 1 on a
    sentinel rank below m, and every slot that a lane hit is sampled."""
    f = indexes["tiny"]
    m = int(f.acc[1])
    ssa_l, ssa_lane, death_l, final_k = ssa_ops.ssa_gen_plain(rank.OccIndex.from_dense(f, "cpu"), m, 3)
    assert sorted(final_k.tolist()) == list(range(m))
    assert int(death_l.sum()) == f.n  # every row is visited once
    assert ssa_l.shape == ssa_lane.shape == ((f.n - m + 7) >> 3,)
    assert bool((ssa_lane >= 0).all()) and bool((ssa_l >= 1).all())


def test_walk_checks_bounds(indexes):
    f = indexes["tiny"]
    idx = rank.OccIndex.from_dense(f, "cpu")
    m = int(f.acc[1])
    with pytest.raises(ValueError):
        ssa_ops.ssa_gen_cuda(idx, m + 1, 3)
    with pytest.raises(ValueError):
        ssa_ops.ssa_gen_cuda(idx, m, ssa_ops.MAX_SHIFT + 1)
    with pytest.raises(TypeError):  # rb rows are not walked yet
        ssa_ops.ssa_gen_cuda(runblock.RunBlockIndex.from_dense(f, "cpu", cache=None), m, 3)
