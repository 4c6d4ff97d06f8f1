"""The port's occ rows and plain rank/extend (ropebwt3_tpu_torch/ops/rank.py)
against the JAX package's ops/rank.py and the numpy DenseFMIndex, on the
corpus index built with the repo's own index build.  Integer outputs: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.ops import rank as jrank
from ropebwt3_tpu_torch.ops import rank as trank

from .test_torch_cuda import corpus_index, random_intervals  # noqa: F401  (fixture reuse)


@pytest.fixture(scope="module")
def jax_index(corpus_index):
    # the 12-column int32 layout the port mirrors (not the prefix-occ rows)
    return jrank.DeviceIndex.from_dense(corpus_index, prefix=False)


@pytest.fixture(scope="module")
def occ_index(corpus_index):
    return trank.OccIndex.from_dense(corpus_index, "cpu")


def test_occf_matches_jax(corpus_index, jax_index):
    nb = len(corpus_index.occ_block)
    blocks = corpus_index.bwt[: nb * 64].reshape(nb, 64)
    assert np.array_equal(trank.pack_bitplanes(blocks), jrank.pack_bitplanes(blocks))
    occf = trank.build_occf(corpus_index)
    assert occf.dtype == np.int32 and occf.shape == (nb, 12)
    assert np.array_equal(occf, np.asarray(jax_index.occf))


def test_from_jax_arrays_round_trip(corpus_index, jax_index, occ_index):
    got = trank.OccIndex.from_jax_arrays(np.asarray(jax_index.occf), np.asarray(jax_index.acc), jax_index.n, "cpu")
    assert got.n == occ_index.n == corpus_index.n
    assert got.occf.dtype == torch.int32 and got.acc.dtype == torch.int32
    assert torch.equal(got.occf, occ_index.occf) and torch.equal(got.acc, occ_index.acc)
    assert got.device == torch.device("cpu")
    with pytest.raises(ValueError):  # prefix-occ rows are not the port's layout
        trank.OccIndex.from_jax_arrays(np.zeros((got.occf.shape[0], 18), np.int32), np.asarray(jax_index.acc), jax_index.n, "cpu")


def test_rank1a(corpus_index, jax_index, occ_index):
    n = corpus_index.n
    k = np.concatenate([[0, n, n - 1, 63, 64, 65], np.random.default_rng(1).integers(0, n + 1, 4000)]).astype(np.int64)
    got = trank.rank1a(occ_index, torch.from_numpy(k)).numpy()
    assert np.array_equal(got, np.asarray(jrank.rank1a(jax_index, jnp.asarray(k))).astype(np.int64))
    assert np.array_equal(got, corpus_index.rank1a(k))
    assert np.array_equal(got[1], corpus_index.acc[1:] - corpus_index.acc[:-1])  # rank(n) = totals
    # the kernel wrapper takes the plain version for a CPU tensor
    assert np.array_equal(trank.rank1a_cuda(occ_index, torch.from_numpy(k)).numpy(), got)


def test_extend(corpus_index, jax_index, occ_index):
    rng = np.random.default_rng(2)
    ik = random_intervals(rng, corpus_index.n, 3000)
    back = rng.random(len(ik)) < 0.5
    got = trank.extend(occ_index, torch.from_numpy(ik), torch.from_numpy(back)).numpy()
    want = np.asarray(jrank.extend(jax_index, jnp.asarray(ik), jnp.asarray(back))).astype(np.int64)
    assert np.array_equal(got, want)
    for b in (True, False):
        assert np.array_equal(got[back == b], corpus_index.extend(ik[back == b], b))


@pytest.mark.parametrize("is_back", [True, False])
def test_extend_c(corpus_index, jax_index, occ_index, is_back):
    rng = np.random.default_rng(3 + is_back)
    ik = random_intervals(rng, corpus_index.n, 3000)
    c = rng.integers(0, 6, len(ik))
    back = np.full(len(ik), is_back)
    got = trank.extend_c(occ_index, torch.from_numpy(ik), torch.from_numpy(c), torch.from_numpy(back)).numpy()
    want = np.asarray(jrank.extend_c(jax_index, jnp.asarray(ik), jnp.asarray(c, jnp.int32), jnp.asarray(back)))
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(got, corpus_index.extend(ik, is_back)[np.arange(len(ik)), c])
    wrapped = trank.extend_c_cuda(
        occ_index, torch.from_numpy(ik).int(), torch.from_numpy(c).int(), torch.from_numpy(back)
    )
    assert np.array_equal(wrapped.numpy(), got)


def test_extend_c_cuda_rejects_bad_input(occ_index):
    ik = torch.tensor([[0, 0, occ_index.n + 1]], dtype=torch.int32)
    with pytest.raises(ValueError):  # interval past the end of the BWT
        trank.extend_c_cuda(occ_index, ik, torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError):  # not an nt6 code
        trank.extend_c_cuda(occ_index, ik * 0, torch.full((1,), 6, dtype=torch.int32), torch.ones(1, dtype=torch.bool))


def test_set_intv(corpus_index, jax_index, occ_index):
    c = np.arange(6)
    got = trank.set_intv(occ_index, torch.from_numpy(c)).numpy()
    assert np.array_equal(got, np.asarray(jrank.set_intv(jax_index, jnp.asarray(c, jnp.int32))).astype(np.int64))
    assert np.array_equal(got, np.stack([corpus_index.set_intv(int(s)) for s in c]))


def test_int64_index_is_refused():
    f = DenseFMIndex.from_bwt(np.array([1, 0], np.uint8))
    f.n = trank.MAX_N_INT32
    with pytest.raises(ValueError):
        trank.OccIndex.from_dense(f, "cpu")
