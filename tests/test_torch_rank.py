"""The port's occ rows and plain rank/extend (ropebwt3_tpu_torch/ops/rank.py)
against the JAX package's ops/rank.py and the numpy DenseFMIndex, on the
corpus index built with the repo's own index build, in int32 and in int64
megablock mode (megablocks shrunk on both sides so the corpus spans many).
Integer outputs: exact."""

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
    occf, mega = trank.build_occf(corpus_index)
    assert occf.dtype == np.int32 and occf.shape == (nb, 12) and mega is None
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


def test_int64_index_is_refused(monkeypatch):
    """int64 megablock rows are selected from MAX_N_INT32 symbols on, as the
    JAX package does; int32 rows are refused there."""
    assert trank.needs_int64(trank.MAX_N_INT32) and not trank.needs_int64(trank.MAX_N_INT32 - 1)
    f = DenseFMIndex.from_bwt(np.array([1, 0, 4, 0], np.uint8))
    monkeypatch.setattr(trank, "MAX_N_INT32", f.n)
    idx = trank.OccIndex.from_dense(f, "cpu")
    assert idx.int64 and idx.layout == "dense64" and idx.dtype == torch.int64 and idx.mega.dtype == torch.int64
    assert np.array_equal(idx.rank1a(torch.arange(f.n + 1)).numpy(), f.rank1a(np.arange(f.n + 1)))
    occf, _ = trank.build_occf(f)
    with pytest.raises(ValueError):  # int32 rows at that size
        trank.OccIndex.from_jax_arrays(occf, f.acc, f.n, "cpu")


MEGA_SHIFT = 6  # 4096-symbol megablocks: the corpus index spans ~32


@pytest.fixture(scope="module")
def jax_index64(corpus_index):
    """The JAX int64 DeviceIndex with MEGA_SHIFT megablocks.  The JAX package
    reads MEGA_BLOCK_SHIFT when it builds the rows and again when it ranks,
    so a test that ranks on this index patches it too."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrank, "MEGA_BLOCK_SHIFT", MEGA_SHIFT)
        return jrank.DeviceIndex.from_dense(corpus_index, idx_dtype=jnp.int64, prefix=False)


@pytest.fixture(scope="module")
def occ_index64(corpus_index):
    return trank.OccIndex.from_dense(corpus_index, "cpu", int64=True, mega_shift=MEGA_SHIFT)


def test_occf_int64_matches_jax(corpus_index, jax_index64, occ_index64):
    assert occ_index64.layout == "dense64" and occ_index64.acc.dtype == torch.int64
    assert np.array_equal(occ_index64.occf.numpy(), np.asarray(jax_index64.occf))
    assert np.array_equal(occ_index64.mega.numpy(), np.asarray(jax_index64.occ_super))
    assert occ_index64.mega.shape[0] > 8
    # relative counts past 2^31 would be negative int32: none may be sign-extended
    got = trank.OccIndex.from_jax_arrays(np.asarray(jax_index64.occf), np.asarray(jax_index64.acc), jax_index64.n, "cpu",
                                         mega=np.asarray(jax_index64.occ_super), mega_shift=MEGA_SHIFT)
    assert torch.equal(got.occf, occ_index64.occf) and torch.equal(got.mega, occ_index64.mega)


def test_int64_rank_extend_match_jax(monkeypatch, corpus_index, jax_index64, occ_index64):
    monkeypatch.setattr(jrank, "MEGA_BLOCK_SHIFT", MEGA_SHIFT)
    n = corpus_index.n
    k = np.concatenate([np.arange(0, n + 1, 4096), np.arange(4090, 4100), [n - 1, n],
                        np.random.default_rng(7).integers(0, n + 1, 4000)]).astype(np.int64)
    got = trank.rank1a(occ_index64, torch.from_numpy(k)).numpy()
    assert np.array_equal(got, np.asarray(jrank.rank1a(jax_index64, jnp.asarray(k))))
    assert np.array_equal(got, corpus_index.rank1a(k))
    assert np.array_equal(trank.rank1a_cuda(occ_index64, torch.from_numpy(k)).numpy(), got)
    rng = np.random.default_rng(8)
    ik = random_intervals(rng, n, 3000)
    back = rng.random(len(ik)) < 0.5
    c = rng.integers(0, 6, len(ik))
    got = trank.extend(occ_index64, torch.from_numpy(ik), torch.from_numpy(back)).numpy()
    assert np.array_equal(got, np.asarray(jrank.extend(jax_index64, jnp.asarray(ik), jnp.asarray(back))))
    got = trank.extend_c(occ_index64, torch.from_numpy(ik), torch.from_numpy(c), torch.from_numpy(back)).numpy()
    want = np.asarray(jrank.extend_c(jax_index64, jnp.asarray(ik), jnp.asarray(c, jnp.int32), jnp.asarray(back)))
    assert np.array_equal(got, want)
    wrapped = trank.extend_c_cuda(occ_index64, torch.from_numpy(ik), torch.from_numpy(c).int(), torch.from_numpy(back))
    assert wrapped.dtype == torch.int64 and np.array_equal(wrapped.numpy(), want)
    got = trank.set_intv(occ_index64, torch.arange(6)).numpy()
    assert np.array_equal(got, np.asarray(jrank.set_intv(jax_index64, jnp.arange(6, dtype=jnp.int32))))
