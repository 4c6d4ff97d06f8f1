"""The port's suffix sort (ropebwt3_tpu_torch/construct/sa.py, K7's plain
passes on the CPU) and its row builder `OccIndex.from_bwt` against the JAX
package: the BWT of `gsa_bwt_jax` (XLA, on the CPU) and of the native SA-IS,
the suffix array of the numpy prefix doubling, and `build_occf` of the dense
host index, in int32 and in int64 megablock mode.  Every comparison is exact
(tolerance 0): inputs from a numpy seed."""

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct import sa as jsa
from ropebwt3_tpu.construct.sa_jax import gsa_bwt_jax
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.nt6 import char2nt6, revcomp
from ropebwt3_tpu.ops import rank as jrank
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch.construct import sa as tsa
from ropebwt3_tpu_torch.ops import rank as trank


def strands(seqs) -> np.ndarray:
    """The construction batch of `seqs`: each forward, then its reverse
    complement, 0-terminated (seqio.read_batch_nt6's layout)."""
    z = np.zeros(1, np.uint8)
    return np.concatenate([x for s in seqs for x in (s, z, revcomp(s), z)])


@pytest.fixture(scope="module")
def batches(corpus):
    rng = np.random.default_rng(17)
    genomes = [char2nt6(r.seq) for r in read_seqs(str(corpus / "genomes.fa"))]
    odd = []  # empty records, N runs, a record of N only, short ones
    for ln in (0, 35, 0, 1, 120, 7, 0):
        s = rng.integers(1, 5, ln).astype(np.uint8)
        if ln > 20:
            s[rng.integers(0, ln - 10) :][:10] = 5
        odd.append(s)
    odd.append(np.full(12, 5, np.uint8))
    return {
        "genomes": strands(genomes),
        "empty_and_N": strands(odd),
        "one_record": np.concatenate([genomes[0][:3000], np.zeros(1, np.uint8)]),
    }


@pytest.mark.parametrize("name", ["genomes", "empty_and_N", "one_record"])
def test_gsa_bwt_matches_jax_and_native(batches, name):
    seq = batches[name]
    launched = sum(tsa.SA_LAUNCHES.values())
    bwt, sa = tsa.gsa_bwt(seq, "cpu")
    assert sum(tsa.SA_LAUNCHES.values()) == launched  # the CPU runs the plain passes
    assert bwt.dtype == torch.uint8 and sa.dtype == torch.int64
    want = jsa.gsa_bwt(seq, backend="native")
    assert np.array_equal(bwt.numpy(), want)
    assert np.array_equal(bwt.numpy(), gsa_bwt_jax(seq))
    assert np.array_equal(sa.numpy(), jsa.suffix_array_doubling(jsa._initial_ranks(seq)))


@pytest.mark.parametrize("name", ["genomes", "empty_and_N"])
def test_gsa_bwt_wide_path(monkeypatch, batches, name):
    """Two stable sorts (rank2, then rank) in place of the packed key, with
    the threshold shrunk below the batch: the same BWT and suffix array."""
    seq = batches[name]
    monkeypatch.setattr(tsa, "PACKED_MAX", 16)
    bwt, sa = tsa.gsa_bwt(seq, "cpu")
    assert np.array_equal(bwt.numpy(), jsa.gsa_bwt(seq, backend="native"))
    assert np.array_equal(sa.numpy(), jsa.suffix_array_doubling(jsa._initial_ranks(seq)))


def test_gsa_bwt_edges():
    one = np.zeros(1, np.uint8)
    assert np.array_equal(tsa.gsa_bwt(one, "cpu")[0].numpy(), one)
    assert tsa.gsa_bwt(np.zeros(0, np.uint8), "cpu")[0].numel() == 0
    with pytest.raises(ValueError):  # a batch ends with a separator
        tsa.gsa_bwt(np.array([1, 2, 0, 3], np.uint8), "cpu")


def test_round_passes_match_plain(batches):
    """The kernel wrappers on CPU tensors are the plain passes."""
    seq = torch.from_numpy(batches["empty_and_N"])
    rank = tsa.initial_ranks(seq)
    for k in (1, 4, 1000):
        assert torch.equal(tsa.sa_keys_cuda(rank, k, True), tsa.sa_keys_plain(rank, k, True))
        assert torch.equal(tsa.sa_keys_cuda(rank, k, False), tsa.sa_keys_plain(rank, k, False))
    key = tsa.sa_keys_plain(rank, 2, True)
    assert torch.equal(tsa.sa_flags_cuda(key, rank), tsa.sa_flags_plain(key, rank))
    with pytest.raises(ValueError):
        tsa.sa_keys_cuda(rank.int(), 1, True)


def jax_occf(f: DenseFMIndex, int64: bool, shift: int, monkeypatch):
    monkeypatch.setattr(jrank, "MEGA_BLOCK_SHIFT", shift)
    return jrank.build_occf(f, int64=int64)


@pytest.mark.parametrize("n", [64 * 300, 64 * 300 + 17, 40])
@pytest.mark.parametrize("int64", [False, True])
def test_occ_from_bwt_matches_build_occf(monkeypatch, n, int64):
    """Rows built from a BWT tensor equal the host build's bit for bit: the
    padded last block, the extra row, and in int64 mode the megablocks
    (shrunk to 4 rows, so the BWT spans many)."""
    rng = np.random.default_rng(n)
    bwt = rng.integers(0, 6, n).astype(np.uint8)
    f = DenseFMIndex.from_bwt(bwt)
    shift = 2 if int64 else trank.MEGA_BLOCK_SHIFT
    idx = trank.OccIndex.from_bwt(torch.from_numpy(bwt), int64=int64, mega_shift=shift)
    want, mega = jax_occf(f, int64, shift, monkeypatch)
    assert idx.occf.dtype == torch.int32 and np.array_equal(idx.occf.numpy(), want)
    assert np.array_equal(idx.acc.numpy(), f.acc) and idx.acc.dtype == (torch.int64 if int64 else torch.int32)
    assert idx.int64 == int64 and (mega is None) == (idx.mega is None)
    if int64:
        assert np.array_equal(idx.mega.numpy(), mega)
    same = trank.OccIndex.from_dense(f, "cpu", int64=int64, mega_shift=shift)
    assert torch.equal(same.occf, idx.occf) and torch.equal(same.acc, idx.acc)


def test_occ_from_bwt_chunks(monkeypatch):
    """Chunks of rows (shrunk to 3) give the one-chunk rows."""
    bwt = torch.from_numpy(np.random.default_rng(3).integers(0, 6, 64 * 10 + 5).astype(np.uint8))
    whole = trank.OccIndex.from_bwt(bwt, int64=True, mega_shift=1)
    monkeypatch.setattr(trank, "FROM_BWT_BLOCKS", 3)
    part = trank.OccIndex.from_bwt(bwt, int64=True, mega_shift=1)
    assert torch.equal(part.occf, whole.occf) and torch.equal(part.mega, whole.mega)
