"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports no jax, so it runs on a machine with a CUDA card and no
JAX: `python -m pytest tests/test_torch_cuda.py -q`.  Without a card every
test here skips.  Its fixtures and helpers (the corpus index built with the
repo's own index build) are shared with the other tests/test_torch_*.py files.
"""

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.nt6 import char2nt6, revcomp
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch.ops import rank, smem


@pytest.fixture(scope="module")
def corpus_index(corpus):
    """Double-strand index of the 8 x 8 kb corpus genomes: each genome then
    its reverse complement, 0-terminated (as seqio.read_batch_nt6 lays them)."""
    parts = []
    for rec in read_seqs(str(corpus / "genomes.fa")):
        s = char2nt6(rec.seq)
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_intervals(rng, n, size):
    """Bi-intervals (x0, x1, s) whose primary span lies in [0, n] in both
    directions, so either endpoint may be the one ranked."""
    lo = rng.integers(0, n + 1, size)
    s = np.minimum(rng.integers(0, n + 1 - lo), rng.integers(0, 2000, size))
    hi = rng.integers(0, n + 1 - s)
    return np.stack([lo, hi, s], axis=1).astype(np.int64)


def flat_of(qs):
    """Reads as (flat uint8, seq_off int64) CPU tensors."""
    flat, seq_off = smem.pack_reads(qs)
    return torch.from_numpy(flat), torch.from_numpy(seq_off)


def assert_same_mems(m1, n1, m2, n2, M):
    """Equal true counts, and equal rows in the min(n, M) filled slots."""
    assert np.array_equal(n1, n2)
    for t in range(len(n1)):
        k = min(int(n1[t]), M)
        assert np.array_equal(m1[t, :k], m2[t, :k]), t


@pytest.mark.cuda
def test_occ_kernels_match_plain(corpus_index, cuda_device):
    cpu = rank.OccIndex.from_dense(corpus_index, "cpu")
    gpu = rank.OccIndex.from_dense(corpus_index, cuda_device)
    rng = np.random.default_rng(5)
    k = torch.from_numpy(np.concatenate([[0, corpus_index.n], rng.integers(0, corpus_index.n + 1, 100_000)]).astype(np.int64))
    assert torch.equal(rank.rank1a_cuda(gpu, k.to(cuda_device)).cpu(), rank.rank1a(cpu, k).int())
    ik = torch.from_numpy(random_intervals(rng, corpus_index.n, 100_000))
    c = torch.from_numpy(rng.integers(0, 6, len(ik)))
    back = torch.from_numpy(rng.random(len(ik)) < 0.5)
    got = rank.extend_c_cuda(gpu, ik.int().to(cuda_device), c.int().to(cuda_device), back.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), rank.extend_c(cpu, ik, c, back).int())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [16, 2])
def test_smem_kernel_matches_plain(corpus, corpus_index, cuda_device, M):
    """M = 2 makes reads overflow: the kernel must keep the true count and
    the latest emit in the last slot, as the plain version does."""
    reads = [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))]
    qs = [r[: 21 + 7 * (i % 19)] for i, r in enumerate(reads * 8)] + [reads[0][:0]]
    flat, seq_off = flat_of(qs)
    cpu = rank.OccIndex.from_dense(corpus_index, "cpu")
    gpu = rank.OccIndex.from_dense(corpus_index, cuda_device)
    mk, nk = smem.smem_tg_cuda(gpu, flat.to(cuda_device), seq_off.to(cuda_device), min_occ=1, min_len=21, max_mems=M)
    torch.cuda.synchronize()
    mp, np_ = smem.smem_tg_plain(cpu, flat, seq_off, min_occ=1, min_len=21, max_mems=M)
    assert_same_mems(mk.cpu().numpy(), nk.cpu().numpy(), mp.numpy(), np_.numpy(), M)
