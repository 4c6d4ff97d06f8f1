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
from ropebwt3_tpu.formats.ssa import write_ssa_bytes
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.nt6 import char2nt6, revcomp
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu.ssa_ops import ssa_gen_native
from ropebwt3_tpu_torch import probe, ssa_ops
from ropebwt3_tpu_torch.ops import rank, runblock, smem

LAYOUTS = ("dense32", "dense64", "rb32", "rb64")


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


def make_index(layout, f, device):
    """The index of `layout` on `device`, int64 megablocks shrunk so the
    corpus index spans several."""
    if layout == "dense32":
        return rank.OccIndex.from_dense(f, device)
    if layout == "dense64":
        return rank.OccIndex.from_dense(f, device, int64=True, mega_shift=6)
    if layout == "rb32":
        return runblock.RunBlockIndex.from_dense(f, device, cache=None)
    return runblock.RunBlockIndex.from_dense(f, device, S=256, int64=True, mega_shift=2, cache=None)


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
@pytest.mark.parametrize("layout", LAYOUTS[1:])
def test_occ_kernels_match_plain_layouts(corpus_index, cuda_device, layout):
    """Every rank position in [0, n] (block boundaries, k = n) and random
    intervals, on the other layouts."""
    cpu, gpu = make_index(layout, corpus_index, "cpu"), make_index(layout, corpus_index, cuda_device)
    assert gpu.layout == layout
    k = torch.arange(corpus_index.n + 1)
    rank.rank1a_cuda.launches.clear()
    assert torch.equal(rank.rank1a_cuda(gpu, k.to(cuda_device)).cpu(), rank.rank1a(cpu, k).to(cpu.dtype))
    rng = np.random.default_rng(6)
    ik = torch.from_numpy(random_intervals(rng, corpus_index.n, 100_000)).to(cpu.dtype)
    c = torch.from_numpy(rng.integers(0, 6, len(ik))).int()
    back = torch.from_numpy(rng.random(len(ik)) < 0.5)
    got = rank.extend_c_cuda(gpu, ik.to(cuda_device), c.to(cuda_device), back.to(cuda_device))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), rank.extend_c(cpu, ik, c, back).to(cpu.dtype))
    assert rank.rank1a_cuda.launches[layout] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("M", [16, 2])
def test_smem_kernel_matches_plain(corpus, corpus_index, cuda_device, M, layout):
    """M = 2 makes reads overflow: the kernel must keep the true count and
    the latest emit in the last slot, as the plain version does."""
    reads = [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))]
    qs = [r[: 21 + 7 * (i % 19)] for i, r in enumerate(reads * 8)] + [reads[0][:0]]
    flat, seq_off = flat_of(qs)
    cpu, gpu = make_index(layout, corpus_index, "cpu"), make_index(layout, corpus_index, cuda_device)
    mk, nk = smem.smem_tg_cuda(gpu, flat.to(cuda_device), seq_off.to(cuda_device), min_occ=1, min_len=21, max_mems=M)
    torch.cuda.synchronize()
    mp, np_ = smem.smem_tg_plain(cpu, flat, seq_off, min_occ=1, min_len=21, max_mems=M)
    assert mk.dtype == mp.dtype == gpu.dtype
    assert_same_mems(mk.cpu().numpy(), nk.cpu().numpy(), mp.numpy(), np_.numpy(), M)


@pytest.mark.cuda
@pytest.mark.parametrize("S,int64", [(8192, False), (1024, True)])
def test_smem_kernel_run_coded_rows(cuda_device, S, int64):
    """rb rows where run-coded blocks dominate (150 near-identical copies; at
    S = 8192 one block of 110 escapes): the record scan, and at S = 8192 the
    wrapped record ends (F4), under the SMEM kernel."""
    rng = np.random.default_rng(11)
    base = rng.integers(1, 5, 3000).astype(np.uint8)
    parts = []
    for _ in range(150):
        s = base.copy()
        mut = rng.random(len(s)) < 0.0002
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    f = DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))
    kw = dict(S=S, int64=int64, mega_shift=2 if int64 else None, cache=None)
    cpu, gpu = runblock.RunBlockIndex.from_dense(f, "cpu", **kw), runblock.RunBlockIndex.from_dense(f, cuda_device, **kw)
    assert 2 * cpu.n_esc < cpu.rows.shape[0]
    qs = []
    for _ in range(500):
        st = int(rng.integers(0, len(base) - 150))
        r = base[st : st + 150].copy()
        mut = rng.random(150) < 0.02
        r[mut] = rng.integers(1, 5, int(mut.sum()))
        qs.append(r)
    flat, seq_off = flat_of(qs)
    mk, nk = smem.smem_tg_cuda(gpu, flat.to(cuda_device), seq_off.to(cuda_device), min_occ=1, min_len=19, max_mems=16)
    torch.cuda.synchronize()
    mp, np_ = smem.smem_tg_plain(cpu, flat, seq_off, min_occ=1, min_len=19, max_mems=16)
    assert_same_mems(mk.cpu().numpy(), nk.cpu().numpy(), mp.numpy(), np_.numpy(), 16)
    k = torch.arange(f.n + 1)
    assert torch.equal(rank.rank1a_cuda(gpu, k.to(cuda_device)).cpu(), rank.rank1a(cpu, k).to(cpu.dtype))


def short_seqs_index(m, seed=9, lo=20, hi=200):
    """Single-strand index of m random sequences of lo..hi bases."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(m):
        parts += [rng.integers(1, 5, int(rng.integers(lo, hi))).astype(np.uint8), np.zeros(1, np.uint8)]
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
@pytest.mark.parametrize("which", ["corpus", "many"])
def test_ssa_kernel_matches_plain(corpus_index, cuda_device, layout, which):
    """ssa_gen's four arrays from the kernel equal the lock-step plain
    version's, and the SSA equals the native engine's, at ss 0, 3 and 8."""
    f = corpus_index if which == "corpus" else short_seqs_index(3000)
    cpu, gpu = make_index(layout, f, "cpu"), make_index(layout, f, cuda_device)
    m = int(f.acc[1])
    for ss in (0, 3, 8):
        got = ssa_ops.ssa_gen_cuda(gpu, m, ss)
        torch.cuda.synchronize()
        want = ssa_ops.ssa_gen_plain(cpu, m, ss)
        assert torch.equal(got[1].cpu(), want[1])
        filled = want[1] >= 0
        assert torch.equal(got[0].cpu().long()[filled], want[0][filled])
        assert torch.equal(got[2].cpu().long(), want[2]) and torch.equal(got[3].cpu().long(), want[3])
        assert write_ssa_bytes(ssa_ops.ssa_gen(f, ss, occ=gpu)) == write_ssa_bytes(ssa_gen_native(f, ss))
    assert ssa_ops.ssa_gen_cuda.launches[layout] >= 6


@pytest.mark.cuda
@pytest.mark.parametrize("cols", probe.ROW_COLS)
def test_probe_gather_kernels_match_plain(cuda_device, cols):
    """Both gather kernels in every mode, exact against gather_plain: a
    shared-memory table of 300 rows and a device-memory table of 100,000,
    q = 1,000 lanes (a ragged last block), iters 0, 1, 9 and 200."""
    g = torch.Generator().manual_seed(cols)
    for fn, nb in ((probe.smem_gather_cuda, 300), (probe.hbm_gather_cuda, 100_000)):
        tab = torch.randint(-(1 << 31), 1 << 31, (nb, cols), dtype=torch.int64, generator=g).int()
        idx0 = torch.randint(0, nb, (1000,), dtype=torch.int32, generator=g)
        for mode in probe.MODES:
            for iters in (0, 1, 9, 200):
                got = fn(tab.to(cuda_device), idx0.to(cuda_device), iters, mode)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), probe.gather_plain(tab, idx0, iters, mode)), (fn.__name__, mode, iters)


@pytest.mark.cuda
def test_probe_smem_capacity(cuda_device):
    """48 KB and the opt-in limit run with P4's sum; one row past it is refused."""
    top = probe.smem_optin(cuda_device) // 512 * 512
    for nbytes in (48 << 10, top):
        out, err = probe.smem_capacity_cuda(nbytes, cuda_device)
        assert err is None and torch.equal(out.cpu(), probe.smem_capacity_plain(nbytes))
    out, err = probe.smem_capacity_cuda(top + 512, cuda_device)
    assert out is None and err
    x = torch.ones(4, device=cuda_device)  # the refusal left no error behind
    assert float((x + x).sum()) == 8.0
