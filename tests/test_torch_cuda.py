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
from ropebwt3_tpu_torch.construct import merge as tmerge
from ropebwt3_tpu_torch.construct import sa as tsa
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
    mk, nk = smem.smem_tg_cuda(gpu, flat.to(cuda_device), seq_off.to(cuda_device), min_occ=1, min_len=21, max_mems=M)[:2]
    torch.cuda.synchronize()
    mp, np_ = smem.smem_tg_plain(cpu, flat, seq_off, min_occ=1, min_len=21, max_mems=M)[:2]
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
    mk, nk = smem.smem_tg_cuda(gpu, flat.to(cuda_device), seq_off.to(cuda_device), min_occ=1, min_len=19, max_mems=16)[:2]
    torch.cuda.synchronize()
    mp, np_ = smem.smem_tg_plain(cpu, flat, seq_off, min_occ=1, min_len=19, max_mems=16)[:2]
    assert_same_mems(mk.cpu().numpy(), nk.cpu().numpy(), mp.numpy(), np_.numpy(), 16)
    k = torch.arange(f.n + 1)
    assert torch.equal(rank.rank1a_cuda(gpu, k.to(cuda_device)).cpu(), rank.rank1a(cpu, k).to(cpu.dtype))


def cut_reads(f, rng, n, lens, err):
    """n reads of lens[0]..lens[1] symbols cut from the index's first
    sequence, each symbol replaced by a random base with probability err."""
    g, _ = f.retrieve(0)
    out = []
    for _ in range(n):
        ln = int(rng.integers(*lens))
        st = int(rng.integers(0, len(g) - ln))
        r = g[st : st + ln].copy()
        mut = rng.random(ln) < err
        r[mut] = rng.integers(1, 5, int(mut.sum()))
        out.append(r)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_chunked_kernel_matches_plain(corpus_index, cuda_device, layout):
    """smem_tgc on lanes of 64 symbols with a 32-symbol margin, reads of
    1-5 kb at 1% error: every lane's rows, counts, START log and trips equal
    the plain version's; the stitched answer equals the CPU's."""
    reads = cut_reads(corpus_index, np.random.default_rng(21), 6, (1000, 5001), 0.01) + [np.zeros(0, np.uint8)]
    flat, seq_off = flat_of(reads)
    cpu, gpu = make_index(layout, corpus_index, "cpu"), make_index(layout, corpus_index, cuda_device)
    lanes = smem.chunk_lanes(seq_off, 64, 32)
    kw = dict(min_occ=1, min_len=19, max_mems=8, log_len=16, trips=True)
    got = smem.smem_tgc_cuda(gpu, flat.to(cuda_device), seq_off.to(cuda_device), lanes.to(cuda_device), **kw)
    torch.cuda.synchronize()
    want = smem.smem_tgc_cuda(cpu, flat, seq_off, lanes, **kw)
    assert_same_mems(got.mems.cpu().numpy(), got.n_mem.cpu().numpy(), want.mems.numpy(), want.n_mem.numpy(), 8)
    assert_same_mems(got.log.cpu().numpy()[..., None], got.n_log.cpu().numpy(), want.log.numpy()[..., None],
                     want.n_log.numpy(), 16)
    assert torch.equal(got.trips.cpu(), want.trips)
    out_gpu = smem.smem_tg(gpu, flat.to(cuda_device), seq_off.to(cuda_device), min_occ=1, min_len=19, chunk=64, margin=32)
    out_cpu = smem.smem_tg(cpu, flat, seq_off, min_occ=1, min_len=19, chunk=64, margin=32)
    assert torch.equal(out_gpu.counts.cpu(), out_cpu.counts) and torch.equal(out_gpu.rows.cpu(), out_cpu.rows)
    assert out_gpu[2:] == out_cpu[2:]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_chunked_reruns_on_card(corpus_index, cuda_device, layout):
    """Reads whose lanes do not meet (a 2-symbol margin at 5% error) rerun
    whole through smem_tg, and reads whose lanes overflow a 4-row buffer
    rerun through smem_tgc with a buffer of their true count: launches of
    the card's kernels, with the CPU's answer."""
    reads = cut_reads(corpus_index, np.random.default_rng(5), 4, (1000, 2001), 0.05)
    flat, seq_off = flat_of(reads)
    cpu, gpu = make_index(layout, corpus_index, "cpu"), make_index(layout, corpus_index, cuda_device)
    for kw in (dict(chunk=64, margin=2), dict(max_mems=4)):
        one, chunked = smem.smem_tg_cuda.launches[layout], smem.smem_tgc_cuda.launches[layout]
        out_gpu = smem.smem_tg(gpu, flat.to(cuda_device), seq_off.to(cuda_device), min_occ=1, min_len=19, **kw)
        out_cpu = smem.smem_tg(cpu, flat, seq_off, min_occ=1, min_len=19, **kw)
        assert torch.equal(out_gpu.counts.cpu(), out_cpu.counts) and torch.equal(out_gpu.rows.cpu(), out_cpu.rows)
        assert out_gpu[2:] == out_cpu[2:]
        if "margin" in kw:
            assert out_gpu.n_unmerged >= 1 and smem.smem_tg_cuda.launches[layout] > one
        else:
            assert out_gpu.n_rerun >= 1 and smem.smem_tgc_cuda.launches[layout] >= chunked + 2


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


def corpus_batch(corpus) -> np.ndarray:
    """The corpus genomes as one construction batch (each forward, then its
    reverse complement, 0-terminated)."""
    z = np.zeros(1, np.uint8)
    return np.concatenate([x for r in read_seqs(str(corpus / "genomes.fa")) for s in [char2nt6(r.seq)]
                           for x in (s, z, revcomp(s), z)])


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["packed", "wide"])
def test_sa_round_kernels_match_plain(corpus, cuda_device, monkeypatch, wide):
    """K7 on the card: the passes of csrc/sa_round.cu give the suffix array
    and BWT of the plain passes on the card, and the native SA-IS's BWT; the
    wide path (two stable sorts) with the threshold shrunk."""
    if wide:
        monkeypatch.setattr(tsa, "PACKED_MAX", 16)
    seq = corpus_batch(corpus)
    before = dict(tsa.SA_LAUNCHES)
    bwt, sa = tsa.gsa_bwt(seq, cuda_device)
    torch.cuda.synchronize()
    pbwt, psa = tsa.gsa_bwt_plain(torch.from_numpy(seq).to(cuda_device))
    assert torch.equal(sa, psa) and torch.equal(bwt, pbwt)
    assert np.array_equal(bwt.cpu().numpy(), gsa_bwt(seq, backend="native"))
    for name in ("sa_keys", "sa_flags", "sa_scatter", "sa_bwt"):
        assert tsa.SA_LAUNCHES[name] > before.get(name, 0), name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
@pytest.mark.parametrize("b2", ["many_short", "genomes"])
def test_merge_rank_kernel_matches_plain(corpus, corpus_index, cuda_device, layout, b2):
    """K6 on the card against merge_rank_plain on the card, exact: B1 the
    corpus index (its rows built on the card by OccIndex.from_bwt equal to
    the host build; dense64 with megablocks of 64 rows), B2 3,000 short
    sequences or the corpus genomes again, ins written apart from the
    records; then the merged BWT equals the CPU's."""
    b1 = torch.from_numpy(np.ascontiguousarray(corpus_index.bwt[: corpus_index.n]))
    int64 = layout == "dense64"
    idx = rank.OccIndex.from_bwt(b1.to(cuda_device), int64=int64, mega_shift=6 if int64 else rank.MEGA_BLOCK_SHIFT)
    ref = make_index(layout, corpus_index, "cpu")
    assert idx.layout == layout and torch.equal(idx.occf.cpu(), ref.occf) and torch.equal(idx.acc.cpu(), ref.acc)
    f2 = short_seqs_index(3000) if b2 == "many_short" else DenseFMIndex.from_bwt(gsa_bwt(corpus_batch(corpus)))
    seq2 = torch.from_numpy(np.ascontiguousarray(f2.bwt[: f2.n])).to(cuda_device)
    acc2, rec = tmerge.lf2_packed(seq2)
    m2 = int(acc2[1])
    before = tmerge.merge_rank_cuda.launches[layout]
    mine = rec.clone()
    got = tmerge.merge_rank_cuda(idx, mine, m2)
    torch.cuda.synchronize()
    want = tmerge.merge_rank_plain(idx, rec.clone(), m2)
    assert torch.equal(got, want) and tmerge.merge_rank_cuda.launches[layout] == before + 1
    assert got is not mine and torch.equal(mine, rec)  # ins apart: the records stay as they were
    merged = tmerge.merge_plain(idx, b1.to(cuda_device), seq2)
    assert torch.equal(merged.cpu(), tmerge.merge_plain(rank.OccIndex.from_bwt(b1), b1, seq2.cpu()))


def merge_b2(corpus, kind: str) -> np.ndarray:
    """A B2 BWT against the corpus index: 3,000 short sequences, the corpus
    genomes again (no strided segment meets: the hand-overs run whole
    walks), or the genomes with 2% more mutations (segments meet)."""
    if kind == "many_short":
        f2 = short_seqs_index(3000)
        return np.ascontiguousarray(f2.bwt[: f2.n])
    seq = corpus_batch(corpus)
    if kind == "mutated":
        rng = np.random.default_rng(5)
        mut = (rng.random(len(seq)) < 0.02) & (seq != 0)
        seq = seq.copy()
        seq[mut] = rng.integers(1, 5, int(mut.sum()))
    return gsa_bwt(seq)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
@pytest.mark.parametrize("b2", ["many_short", "genomes", "mutated"])
@pytest.mark.parametrize("S", [1, 8, 64, "derived", "above_n2"])
def test_merge_rank_segments_match_plain(corpus, corpus_index, cuda_device, layout, b2, S):
    """K6's two passes on the card against merge_rank_chunked_plain on the
    card at the same stride (ins and every segment record), and ins
    against merge_rank_plain, exact; a stride that is not a power of two
    is refused before the launch."""
    b1 = torch.from_numpy(np.ascontiguousarray(corpus_index.bwt[: corpus_index.n])).to(cuda_device)
    int64 = layout == "dense64"
    idx = rank.OccIndex.from_bwt(b1, int64=int64, mega_shift=6 if int64 else rank.MEGA_BLOCK_SHIFT)
    acc2, rec = tmerge.lf2_packed(torch.from_numpy(merge_b2(corpus, b2)).to(cuda_device))
    m2, n2 = int(acc2[1]), rec.numel()
    S = {"derived": tmerge.stride(n2, cuda_device), "above_n2": 1 << n2.bit_length()}.get(S, S)
    want = tmerge.merge_rank_plain(idx, rec.clone(), m2)
    pins, pseg = tmerge.merge_rank_chunked_plain(idx, rec.clone(), m2, S)
    assert torch.equal(pins, want)
    ins = torch.empty_like(rec)
    before = tmerge.merge_rank_cuda.launches[layout]
    got, seg = tmerge.launch_merge_rank(idx, rec, ins, m2, S)
    torch.cuda.synchronize()
    assert tmerge.merge_rank_cuda.launches[layout] == before + 1 and got is ins
    assert torch.equal(got, want) and torch.equal(seg, pseg)
    with pytest.raises(ValueError):
        tmerge.merge_rank_cuda(idx, rec.clone(), m2, S=7)
