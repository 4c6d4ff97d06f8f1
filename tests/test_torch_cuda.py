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
from ropebwt3_tpu_torch.ops import kount, rank, runblock, smem

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


def low_complexity_genomes(seed: int = 11, n: int = 4, length: int = 6000) -> list[np.ndarray]:
    """n genomes of tandem repeats: runs of 150-600 bp of a motif of 1-6
    random bases, at 1% substitutions, so one interval extends to many
    repeats of itself (long probe chains, keys that repeat within a node)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts, size = [], 0
        while size < length:
            motif = rng.integers(1, 5, int(rng.integers(1, 7)))
            run = np.tile(motif, 600 // len(motif) + 1)[: int(rng.integers(150, 600))]
            parts.append(run)
            size += len(run)
        g = np.concatenate(parts)[:length].astype(np.uint8)
        mut = rng.random(length) < 0.01
        g[mut] = rng.integers(1, 5, int(mut.sum()))
        out.append(g)
    return out


@pytest.fixture(scope="module")
def low_complexity():
    """low_complexity_genomes and their double-strand index, laid out as
    corpus_index's."""
    gen = low_complexity_genomes()
    parts = []
    for s in gen:
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    return gen, DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))


def cyclic_bwt_index(seed):
    """A random BWT string of 200-800 nt6 symbols with one to three `$`:
    its LF is a permutation, and the rows on its cycles without a `$` walk
    forever (`get` stops them after n symbols, as the reference does)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 800))
    bwt = rng.integers(1, 6, n).astype(np.uint8)
    bwt[rng.choice(n, int(rng.integers(1, 4)), replace=False)] = 0
    return DenseFMIndex.from_bwt(bwt)


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


def edge_intervals(n, S):
    """Bi-intervals (lo, lo, s) whose ends both sit at multiples of 128 plus
    or minus 1 (the rb escape sub-rows' edges), or at block edges (offset 0
    of one block, offset S of the one before), in [0, n]."""
    sub = np.arange(0, n + 1, 128)
    edges = np.unique(np.clip(np.concatenate([sub - 1, sub, sub + 1, np.arange(0, n + 1, S), [0, n]]), 0, n))
    lo = np.repeat(edges, 3)
    hi = edges[np.clip(np.searchsorted(edges, lo) + np.tile([0, 1, 5], len(edges)), 0, len(edges) - 1)]
    return np.stack([lo, lo, hi - lo], axis=1).astype(np.int64)


def flat_of(qs):
    """Reads as (flat uint8, seq_off int64) CPU tensors."""
    flat, seq_off = smem.pack_reads(qs)
    return torch.from_numpy(flat), torch.from_numpy(seq_off)


HAPDIV_W = 32


def make_windows(gen: list[np.ndarray], K: int, err: float, crafted_start: int, seed: int) -> np.ndarray:
    """W windows (W, K) int32: HAPDIV_W - 1 cut from random genomes with
    substitutions, insertions and deletions, each at a third of `err`, then
    the crafted one."""
    rng = np.random.default_rng(seed)
    wins = []
    for _ in range(HAPDIV_W - 1):
        g = gen[int(rng.integers(0, len(gen)))]
        st = int(rng.integers(0, len(g) - 2 * K))
        out = []
        for x in g[st : st + 2 * K]:
            u = rng.random()
            if u < err / 3:  # deletion
                continue
            if u < 2 * err / 3:  # insertion before x
                out.append(int(rng.integers(1, 5)))
            out.append(int(rng.integers(1, 5)) if u >= 2 * err / 3 and u < err else int(x))
        wins.append(out[:K])
    g0 = gen[0][crafted_start : crafted_start + K].astype(np.int32)
    wins.append(np.concatenate([g0[: K // 2], np.full(4, 4, np.int32), g0[K // 2 :]])[:K])
    return np.asarray(wins, dtype=np.int32)


def sw_reads(gen: list[np.ndarray], n: int, seed: int) -> list[np.ndarray]:
    """n reads cut from genome 0 as tests/test_sw_jax.py:25-48 cuts them:
    150, 90 and 45 bp with substitutions, N bases, tandem repeats that merge
    DAWG nodes and 4-bp deletions that exercise the F closure."""
    rng = np.random.default_rng(seed)
    base = gen[0]
    out = []
    for i in range(n):
        L = [150, 90, 45][i % 3]
        st = int(rng.integers(0, len(base) - L))
        r = base[st : st + L].copy()
        mut = rng.random(L) < [0.02, 0.05, 0.0][i % 3]
        r[mut] = rng.integers(1, 5, int(mut.sum()))
        if i % 6 == 0:
            r[4:6] = 5  # N bases
        if i % 8 == 0:
            r = np.tile(r[: L // 3], 3)[:L]  # repeats: DAWG node merges
        if i % 5 == 2:
            r = np.delete(r, slice(20, 24))  # deletion: exercises the F closure
        out.append(r)
    return out


def sw_dawgs(f, opt, reads: list[np.ndarray]) -> tuple:
    """The DAWGs of the reads the card takes (the port's native staging), as
    sw_cuda takes them: node_c (W, NC), pre (W, NC, P), n_node (W,) int32 CPU
    tensors, NC and P the largest n_node and in-degree; and the reads' ids."""
    from ropebwt3_tpu_torch.align import bwasw, sw

    flat, seq_off = bwasw.flat_reads(reads)
    ok, n_node, max_pre, node_c, pre = bwasw.sw_stage(opt, f, flat, seq_off, sw.NC_MAX, sw.P_MAX)
    sel = np.flatnonzero(ok & (n_node <= sw.NC_MAX) & (max_pre <= sw.P_MAX))
    NC, P = int(n_node[sel].max()), int(max_pre[sel].max())
    arrays = (node_c[sel, :NC], pre[sel, :NC, :P], n_node[sel])
    return (*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), sel)


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


def check_rb_on_card(f, cpu, gpu, device, reads, min_len):
    """The rb kernels against the plain rank on the card's index: rank1a at
    every k in [0, n], extend_c on intervals with both ends at sub-row and
    block edges, and smem_tgc on the reads' lanes (64 + 32): rows, counts,
    START logs and trips."""
    k = torch.arange(f.n + 1)
    assert torch.equal(rank.rank1a_cuda(gpu, k.to(device)).cpu(), rank.rank1a(cpu, k).to(cpu.dtype))
    ik = torch.from_numpy(edge_intervals(f.n, cpu.S)).to(cpu.dtype)
    c = torch.from_numpy(np.random.default_rng(12).integers(0, 6, len(ik))).int()
    for back in (torch.zeros(len(ik), dtype=torch.bool), torch.ones(len(ik), dtype=torch.bool)):
        got = rank.extend_c_cuda(gpu, ik.to(device), c.to(device), back.to(device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), rank.extend_c(cpu, ik, c, back).to(cpu.dtype))
    flat, seq_off = flat_of(reads)
    lanes = smem.chunk_lanes(seq_off, 64, 32)
    kw = dict(min_occ=1, min_len=min_len, max_mems=8, log_len=16, trips=True)
    got = smem.smem_tgc_cuda(gpu, flat.to(device), seq_off.to(device), lanes.to(device), **kw)
    torch.cuda.synchronize()
    want = smem.smem_tgc_cuda(cpu, flat, seq_off, lanes, **kw)
    assert_same_mems(got.mems.cpu().numpy(), got.n_mem.cpu().numpy(), want.mems.numpy(), want.n_mem.numpy(), 8)
    assert_same_mems(got.log.cpu().numpy()[..., None], got.n_log.cpu().numpy(), want.log.numpy()[..., None],
                     want.n_log.numpy(), 16)
    assert torch.equal(got.trips.cpu(), want.trips)


@pytest.mark.cuda
@pytest.mark.parametrize("S,int64", [(8192, False), (1024, True)])
def test_smem_kernel_run_coded_rows(cuda_device, S, int64):
    """rb rows where run-coded blocks dominate (150 near-identical copies; at
    S = 8192 one block of 110 escapes): the record loads, and at S = 8192
    the wrapped record ends (F4), under the SMEM kernels and the rank
    kernels at sub-row and block edges."""
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
    check_rb_on_card(f, cpu, gpu, cuda_device, qs[:40], 19)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [256, 8192])
@pytest.mark.parametrize("int64", [False, True])
def test_rb_kernels_all_escape_rows(cuda_device, S, int64):
    """rb rows where every block is an escape (a random sequence, both
    strands): each rank reads one escape sub-row, under the rank kernels and
    smem_tgc."""
    rng = np.random.default_rng(5)
    seq = rng.integers(1, 5, 40000).astype(np.uint8)
    f = DenseFMIndex.from_bwt(gsa_bwt(np.concatenate([seq, [0], revcomp(seq), [0]]).astype(np.uint8)))
    kw = dict(S=S, int64=int64, mega_shift=1 if int64 else None, cache=None)
    cpu, gpu = runblock.RunBlockIndex.from_dense(f, "cpu", **kw), runblock.RunBlockIndex.from_dense(f, cuda_device, **kw)
    assert cpu.n_esc == cpu.rows.shape[0] and torch.equal(gpu.esc.cpu(), cpu.esc)
    check_rb_on_card(f, cpu, gpu, cuda_device, cut_reads(f, rng, 8, (300, 2001), 0.01), 15)


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
    through smem_tgc at a 4-symbol margin, then whole through smem_tg, and
    reads whose lanes overflow a 4-row buffer rerun through smem_tgc with a
    buffer of their true count: launches of the card's kernels, with the
    CPU's answer."""
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
            assert out_gpu.n_whole >= 1 and smem.smem_tg_cuda.launches[layout] > one
            assert smem.smem_tgc_cuda.launches[layout] >= chunked + 2
        else:
            assert out_gpu.n_rerun >= 1 and smem.smem_tgc_cuda.launches[layout] >= chunked + 2


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", ["shuffled", "tiny", "three"])
def test_smem_tgc_queue_matches_plain(corpus, corpus_index, cuda_device, layout, case):
    """smem_tgc's grid of resident blocks taking lanes from its queue: the
    lanes in a shuffled order, 300,000 tiny lanes (more than the resident
    threads, so threads take many lanes each) and 3 lanes (fewer threads
    than a block): every lane's rows, counts, START log and trips equal the
    plain version's, each at its own index."""
    rng = np.random.default_rng(31)
    if case == "tiny":
        reads = [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))]
        qs = [reads[i % len(reads)][: int(n)] for i, n in enumerate(rng.integers(15, 40, 300_000))]
    else:
        qs = cut_reads(corpus_index, rng, 6 if case == "shuffled" else 2, (300, 2001), 0.01)
    flat, seq_off = flat_of(qs)
    lanes = smem.chunk_lanes(seq_off, 64, 32)
    if case == "three":
        lanes = lanes[:3]
    order = torch.from_numpy(rng.permutation(lanes.shape[0])) if case == "shuffled" else None
    gpu = make_index(layout, corpus_index, cuda_device)
    flat, seq_off, lanes = flat.to(cuda_device), seq_off.to(cuda_device), lanes.to(cuda_device)
    kw = dict(min_occ=1, min_len=15, max_mems=8, log_len=16)
    got = smem.smem_tgc_cuda(gpu, flat, seq_off, lanes, order=None if order is None else order.to(cuda_device),
                             trips=True, **kw)
    torch.cuda.synchronize()
    want = smem.smem_tg_plain(gpu, flat, seq_off, lanes=lanes, **kw)  # the plain lanes, on the card
    assert_same_mems(got.mems.cpu().numpy(), got.n_mem.cpu().numpy(), want.mems.cpu().numpy(), want.n_mem.cpu().numpy(), 8)
    assert_same_mems(got.log.cpu().numpy()[..., None], got.n_log.cpu().numpy(), want.log.cpu().numpy()[..., None],
                     want.n_log.cpu().numpy(), 16)
    assert torch.equal(got.trips, want.trips)


def row_edge_intervals(n, mega_syms):
    """Bi-intervals (k, k, s) whose far end k + s sits one before, at and one
    past a 64-symbol row edge (k in the row before, in the same row, or
    rows back), with s = 0, with k + s = n, and across megablock edges of
    mega_syms symbols, all in [0, n]."""
    out = []
    for e in list(range(64, n, 64 * 37)) + list(range(mega_syms, n, mega_syms)) + [n - n % 64]:
        for end in (e - 1, e, e + 1):
            for k in (end, end - 1, end - 2, e - 64, e - 65, e - 1000):
                if 0 <= k <= end <= n:
                    out.append((k, k, end - k))
    out += [(k, k, 0) for k in (0, 63, 64, n - 1, n)] + [(k, k, n - k) for k in (0, n - 1, n - 64, n - 65, n)]
    return np.array(out, dtype=np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_occ_extend_c_at_row_edges(corpus_index, cuda_device, layout):
    """occ_extend_c, whose two ranks take one dense row when they share one
    (rank6_pair), at k + s on either side of a row edge, at s = 0, at
    k + s = n and across int64 megablock edges, both directions and every
    symbol: equal to the plain extend_c."""
    cpu, gpu = make_index(layout, corpus_index, "cpu"), make_index(layout, corpus_index, cuda_device)
    ik = torch.from_numpy(np.repeat(row_edge_intervals(corpus_index.n, 64 << 6), 6, axis=0)).to(cpu.dtype)
    c = torch.arange(6, dtype=torch.int32).repeat(ik.shape[0] // 6)
    for back in (torch.zeros(len(ik), dtype=torch.bool), torch.ones(len(ik), dtype=torch.bool)):
        got = rank.extend_c_cuda(gpu, ik.to(cuda_device), c.to(cuda_device), back.to(cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), rank.extend_c(cpu, ik, c, back).to(cpu.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_occ_lf_kernel_matches_plain(corpus_index, cuda_device, layout):
    """occ_lf (csrc/occ_rank.cu over each layout's lf_step) at every k of
    the corpus index: the symbol and LF(k) equal to the plain `lf` on the
    card and to DenseFMIndex.lf; one count a launch."""
    x = make_index(layout, corpus_index, cuda_device)
    k = torch.arange(corpus_index.n, device=cuda_device)
    before = rank.lf_cuda.launches[layout]
    c, nk = rank.lf_cuda(x, k)
    torch.cuda.synchronize()
    assert rank.lf_cuda.launches[layout] == before + 1 and c.dtype == torch.int32 and nk.dtype == x.dtype
    want_c, want_nk = rank.lf(x, k)
    assert torch.equal(c.long(), want_c) and torch.equal(nk.long(), want_nk)
    jc, jnk = corpus_index.lf(np.arange(corpus_index.n))
    assert np.array_equal(c.cpu().numpy(), jc) and np.array_equal(nk.cpu().numpy(), jnk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frontier", "random", "edges", "empty"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_kount_rank_kernel_matches_plain(corpus_index, cuda_device, layout, case):
    """kount_rank (csrc/kount.cu) equals kount_rank_plain exactly: on every
    level of the corpus's `kount -k 8 -m 2` frontier (symbol-major, as
    kount ranks it), on random unsorted (k, l), on the edges 0 and n and
    both sides of every row edge (rb: of every block, 256 dividing 64's
    multiples), and on N = 0 (no launch); one count a launch."""
    cpu, gpu = make_index(layout, corpus_index, "cpu"), make_index(layout, corpus_index, cuda_device)
    n, rng = corpus_index.n, np.random.default_rng(23)
    if case == "frontier":
        pairs = []
        kount.kount_levels([cpu], 8, 2, on_level=lambda d, ks, ls, chars: pairs.append((ks[0], ls[0])))
    elif case == "random":
        a, b = rng.integers(0, n + 1, (2, 200_000))
        pairs = [tuple(torch.from_numpy(v).to(cpu.dtype) for v in (np.minimum(a, b), np.maximum(a, b)))]
    elif case == "edges":
        e = torch.from_numpy(np.unique(np.clip(np.concatenate([np.arange(0, n + 1, 64) + d for d in (-1, 0, 1)]
                                                              + [[0, n]]), 0, n))).to(cpu.dtype)
        pairs = [(e, torch.full_like(e, n)), (torch.zeros_like(e), e), (e, e)]
    else:
        pairs = [(torch.zeros(0, dtype=cpu.dtype), torch.zeros(0, dtype=cpu.dtype))]
    kount.kount_rank_cuda.launches.clear()
    for k, l in pairs:
        ok, size = kount.kount_rank_cuda(gpu, k.to(cuda_device), l.to(cuda_device))
        torch.cuda.synchronize()
        want_ok, want_size = kount.kount_rank_plain(cpu, k, l)
        assert torch.equal(ok.cpu(), want_ok) and torch.equal(size.cpu(), want_size)
    assert kount.kount_rank_cuda.launches[layout] == sum(1 for k, _ in pairs if len(k))


def short_seqs_index(m, seed=9, lo=20, hi=200):
    """Single-strand index of m random sequences of lo..hi bases."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(m):
        parts += [rng.integers(1, 5, int(rng.integers(lo, hi))).astype(np.uint8), np.zeros(1, np.uint8)]
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
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
@pytest.mark.parametrize("S", [4, 128, "above_n"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("which", ["corpus", "many"])
def test_ssa_segments_match_plain(corpus_index, cuda_device, layout, which, S):
    """ssa_gen's three passes on the card against ssa_gen_seg_plain on the
    CPU at the same stride (above n: the heads alone), at ss 0, 3 and 8: the
    four arrays and the segment records exact, one launch a walk; a stride
    that is not a power of two is refused."""
    f = corpus_index if which == "corpus" else short_seqs_index(3000)
    cpu, gpu = make_index(layout, f, "cpu"), make_index(layout, f, cuda_device)
    m = int(f.acc[1])
    S = ssa_ops.heads_only(f.n) if S == "above_n" else S
    for ss in (0, 3, 8):
        before = ssa_ops.ssa_gen_cuda.launches[layout]
        *got, rec = ssa_ops.launch_walk(gpu, m, ss, S)
        torch.cuda.synchronize()
        *want, want_rec = ssa_ops.ssa_gen_seg_plain(cpu, m, ss, S)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().long(), w.long())
        assert torch.equal(rec.cpu(), want_rec[1:])
        assert ssa_ops.ssa_gen_cuda.launches[layout] == before + 1
    with pytest.raises(ValueError):
        ssa_ops.ssa_gen_cuda(gpu, m, 3, S=7)


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
    for name in ("sa_keys", "sa_flags", "sa_scatter", "sa_bwt") + (() if wide else ("sa_sort",)):
        assert tsa.SA_LAUNCHES[name] > before.get(name, 0), name
    if wide:  # two torch.sort calls a round, not the hand sort
        assert tsa.SA_LAUNCHES["sa_sort"] == before.get("sa_sort", 0)


# above one tile a block on every SM, twice: tiles wait on tiles of another wave
SORT_SIZES = (1, 255, 3841, 10007, 2 * 132 * 3840 + 17)


def sort_keys(bits: int, word: int, size: int) -> torch.Tensor:
    """Keys of `bits` live bits in `word`-bit words, many ties, numpy-seeded."""
    rng = np.random.default_rng(bits * 100_003 + size + word)
    hi = np.uint64((1 << bits) - 1)
    pool = rng.integers(0, np.iinfo(np.uint64).max, size // 4 + 1, dtype=np.uint64, endpoint=True) & hi
    u = pool[rng.integers(0, pool.size, size)]
    u[rng.integers(0, size)] = hi
    return torch.from_numpy(u.astype(np.uint32).view(np.int32) if word == 32 else u.view(np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("size", SORT_SIZES)
@pytest.mark.parametrize("bits,word", [(1, 32), (7, 32), (8, 32), (12, 32), (31, 32), (32, 32), (12, 64), (32, 64),
                                       (33, 64), (52, 64), (64, 64)])
def test_sa_sort_matches_plain(cuda_device, bits, word, size):
    """csrc/sa_sort.cu against sa_sort_plain on the card, exact (both are
    stable): the sorted keys and the int32 permutation, one launch."""
    key = sort_keys(bits, word, size).to(cuda_device)
    before = tsa.SA_LAUNCHES["sa_sort"]
    key_s, perm = tsa.sa_sort_cuda(key, bits)
    torch.cuda.synchronize()
    want_s, want = tsa.sa_sort_plain(key, bits)
    assert perm.dtype == torch.int32 and torch.equal(perm, want) and torch.equal(key_s, want_s)
    assert tsa.SA_LAUNCHES["sa_sort"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["equal", "descending"])
@pytest.mark.parametrize("word", [32, 64])
def test_sa_sort_edge_keys(cuda_device, kind, word):
    """All-equal keys (every digit nonzero) keep their order; descending keys
    reverse; the keys sorted in place of a SortSpace's first buffer, twice
    over one space, give the same; a key in its second buffer is refused."""
    n = SORT_SIZES[-1]
    dt = torch.int32 if word == 32 else torch.int64
    if kind == "equal":
        bits, key = 24, torch.full((n,), 0x9A5C3F, dtype=dt, device=cuda_device)
        want = torch.arange(n, dtype=torch.int32, device=cuda_device)
    else:
        bits, key = n.bit_length(), torch.arange(n - 1, -1, -1, dtype=dt, device=cuda_device)
        want = torch.arange(n - 1, -1, -1, dtype=torch.int32, device=cuda_device)
    space = tsa.SortSpace(n, cuda_device)
    for _ in range(2):
        into = space.key(0, word == 32)
        into.copy_(key)
        key_s, perm = tsa.sa_sort_cuda(into, bits, space)
        torch.cuda.synchronize()
        assert torch.equal(perm, want) and torch.equal(key_s, key[want.long()])
    with pytest.raises(ValueError):
        tsa.sa_sort_cuda(space.key(1, word == 32), bits, space)


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


@pytest.mark.cuda
@pytest.mark.parametrize("layout,block", [("rb32", 8192), ("rb32", 256), ("rb64", 256), ("rb64", 8192)])
@pytest.mark.parametrize("b2", ["many_short", "genomes", "mutated"])
@pytest.mark.parametrize("S", [8, "derived"])
def test_merge_rank_rb_matches_plain(corpus, corpus_index, cuda_device, layout, block, b2, S):
    """K6 over rb rows (merge_rank_rb32 / rb64: Rb<T>::rank2 until the
    bounds meet, then rank1) on the card against merge_rank_chunked_plain
    over the same rows on the card (ins and every segment record) and
    merge_rank_plain over the dense rows, exact: blocks of 8192 (all
    escapes) and 256 (run-coded), rb64 in megablocks of 4 rows."""
    int64 = layout == "rb64"
    idx = runblock.RunBlockIndex.from_dense(corpus_index, cuda_device, S=block, int64=int64,
                                            mega_shift=2 if int64 else None, cache=None)
    assert idx.layout == layout
    acc2, rec = tmerge.lf2_packed(torch.from_numpy(merge_b2(corpus, b2)).to(cuda_device))
    m2, n2 = int(acc2[1]), rec.numel()
    S = tmerge.stride(n2, cuda_device) if S == "derived" else S
    want = tmerge.merge_rank_plain(rank.OccIndex.from_dense(corpus_index, cuda_device), rec.clone(), m2)
    pins, pseg = tmerge.merge_rank_chunked_plain(idx, rec.clone(), m2, S)
    assert torch.equal(pins, want)
    before = tmerge.merge_rank_cuda.launches[layout]
    got, seg = tmerge.launch_merge_rank(idx, rec, torch.empty_like(rec), m2, S)
    torch.cuda.synchronize()
    assert tmerge.merge_rank_cuda.launches[layout] == before + 1
    assert torch.equal(got, want) and torch.equal(seg, pseg)


# the cases of the DP kernels' card tests: the corpus (the ids of the first
# cases), a low-complexity index and its windows or reads, and -A 100
# (every window or read that aligns passes the 12-bit score field)
DP_CASES = [pytest.param(51, 25, "corpus", id="51-25"), pytest.param(101, 25, "corpus", id="101-25"),
            pytest.param(51, 16, "corpus", id="51-16"), pytest.param(31, 48, "corpus", id="31-48"),
            pytest.param(51, 25, "low_complexity", id="51-25-low_complexity"),
            pytest.param(31, 48, "low_complexity", id="31-48-low_complexity"),
            pytest.param(51, 25, "match100", id="51-25-match100")]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
@pytest.mark.parametrize("K,n_best,kind", DP_CASES)
def test_hapdiv_kernel_matches_plain(corpus, corpus_index, low_complexity, cuda_device, layout, K, n_best, kind):
    """K8 (csrc/hapdiv.cu, one warp a window) against hapdiv_plain on the
    card, exact: the four arrays on every window, `bad` included, and the
    trips of the windows not flagged; make_windows' windows (substitutions
    and indels, one crafted to be flagged: an insertion) and a
    low-complexity run, on the corpus or on a low-complexity index (long
    probe chains, wraps, keys repeated in a node), or scored -A 100 (the
    12-bit score flag)."""
    from ropebwt3_tpu_torch.align import hapdiv

    gen = [char2nt6(rec.seq) for rec in read_seqs(str(corpus / "genomes.fa"))]
    f = corpus_index
    if kind == "low_complexity":
        gen, f = low_complexity
    wins = np.concatenate([make_windows(gen, K, 0.06, 3883, seed=K + n_best), np.ones((1, K), np.int32)])
    x = make_index(layout, f, cuda_device)
    seqs = torch.from_numpy(wins).to(cuda_device)
    kw = dict(n_best=n_best, trips=True, match=100 if kind == "match100" else 1)
    before = hapdiv.hapdiv_cuda.launches[layout]
    got = hapdiv.hapdiv_cuda(x, seqs, K, **kw)
    assert hapdiv.hapdiv_cuda.launches[layout] == before + 1
    want = hapdiv.hapdiv_plain(x, seqs, K, **kw)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ok = ~got[3]
    assert torch.equal(got[4][ok], want[4][ok])  # trips: the rounds of a flagged window stop at its flag
    assert bool(got[3].any()) if kind == "match100" else bool(ok.any()) and (kind != "corpus" or bool(got[3].any()))


SW_CASES = [pytest.param(False, 25, "corpus", id="False-25"), pytest.param(True, 25, "corpus", id="True-25"),
            pytest.param(False, 16, "corpus", id="False-16"), pytest.param(False, 48, "corpus", id="False-48"),
            pytest.param(False, 25, "low_complexity", id="False-25-low_complexity"),
            pytest.param(True, 48, "low_complexity", id="True-48-low_complexity"),
            pytest.param(False, 25, "match100", id="False-25-match100")]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
@pytest.mark.parametrize("e2e,n_best,kind", SW_CASES)
def test_sw_kernel_matches_plain(corpus, corpus_index, low_complexity, cuda_device, layout, e2e, n_best, kind):
    """K9 (csrc/sw.cu, one warp a read) against sw_plain on the card, exact:
    bad, best_sc and best_pos on every read, the archive and the trips of the
    reads not flagged; sw_reads' reads, general DAWGs (in-degree up to 6) and
    the linear ones of -e, on the corpus or cut from a low-complexity index
    (long probe chains, wraps, keys repeated in a node), or scored -A 100
    (the 12-bit score flag)."""
    from ropebwt3_tpu_torch.align import bwasw, sw

    gen = [char2nt6(rec.seq) for rec in read_seqs(str(corpus / "genomes.fa"))]
    f = corpus_index
    if kind == "low_complexity":
        gen, f = low_complexity
    opt = bwasw.SwOpt(flag=bwasw.RB3_SWF_E2E if e2e else 0, end_len=1 if e2e else 11, n_best=n_best)
    node_c, pre, n_node, _ = sw_dawgs(f, opt, sw_reads(gen, 24, seed=n_best + e2e))
    x = make_index(layout, f, cuda_device)
    args = [t.to(cuda_device) for t in (node_c, pre, n_node)]
    kw = dict(n_best=n_best, end_len=opt.end_len, trips=True, match=100 if kind == "match100" else 1)
    before = sw.sw_cuda.launches[layout]
    got = sw.sw_cuda(x, *args, **kw)
    assert sw.sw_cuda.launches[layout] == before + 1
    want = sw.sw_plain(x, *args, **kw)
    for a, b in zip(got[4:7], want[4:7]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ok = ~got[6]
    rows = torch.repeat_interleave(ok, args[2].long())
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a[rows], b[rows])
    assert torch.equal(got[7][ok], want[7][ok])  # trips: the rounds of a flagged read stop at its flag
    assert bool(got[6].any()) if kind == "match100" else bool(ok.any())


@pytest.mark.cuda
def test_sw_engine_on_card_matches_native(corpus, corpus_index, cuda_device):
    """SwDeviceEngine on the card (K9, the native finish, native reruns of
    the flagged reads) gives the native engine's hits, hit for hit."""
    from ropebwt3_tpu_torch.align import bwasw, sw

    gen = [char2nt6(rec.seq) for rec in read_seqs(str(corpus / "genomes.fa"))]
    reads = sw_reads(gen, 48, seed=5)
    opt = bwasw.SwOpt()
    eng = sw.SwDeviceEngine(corpus_index, opt, device=cuda_device)
    before = sw.sw_cuda.launches["dense32"]
    got = eng.run(reads)
    assert sw.sw_cuda.launches["dense32"] == before + 1 and eng.n_card > 0
    want = bwasw.rb3_sw_batch(opt, corpus_index, reads)
    sig = [[[(h.score, h.lo, h.hi, h.cigar, h.cs, h.qoff) for h in hs] for hs in out] for out in (got, want)]
    assert sig[0] == sig[1] and any(sig[0])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["corpus", "cyclic"])
@pytest.mark.parametrize("S", [8, 256, "heads"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_retrieve_seg_matches_plain(corpus_index, cuda_device, layout, S, which):
    """K11 (csrc/walk.cu retrieve_seg: passes 1, 3 and 4, with ssa_gen.cu's
    pointer jumping) against retrieve_seg_plain on the card at stride S:
    each k's symbols and end row and the segment records (4, n_seg), one
    launch a walk; then the whole walk at the derived stride against the
    JAX package's DenseFMIndex.retrieve.  The corpus index: every sentinel
    row, 0, n - 1, a `$` row, a duplicate, a strided start row and 40
    seeded rows; a random BWT string: every row, `$`-free cycles among
    them."""
    from ropebwt3_tpu_torch.ops import walk

    f = corpus_index if which == "corpus" else cyclic_bwt_index(4)
    x = make_index(layout, f, cuda_device)
    m = int(f.acc[1])
    S = walk.heads_only(f.n) if S == "heads" else S
    if which == "corpus":
        rng = np.random.default_rng(21)
        ks = [*range(m), 0, f.n - 1, int(np.flatnonzero(f.bwt[: f.n] == 0)[0]), 5, 5, m + 3 * min(S, 64),
              *rng.integers(0, f.n, 40).tolist()]
    else:
        ks = list(range(f.n))
    k, _ = walk.check_retrieve(x, ks, S, kernel=True)
    before = walk.retrieve_cuda.launches[layout]
    seqs, ends, rec = walk.launch_retrieve(x, k, m, S)
    torch.cuda.synchronize()
    assert walk.retrieve_cuda.launches[layout] == before + 1
    want = walk.retrieve_seg_plain(x, ks, S)
    assert all(np.array_equal(a, b) for a, b in zip(seqs, want[0])) and np.array_equal(ends, want[1])
    assert torch.equal(rec, want[2])
    if which == "cyclic":
        assert bool((rec[2][: len(ks)] >= 0).any())
    seqs, ends = walk.retrieve_cuda(x, ks)
    for k0, s, e in zip(ks, seqs, ends):
        w, wend = f.retrieve(k0)
        assert np.array_equal(s, w) and int(e) == wend


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_suffix_walk_matches_plain(corpus, corpus_index, cuda_device, layout):
    """K12 (csrc/walk.cu suffix_walk) against suffix_plain on the card and
    on the CPU: the corpus reads, pieces of them with N's, an empty read,
    one of a lone N and whole matches of the genomes; one launch."""
    from ropebwt3_tpu_torch.ops import walk

    reads = [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))]
    gen = [char2nt6(r.seq) for r in read_seqs(str(corpus / "genomes.fa"))]
    rng = np.random.default_rng(22)
    qs = reads + [np.where(rng.random(len(r)) < 0.02, 5, r).astype(np.uint8) for r in reads]
    qs += [np.zeros(0, np.uint8), np.full(1, 5, np.uint8), gen[0][:2000], gen[3][5000:5300]]
    flat, off = flat_of(qs)
    x = make_index(layout, corpus_index, cuda_device)
    before = walk.suffix_cuda.launches[layout]
    got = walk.suffix_cuda(x, flat.to(cuda_device), off.to(cuda_device))
    torch.cuda.synchronize()
    assert walk.suffix_cuda.launches[layout] == before + 1
    want = walk.suffix_plain(x, flat.to(cuda_device), off.to(cuda_device))
    cpu = walk.suffix_plain(make_index(layout, corpus_index, "cpu"), flat, off)
    for a, b, c in zip(got, want, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert int(got[0][-4]) == 0 and int(got[0][-3]) == 1 and int(got[1][-3]) == 0 and int(got[0][-2]) == 0


def n_index(seed: int = 7, n_seq: int = 4, length: int = 2047):
    """n_seq mutated copies of a random genome with N runs, double strand:
    n = n_seq x 2 x (length + 1); 4 x 2047 gives 16,384, which S = 256
    divides, and 257 dense rows, which four shards cut unevenly."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 5, length).astype(np.uint8)
    parts = []
    for _ in range(n_seq):
        s = base.copy()
        mut = rng.random(length) < 0.02
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        for st in rng.integers(0, length - 8, 3):
            s[st : st + int(rng.integers(1, 8))] = 5
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))


def sharded_index(layout, f, device):
    """make_index's layout, rb at S = 256 (which n_index's n is a multiple of)."""
    if layout == "rb32":
        return runblock.RunBlockIndex.from_dense(f, device, S=256, cache=None)
    return make_index(layout, f, device)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_kernels_match_plain(cuda_device, layout):
    """smem_tg_* and smem_tgc_* over the rows of a 2x4 mesh of one card,
    mapped into one range (parallel/mesh.py ShardedRows: the unsharded
    kernels at the range's base pointer), against their plain version
    (smem_tg_plain over rank6_sharded_plain, on the CPU) and against the
    kernels over the unsharded rows: rows, counts, START logs and trips,
    exact, on every view; reads with N runs rank at k = n, which S divides
    on rb rows (F1); one launch counted each."""
    from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, make_mesh

    f = n_index()
    rng = np.random.default_rng(31)
    reads = cut_reads(f, rng, 20, (60, 1500), 0.02) + [np.full(40, 5, np.uint8), np.zeros(0, np.uint8)]
    flat, off = flat_of(reads)
    lanes = smem.chunk_lanes(off, 64, 32)
    gpu = sharded_index(layout, f, cuda_device)
    sh = ShardedRows(gpu, make_mesh(2, 4, [cuda_device] * 8))
    cpu = ShardedRows(sharded_index(layout, f, "cpu"), make_mesh(2, 4, ["cpu"] * 8))
    assert sh.nb % 4 or layout.startswith("rb")  # dense: an uneven tail
    kw = dict(min_occ=1, min_len=19, max_mems=8)
    d_flat, d_off, d_lanes = flat.to(cuda_device), off.to(cuda_device), lanes.to(cuda_device)
    want1 = smem.smem_tg_plain(cpu.views[0], flat, off, **kw)
    wantc = smem.smem_tg_plain(cpu.views[0], flat, off, lanes=lanes, log_len=16, **kw)
    base1 = smem.smem_tg_cuda(gpu, d_flat, d_off, trips=True, **kw)
    for v in sh.views:
        n1, nc = smem.smem_tg_cuda.launches[v.layout], smem.smem_tgc_cuda.launches[v.layout]
        got1 = smem.smem_tg_cuda(v, d_flat, d_off, trips=True, **kw)
        gotc = smem.smem_tgc_cuda(v, d_flat, d_off, d_lanes, log_len=16, trips=True, **kw)
        torch.cuda.synchronize()
        assert smem.smem_tg_cuda.launches[v.layout] == n1 + 1 and smem.smem_tgc_cuda.launches[v.layout] == nc + 1
        for got, want in ((got1, want1), (gotc, wantc), (got1, base1)):
            assert_same_mems(got.mems.cpu().numpy(), got.n_mem.cpu().numpy(), want.mems.cpu().numpy(),
                             want.n_mem.cpu().numpy(), 8)
            assert torch.equal(got.trips.cpu(), want.trips.cpu())
        assert_same_mems(gotc.log.cpu().numpy()[..., None], gotc.n_log.cpu().numpy(), wantc.log.numpy()[..., None],
                         wantc.n_log.numpy(), 16)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense32", "rb32"])
def test_sharded_engine_matches_unsharded(cuda_device, layout):
    """The engine over a 2x4 mesh of one card (smem_mesh: the card takes
    the eight slots' shares of the reads as one, one chunked engine over
    the mapped rows) equals the unsharded engine, in one smem_tgc launch."""
    from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, make_mesh
    from ropebwt3_tpu_torch.parallel.smem_sharded import smem_mesh

    f = n_index()
    reads = cut_reads(f, np.random.default_rng(8), 40, (20, 2000), 0.02)
    flat, off = smem.pack_reads(reads)
    gpu = sharded_index(layout, f, cuda_device)
    sh = ShardedRows(gpu, make_mesh(2, 4, [cuda_device] * 8))
    want = smem.smem_tg(gpu, torch.from_numpy(flat).to(cuda_device), torch.from_numpy(off).to(cuda_device),
                        min_occ=1, min_len=19)
    before = smem.smem_tgc_cuda.launches[layout]
    got = smem_mesh(sh.views, flat, off, min_occ=1, min_len=19)
    assert smem.smem_tgc_cuda.launches[layout] == before + 1 and sh.views[0].layout == layout
    assert np.array_equal(got.counts, want.counts.cpu().numpy()) and np.array_equal(got.rows, want.rows.cpu().numpy())


def occupancy(name: str, which: int) -> tuple[int, int]:
    """(registers, resident blocks an SM) of a kernel through its
    rb3c_occupancy_* query."""
    import ctypes

    from ropebwt3_tpu_torch import kernels

    b, loc, regs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    assert getattr(kernels.lib(), f"rb3c_occupancy_{name}")(which, ctypes.byref(b), ctypes.byref(loc),
                                                           ctypes.byref(regs)) == 0
    assert b.value >= 1 and regs.value > 0
    return regs.value, b.value


@pytest.mark.cuda
def test_sharded_kernel_occupancy(cuda_device):
    """The SMEM kernels a 2x4 mesh of one card launches over its mapped rows
    take the unsharded kernels' registers and resident blocks an SM, in
    every layout (one thread a lane and a read): they are those kernels."""
    from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, make_mesh

    f = n_index()
    for layout in LAYOUTS:
        v = ShardedRows(sharded_index(layout, f, cuda_device), make_mesh(2, 4, [cuda_device] * 8)).views[-1]
        for chunked in (1, 0):
            assert occupancy(f"smem_tg_{v.layout}", chunked) == occupancy(f"smem_tg_{layout}", chunked)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 64, "derived"])
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
def test_merge_rank_sharded_matches_plain(corpus, corpus_index, cuda_device, layout, S):
    """K6 over B1's rows sharded on a 2x4 mesh of one card and mapped into
    one range (merge_rank_mesh: the card takes the eight slots' segments as
    one range, each pass one launch of merge_rank_<layout> over the mapped
    rows) against merge_rank_chunked_plain over rank6_sharded_plain on the
    card and against the unsharded kernel, which runs both passes in one
    call: ins and every segment record exact; 2 launches counted."""
    from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, make_mesh

    b1 = torch.from_numpy(np.ascontiguousarray(corpus_index.bwt[: corpus_index.n])).to(cuda_device)
    int64 = layout == "dense64"
    idx = rank.OccIndex.from_bwt(b1, int64=int64, mega_shift=6 if int64 else rank.MEGA_BLOCK_SHIFT)
    views = ShardedRows(idx, make_mesh(2, 4, [cuda_device] * 8)).views
    acc2, rec = tmerge.lf2_packed(torch.from_numpy(merge_b2(corpus, "mutated")).to(cuda_device))
    m2 = int(acc2[1])
    S = tmerge.stride(rec.numel(), cuda_device) if S == "derived" else S
    before = tmerge.merge_rank_cuda.launches[layout]
    ins, seg = tmerge.merge_rank_mesh(views, rec, m2, S)
    torch.cuda.synchronize()
    assert tmerge.merge_rank_cuda.launches[layout] == before + 2
    pins, pseg = tmerge.merge_rank_chunked_plain(views[-1], rec.clone(), m2, S)
    uins, useg = tmerge.launch_merge_rank(idx, rec, torch.empty_like(rec), m2, S)
    assert torch.equal(ins, pins) and torch.equal(seg, pseg)
    assert torch.equal(uins, pins) and torch.equal(useg, pseg)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
@pytest.mark.parametrize("which", ["corpus", "many", "cyclic"])
def test_ssa_walk_ranges_sharded_match_plain(corpus_index, cuda_device, layout, which):
    """K5's pass 1 by range (rb3c_ssa_walk_* over [g0, g1)) on the card: each
    of eight ranges' slots and records exact against ssa_walk_plain over the
    same range on the CPU; walk_mesh over [card] x 8 (one range launch a
    card counted, passes 2 and 3 once) equal to
    ssa_gen_seg_plain and to the unsharded walk, whose pass 1 runs the full
    range; at S 8 and ss 0 and 3, on the corpus, 3,000 short sequences and a
    BWT with `$`-free cycles (their slots cleared after the merge)."""
    from ropebwt3_tpu_torch.parallel.mesh import make_mesh, replicate, split_segments

    f = {"corpus": lambda: corpus_index, "many": lambda: short_seqs_index(3000), "cyclic": lambda: cyclic_bwt_index(0)}[which]()
    cpu, gpu = make_index(layout, f, "cpu"), make_index(layout, f, cuda_device)
    reps = replicate(gpu, make_mesh(2, 4, [cuda_device] * 8).devices)
    m, S = int(f.acc[1]), 8
    n_seg = ssa_ops.segments(f.n, m, S)
    cuts = split_segments(n_seg, 8)
    for ss in (0, 3):
        n_ssa = ssa_ops.n_slots(cpu, m, ss)
        for g0, g1 in zip(cuts, cuts[1:]):
            share = (torch.zeros(n_ssa, dtype=gpu.dtype, device=cuda_device),
                     torch.full((n_ssa,), -1, dtype=torch.int32, device=cuda_device),
                     torch.full((3, n_seg), ssa_ops.LOW, dtype=torch.int64, device=cuda_device))
            ssa_ops.launch_walk_range(gpu, m, ss, S, g0, g1, *share)
            torch.cuda.synchronize()
            for got, want in zip(share, ssa_ops.ssa_walk_plain(cpu, m, ss, S, g0, g1)):
                assert torch.equal(got.cpu().long(), want.long())
        before = ssa_ops.ssa_gen_mesh.launches[layout]
        got = ssa_ops.walk_mesh(reps, m, ss, S)
        torch.cuda.synchronize()
        assert ssa_ops.ssa_gen_mesh.launches[layout] == before + 1
        *want, want_rec = ssa_ops.ssa_gen_seg_plain(cpu, m, ss, S)
        for a, b, c in zip(got, [*want, want_rec[1:]], ssa_ops.launch_walk(gpu, m, ss, S)):
            assert torch.equal(a.cpu().long(), b.long()) and torch.equal(c, a)
        if which == "cyclic":
            assert bool((got[4][1] >= 0).any())


@pytest.mark.cuda
def test_merge_rank_sharded_occupancy(cuda_device):
    """Both passes of K6 over a 2x4 mesh's mapped rows take the unsharded
    passes' registers and resident blocks an SM, in dense32 and dense64."""
    from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, make_mesh

    f = n_index()
    for layout in ("dense32", "dense64"):
        v = ShardedRows(make_index(layout, f, cuda_device), make_mesh(2, 4, [cuda_device] * 8)).views[0]
        for hand_over in (0, 1):
            assert occupancy(f"merge_rank_{v.layout}", hand_over) == occupancy(f"merge_rank_{layout}", hand_over)


def runs_bwt(rng, n: int, mean: int) -> np.ndarray:
    """n symbols in runs of 1 .. 2 mean - 1 of random symbols 0-5: a uint8
    string as a BWT (its rows need not come from a real text)."""
    lens = rng.integers(1, 2 * mean, n // mean + 2)
    return np.repeat(rng.integers(0, 6, lens.size).astype(np.uint8), lens)[:n]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32"])
def test_mapping_reads_across_slab_boundaries(cuda_device, layout):
    """Eight slabs of one card mapped into one range, each holding real
    rows (a BWT of 8 mapping units of rows less a few: 131,072 dense rows a
    unit, 65,536 rb rows at S = 256), ranked by the occ_rank1a kernel through
    the range's base pointer at every slab boundary (both sides, and the
    first and last symbols of each side's row) and at random positions:
    equal to the unsharded rows' rank and to rank6_sharded_plain; the
    mapped bytes are counted while the rows live and given back after."""
    import gc

    from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, make_mesh, mapped_bytes, rank6_sharded_plain

    rng = np.random.default_rng(33)
    if layout == "rb32":
        f = DenseFMIndex.from_bwt(runs_bwt(rng, 8 * 65536 * 256 - 3000, 6))
        x = runblock.RunBlockIndex.from_dense(f, cuda_device, S=256, cache=None)
        block = 256
    else:
        bwt = torch.from_numpy(runs_bwt(rng, 8 * 131072 * 64 - 3000, 3)).to(cuda_device)
        x = rank.OccIndex.from_bwt(bwt, int64=layout == "dense64", mega_shift=12 if layout == "dense64" else 20)
        block = 64
    before = mapped_bytes(cuda_device)[0]
    sh = ShardedRows(x, make_mesh(1, 8, [cuda_device] * 8))
    v = sh.views[0]
    assert v.layout == layout and sh.nb_local == sh.unit and all(s.rows.shape[0] for s in v.slabs)
    assert mapped_bytes(cuda_device)[0] - before == sh.phys_bytes > 0
    edge = np.arange(1, 8) * sh.nb_local * block
    k = np.concatenate([edge[:, None] + np.array([-block - 1, -block, -block + 1, -2, -1, 0, 1, 2, block - 1, block,
                                                  block + 1])[None, :], rng.integers(0, x.n + 1, (1, 20000))], axis=None)
    k = torch.from_numpy(np.unique(np.clip(np.append(k, [0, x.n]), 0, x.n))).to(cuda_device)
    got = rank.rank1a_cuda(v, k)
    torch.cuda.synchronize()
    assert torch.equal(got.long(), x.rank1a(k)) and torch.equal(got.long(), rank6_sharded_plain(v, k))
    del sh, v, got
    gc.collect()
    assert mapped_bytes(cuda_device)[0] == before
