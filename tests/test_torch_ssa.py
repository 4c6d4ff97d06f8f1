"""The port's SSA generation (ropebwt3_tpu_torch/ssa_ops.py) and its LF step
(ops/rank.py `sym_at`, `lf`) against the JAX package: `ssa_gen_device` run
on the CPU, the native engine `ssa_gen_native`, the numpy `ssa_gen` and
`DenseFMIndex.lf`.  Dense rows in int32 and in int64 megablock mode with the
megablocks shrunk.  SSA files: byte-equal; LF: exact at every k.  The
segmented walk (`ssa_gen_seg_plain`, the kernel's three passes) against the
lock-step walk (`ssa_gen_plain`) at strides from 1 to above n, and on
random BWT strings whose LF has cycles without a `$`."""

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.formats.ssa import write_ssa_bytes
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.ssa_ops import ssa_gen as ssa_gen_np
from ropebwt3_tpu.ssa_ops import ssa_gen_device, ssa_gen_native
from ropebwt3_tpu_torch import ssa_ops
from ropebwt3_tpu_torch.construct import merge as tmerge
from ropebwt3_tpu_torch.ops import rank, runblock

from .test_torch_cuda import corpus_index, short_seqs_index  # noqa: F401  (fixture reuse)

INPUTS = ("tiny", "corpus", "m64", "m65")
MEGA_SHIFT = 6  # int64 rows: megablocks of 64 symbols, one per row
STRIDES = (1, 3, 8, 64, "above_n")  # "above_n": n + 1, the m heads alone


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
    rb = runblock.RunBlockIndex.from_dense(f, "cpu", cache=None)  # rb rows walk, as the dense ones
    for a, b in zip(ssa_ops.ssa_gen_cuda(rb, m, 3), ssa_ops.ssa_gen_cuda(idx, m, 3)):
        assert torch.equal(a.long(), b.long())
    with pytest.raises(TypeError):  # not occ rows
        ssa_ops.check_walk(f, m, 3)


@pytest.fixture(scope="module")
def walks(indexes):
    """Per (index, width, shift): the rows, the lock-step walk, and the SSA
    bytes of the native engine and of ssa_gen_device, each made once."""
    memo = {}

    def get(which, int64, ss):
        key = (which, int64, ss)
        if key not in memo:
            f = indexes[which]
            idx = rank.OccIndex.from_dense(f, "cpu", int64=int64, mega_shift=MEGA_SHIFT)
            native = write_ssa_bytes(ssa_gen_native(f, ss))
            assert write_ssa_bytes(ssa_gen_device(f, ss)) == native
            memo[key] = (f, idx, ssa_ops.ssa_gen_plain(idx, int(f.acc[1]), ss), native)
        return memo[key]

    return get


def assert_same_walk(got, want):
    """The four walk arrays equal, ssa_l everywhere (0 where no lane hit)."""
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g.long(), w.long())


@pytest.mark.parametrize("S", STRIDES)
@pytest.mark.parametrize("ss", [0, 2, 3, 8])
@pytest.mark.parametrize("int64", [False, True], ids=["dense32", "dense64"])
@pytest.mark.parametrize("which", INPUTS)
def test_segmented_walk_matches_lockstep(walks, which, int64, ss, S):
    """ssa_gen_seg_plain's arrays equal ssa_gen_plain's, and its SSA the
    native engine's and ssa_gen_device's bytes; the records say that every
    segment is reached (nxt -1) and ends on its walk's sentinel rank."""
    f, idx, want, native = walks(which, int64, ss)
    m = int(f.acc[1])
    S = f.n + 1 if S == "above_n" else S
    *got, rec = ssa_ops.ssa_gen_seg_plain(idx, m, ss, S)
    assert_same_walk(got, want)
    assert write_ssa_bytes(ssa_ops.assemble(m, ss, *got)) == native
    n_seg = ssa_ops.segments(f.n, m, S)
    assert rec.shape == (4, n_seg) and n_seg == (m if S > f.n - m else m + -(-(f.n - m) // S))
    assert bool((rec[2] == -1).all()) and bool(((rec[3] >= 0) & (rec[3] < m)).all())
    assert int(rec[0].sum()) == f.n and bool((rec[0] >= 1).all())  # every row walked once


def random_bwt_index(seed):
    """A random BWT string of 200-800 nt6 symbols with one to three `$`: its
    LF is a permutation whose cycles without a `$` no lane walks."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(200, 800))
    bwt = rng.integers(1, 6, n).astype(np.uint8)
    bwt[rng.choice(n, int(rng.integers(1, 4)), replace=False)] = 0
    return DenseFMIndex.from_bwt(bwt)


@pytest.mark.parametrize("seed", range(6))
def test_segmented_walk_on_random_bwt(seed):
    """Where the lock-step walk leaves slots unfilled (rows on `$`-free LF
    cycles), the segmented walk leaves the same ones, at every stride; the
    segments on such cycles keep nxt >= 0.  The SSA equals ssa_gen_device's."""
    f = random_bwt_index(seed)
    m = int(f.acc[1])
    idx = rank.OccIndex.from_dense(f, "cpu")
    for ss in (0, 2):
        want = ssa_ops.ssa_gen_plain(idx, m, ss)
        if ss == 0:
            assert bool((want[1] < 0).any())  # some rows lie on cycles no lane walks
        for S in (1, 3, 8, f.n + 1):
            *got, rec = ssa_ops.ssa_gen_seg_plain(idx, m, ss, S)
            assert_same_walk(got, want)
            reached = rec[2] < 0
            assert int(rec[0][reached].sum()) == int(want[2].sum())  # the lanes' rows, each walked once
        assert write_ssa_bytes(ssa_ops.assemble(m, ss, *want)) == write_ssa_bytes(ssa_gen_device(f, ss))


def test_walk_refuses_non_power_of_two_stride(indexes):
    """The kernel takes a power-of-two stride (a mask in each step); the
    plain version any positive int."""
    f = indexes["tiny"]
    idx, m = rank.OccIndex.from_dense(f, "cpu"), int(f.acc[1])
    ssa_ops.check_walk(idx, m, 3, 3)
    ssa_ops.check_walk(idx, m, 3, 4, kernel=True)
    for S, kernel in ((3, True), (6, True), (1 << 63, True), (0, False), (-4, False), (2.0, False)):
        with pytest.raises(ValueError):
            ssa_ops.check_walk(idx, m, 3, S, kernel=kernel)


def test_walk_refuses_segment_ids_past_int32():
    """Segment ids go into the int32 ssa_lane: n_seg >= 2^31 is refused."""
    ssa_ops.check_segments((1 << 31) - 1, 2, 1, True)  # 2^31 - 1 segments
    with pytest.raises(ValueError):
        ssa_ops.check_segments(1 << 31, 2, 1, False)
    with pytest.raises(ValueError):
        ssa_ops.check_segments(1 << 40, 1 << 20, 256, True)
    ssa_ops.check_segments(1 << 40, 1 << 20, 1024, True)


@pytest.mark.parametrize("int64", [False, True], ids=["dense32", "dense64"])
@pytest.mark.parametrize("which", INPUTS)
def test_ssa_bytes_counts_the_walk(indexes, which, int64):
    """ssa_bytes covers every array a walk holds on the card (the rows, the
    slot arrays, death_l, final_k, lane_of and the double-buffered segment
    records), with no more above their bytes than the allocator's rounding;
    the records cost 48 B a segment, 0.375 B a symbol at S = 128."""
    f = indexes[which]
    m, ss = int(f.acc[1]), 3
    idx = rank.OccIndex.from_dense(f, "cpu", int64=int64, mega_shift=MEGA_SHIFT)
    w = 8 if int64 else 4
    n_ssa = ssa_ops.n_slots(idx, m, ss)
    for S in (1, 8, 128, f.n + 1):
        n_seg = ssa_ops.segments(f.n, m, S)
        held = idx.nbytes + (w + 4) * n_ssa + (2 * w + 4) * m + 48 * n_seg
        got = ssa_ops.ssa_bytes(f.n, m, ss, S, MEGA_SHIFT if int64 else None)
        assert held <= got <= held + 9 * (ssa_ops.ALLOC_ROUND + 48) + 9 * ssa_ops.ALLOC_SPLIT * (got >= ssa_ops.ALLOC_SPLIT)
    n = 64_000_032  # bench.py's index: 32 walks
    seg = ssa_ops.ssa_bytes(n, 32, 8, 128) - ssa_ops.ssa_bytes(n, 32, 8, ssa_ops.heads_only(n))
    assert 0 <= seg - 0.375 * (n - 32) <= ssa_ops.ALLOC_ROUND + ssa_ops.ALLOC_SPLIT


def test_walk_stride_rules(monkeypatch):
    """On a 132-SM card: bench.py's index (32 walks of 2 M steps) takes the
    shared stride rule's S = 256; the short reads' index (200,000 walks of
    ~151 steps) and 270,336 heads (2,048 a SM) run as heads alone; the CPU
    tests' corpus (16 walks of 8,000) takes S = 128.  On the CPU, one SM."""
    for mod in (ssa_ops, tmerge):
        monkeypatch.setattr(mod, "sm_count", lambda device: 132)
    assert ssa_ops.walk_stride(64_000_032, 32, "cuda") == 256
    assert ssa_ops.walk_stride(30_200_000, 200_000, "cuda") == ssa_ops.heads_only(30_200_000) > 30_200_000
    assert ssa_ops.walk_stride(10**10, 132 * 2048, "cuda") == ssa_ops.heads_only(10**10)
    assert ssa_ops.walk_stride(128_016, 16, "cuda") == 128
    monkeypatch.undo()
    assert ssa_ops.walk_stride(64_000_032, 32, "cpu") == 32768
    assert ssa_ops.jump_rounds(250_032, 32) == 18 and ssa_ops.jump_rounds(32, 32) == 0
