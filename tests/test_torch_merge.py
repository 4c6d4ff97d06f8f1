"""The port's merge (ropebwt3_tpu_torch/construct/merge.py: lf2_table,
lf2_packed, merge_rank_plain, merge_rank_chunked_plain at several segment
strides, merge_apply, merge_plain, merge_bytes) against the JAX
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
    """(B1 BWT, B2 BWT) pairs: many short sequences, a few long ones, B2
    holding a single sequence (single strand), B2 holding a sequence that B1
    holds too (its strided segments never meet: one hand-over runs the
    whole walk), and B2 of short pieces of B1's sequences (segments reach
    `$` before they meet)."""
    rng = np.random.default_rng(23)
    base = rng.integers(1, 5, 4000).astype(np.uint8)
    longs = []
    for _ in range(5):
        s = base.copy()
        mut = rng.random(len(s)) < 0.02
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        longs.append(s)
    one = np.concatenate([longs[4][:2500], np.zeros(1, np.uint8)])
    pieces = [longs[0][a : a + int(rng.integers(1, 300))] for a in rng.integers(0, 3600, 30)]
    out = {
        "many_short": (strands(seqs(rng, 300, 0, 60)), strands(seqs(rng, 200, 0, 60))),
        "few_long": (strands(longs[:3]), strands(longs[3:])),
        "single_b2": (strands(longs[:2]), one),
        "repeat_b1": (strands([*longs[:2], base[:1500]]), strands([base[:1500], longs[3][:1500]])),
        "pieces_of_b1": (strands(longs[:2]), strands(pieces)),
    }
    return {k: (jgsa(a, backend="native"), jgsa(b, backend="native")) for k, (a, b) in out.items()}


@pytest.fixture(scope="module")
def want_ins(cases):
    """Each case's ins by the JAX package's merge_rank_plain, checked equal
    to its native merge_rank_native."""
    out = {}
    for name, (b1, b2) in cases.items():
        f1 = DenseFMIndex.from_bwt(b1)
        out[name] = jmerge.merge_rank_plain(f1, b2)[1]
        assert np.array_equal(out[name], jmerge.merge_rank_native(f1, b2)[1])
    return out


CASES = ["many_short", "few_long", "single_b2", "repeat_b1", "pieces_of_b1"]


def b1_rows(b1, int64):
    return OccIndex.from_bwt(torch.from_numpy(b1), int64=int64, mega_shift=2 if int64 else 26)


def writes_of(rec, m2, S, seg):
    """How often each B2 position is written, as the segment records tell it
    (the kernel fills the same records): pass 1 writes segment g's walk from
    its meeting step on, pass 2's lane g `hand` steps on from g's end."""
    nxt = (rec >> 3).numpy()
    first, n_seg = tmerge.segments(len(rec), m2, S)
    meet, length, end_pos, _, hand = (x.tolist() for x in seg)
    count = np.zeros(len(rec), np.int64)
    for g in range(n_seg):
        kb = g if g < m2 else (first + g - m2) * S
        for t in range(length[g]):
            count[kb] += t >= meet[g]
            kb = nxt[kb]
        kb = end_pos[g]
        for _ in range(hand[g]):
            count[kb] += 1
            kb = nxt[kb]
    return count


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


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("int64", [False, True], ids=["dense32", "dense64"])
def test_merge_rank_matches_jax(cases, want_ins, case, int64):
    """merge_rank_cuda on a CPU index runs merge_rank_chunked_plain at the
    derived stride, merge_rank_plain the walk a lane a sequence: both equal
    the JAX package's ins."""
    b1, b2 = cases[case]
    idx = b1_rows(b1, int64)
    assert idx.layout == ("dense64" if int64 else "dense32")
    acc2, rec = tmerge.lf2_packed(torch.from_numpy(b2))
    m2 = int(acc2[1])
    launched = sum(tmerge.merge_rank_cuda.launches.values())
    lanes = tmerge.merge_rank_plain(idx, rec.clone(), m2)
    ins = tmerge.merge_rank_cuda(idx, rec, m2)  # a CPU index: the plain version
    assert ins is rec and sum(tmerge.merge_rank_cuda.launches.values()) == launched
    assert np.array_equal(ins.numpy(), want_ins[case]) and torch.equal(lanes, ins)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("S", [1, 7, 64, "above_n2"])
@pytest.mark.parametrize("int64", [False, True], ids=["dense32", "dense64"])
def test_merge_rank_chunked_matches_jax(cases, want_ins, case, S, int64):
    """Segments every S B2 positions, with meetings and hand-overs, give the
    JAX package's ins exactly; every B2 position is written once; the
    segment records add up (each position in one segment, a hand-over
    writes only unmet prefixes); S above n2 leaves the sentinel lanes alone."""
    b1, b2 = cases[case]
    idx = b1_rows(b1, int64)
    acc2, rec = tmerge.lf2_packed(torch.from_numpy(b2))
    m2, n2 = int(acc2[1]), len(b2)
    S = n2 + 1 if S == "above_n2" else S
    ins, seg = tmerge.merge_rank_chunked_plain(idx, rec.clone(), m2, S)
    assert np.array_equal(ins.numpy(), want_ins[case])
    assert bool((writes_of(rec, m2, S, seg) == 1).all())
    first, n_seg = tmerge.segments(n2, m2, S)
    meet, length, end_pos, end_ka, hand = seg
    assert seg.shape == (5, n_seg) and int(length.sum()) == n2
    assert bool((meet[:m2] == 0).all()) and bool((end_pos[:m2] == -1).all() if S > n2 else True)
    own = torch.where(meet == tmerge.NEVER, 0, length - meet.clamp(max=n2))
    assert int(own.sum() + hand.sum()) == n2  # pass 1's writes and pass 2's, once each
    exact = (end_pos >= 0) & (end_ka >= 0)
    assert torch.equal(end_ka[exact], ins[end_pos[exact]]) and bool((hand[~exact] == 0).all())
    if S > n2:
        assert n_seg == m2 and int(hand.sum()) == 0


def test_merge_rank_segments_and_stride():
    """The segment table's edges: no sentinel, no segment; S dividing m2;
    S = 1; the stride derived on the CPU (one SM) is a power of two >=
    MIN_STRIDE; a bad S, bad records or an ins over the records are
    refused before a launch."""
    assert tmerge.segments(100, 0, 7) == (0, 0)
    assert tmerge.segments(100, 14, 7) == (2, 14 + 13)  # 14, 21, ..., 98
    assert tmerge.segments(100, 3, 1) == (3, 100)
    assert tmerge.segments(100, 3, 101) == (1, 3)
    assert tmerge.segments(0, 0, 1024) == (0, 0)
    assert tmerge.stride(10, "cpu") == tmerge.MIN_STRIDE
    big = tmerge.MIN_STRIDE * tmerge.LANES_PER_SM * 3
    assert tmerge.stride(big, "cpu") == 4 * tmerge.MIN_STRIDE
    for bad in (0, -1, 2.0):
        with pytest.raises(ValueError):
            tmerge.segments(100, 3, bad)
    b1 = torch.tensor([1, 0, 2], dtype=torch.uint8)
    idx = OccIndex.from_bwt(b1)
    acc2, rec = tmerge.lf2_packed(torch.tensor([3, 0], dtype=torch.uint8))
    with pytest.raises(ValueError):
        tmerge.merge_rank_cuda(idx, rec.clone(), 1, S=0)
    # records of another type or size, an ins that is not int64 or is the
    # records themselves, a stride the kernel does not take
    out = torch.empty_like(rec)
    for recs, ins, S in ((rec.int(), out, 4), (rec[:1], out, 4), (rec, out.int(), 4), (rec, rec, 4),
                         (rec, rec.view(-1), 4), (rec, out, 6)):
        with pytest.raises(ValueError):
            tmerge.launch_merge_rank(idx, recs, ins, 1, S)
    empty = torch.zeros(0, dtype=torch.int64)
    assert tmerge.merge_rank_chunked_plain(idx, empty, 0, 4)[1].shape == (5, 0)
    assert tmerge.merge_rank_cuda(idx, rec.clone(), 0).tolist() == rec.tolist()  # no lane: rec as it was


@pytest.mark.parametrize("case", CASES)
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
