"""K6, the merge rank, over run-block (rb) rows of B1, on the CPU: the rows
a merge takes once B1's dense rows do not belong on the card (ROADMAP
item 8, construct/merge.py merge_host).

- `merge_rank_chunked_plain` over a `RunBlockIndex` gives the JAX package's
  `merge_rank_plain` ins (construct/merge.py, host numpy: no JAX compile)
  on the same B1 and B2, and the segment records of the same walk over the
  dense rows: blocks of 256 (run-coded) and 8192 (all escapes), int32 and
  int64 with megablocks of one and four rows (walks cross them), a B2 of
  mutated copies (segments meet) and one that repeats a B1 sequence
  exactly (no strided segment meets: the hand-overs run whole walks);
- csrc/merge_rank.cu's `walk_segment` / `hand_over` over rb.cuh's
  `Rb<T>` (the text before `#ifdef __CUDACC__`), built for the host with
  g++ behind the C signature of rb3c_merge_rank_rb32 / rb64, give the same
  ins and segment records; and `Rb<T>::rank1` (the step once the bounds
  have met) equals `rank1a` at every k and symbol.
Every comparison is exact.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct.merge import merge_rank_plain as jax_merge_rank_plain
from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.nt6 import revcomp
from ropebwt3_tpu_torch.construct import merge
from ropebwt3_tpu_torch.ops.rank import OccIndex
from ropebwt3_tpu_torch.ops.runblock import RunBlockIndex

from .test_torch_runblock import HOST_SHIM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "ropebwt3_tpu_torch", "csrc")
BASE_LEN = 1023


def genome_copies(seed: int, n: int, rate: float, base_seed: int = 11) -> list[np.ndarray]:
    """n copies of one random genome (BASE_LEN bp, seed base_seed) at
    `rate` substitutions, with a run of N in each."""
    base = np.random.default_rng(base_seed).integers(1, 5, BASE_LEN).astype(np.uint8)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = base.copy()
        mut = rng.random(BASE_LEN) < rate
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        st = int(rng.integers(0, BASE_LEN - 8))
        s[st : st + int(rng.integers(1, 6))] = 5
        out.append(s)
    return out


def double_strand_bwt(seqs: list[np.ndarray]) -> np.ndarray:
    parts = []
    for s in seqs:
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    return gsa_bwt(np.concatenate(parts))


@pytest.fixture(scope="module")
def b1s():
    """B1 of each kind, with the sequences it was built from: `copies`, 24
    copies at 0.3% divergence (n = 49,152; most blocks of 256 run-coded),
    and `random`, 24 unrelated sequences (every block of 8192 an escape)."""
    copies = genome_copies(1, 24, 0.003)
    rng = np.random.default_rng(2)
    rand = [rng.integers(1, 5, BASE_LEN).astype(np.uint8) for _ in range(24)]
    return {"copies": (copies, DenseFMIndex.from_bwt(double_strand_bwt(copies))),
            "random": (rand, DenseFMIndex.from_bwt(double_strand_bwt(rand)))}


def b2_of(kind: str, seqs: list[np.ndarray]) -> np.ndarray:
    """B2: `mutated`, four fresh copies of B1's genome at 2% (segments meet
    after a few to a few hundred steps; for a random B1, sequences it
    lacks); `repeat`, one of B1's own sequences again beside a mutated one
    (its walks never meet)."""
    if kind == "mutated":
        return double_strand_bwt(genome_copies(9, 4, 0.02))
    return double_strand_bwt([seqs[3], genome_copies(10, 1, 0.02)[0]])


def rb_rows(f, S: int, int64: bool) -> RunBlockIndex:
    """f's rb rows at block size S; int64 in megablocks of one row (S
    8192) or four (S 256)."""
    return RunBlockIndex.from_dense(f, "cpu", S=S, int64=int64, mega_shift=(0 if S == 8192 else 2) if int64 else None,
                                    cache=None)


CASES = [("copies", 256), ("random", 8192)]


@pytest.mark.parametrize("kind,S", CASES)
@pytest.mark.parametrize("int64", [False, True], ids=["rb32", "rb64"])
@pytest.mark.parametrize("b2", ["mutated", "repeat"])
def test_rb_rows_give_the_jax_ins(b1s, kind, S, int64, b2):
    """merge_rank_chunked_plain over rb rows, at strides 8 and 64: ins equal
    to the JAX package's merge_rank_plain, and segment records equal to the
    same walk's over the dense rows."""
    seqs, f = b1s[kind]
    x = rb_rows(f, S, int64)
    assert x.layout == ("rb64" if int64 else "rb32") and x.S == S
    if S == 8192:
        assert x.n_esc == x.rows.shape[0]
    else:
        assert 4 * x.n_esc < x.rows.shape[0]
    if int64:
        assert x.mega.shape[0] > 4
    bwt2 = b2_of(b2, seqs)
    want = jax_merge_rank_plain(f, bwt2)[1]
    acc2, rec = merge.lf2_packed(torch.from_numpy(bwt2))
    m2 = int(acc2[1])
    dense = OccIndex.from_dense(f, "cpu")
    for stride in (8, 64):
        ins, seg = merge.merge_rank_chunked_plain(x, rec.clone(), m2, stride)
        assert np.array_equal(ins.numpy(), want), stride
        assert torch.equal(seg, merge.merge_rank_chunked_plain(dense, rec.clone(), m2, stride)[1])
        if b2 == "repeat":  # a strided segment on B1's own sequence never meets
            assert bool((seg[0, m2:] == merge.NEVER).any()) and int(seg[4].max()) > 100


def test_merge_rank_cuda_takes_rb_rows_on_the_cpu(b1s):
    """merge_rank_cuda over rb rows on the CPU (the host placement's call):
    the plain passes at the derived stride, the JAX ins."""
    seqs, f = b1s["copies"]
    bwt2 = b2_of("mutated", seqs)
    acc2, rec = merge.lf2_packed(torch.from_numpy(bwt2))
    got = merge.merge_rank_cuda(rb_rows(f, 256, False), rec, int(acc2[1]))
    assert np.array_equal(got.numpy(), jax_merge_rank_plain(f, bwt2)[1])


# csrc/merge_rank.cu's passes over rb.cuh's Rb<T> for the host, behind
# rb3c_merge_rank_*'s C signature (the stream dropped), and Rb<T>::rank1
RB_K6_HOST = r"""
#include "merge_rank.cu"
using rb3c::merge::Seg;
using rb3c::merge::Walk;
#define X(name, L)                                                                                                  \
  extern "C" void rank1_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int ms,     \
                               int bs, const int64_t* k, int64_t n, void* out) {                                    \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                          \
    for (int64_t i = 0; i < n; ++i)                                                                                 \
      for (int s = 0; s < 6; ++s) static_cast<L::T*>(out)[6 * i + s] = ix.rank1((L::T)k[i], s);                    \
  }                                                                                                                  \
  extern "C" int merge_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int ms, int bs, \
                              const int64_t* rec, int64_t* ins, int64_t m2, int shift, int64_t first, int64_t n_seg, \
                              int64_t g0, int64_t g1, int passes, int64_t* seg) {                                   \
    if (g0 < 0 || g1 > n_seg) return 1;                                                                              \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                          \
    const Walk w{rec, ins, m2, first, n_seg, shift};                                                                 \
    const Seg s{seg, seg + n_seg, seg + 2 * n_seg, seg + 3 * n_seg, seg + 4 * n_seg};                                \
    for (int64_t g = g0; g < g1; ++g)                                                                                \
      if (passes & 1) rb3c::merge::walk_segment(ix, w, s, g);                                                        \
    for (int64_t g = g0; g < g1 && n_seg > m2; ++g)                                                                  \
      if (passes & 2) rb3c::merge::hand_over(ix, w, s, g);                                                           \
    return 0;                                                                                                        \
  }
X(rb32, rb3c::Rb<int>)
X(rb64, rb3c::Rb<int64_t>)
"""


@pytest.fixture(scope="module")
def k6_rb_host(tmp_path_factory):
    """csrc/merge_rank.cu's passes and rb.cuh's rank1, built for the host with g++."""
    d = tmp_path_factory.mktemp("k6_rb_host")
    (d / "k6_rb_host.cpp").write_text(HOST_SHIM[: HOST_SHIM.index('#include "rb.cuh"')] + RB_K6_HOST)
    so = d / "libk6_rb_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so),
                        str(d / "k6_rb_host.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


def _tables(x) -> list:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    rows, esc, mega, acc, ms, bs = x.kernel_tables()
    return [vp(rows), vp(esc), vp(mega), vp(acc), i32(ms), i32(bs)]


@pytest.mark.parametrize("kind,S", CASES)
@pytest.mark.parametrize("int64", [False, True], ids=["rb32", "rb64"])
def test_rb_rank1_on_the_host(k6_rb_host, b1s, kind, S, int64):
    """Rb<T>::rank1 (one header, then the records of one symbol or the
    escape sub-row), built for the host: rank1a at every k in [0, n] (F1's
    block boundaries and k = n among them) for each of the six symbols."""
    f = b1s[kind][1]
    x = rb_rows(f, S, int64)
    k = torch.arange(f.n + 1)
    out = torch.empty((f.n + 1, 6), dtype=x.dtype)
    getattr(k6_rb_host, f"rank1_{x.layout}")(*_tables(x), ctypes.c_void_p(k.data_ptr()), ctypes.c_int64(k.numel()),
                                             ctypes.c_void_p(out.data_ptr()))
    assert torch.equal(out.long(), x.rank1a(k))


@pytest.mark.parametrize("kind,S", CASES)
@pytest.mark.parametrize("int64", [False, True], ids=["rb32", "rb64"])
@pytest.mark.parametrize("b2", ["mutated", "repeat"])
def test_card_passes_on_the_host(k6_rb_host, b1s, kind, S, int64, b2):
    """merge_rank.cu's two passes over Rb<T> (rank2 while the bounds differ,
    rank1 once they meet, and in the hand-over), built for the host, over
    all segments and over three ranges of them with the records merged by
    a max between the passes, as a mesh runs them: ins and segment records
    equal to merge_rank_chunked_plain's over the same rb rows, at S 8 and 64."""
    from ropebwt3_tpu_torch.parallel import launch

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    seqs, f = b1s[kind]
    x = rb_rows(f, S, int64)
    acc2, rec = merge.lf2_packed(torch.from_numpy(b2_of(b2, seqs)))
    m2 = int(acc2[1])
    run = getattr(k6_rb_host, f"merge_{x.layout}")
    for stride in (8, 64):
        pins, pseg = merge.merge_rank_chunked_plain(x, rec.clone(), m2, stride)
        first, n_seg = merge.segments(rec.numel(), m2, stride)

        def passes(ins, seg, g0, g1, which):
            assert run(*_tables(x), vp(rec.data_ptr()), vp(ins.data_ptr()), i64(m2), i32(stride.bit_length() - 1),
                       i64(first), i64(n_seg), i64(g0), i64(g1), i32(which), vp(seg.data_ptr())) == 0

        ins, seg = torch.full_like(rec, -1), torch.full((merge.SEG_ROWS, n_seg), -1, dtype=torch.int64)
        passes(ins, seg, 0, n_seg, merge.WALK | merge.HAND_OVER)
        assert torch.equal(ins, pins) and torch.equal(seg, pseg), stride
        cuts = [0, n_seg // 3, 2 * n_seg // 3, n_seg]
        ins = [torch.full_like(rec, -1) for _ in range(3)]
        segs = [torch.full((merge.SEG_ROWS, n_seg), merge.LOW, dtype=torch.int64) for _ in range(3)]
        for g0, g1, xi, sg in zip(cuts, cuts[1:], ins, segs):
            passes(xi, sg, g0, g1, merge.WALK)
        full = launch.merge_shares(segs)
        for g0, g1, xi in zip(cuts, cuts[1:], ins):
            passes(xi, full, g0, g1, merge.HAND_OVER)
        assert torch.equal(launch.merge_shares(ins), pins) and torch.equal(full, pseg), stride
