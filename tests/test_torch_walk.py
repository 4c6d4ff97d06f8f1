"""`get`'s segmented LF walk (ops/walk.py, K11 of csrc/walk.cu) on the CPU:
retrieve_seg_plain against the JAX package's DenseFMIndex.retrieve (numpy
and its native walk, no JAX compile) at several strides, on the corpus
index and on random BWT strings with `$`-free LF cycles; the segment
records after pointer jumping against the reference's walk from each
segment's start; `get --device=cpu` against `python -m ropebwt3_tpu get` on
an FMD with cycles; the F2 refusals; and the card's path, launch_retrieve,
over the kernels built for the host with g++, against retrieve_seg_plain."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch import kernels
from ropebwt3_tpu_torch.kernels import CSRC
from ropebwt3_tpu_torch.ops import runblock, walk
from ropebwt3_tpu_torch.ops.rank import OccIndex

from .test_torch_cli import _in_process
from .test_torch_cuda import corpus_index, cyclic_bwt_index  # noqa: F401  (fixture reuse)
from .test_torch_runblock import HOST_SHIM

HEADS = "heads"  # the heads-only stride, heads_only(n)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The lock-step plain walk runs thousands of small ops, which intra-op
    threads only slow down (most under several test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stride_of(S, n: int) -> int:
    return walk.heads_only(n) if S == HEADS else S


def lf_steps(f, k: int, j: int) -> int:
    """LF^j(k) by the JAX package's DenseFMIndex.lf (no `$` on the way)."""
    for _ in range(j):
        c, k = f.lf(np.array(k))
        assert int(c) != 0
        k = int(k)
    return k


def corpus_ks(f, S: int) -> list[int]:
    """Every sentinel row (each sequence whole), n - 1, a `$` row, a
    duplicate, a k 1,000 steps down row 0's walk (nested ks), a strided
    start row and seeded random rows."""
    m = int(f.acc[1])
    rng = np.random.default_rng(15)
    rand = rng.integers(0, f.n, 12).tolist()
    dollar = int(np.flatnonzero(f.bwt[: f.n] == 0)[-1])
    strided = m + 3 * (S if S <= f.n - m else 64)
    return [*range(m), f.n - 1, dollar, rand[0], lf_steps(f, 0, 1000), strided, *rand]


def assert_same_as_reference(f, ks, seqs, ends):
    assert len(seqs) == len(ks) == len(ends)
    for k, s, e in zip(ks, seqs, ends):
        want, wend = f.retrieve(k)
        assert np.array_equal(s, want) and int(e) == wend, k


@pytest.mark.parametrize("S", [1, 3, 8, 64, HEADS])
def test_retrieve_seg_plain_matches_jax(corpus_index, S):  # noqa: F811
    """retrieve_seg_plain at stride S on the corpus index (16 sequences of
    8 kb) against DenseFMIndex.retrieve, symbol for symbol and end row."""
    f = corpus_index
    S = stride_of(S, f.n)
    idx = OccIndex.from_dense(f, "cpu")
    ks = corpus_ks(f, S)
    seqs, ends, rec = walk.retrieve_seg_plain(idx, ks, S)
    assert_same_as_reference(f, ks, seqs, ends)
    assert rec.shape == (4, walk.segments(f.n, int(f.acc[1]), len(ks), S))
    assert len(seqs[int(f.acc[1]) + 1]) == 0 and max(len(s) for s in seqs) == 8000
    assert bool((rec[2] < 0).all())  # a built index has no `$`-free cycle


@pytest.mark.parametrize("seed", range(6))
def test_retrieve_seg_plain_on_cycles(seed):
    """Every row of a random BWT string (LF cycles without `$`), at every
    stride: a cycle head gives n symbols and LF^n(k), as the reference's
    max_len = n walk does; records of the cycle heads keep nxt >= 0."""
    f = cyclic_bwt_index(seed)
    idx = OccIndex.from_dense(f, "cpu")
    ks = list(range(f.n))
    lens = None
    for S in (1, 3, 8, 64, walk.heads_only(f.n)):
        seqs, ends, rec = walk.retrieve_seg_plain(idx, ks, S)
        assert_same_as_reference(f, ks, seqs, ends)
        cyc = rec[2][: f.n] >= 0
        assert bool(cyc.any()) and all(len(seqs[i]) == f.n for i in torch.nonzero(cyc)[:, 0].tolist())
        lens = [len(s) for s in seqs] if lens is None else lens
        assert lens == [len(s) for s in seqs]
    assert walk.retrieve_plain(idx, ks)[1].tolist() == ends.tolist()


@pytest.mark.parametrize("which", ["corpus", "cyclic"])
def test_records_match_a_lockstep_walk(corpus_index, which):  # noqa: F811
    """After pointer jumping, each segment that reaches a `$` holds d = the
    symbols from its start to it and term = its row, as the reference's
    walk from the segment's start gives them; a segment on a `$`-free cycle
    keeps nxt >= 0 and term -1; pass 1's length is the steps to the first
    `$`, strided start row or (a head) its own start."""
    f = corpus_index if which == "corpus" else cyclic_bwt_index(7)
    idx = OccIndex.from_dense(f, "cpu")
    m = int(f.acc[1])
    rng = np.random.default_rng(3)
    ks = [int(k) for k in rng.integers(0, f.n, 6)]
    for S in ((64,) if which == "corpus" else (1, 3, 8)):
        _, _, (length, d, nxt, term) = walk.retrieve_seg_plain(idx, ks, S)
        n_seg = d.numel()
        starts = ks + [m + j * S for j in range(n_seg - len(ks))]
        check = range(n_seg) if which == "cyclic" else rng.choice(n_seg, 40, replace=False).tolist()
        for g in check:
            s0 = starts[g]
            seq, end = f.retrieve(s0)
            if nxt[g] < 0:
                assert int(d[g]) == len(seq) and int(term[g]) == end, g
            else:
                assert len(seq) == f.n and int(term[g]) == -1, g
            k, t = s0, 0
            while True:
                c, nk = f.lf(np.array(k))
                if int(c) == 0:
                    break
                t += 1
                if (int(nk) - m) % S == 0 or (g < len(ks) and int(nk) == s0):
                    break
                k = int(nk)
            assert int(length[g]) == t, g


def test_get_on_a_cyclic_fmd_matches_reference(tmp_path):
    """plain2fmd of a BWT string with `$`-free cycles (both packages write
    the same FMD), then `get --device=cpu` of every row and garbage
    against `python -m ropebwt3_tpu get`, byte for byte: each cycle row
    prints n symbols."""
    rng = np.random.default_rng(11)
    n = 300
    txt = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, n)].copy()
    txt[rng.choice(n, 3, replace=False)] = ord("$")
    bwt = tmp_path / "bwt.txt"
    bwt.write_bytes(txt.tobytes())
    fmd = tmp_path / "c.fmd"
    rc, data = _in_process(jcli.main, ["plain2fmd", str(bwt)])
    assert rc == 0 and data == _in_process(tcli.main, ["plain2fmd", str(bwt)])[1]
    fmd.write_bytes(data)
    argv = ["get", str(fmd), *map(str, range(n + 1)), "x", "-1", "7"]
    want = _in_process(jcli.main, argv)[1]
    rc, got = _in_process(tcli.main, argv[:1] + ["--device=cpu"] + argv[1:])
    assert rc == 0 and got == want
    assert any(len(ln) == n for ln in want.split(b"\n")[1::2])  # a cycle row's n symbols


def test_retrieve_checks_its_inputs(corpus_index, monkeypatch):  # noqa: F811
    """F2, before any walk: positions outside [0, n), a k list that is not
    1-D integers, rb rows, a stride that is not a positive int (the kernel:
    a power of two), segment ids past 2^31, and the card budget (named in
    the CapacityError)."""
    f = corpus_index
    idx = OccIndex.from_dense(f, "cpu")
    for ks in ([0, f.n], [-1, 0], [[0, 1]], [0.5]):
        with pytest.raises(ValueError):
            walk.retrieve_cuda(idx, ks, 8)
    for S in (0, -4, 2.0):
        with pytest.raises(ValueError):
            walk.retrieve_seg_plain(idx, [0], S)
    walk.check_retrieve(idx, [0, 5], 3, kernel=False)
    with pytest.raises(ValueError, match="power-of-two"):
        walk.check_retrieve(idx, [0, 5], 3, kernel=True)
    rb = runblock.RunBlockIndex.from_dense(f, "cpu", S=256, cache=None)
    with pytest.raises(ValueError, match="dense rows"):
        walk.retrieve_cuda(rb, [0, 1])
    big = OccIndex(idx.occf, torch.tensor([0, 1, 2, 3, 4, 5, 1 << 32]), 1 << 32)
    with pytest.raises(ValueError, match="2\\^31"):
        walk.check_retrieve(big, [0], 1, kernel=False)
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: 1000)
    with pytest.raises(tcli.CapacityError, match="1000 B"):
        walk._fits(torch.device("cpu"), 1001, "the segment records")
    walk._fits(torch.device("cpu"), 1000, "the segment records")


def test_walk_stride():
    """The heads alone on a short-read index (mean sequence below 16
    strides) and when the heads fill the card; else merge.stride's rule."""
    cpu = torch.device("cpu")
    assert walk.walk_stride(64_000_032, 32, 34, cpu) == 1 << 15  # one SM: 2,048 lanes
    assert walk.walk_stride(15_100_000, 100_000, 3, cpu) == walk.heads_only(15_100_000)
    assert walk.walk_stride(64_000_032, 32, 4096, cpu) == walk.heads_only(64_000_032)
    assert walk.segments(100, 4, 2, walk.heads_only(100)) == 2 and walk.segments(100, 4, 2, 8) == 14


WALK_HOST = r"""
struct Dim3 { int64_t x; };
static Dim3 blockIdx{0}, blockDim{1}, threadIdx{0}, gridDim{1};
#define __host__
"""

# csrc/walk.cu's K11 entry points and ssa_gen.cu's rb3c_ssa_jump, their C
# signatures kept, each launch a loop over the thread ids
WALK_ENTRIES = r"""
#define HOST_PASSES(name, L)                                                                                        \
  extern "C" int rb3c_retrieve_seg_walk_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, \
      int ms, int bs, const int64_t* ks, int64_t q, int64_t m, int shift, int64_t n_seg, int64_t* seg, int64_t* len, \
      void*) {                                                                                                      \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                        \
    for (int64_t g = 0; g < n_seg; ++g) blockIdx.x = g, retrieve_seg_walk<L>(ix, ks, q, m, shift, n_seg, seg, len); \
    return 0;                                                                                                       \
  }                                                                                                                 \
  extern "C" int rb3c_retrieve_seg_write_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, \
      int ms, int bs, const int64_t* ks, int64_t q, int64_t m, int shift, int64_t n_seg, const int64_t* seg,        \
      const int64_t* len, const int64_t* terms, const int64_t* lmax, const int64_t* base, int64_t u, uint8_t* out,  \
      void*) {                                                                                                      \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                        \
    for (int64_t g = 0; g < n_seg; ++g)                                                                            \
      blockIdx.x = g, retrieve_seg_write<L>(ix, ks, q, m, shift, n_seg, seg, len, terms, lmax, base, u, out);      \
    return 0;                                                                                                       \
  }                                                                                                                 \
  extern "C" int rb3c_retrieve_seg_cycle_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, \
      int ms, int bs, const int64_t* ks, const int64_t* heads, int64_t n_cyc, int64_t n, uint8_t* out,             \
      int64_t* period, int64_t* end, void*) {                                                                       \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                        \
    for (int64_t i = 0; i < n_cyc; ++i) blockIdx.x = i, retrieve_seg_cycle<L>(ix, ks, heads, n_cyc, n, out, period, end); \
    blockIdx.x = 0;                                                                                                 \
    retrieve_seg_tile(n_cyc, n, out, period);                                                                      \
    return 0;                                                                                                       \
  }
HOST_PASSES(dense32, rb3c::Dense<int>)
HOST_PASSES(dense64, rb3c::Dense<int64_t>)
"""

JUMP_ENTRY = r"""
extern "C" int rb3c_ssa_jump(int64_t* seg, int64_t n_seg, int rounds, void*) {
  for (int i = 0; i < rounds; ++i) {
    const Segs a = segs_at(seg + (i % 2) * 3 * n_seg, n_seg), b = segs_at(seg + (1 - i % 2) * 3 * n_seg, n_seg);
    for (int64_t g = 0; g < n_seg; ++g) blockIdx.x = g, ssa_jump_round(a, b, n_seg);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def walk_host(tmp_path_factory):
    """csrc/walk.cu's and ssa_gen.cu's kernels (the text before their C
    entry points) built for the host with g++, one file each, behind K11's
    and rb3c_ssa_jump's C signatures: a launch runs the kernel once a
    thread id.  Returns kernels.launch's stand-in."""
    shim = HOST_SHIM[: HOST_SHIM.index('#include "rb.cuh"')] + WALK_HOST
    d = tmp_path_factory.mktemp("walk_host")
    files = []
    for name, entries in (("walk", WALK_ENTRIES), ("ssa_gen", JUMP_ENTRY)):
        src = open(f"{CSRC}/{name}.cu").read()
        body = src[: src.index('extern "C" {')].replace("#include <cuda_runtime.h>", "")
        files.append(d / f"{name}_host.cpp")
        files[-1].write_text(shim + body + entries)
    so = d / "libwalk_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so), *map(str, files)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))

    def launch(name, device, *args):
        fn = getattr(lib, name)
        fn.argtypes = kernels._ENTRIES[name]
        assert fn(*args, None) == 0

    return launch


@pytest.mark.parametrize("which", ["corpus", "cyclic"])
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
def test_walk_cu_on_the_host(walk_host, corpus_index, monkeypatch, which, layout):  # noqa: F811
    """launch_retrieve, the card's path, with the kernels built for the host
    (K11's passes 1, 3 and 4 and K5's pointer jumping) at power-of-two
    strides (and, on the random BWT, the heads alone): symbols, end rows
    and segment records equal to retrieve_seg_plain's (cycle heads
    included on the random BWT), one count a walk."""
    monkeypatch.setattr(kernels, "launch", walk_host)
    f = corpus_index if which == "corpus" else cyclic_bwt_index(2)
    idx = OccIndex.from_dense(f, "cpu", int64=layout == "dense64", mega_shift=10)
    for S in ((64,) if which == "corpus" else (1, 8, walk.heads_only(f.n))):
        ks = corpus_ks(f, S) if which == "corpus" else list(range(f.n)) + [3, 3]
        want = walk.retrieve_seg_plain(idx, ks, S)
        k, m = walk.check_retrieve(idx, ks, S, kernel=True)
        before = walk.retrieve_cuda.launches[layout]
        got = walk.launch_retrieve(idx, k, m, S)
        assert walk.retrieve_cuda.launches[layout] == before + 1
        assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0])) and np.array_equal(got[1], want[1])
        assert torch.equal(got[2], want[2])
