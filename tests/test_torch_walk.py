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
from ropebwt3_tpu_torch.ops import runblock, smem, walk
from ropebwt3_tpu_torch.ops.rank import OccIndex

from .test_torch_cli import _in_process
from .test_torch_cuda import corpus_index, cyclic_bwt_index, n_index  # noqa: F401  (fixture reuse)
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
    1-D integers, rows of no kernel layout (rb rows are one: they walk), a
    stride that is not a positive int (the kernel: a power of two), segment
    ids past 2^31, and the card budget (named in the CapacityError)."""
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
    assert walk.check_retrieve(rb, [0, 5], 8, kernel=True)[1] == int(f.acc[1])
    seqs, ends = walk.retrieve_cuda(rb, [0, 1], 8)
    assert all(np.array_equal(s, f.retrieve(k)[0]) for k, s in zip([0, 1], seqs))
    with pytest.raises(ValueError, match="rows, not rb16"):
        walk.retrieve_cuda(OtherLayout(rb), [0, 1])
    big = OccIndex(idx.occf, torch.tensor([0, 1, 2, 3, 4, 5, 1 << 32]), 1 << 32)
    with pytest.raises(ValueError, match="2\\^31"):
        walk.check_retrieve(big, [0], 1, kernel=False)
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: 1000)
    with pytest.raises(tcli.CapacityError, match="1000 B"):
        walk._fits(torch.device("cpu"), 1001, "the segment records")
    walk._fits(torch.device("cpu"), 1000, "the segment records")


class OtherLayout:
    """An index whose layout no kernel has: the wrappers refuse it."""

    def __init__(self, idx, layout: str = "rb16"):
        self.idx, self.layout = idx, layout

    def __getattr__(self, name):
        return getattr(self.idx, name)


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
RB3C_LAYOUTS(HOST_PASSES)
"""

# K12's entry point in every layout, its C signature kept, and a loop over
# the layout's rank2 for its own test
SUFFIX_ENTRIES = r"""
#define HOST_SUFFIX(name, L)                                                                                        \
  extern "C" int rb3c_suffix_walk_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc,     \
      int ms, int bs, const uint8_t* q, const int64_t* off, int64_t R, int64_t* start, int64_t* last, void*) {      \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                        \
    for (int64_t r = 0; r < R; ++r) blockIdx.x = r, suffix_walk<L>(ix, q, off, R, start, last);                    \
    return 0;                                                                                                       \
  }                                                                                                                 \
  extern "C" void rank2_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int ms, int bs, \
      const int64_t* k, const int64_t* l, const uint8_t* c, int64_t n, int64_t* ok, int64_t* ol) {                 \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                        \
    for (int64_t i = 0; i < n; ++i) {                                                                               \
      typename L::T a, b;                                                                                           \
      ix.rank2((typename L::T)k[i], (typename L::T)l[i], c[i], a, b);                                               \
      ok[i] = a, ol[i] = b;                                                                                         \
    }                                                                                                               \
  }
RB3C_LAYOUTS(HOST_SUFFIX)
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
    entry points) built for the host with g++, one file each, behind K11's,
    K12's and rb3c_ssa_jump's C signatures: a launch runs the kernel once a
    thread id.  Returns kernels.launch's stand-in, with the library as its
    `lib`."""
    shim = HOST_SHIM[: HOST_SHIM.index('#include "rb.cuh"')] + WALK_HOST
    d = tmp_path_factory.mktemp("walk_host")
    files = []
    for name, entries in (("walk", WALK_ENTRIES + SUFFIX_ENTRIES), ("ssa_gen", JUMP_ENTRY)):
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

    launch.lib = lib
    return launch


@pytest.mark.parametrize("which", ["corpus", "cyclic"])
@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32", "rb64"])
def test_walk_cu_on_the_host(walk_host, corpus_index, monkeypatch, which, layout):  # noqa: F811
    """launch_retrieve, the card's path, with the kernels built for the host
    (K11's passes 1, 3 and 4 over each layout's lf_step, and K5's pointer
    jumping) at power-of-two strides (and, on the random BWT, the heads
    alone): symbols, end rows and segment records equal to
    retrieve_seg_plain's (cycle heads included on the random BWT), one
    count a walk.  rb rows at S = 256 (rb64: megablocks of 4 blocks): the
    corpus's mostly run-coded, the random BWT's escapes."""
    monkeypatch.setattr(kernels, "launch", walk_host)
    f = corpus_index if which == "corpus" else cyclic_bwt_index(2)
    idx = (OccIndex.from_dense(f, "cpu", int64=layout == "dense64", mega_shift=10) if layout.startswith("dense")
           else runblock.RunBlockIndex.from_dense(f, "cpu", S=256, int64=layout == "rb64", mega_shift=2, cache=None))
    for S in ((64,) if which == "corpus" else (1, 8, walk.heads_only(f.n))):
        ks = corpus_ks(f, S) if which == "corpus" else list(range(f.n)) + [3, 3]
        want = walk.retrieve_seg_plain(idx, ks, S)
        k, m = walk.check_retrieve(idx, ks, S, kernel=True)
        before = walk.retrieve_cuda.launches[layout]
        got = walk.launch_retrieve(idx, k, m, S)
        assert walk.retrieve_cuda.launches[layout] == before + 1
        assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0])) and np.array_equal(got[1], want[1])
        assert torch.equal(got[2], want[2])


@pytest.fixture(scope="module")
def suffix_texts(corpus_index):  # noqa: F811
    """The corpus index (n = 128,016) and test_torch_cuda's n_index (n =
    16,384, a multiple of 64 and of S = 256: l = n at a row and a block
    boundary, F1)."""
    return {"corpus": corpus_index, "n64": n_index()}


def suffix_index(f, layout: str):
    """f's rows in `layout` on the CPU: dense64 in megablocks of 2^16
    symbols (the corpus index's two) or, on a smaller index, of 256; rb at
    S = 256 (rb64: megablocks of 4 blocks)."""
    if layout.startswith("dense"):
        return OccIndex.from_dense(f, "cpu", int64=layout == "dense64", mega_shift=10 if f.n > 1 << 16 else 2)
    return runblock.RunBlockIndex.from_dense(f, "cpu", S=256, int64=layout == "rb64", mega_shift=2, cache=None)


def suffix_reads(f, seed: int) -> list[np.ndarray]:
    """Seeded reads of f's own sequences (DenseFMIndex.retrieve): pieces of
    20-300 symbols, half of them with 1% substitutions and some with N's;
    random reads; a sequence's first 2,500 symbols (n_index's: all of
    it); an empty read and a lone N."""
    rng = np.random.default_rng(seed)
    seqs = [f.retrieve(k)[0] for k in range(int(f.acc[1]))]
    reads = []
    for j in range(400):
        s = seqs[j % len(seqs)]
        ln = int(rng.integers(20, 300))
        st = int(rng.integers(0, max(1, len(s) - ln)))
        r = s[st : st + ln].copy()
        if j % 2:
            mut = rng.random(len(r)) < 0.01
            r[mut] = rng.integers(1, 5, int(mut.sum()))
        if j % 7 == 0:
            r[rng.random(len(r)) < 0.02] = 5
        reads.append(r.astype(np.uint8))
    reads += [rng.integers(1, 5, int(rng.integers(5, 40))).astype(np.uint8) for _ in range(50)]
    return reads + [seqs[0][:2500].astype(np.uint8), np.zeros(0, np.uint8), np.full(1, 5, np.uint8)]


def jax_suffix(f, reads, tmp_path) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's main_suffix of `reads` on f (an FMD written by its
    plain2fmd): each read's start and last interval size."""
    alpha = np.frombuffer(b"$ACGTN", np.uint8)
    bwt = tmp_path / "bwt.txt"
    bwt.write_bytes(alpha[f.bwt[: f.n]].tobytes())
    rc, data = _in_process(jcli.main, ["plain2fmd", str(bwt)])
    assert rc == 0
    fmd, fa = tmp_path / "s.fmd", tmp_path / "q.fa"
    fmd.write_bytes(data)
    fa.write_bytes(b"".join(b">r%d\n%s\n" % (i, alpha[r].tobytes()) for i, r in enumerate(reads)))
    rc, out = _in_process(jcli.main, ["suffix", str(fmd), str(fa)])
    rows = [ln.split(b"\t") for ln in out.splitlines()]
    assert rc == 0 and len(rows) == len(reads) and all(int(x[2]) == len(r) for x, r in zip(rows, reads))
    return np.array([int(x[1]) for x in rows]), np.array([int(x[3]) for x in rows])


@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32", "rb64"])
@pytest.mark.parametrize("which", ["corpus", "n64"])
def test_suffix_walk_on_the_host(walk_host, suffix_texts, monkeypatch, tmp_path, which, layout):
    """K12, csrc/walk.cu suffix_walk over each layout's rank2, built for
    the host behind its C signature and launched by launch_suffix (the
    card's path): start and last equal to suffix_plain's and to the JAX
    package's main_suffix, read for read."""
    monkeypatch.setattr(kernels, "launch", walk_host)
    f = suffix_texts[which]
    idx = suffix_index(f, layout)
    reads = suffix_reads(f, 21)
    flat, off = (torch.from_numpy(a) for a in smem.pack_reads(reads))
    want = walk.suffix_plain(idx, flat, off)
    want_start, want_last = jax_suffix(f, reads, tmp_path)
    assert np.array_equal(want[0].numpy(), want_start) and np.array_equal(want[1].numpy(), want_last)
    start, last = torch.full_like(want[0], -7), torch.full_like(want[1], -7)
    walk.launch_suffix(idx, flat, off, start, last)
    assert torch.equal(start, want[0]) and torch.equal(last, want[1])
    lens = off[1:] - off[:-1]
    assert bool((want[0] == 0)[lens > 0].any()) and bool((want[0] > 0).any())  # whole matches, and stops


@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32", "rb64"])
def test_rank2_on_the_host(walk_host, suffix_texts, layout):
    """Each layout's rank2 (occ_c at both ends, one symbol) against
    rank1a's column c, on n_index's rows: pairs in one row or block, pairs
    that straddle a row, a block, a 128-symbol sub-row or a megablock
    (256 symbols dense64, 1,024 rb64), k = l, and ends at n, a multiple of
    64 and of S (F1)."""
    f = suffix_texts["n64"]
    idx = suffix_index(f, layout)
    n = f.n
    rng = np.random.default_rng(5)
    k = rng.integers(0, n + 1, 3000)
    l = np.minimum(n, k + np.concatenate([rng.integers(0, 64, 1000), rng.integers(0, 600, 1000),
                                          rng.integers(0, n, 1000)]))
    edges = [(n, n), (n - 1, n), (0, n), (0, 0), (64, 128), (63, 64), (255, 256), (256, 512), (1023, 1025),
             (127, 129), (n - 64, n), (n - 256, n)]
    k = np.concatenate([k, [a for a, _ in edges]]).astype(np.int64)
    l = np.concatenate([l, [b for _, b in edges]]).astype(np.int64)
    c = rng.integers(0, 6, len(k)).astype(np.uint8)
    ok, ol = np.zeros(len(k), np.int64), np.zeros(len(k), np.int64)
    fn = getattr(walk_host.lib, f"rank2_{layout}")
    fn.argtypes = [*kernels._TABLES, *[ctypes.c_void_p] * 3, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    fn(*idx.kernel_tables(), k.ctypes.data, l.ctypes.data, c.ctypes.data, len(k), ok.ctypes.data, ol.ctypes.data)
    ci = torch.from_numpy(c.astype(np.int64))[:, None]
    want_k = idx.rank1a(torch.from_numpy(k)).long().gather(1, ci)[:, 0]
    want_l = idx.rank1a(torch.from_numpy(l)).long().gather(1, ci)[:, 0]
    assert np.array_equal(ok, want_k.numpy()) and np.array_equal(ol, want_l.numpy())


@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32", "rb64"])
def test_walk_time_counts_the_steps(suffix_texts, layout):
    """walk_time's step record on the CPU: every step's (k, l, c), in
    lock-step order, as each read's own backward search from its last
    symbol gives them; and the row fetches of both designs (rank6: two
    rows, or two headers and two second rounds, a step; rank2 fewer, where
    the ends share them)."""
    from ropebwt3_tpu_torch import walk_time

    f = suffix_texts["corpus"]
    idx = suffix_index(f, layout)
    reads = suffix_reads(f, 3)
    reads = reads[:-3:30] + reads[-2:]  # not the 2,500-step read: as many lock-steps
    flat, off = (torch.from_numpy(a) for a in smem.pack_reads(reads))
    counted = walk_time.Steps(idx)
    start, _ = walk.suffix_plain(counted, flat, off)
    k, l, c, steps = walk_time.step_symbols(counted.calls, flat, off, start)
    acc = idx.acc.long().tolist()
    own = []  # each read's steps, one backward search at a time
    for r in reads:
        kk, ll, seq = 0, f.n, []
        for i in range(len(r) - 1, -1, -1):
            seq.append((kk, ll, int(r[i])))
            occ = idx.rank1a(torch.tensor([kk, ll])).long()
            kk, ll = acc[r[i]] + int(occ[0, r[i]]), acc[r[i]] + int(occ[1, r[i]])
            if ll <= kk:
                break
        own.append(seq)
    assert [len(x) for x in own] == steps.tolist()
    want = [own[r][t] for t in range(max(map(len, own))) for r in range(len(own)) if len(own[r]) > t]
    assert list(zip(k.tolist(), l.tolist(), c.tolist())) == want
    tr = walk_time.traffic(idx, k, l)
    N = k.numel()
    per = 2 if layout.startswith("dense") else 4
    assert tr["rank6"]["fetches"] == per * N and N <= tr["rank2"]["fetches"] < per * N
    assert tr["rank2"]["sectors"] < tr["rank6"]["sectors"]
