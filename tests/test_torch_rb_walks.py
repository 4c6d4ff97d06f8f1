"""`get`, `suffix`, `kount` and `ssa` on run-block (rb) rows, on the CPU.

The LF step over rb rows (ops/rank.py `lf` over `RunBlockIndex.sym_at`),
the plain walks (retrieve_seg_plain, ssa_gen_seg_plain) and kount's plain
level rank over rb32 and rb64 rows, at S = 256 (mostly run-coded blocks)
and S = 8192 (every block an escape), rb64 in megablocks of four blocks:
each against the JAX package's host functions (DenseFMIndex.lf, .retrieve,
.rank1a_fast, the native SSA), exact.  The four commands through the
port's CLI with `--device=cpu` on rb rows (RB3TPU_DEVICE_OCC=rb, or auto
where the dense rows pass the budget), byte-equal to `python -m
ropebwt3_tpu`, their stderr naming the rb layout; rb rows past the card's
budget stop before any upload.  The card's routines built for the host with
g++ (HOST_SHIM): Rb<T>::lf_step behind rb3c_occ_lf, and K5's three passes
(csrc/ssa_gen.cu) behind their C signatures, launched by ssa_ops.launch_walk.
No JAX compile: the JAX package's functions here are host numpy and its
native library."""

import contextlib
import ctypes
import io
import subprocess
from collections import Counter

import numpy as np
import pytest
import torch

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.formats.ssa import write_ssa_bytes
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.nt6 import char2nt6, revcomp
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu.ssa_ops import ssa_gen_native
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch import kernels, ssa_ops
from ropebwt3_tpu_torch.kernels import CSRC
from ropebwt3_tpu_torch.ops import kount, rank, runblock, smem, walk

from .test_torch_cuda import corpus_index  # noqa: F401  (fixture reuse)
from .test_torch_runblock import HOST_SHIM
from .test_torch_walk import JUMP_ENTRY, WALK_HOST, corpus_ks, one_thread  # noqa: F401  (one_thread: autouse)

RB = [("rb32", 256), ("rb32", 8192), ("rb64", 256), ("rb64", 8192)]
RB_IDS = [f"{lay}-S{S}" for lay, S in RB]
MEGA_SHIFT = 2  # rb64: megablocks of four blocks, several on the corpus index at either S
SEG = 64  # the segment stride of the plain walks here (not the rb block size)
SS = 4  # the SSA's sample shift


def rb_rows(f, layout: str, S: int) -> runblock.RunBlockIndex:
    """f's rb rows on the CPU at block size S, rb64 in megablocks of four
    blocks; the S = 8192 rows are all escapes, the S = 256 rows mostly
    run-coded."""
    x = runblock.RunBlockIndex.from_dense(f, "cpu", S=S, int64=layout == "rb64",
                                          mega_shift=MEGA_SHIFT if layout == "rb64" else None, cache=None)
    nb = x.rows.shape[0]
    assert x.layout == layout and (x.n_esc == nb if S == 8192 else 2 * x.n_esc < nb)
    assert not x.int64 or x.mega.shape[0] > 1
    return x


@pytest.fixture(scope="module")
def first_genome_index(corpus):
    """The corpus's first genome alone, double strand (kount's second index)."""
    s = char2nt6(next(iter(read_seqs(str(corpus / "genomes.fa")))).seq)
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate([s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)])))


def write_fmd(f, path) -> str:
    """f as an FMD, through the JAX package's plain2fmd of its BWT text."""
    bwt = path.with_suffix(".txt")
    bwt.write_bytes(np.frombuffer(b"$ACGTN", np.uint8)[f.bwt[: f.n]].tobytes())
    rc, data = run_main(jcli.main, ["plain2fmd", str(bwt)])[:2]
    assert rc == 0
    path.write_bytes(data)
    return str(path)


def run_main(main, argv) -> tuple[int, bytes, str]:
    """(exit code, stdout bytes, stderr) of a CLI's main in this process."""
    buf, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    out.flush()
    return rc, buf.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def fmds(corpus, corpus_index, first_genome_index, tmp_path_factory):  # noqa: F811
    """The two indexes as FMDs, and `get`'s positions on the corpus's: the
    row 7,700 steps down each of its first four sequences' walks (300
    symbols each, so the plain walk takes 300 lock-step trips), a sentinel
    row (an empty sequence) and n."""
    d = tmp_path_factory.mktemp("rb_walks")
    f = corpus_index
    k = np.arange(4)
    for _ in range(7700):
        k = f.lf(k)[1]
    return {"corpus": write_fmd(f, d / "corpus.fmd"), "g0": write_fmd(first_genome_index, d / "g0.fmd"), "dir": d,
            "n": f.n, "short": k.tolist(), "dollar": int(np.flatnonzero(f.bwt[: f.n] == 0)[0])}


def command(cmd: str, fmds: dict, corpus, out: str | None = None) -> list[str]:
    """The argv of `cmd` on the FMDs: get of short walks, a sentinel row,
    a duplicate, garbage and positions outside [0, n); suffix of the corpus reads; kount of one index and of two;
    ssa -s 4 into `out`."""
    fmd = fmds["corpus"]
    if cmd == "get":
        n, short, dollar = fmds["n"], fmds["short"], fmds["dollar"]
        return ["get", fmd, *map(str, [*short, dollar, "abc", short[1], -1, n])]
    if cmd == "suffix":
        return ["suffix", fmd, str(corpus / "reads.fa")]
    if cmd == "kount":
        return ["kount", "-k", "6", "-m", "20", fmd]
    if cmd == "kount2":
        return ["kount", "-k5", "-m3", fmd, fmds["g0"]]
    return ["ssa", "-s", str(SS), "-o", out, fmd]


@pytest.fixture(scope="module")
def references(fmds, corpus):
    """`python -m ropebwt3_tpu`'s output of each command (ssa: the file),
    in this process, made once."""
    memo = {}

    def get(cmd: str) -> bytes:
        if cmd not in memo:
            out = str(fmds["dir"] / "ref.ssa")
            rc, data, _ = run_main(jcli.main, command(cmd, fmds, corpus, out))
            assert rc == 0
            memo[cmd] = open(out, "rb").read() if cmd == "ssa" else data
            assert memo[cmd]
        return memo[cmd]

    return get


def port_command(cmd: str, fmds: dict, corpus, tag: str) -> tuple[int, bytes, str]:
    """The port's `cmd` with --device=cpu in this process: (exit code, its
    output (ssa: the file), stderr)."""
    out = str(fmds["dir"] / f"port_{tag}.ssa")
    argv = command(cmd, fmds, corpus, out)
    rc, data, err = run_main(tcli.main, [argv[0], "--device=cpu", *argv[1:]])
    return rc, (open(out, "rb").read() if cmd == "ssa" and rc == 0 else data), err


def force_rows(monkeypatch, layout: str, S: int) -> None:
    """The CLI's rb rows at block size S in `layout` (rb64: megablocks of
    four blocks), built fresh: from_dense_np patched, as the chooser calls it."""
    build = runblock.from_dense_np
    monkeypatch.setattr(runblock, "from_dense_np", lambda f, **kw: build(
        f, S=S, int64=layout == "rb64", mega_shift=MEGA_SHIFT if layout == "rb64" else None, cache=None))


# ---------------------------------------------------------------------------
# the plain versions over rb rows against the JAX package's host functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,S", RB, ids=RB_IDS)
def test_lf_over_rb_rows_matches_jax(corpus_index, layout, S):  # noqa: F811
    """sym_at and ops/rank.py `lf` over rb rows at every k of the corpus
    index: equal to the BWT and to DenseFMIndex.lf."""
    f = corpus_index
    x = rb_rows(f, layout, S)
    k = np.arange(f.n)
    c, nk = f.lf(k)
    got_c, got_nk = rank.lf(x, torch.from_numpy(k))
    assert np.array_equal(got_c.numpy(), c) and np.array_equal(got_nk.numpy(), nk)
    assert np.array_equal(x.sym_at(torch.from_numpy(k[::97])).numpy(), f.bwt[: f.n : 97])
    c32, nk_w = rank.lf_cuda(x, torch.from_numpy(k[::97]))  # a CPU index: the plain version, in the kernel's types
    assert c32.dtype == torch.int32 and nk_w.dtype == x.dtype and np.array_equal(nk_w.numpy(), nk[::97])


@pytest.mark.parametrize("layout,S", RB, ids=RB_IDS)
def test_retrieve_seg_plain_on_rb_rows(corpus_index, layout, S):  # noqa: F811
    """`get`'s plain walk over rb rows at segment stride 64: each k's
    symbols and end row equal to DenseFMIndex.retrieve's, and the segment
    records equal to the walk over dense rows (the walk is the BWT's)."""
    f = corpus_index
    ks = corpus_ks(f, SEG)
    seqs, ends, rec = walk.retrieve_seg_plain(rb_rows(f, layout, S), ks, SEG)
    for k, s, e in zip(ks, seqs, ends):
        want, wend = f.retrieve(k)
        assert np.array_equal(s, want) and int(e) == wend, k
    assert torch.equal(rec, walk.retrieve_seg_plain(rank.OccIndex.from_dense(f, "cpu"), ks, SEG)[2])


@pytest.mark.parametrize("layout,S", RB, ids=RB_IDS)
def test_ssa_gen_seg_plain_on_rb_rows(corpus_index, layout, S):  # noqa: F811
    """K5's plain passes over rb rows: the SSA byte-equal to the JAX
    package's native SSA; every row walked once."""
    f = corpus_index
    m = int(f.acc[1])
    x = rb_rows(f, layout, S)
    *got, rec = ssa_ops.ssa_gen_seg_plain(x, m, SS, SEG)
    assert write_ssa_bytes(ssa_ops.assemble(m, SS, *got)) == write_ssa_bytes(ssa_gen_native(f, SS))
    assert int(rec[0].sum()) == f.n and bool((rec[2] == -1).all())  # every row walked once, every segment reached


@pytest.mark.parametrize("layout,S", RB, ids=RB_IDS)
def test_ssa_bytes_counts_rb_rows(corpus_index, layout, S):  # noqa: F811
    """ssa_bytes with rb rows counts their arrays (RunBlockIndex.nbytes)
    in place of the dense rows, and every array of the walk, with no more
    above their bytes than the allocator's rounding."""
    f = corpus_index
    m = int(f.acc[1])
    x = rb_rows(f, layout, S)
    w = 8 if x.int64 else 4
    n_ssa = ssa_ops.n_slots(x, m, SS)
    for seg in (1, SEG, ssa_ops.heads_only(f.n)):
        held = x.nbytes + (w + 4) * n_ssa + (2 * w + 4) * m + 48 * ssa_ops.segments(f.n, m, seg)
        got = ssa_ops.ssa_bytes(f.n, m, SS, seg, rb=x)
        assert held <= got <= held + 9 * ssa_ops.ALLOC_ROUND + 9 * ssa_ops.ALLOC_SPLIT * (got >= ssa_ops.ALLOC_SPLIT)


@pytest.mark.parametrize("layout,S", RB, ids=RB_IDS)
def test_kount_rank_plain_on_rb_rows(corpus_index, layout, S):  # noqa: F811
    """kount's plain level rank over rb rows on every level of the corpus's
    `kount -k 8 -m 2` frontier: ok and size equal to the JAX package's
    rank1a_fast at k and l."""
    f = corpus_index
    x = rb_rows(f, layout, S)
    levels = []
    kount.kount_levels([x], 8, 2, on_level=lambda d, ks, ls, chars: levels.append((ks[0], ls[0])))
    assert len(levels) == 8 and max(len(k) for k, _ in levels) > 10_000
    for k, l in levels:
        ok, size = kount.kount_rank_cuda(x, k, l)  # a CPU index: kount_rank_plain
        assert ok.dtype == x.dtype
        rk, rl = f.rank1a_fast(k.numpy()), f.rank1a_fast(l.numpy())
        assert np.array_equal(ok.numpy(), rk[:, 1:5].T) and np.array_equal(size.numpy(), (rl - rk)[:, 1:5].T)


# ---------------------------------------------------------------------------
# the CLI on rb rows
# ---------------------------------------------------------------------------

CMDS = ["get", "suffix", "kount", "kount2", "ssa"]
LOG = {"get": "retrieve_seg walks", "suffix": "suffix_walk launches", "kount": "kount_rank launches",
       "kount2": "kount_rank launches", "ssa": "ssa_gen launches"}


@pytest.mark.parametrize("layout,S", RB, ids=RB_IDS)
@pytest.mark.parametrize("cmd", CMDS)
def test_cli_on_rb_rows_matches_reference(fmds, corpus, references, monkeypatch, cmd, layout, S):
    """get, suffix, kount (one index and two) and ssa -s 4 with
    --device=cpu and RB3TPU_DEVICE_OCC=rb: output byte-equal to `python -m
    ropebwt3_tpu`'s; stderr names the rb layout and its block size, in the
    rows' line and in the command's launch line."""
    monkeypatch.setenv("RB3TPU_DEVICE_OCC", "rb")
    force_rows(monkeypatch, layout, S)
    rc, got, err = port_command(cmd, fmds, corpus, f"{cmd}_{layout}_{S}")
    assert rc == 0 and got == references(cmd)
    assert f"occ layout {layout} (block size S {S}," in err and f"{LOG[cmd]} ({layout})" in err, err


@pytest.mark.parametrize("cmd", ["get", "suffix", "kount2", "ssa"])
def test_auto_picks_rb_rows(fmds, corpus, references, monkeypatch, cmd):
    """With no override and a budget the dense rows pass (AUTO_RB_BYTES_CPU
    patched small), the chooser takes rb32 rows, from the `.rb.npz` cache
    after the first command: output byte-equal, stderr naming rb32."""
    monkeypatch.delenv("RB3TPU_DEVICE_OCC", raising=False)
    monkeypatch.setattr(smem, "AUTO_RB_BYTES_CPU", 1000)
    rc, got, err = port_command(cmd, fmds, corpus, f"auto_{cmd}")
    assert rc == 0 and got == references(cmd)
    assert "occ layout rb32 (block size S " in err and f"{LOG[cmd]} (rb32)" in err, err
    monkeypatch.setattr(smem, "AUTO_RB_BYTES_CPU", 1e12)  # dense rows within the budget: dense32
    rc, got, err = port_command(cmd, fmds, corpus, f"auto_dense_{cmd}")
    assert rc == 0 and got == references(cmd) and "occ layout dense32" in err


@pytest.mark.parametrize("cmd", ["get", "suffix", "kount2", "ssa"])
def test_rb_rows_past_the_card_budget(fmds, corpus, monkeypatch, cmd):
    """rb rows larger than the card's budget (card_bytes patched): one
    ERROR line naming their bytes and the budget, no output, no rows
    uploaded and no launch."""
    monkeypatch.setenv("RB3TPU_DEVICE_OCC", "rb")
    monkeypatch.setenv("RB3TPU_STRICT_EXIT", "1")
    force_rows(monkeypatch, "rb32", 256)
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: 1000)

    def no_upload(*a, **kw):
        raise AssertionError("rb rows uploaded past the budget")

    monkeypatch.setattr(runblock.RunBlockIndex, "from_np", no_upload)
    counters = (walk.retrieve_cuda, walk.suffix_cuda, kount.kount_rank_cuda, ssa_ops.ssa_gen_cuda)
    before = [dict(c.launches) for c in counters]
    rc, got, err = port_command(cmd, fmds, corpus, f"cap_{cmd}")
    assert rc != 0 and not got and [dict(c.launches) for c in counters] == before
    errors = [ln for ln in err.splitlines() if ln.startswith("ERROR")]
    assert len(errors) == 1 and errors[0].startswith(f"ERROR: the occ rows of {1 + (cmd == 'kount2')} index(es) need ~")
    assert "B of the card (rb rows), which has 1000 B" in errors[0] and "occ layout" not in err


# ---------------------------------------------------------------------------
# the card's routines built for the host
# ---------------------------------------------------------------------------

# K5's passes and the LF step, behind their C signatures, each launch a loop
# over the thread ids (kernels.launch's stand-in calls them)
SSA_ENTRIES = r"""
#define HOST_WALK(name, L)                                                                                          \
  extern "C" int rb3c_ssa_walk_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int ms,  \
      int bs, int64_t m, int ss, int shift, int64_t n_seg, int64_t g0, int64_t g1, void* ssa_l, int* ssa_lane,       \
      int64_t* seg, void*) {                                                                                          \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                        \
    for (int64_t g = 0; g < g1 - g0; ++g)                                                                            \
      blockIdx.x = g, ssa_walk<L>(ix, m, ss, shift, n_seg, g0, g1, static_cast<typename L::T*>(ssa_l), ssa_lane,     \
                                  segs_at(seg, n_seg));                                                               \
    return 0;                                                                                                         \
  }                                                                                                                   \
  extern "C" int rb3c_occ_lf_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int ms,    \
      int bs, const int64_t* k, int64_t n, int* c, void* nk, void*) {                                                \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                        \
    for (int64_t i = 0; i < n; ++i) {                                                                                 \
      typename L::T x;                                                                                                \
      c[i] = ix.lf_step((typename L::T)k[i], x);                                                                     \
      static_cast<typename L::T*>(nk)[i] = x;                                                                        \
    }                                                                                                                 \
    return 0;                                                                                                         \
  }
RB3C_LAYOUTS(HOST_WALK)
#define HOST_FINISH(name, T)                                                                                        \
  extern "C" int rb3c_ssa_finish_##name(const int64_t* seg, int64_t n_seg, int64_t m, int64_t n_ssa, void* ssa_l,     \
      int* ssa_lane, void* death_l, void* final_k, int* lane_of, void*) {                                            \
    const Segs s = segs_at(const_cast<int64_t*>(seg), n_seg);                                                        \
    for (int64_t i = 0; i < m; ++i)                                                                                   \
      blockIdx.x = i, ssa_finish_lanes<T>(s, m, static_cast<T*>(death_l), static_cast<T*>(final_k), lane_of);       \
    for (int64_t i = 0; i < n_ssa; ++i)                                                                               \
      blockIdx.x = i, ssa_finish_slots<T>(s, lane_of, n_ssa, static_cast<T*>(ssa_l), ssa_lane);                     \
    return 0;                                                                                                         \
  }
HOST_FINISH(dense32, int)
HOST_FINISH(dense64, int64_t)
HOST_FINISH(rb32, int)
HOST_FINISH(rb64, int64_t)
"""


@pytest.fixture(scope="module")
def ssa_host(tmp_path_factory):
    """csrc/ssa_gen.cu's kernels (the text before its C entry points) built
    for the host with g++ behind the C signatures of K5's passes and of
    rb3c_occ_lf.  Returns kernels.launch's stand-in, the library as `lib`."""
    src = open(f"{CSRC}/ssa_gen.cu").read()
    body = src[: src.index('extern "C" {')].replace("#include <cuda_runtime.h>", "")
    d = tmp_path_factory.mktemp("ssa_host")
    (d / "ssa_host.cpp").write_text(HOST_SHIM[: HOST_SHIM.index('#include "rb.cuh"')] + WALK_HOST + body + SSA_ENTRIES
                                    + JUMP_ENTRY)
    so = d / "libssa_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so),
                        str(d / "ssa_host.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))

    def launch(name, device, *args):
        fn = getattr(lib, name)
        fn.argtypes = kernels._ENTRIES[name]
        assert fn(*args, None) == 0

    launch.lib = lib
    return launch


def host_rows(f, layout: str, S: int):
    if layout.startswith("dense"):
        return rank.OccIndex.from_dense(f, "cpu", int64=layout == "dense64", mega_shift=6)
    return rb_rows(f, layout, S)


HOST = [("dense32", 64), ("dense64", 64), *RB]
HOST_IDS = ["dense32", "dense64", *RB_IDS]


@pytest.mark.parametrize("layout,S", HOST, ids=HOST_IDS)
def test_lf_step_on_the_host(ssa_host, corpus_index, layout, S):  # noqa: F811
    """Each layout's lf_step (csrc/rb.cuh Rb<T>::lf_step; occ.cuh's dense
    one), built for the host behind rb3c_occ_lf's C signature, at every k
    of the corpus index: the symbol and LF(k) equal to DenseFMIndex.lf."""
    f = corpus_index
    x = host_rows(f, layout, S)
    k = np.arange(f.n, dtype=np.int64)
    c = np.full(f.n, -1, np.int32)
    nk = torch.full((f.n,), -1, dtype=x.dtype)
    ssa_host("rb3c_occ_lf_" + layout, None, *x.kernel_tables(), k.ctypes.data, f.n, c.ctypes.data, nk.data_ptr())
    want_c, want_nk = f.lf(k)
    assert np.array_equal(c, want_c) and np.array_equal(nk.numpy(), want_nk)


@pytest.mark.parametrize("layout,S", HOST, ids=HOST_IDS)
def test_ssa_gen_cu_on_the_host(ssa_host, corpus_index, monkeypatch, layout, S):  # noqa: F811
    """K5 (csrc/ssa_gen.cu: the walk over each layout's lf_step, the
    pointer jumping, the finish in the layout's width) built for the host
    and launched by ssa_ops.launch_walk, the card's path, at segment stride
    64: the four arrays and the records equal to ssa_gen_seg_plain's, the
    SSA byte-equal to the JAX package's native SSA; one count a walk."""
    monkeypatch.setattr(kernels, "launch", ssa_host)
    monkeypatch.setattr(ssa_ops.ssa_gen_cuda, "launches", Counter())  # this worker's other files count none
    f = corpus_index
    x = host_rows(f, layout, S)
    m = int(f.acc[1])
    *want, want_rec = ssa_ops.ssa_gen_seg_plain(x, m, SS, SEG)
    *got, rec = ssa_ops.launch_walk(x, m, SS, SEG)
    assert ssa_ops.ssa_gen_cuda.launches == {layout: 1}
    for a, b in zip(got, want):
        assert torch.equal(a.long(), b.long())
    assert torch.equal(rec, want_rec[1:])
    assert write_ssa_bytes(ssa_ops.assemble(m, SS, *got)) == write_ssa_bytes(ssa_gen_native(f, SS))
