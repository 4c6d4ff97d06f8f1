"""`build --mesh` and `ssa --mesh` in the port (construct/merge.py
merge_rank_mesh, ssa_ops.py ssa_gen_mesh, csrc/merge_rank.cu and
csrc/ssa_gen.cu over segment ranges) against the JAX package's, on the CPU.
Integer outputs: exact; CLI outputs: byte-equal.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py:
`merge_rank_sharded` (parallel/merge_sharded.py: B1's rows over `idx`, LF
lanes over `dp`) and the mesh branch of `ssa_gen_device` (lanes over `dp`,
slots merged by a pmax), one compile each.  The port's side is its plain
path over meshes of [cpu] * 8: each range of the segments walked by the
plain passes (over `rank6_sharded_plain` for the merge), the shares merged
by a max.  On the CPU a card takes one range of the segments, so
[cpu] * 8 runs one; the eight ranges' passes are also run one by one.
csrc/occ.cuh's row load and one-symbol rank, and merge_rank.cu's two passes
over ranges, are built for the host with g++ and run over the mapped
layout (one host buffer, slabs in whole units) through the view's base
pointer.
The CLI runs in this process, and under two gloo processes; `--mesh` on the
other commands is parsed as the JAX package parses it."""

import contextlib
import ctypes
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.nt6 import revcomp
from ropebwt3_tpu_torch import cli, ssa_ops
from ropebwt3_tpu_torch.construct import merge
from ropebwt3_tpu_torch.formats.ssa import write_ssa_bytes
from ropebwt3_tpu_torch.kernels import CSRC
from ropebwt3_tpu_torch.ops.rank import OccIndex
from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, make_mesh, rank6_sharded_plain, split_segments

from .test_torch_cuda import cyclic_bwt_index
from .test_torch_mesh import MEGA, n_index  # noqa: F401  (fixture reuse)
from .test_torch_runblock import HOST_SHIM
from .test_torch_walk import one_thread  # noqa: F401  (autouse here too: the plain passes are lock-step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


def copies_bwt(seed: int, n: int = 3, rate: float = 0.03) -> np.ndarray:
    """B2: the BWT of n copies of n_index's genome (its base, seed 7) at
    `rate` substitutions, double strand: walks that meet B1's after a few
    to a few hundred steps."""
    base = np.random.default_rng(7).integers(1, 5, 2047).astype(np.uint8)
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n):
        s = base.copy()
        mut = rng.random(2047) < rate
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    return gsa_bwt(np.concatenate(parts))


def dense(f, layout: str) -> OccIndex:
    return OccIndex.from_dense(f, "cpu", int64=layout == "dense64", mega_shift=MEGA)


def test_merge_rank_mesh_matches_jax_merge_rank_sharded(n_index, monkeypatch):
    """merge_rank_mesh over 2x4 views of [cpu] * 8 (the segments in eight
    ranges, B1's 257 rows in four uneven slabs) gives the JAX package's
    merge_rank_sharded ins on a 2x4 mesh of virtual devices, in dense32
    and dense64 (megablocks of 8 rows), at S 64 and 8; its segment records
    equal merge_rank_chunked_plain's on the unsharded rows, and at S 8
    hand-overs write into other ranges' segments."""
    import jax

    from ropebwt3_tpu.parallel.mesh import make_mesh as jax_mesh
    from ropebwt3_tpu.parallel.merge_sharded import merge_rank_sharded

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    b2 = copies_bwt(3)
    walk = int(np.diff(np.flatnonzero(np.concatenate([[0], b2 == 0]))).max()) + 1
    want = merge_rank_sharded(n_index, b2, jax_mesh(2, 4), window=walk)[1]
    acc2, rec = merge.lf2_packed(torch.from_numpy(b2))
    m2 = int(acc2[1])
    for layout in ("dense32", "dense64"):
        idx = dense(n_index, layout)
        views = ShardedRows(idx, make_mesh(2, 4, CPU8)).views
        for S in (64, 8):
            ins, seg = merge.merge_rank_mesh(views, rec, m2, S)
            assert np.array_equal(ins.numpy(), want), (layout, S)
            assert torch.equal(seg, merge.merge_rank_chunked_plain(idx, rec.clone(), m2, S)[1])
            if S == 8:
                first, n_seg = merge.segments(rec.numel(), m2, S)
                cuts = np.array(split_segments(n_seg, 8))
                g = torch.nonzero((seg[4] > 0) & (seg[2] >= 0))[:, 0].numpy()
                nxt = m2 + seg[2, g].numpy() // S - first
                assert (np.searchsorted(cuts, g, "right") != np.searchsorted(cuts, nxt, "right")).any()


def jax_ssa_bytes(sa) -> bytes:
    from ropebwt3_tpu.formats.ssa import write_ssa_bytes as jax_write

    return jax_write(sa)


@pytest.mark.parametrize("ss", [2, 8])
def test_ssa_gen_mesh_matches_jax(n_index, ss):
    """ssa_gen_mesh over a 4x2 mesh of [cpu] * 8 (the rows replicated, the
    segments in eight ranges, at S 16 and 128): the SSA of the JAX
    package's mesh branch of ssa_gen_device on a 4x2 mesh of virtual
    devices at -s 2 (one compile), and of its native walk at -s 8; the
    arrays and segment records equal ssa_gen_seg_plain's, unsharded."""
    import jax

    from ropebwt3_tpu.parallel.mesh import make_mesh as jax_mesh
    from ropebwt3_tpu.ssa_ops import ssa_gen_device, ssa_gen_native

    if ss == 2:
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        want = jax_ssa_bytes(ssa_gen_device(n_index, ss, mesh=jax_mesh(4, 2)))
    else:
        want = jax_ssa_bytes(ssa_gen_native(n_index, ss))
    mesh = make_mesh(4, 2, CPU8)
    m = int(n_index.acc[1])
    for S in (16, 128):
        assert write_ssa_bytes(ssa_ops.ssa_gen_mesh(n_index, ss, mesh, S=S)) == want, S
        reps = [dense(n_index, "dense32")] * 8
        got = ssa_ops.walk_mesh(reps, m, ss, S)
        *plain, rec = ssa_ops.ssa_gen_seg_plain(reps[0], m, ss, S)
        for a, b in zip(got, [*plain, rec[1:]]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 2])
def test_ssa_gen_mesh_on_dollar_free_cycles(seed):
    """A random BWT string with fewer `$` than LF cycles (F7): the slots of
    segments on a `$`-free cycle, walked in any range, are cleared after
    the merge, and the SSA equals the port's unsharded ssa_gen, at -s 0 and
    1 over a 2x4 mesh of [cpu] * 8 at S 4."""
    f = cyclic_bwt_index(seed)
    mesh = make_mesh(2, 4, CPU8)
    m = int(f.acc[1])
    for ss in (0, 1):
        got = ssa_ops.walk_mesh([dense(f, "dense32")] * 8, m, ss, 4)
        assert bool((got[4][1] >= 0).any())  # segments left on a cycle
        assert write_ssa_bytes(ssa_ops.ssa_gen_mesh(f, ss, mesh, S=4)) == write_ssa_bytes(ssa_ops.ssa_gen(f, ss, "cpu"))


# csrc/merge_rank.cu (the text before `#ifdef __CUDACC__`) for the host:
# occ.cuh's rank in K6's two halves at every k, and both passes over a range
# of the segments, behind the C signature of rb3c_merge_rank_* (the stream
# dropped), over the tables the view's kernel_tables() gives: the mapped
# range's base pointer
MAPPED_K6_HOST = r"""
#include "merge_rank.cu"
using rb3c::merge::Seg;
using rb3c::merge::Walk;
#define X(name, L)                                                                                                  \
  extern "C" void rank1_##name(const int* rows, const int* esc, const int64_t* mega, const void* acc, int ms,     \
                               int bs, const int64_t* k, int64_t n, void* out) {                                    \
    const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};                                                          \
    for (int64_t i = 0; i < n; ++i) {                                                                               \
      int4 a, b, c;                                                                                                  \
      ix.load_row(k[i] >> 6, a, b, c);                                                                               \
      for (int s = 0; s < 6; ++s) static_cast<L::T*>(out)[6 * i + s] = ix.rank1((L::T)k[i], s, a, b, c);          \
    }                                                                                                                \
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
X(dense32, rb3c::Dense<int>)
X(dense64, rb3c::Dense<int64_t>)
"""


@pytest.fixture(scope="module")
def k6_host(tmp_path_factory):
    """csrc/merge_rank.cu's passes over occ.cuh's Dense, built for the host with g++."""
    d = tmp_path_factory.mktemp("k6_host")
    (d / "k6_host.cpp").write_text(HOST_SHIM[: HOST_SHIM.index('#include "rb.cuh"')] + MAPPED_K6_HOST)
    so = d / "libk6_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so),
                        str(d / "k6_host.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


def _tables(v) -> list:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    rows, esc, mega, acc, ms, bs = v.kernel_tables()
    return [vp(rows), vp(esc), vp(mega), vp(acc), i32(ms), i32(bs)]


@pytest.mark.parametrize("n_idx", [3, 8])
@pytest.mark.parametrize("layout", ["dense32", "dense64"])
def test_mapped_rank1_on_the_host(k6_host, n_index, layout, n_idx):
    """The card's K6 rank over the mapped rows (occ.cuh Dense::load_row,
    then rank1 for each symbol, at the view's base pointer), built for the
    host, equals rank6_sharded_plain at every k in [0, n], over 3 (uneven
    slabs) and 8 slabs in units of 3 rows, in dense32 and dense64 (the
    megablock base read at the global row)."""
    v = ShardedRows(dense(n_index, layout), make_mesh(1, n_idx, ["cpu"] * n_idx), unit=3).views[-1]
    k = torch.arange(n_index.n + 1)
    out = torch.empty((n_index.n + 1, 6), dtype=v.dtype)
    getattr(k6_host, f"rank1_{layout}")(*_tables(v), ctypes.c_void_p(k.data_ptr()), ctypes.c_int64(k.numel()),
                                        ctypes.c_void_p(out.data_ptr()))
    assert torch.equal(out.long(), rank6_sharded_plain(v, k))


@pytest.mark.parametrize("layout", ["dense32", "dense64"])
def test_mapped_merge_passes_on_the_host(k6_host, n_index, monkeypatch, layout):
    """merge_rank_mesh with the card's two passes (merge_rank.cu over the
    mapped rows of a 2x4 mesh, slabs in units of 3 rows, built for the host)
    in place of the plain ones; and the same passes over each of the eight
    slots' ranges one by one, each into its own ins and records, merged by
    a max between the passes: ins and segment records equal
    merge_rank_chunked_plain's on the unsharded rows, at S 8 and 64."""
    from ropebwt3_tpu_torch.parallel import launch

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

    def host_pass(passes):
        def run(v, rec, ins, m2, S, seg, g0, g1):
            first, n_seg = merge.segments(rec.numel(), m2, S)
            assert getattr(k6_host, f"merge_{layout}")(
                *_tables(v), vp(rec.data_ptr()), vp(ins.data_ptr()), i64(m2), i32(S.bit_length() - 1), i64(first),
                i64(n_seg), i64(g0), i64(g1), i32(passes), vp(seg.data_ptr())) == 0
        return run

    idx = dense(n_index, layout)
    views = ShardedRows(idx, make_mesh(2, 4, CPU8), unit=3).views
    acc2, rec = merge.lf2_packed(torch.from_numpy(copies_bwt(5)))
    m2 = int(acc2[1])
    want = {S: merge.merge_rank_chunked_plain(idx, rec.clone(), m2, S) for S in (8, 64)}
    walk, hand = host_pass(merge.WALK), host_pass(merge.HAND_OVER)
    for S, (pins, pseg) in want.items():
        n_seg = merge.segments(rec.numel(), m2, S)[1]
        cuts = split_segments(n_seg, 8)
        ins = [torch.full_like(rec, -1) for _ in views]
        segs = [torch.full((merge.SEG_ROWS, n_seg), merge.LOW, dtype=torch.int64) for _ in views]
        for v, g0, g1, x, sg in zip(views, cuts, cuts[1:], ins, segs):
            walk(v, rec, x, m2, S, sg, g0, g1)
        full = launch.merge_shares(segs)
        for v, g0, g1, x in zip(views, cuts, cuts[1:], ins):
            hand(v, rec, x, m2, S, full, g0, g1)
        assert torch.equal(launch.merge_shares(ins), pins) and torch.equal(full, pseg)
    monkeypatch.setattr(merge, "merge_walk_plain", walk)
    monkeypatch.setattr(merge, "merge_hand_over_plain", hand)
    for S, (pins, pseg) in want.items():
        ins, seg = merge.merge_rank_mesh(views, rec, m2, S)
        assert torch.equal(ins, pins) and torch.equal(seg, pseg)


def _main(argv: list[str]) -> tuple[int, bytes, str]:
    """(exit code, stdout, stderr) of the port's CLI run in this process."""
    buf, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    out.flush()
    return rc, buf.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def fmd(corpus, tmp_path_factory):
    """The corpus index as `build --device=cpu -m16k -do` writes it (seven merges)."""
    fn = str(tmp_path_factory.mktemp("mesh_construct") / "idx.fmd")
    rc, _, err = _main(["build", "--device=cpu", "-m16k", "-do", fn, str(corpus / "genomes.fa")])
    assert rc == 0, err
    return fn


def _ssa(fmd: str, out: str, *extra: str) -> bytes:
    rc, stdout, err = _main(["ssa", "--device=cpu", *extra, "-o", out, fmd])
    assert rc == 0 and not stdout, err
    return open(out, "rb").read()


@pytest.mark.parametrize("case", ["ssa", "build", "merge", "get", "suffix", "fa2kmer"])
def test_mesh_option_as_the_jax_package_takes_it(corpus, fmd, tmp_path, case):
    """`ssa --mesh=4x2` and `build -m16k --mesh=2x4` (seven merges over B1's
    rows sharded four ways) run on the CPU mesh and write the bytes of the
    same commands without --mesh; `merge`, `get` and `suffix` skip
    --mesh=2x1 / --mesh=2 (a non-strict parse), and `fa2kmer --mesh=2` stops
    with `ERROR: unknown option` (a strict one), as `python -m ropebwt3_tpu`
    does each."""
    genomes, reads, t = str(corpus / "genomes.fa"), str(corpus / "reads.fa"), str(tmp_path)
    if case == "ssa":
        assert _ssa(fmd, f"{t}/m.ssa", "--mesh=4x2") == _ssa(fmd, f"{t}/u.ssa")
        return
    if case == "build":
        rc, _, err = _main(["build", "--device=cpu", "-m16k", "--mesh=2x4", "-do", f"{t}/m.fmd", genomes])
        assert rc == 0 and err.count("rows sharded over a 2x4 mesh of cpu") == 7, err
        assert open(f"{t}/m.fmd", "rb").read() == open(fmd, "rb").read()
        return
    if case == "fa2kmer":
        # both packages exit 0 after an error unless asked for real exit codes
        env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", RB3TPU_STRICT_EXIT="1")
        want = subprocess.run([sys.executable, "-m", "ropebwt3_tpu", "fa2kmer", "--mesh=2", reads], cwd=ROOT,
                              capture_output=True, env=env)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RB3TPU_STRICT_EXIT", "1")
            got = _main(["fa2kmer", "--mesh=2", reads])
        assert (got[0], got[1], got[2]) == (want.returncode, want.stdout, want.stderr.decode()) == (
            1, b"", "ERROR: unknown option\n")
        return
    if case == "merge":
        small = f"{t}/reads.fmd"
        assert _main(["build", "--device=cpu", "-do", small, reads])[0] == 0
        argv = ["merge", "--device=cpu", "-o", f"{t}/{{}}.fmr", fmd, small]
    elif case == "get":
        argv = ["get", "--device=cpu", fmd, "0", "7", "31"]
    else:
        argv = ["suffix", "--device=cpu", fmd, reads]
    flag = "--mesh=2x1" if case == "merge" else "--mesh=2"
    outs = []
    for tag, extra in (("u", []), ("m", [flag])):
        rc, stdout, err = _main([a.format(tag) for a in argv[:1] + extra + argv[1:]])
        assert rc == 0, err
        outs.append(open(f"{t}/{tag}.fmr", "rb").read() if case == "merge" else stdout)
    assert outs[0] and outs[1] == outs[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_ssa(fmd, tmp_path):
    """Two processes (WORLD_SIZE=2, a gloo group on localhost) run `ssa
    --device=cpu --mesh=2x1 -o pR.ssa`: each walks its half of the segments,
    the shares are merged in both, and each writes its own file, byte-equal
    to the unsharded `ssa`; neither writes stdout."""
    want = _ssa(fmd, str(tmp_path / "u.ssa"))
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen([sys.executable, "-m", "ropebwt3_tpu_torch", "ssa", "--device=cpu", "--mesh=2x1", "-o",
                               str(tmp_path / f"p{r}.ssa"), fmd], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1].decode()[-2000:] for o in outs]
    assert [o[0] for o in outs] == [b"", b""]
    for r in range(2):
        assert open(tmp_path / f"p{r}.ssa", "rb").read() == want
        assert b"ssa_gen range launches (dense32) over a 1x1 mesh of cpu" in outs[r][1]
