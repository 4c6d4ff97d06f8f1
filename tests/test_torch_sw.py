"""The port's sw (ropebwt3_tpu_torch/align/sw.py, with the native staging
and finish of native/bwasw_core.cpp) against the JAX package's, on the CPU:

- `sw_plain` against `sw_device` (JAX, JAX_PLATFORMS=cpu) on the same staged
  DAWGs, exact: `bad` on every read, the archive, best_sc and best_pos on
  the reads not flagged; general DAWGs (in-degree up to 6) and the linear
  ones of -e (two JAX compiles in all);
- csrc/sw.cu's read routine, compiled with g++ for the host (one lane a
  read), against `sw_plain`, dense32 and dense64 rows;
- `rb3t_sw_stage` against the JAX package's `bwtl.dawg_gen` /
  `dawg_gen_linear` and `smem_present`;
- `SwDeviceEngine(device="cpu")` against the JAX package's `rb3_sw_batch`,
  hit for hit with positions, at -p 0 and -p 3;
- `python -m ropebwt3_tpu_torch sw --device=cpu` (and `mem -d`, `search`)
  stdout byte-equal to `python -m ropebwt3_tpu sw`, whose engine is the
  native one.

The reads are tests/test_torch_cuda.py's `sw_reads`: substitutions, N
bases, tandem repeats that merge DAWG nodes, deletions that exercise the F
closure."""

import contextlib
import ctypes
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ropebwt3_tpu.align import bwasw as jbw
from ropebwt3_tpu.align import sw_jax as jsw
from ropebwt3_tpu.align.bwtl import bwtl_gen, dawg_gen, dawg_gen_linear
from ropebwt3_tpu.nt6 import char2nt6
from ropebwt3_tpu.ops.rank import DeviceIndex
from ropebwt3_tpu.ops.smem_ref import smem_present
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu.ssa_ops import ssa_gen_native
from ropebwt3_tpu_torch.align import bwasw, sw
from ropebwt3_tpu_torch.ops.rank import OccIndex

from .test_torch_cli import ROOT, _run
from .test_torch_cli import corpus_fmd  # noqa: F401  (fixture reuse)
from .test_torch_cuda import corpus_index  # noqa: F401  (fixture reuse)
from .test_torch_cuda import sw_dawgs, sw_reads
from .test_torch_runblock import HOST_SHIM

CSRC = os.path.join(ROOT, "ropebwt3_tpu_torch", "csrc")


def _run_port_without_jax(args):
    """The port's CLI in a process where `import jax` fails, with one
    intra-op thread (see one_thread)."""
    code = "import sys\nsys.modules['jax'] = None\nfrom ropebwt3_tpu_torch.cli import main\nsys.exit(main(sys.argv[1:]))\n"
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code] + args, cwd=ROOT, capture_output=True, env=env)


@contextlib.contextmanager
def one_thread():
    """The lock-step plain version runs thousands of small ops, which
    intra-op threads only slow down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def genomes(corpus):
    return [char2nt6(rec.seq) for rec in read_seqs(str(corpus / "genomes.fa"))]


def sig(hits):
    return [(h.score, h.lo, h.hi, tuple(h.cigar), h.cs, tuple(h.qoff), tuple(map(tuple, h.pos))) for h in hits]


@pytest.fixture(scope="module", params=[False, True], ids=["general", "e2e"])
def case(request, corpus_index, genomes):  # noqa: F811
    """16 reads' DAWGs through sw_device and sw_plain."""
    e2e = request.param
    opt = bwasw.SwOpt(flag=bwasw.RB3_SWF_E2E if e2e else 0, end_len=1 if e2e else 11)
    node_c, pre, n_node, _ = sw_dawgs(corpus_index, opt, sw_reads(genomes, 16, seed=1))
    if not e2e:  # P_MAX predecessor slots, as sw_device's largest bucket has them
        pre = torch.nn.functional.pad(pre, (0, sw.P_MAX - pre.shape[2]), value=-1)
    want = [np.asarray(a) for a in jsw.sw_device(DeviceIndex.from_dense(corpus_index), jnp.asarray(node_c.numpy()),
                                                 jnp.asarray(pre.numpy()), jnp.asarray(n_node.numpy()),
                                                 node_c.shape[1], end_len=opt.end_len)]
    with one_thread():
        got = [a.numpy() for a in sw.sw_plain(OccIndex.from_dense(corpus_index, "cpu"), node_c, pre, n_node,
                                              end_len=opt.end_len, trips=True)]
    return dict(opt=opt, node_c=node_c, pre=pre, n_node=n_node, want=want, got=got)


def test_plain_matches_sw_device(case):
    want, got, n_node = case["want"], case["got"], case["n_node"].numpy()
    assert case["pre"].shape[2] == (1 if case["opt"].flag else sw.P_MAX) and int(case["pre"].max()) > 0
    np.testing.assert_array_equal(got[6], want[6])
    ok = ~want[6]
    assert 2 <= ok.sum() < len(ok)  # reads of both kinds
    np.testing.assert_array_equal(got[4][ok], want[4][ok])
    np.testing.assert_array_equal(got[5][ok], want[5][ok])
    rows = np.zeros(len(n_node) + 1, np.int64)
    np.cumsum(n_node, out=rows[1:])
    assert got[3].shape == (rows[-1], sw.N_BEST) and got[0].dtype == np.int32 and got[3].dtype == np.int64
    for r in np.flatnonzero(ok):
        mine = [a[rows[r] : rows[r + 1]] for a in got[:4]]
        ref = [a[: n_node[r], r] for a in want[:4]]  # sw_device's archive is (NC, W, N)
        valid = (ref[3] & 1).astype(bool)
        np.testing.assert_array_equal(mine[3] & 1, ref[3] & 1)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a[valid], b[valid])
        assert not any(a[~valid].any() for a in mine)  # the port's invalid cells are 0


@pytest.fixture(scope="module")
def sw_host(tmp_path_factory):
    """csrc/sw.cu's `sw_read` built for the host with g++: one lane a read."""
    src = HOST_SHIM.split('#include "rb.cuh"')[0] + '#include <memory>\n#include "sw.cu"\n'
    src += r"""
template <class L, int NB>
static void run(const L& ix, const int* node_c, const int* pre, const int* n_node, const int64_t* rows, int64_t W,
                int NC, int P, int n_best, int end_len, long long* scratch, int* lo, int* hi, int* rc, long long* w,
                int* best_sc, int* best_pos, uint8_t* bad, int* trips) {
  const rb3c::sw::Opt o = rb3c::sw::make_opt(n_best, end_len, 1, 3, 5, 2);
  auto s = std::make_unique<rb3c::sw::State<typename L::T, NB>>();
  for (int64_t r = 0; r < W; ++r) {
    const int64_t c0 = rows[r] * n_best;
    rb3c::sw::sw_read<1, false>(ix, *s, node_c + r * NC, pre + r * NC * P, n_node[r], P, o, scratch + c0 * 4, lo + c0,
                                hi + c0, rc + c0, w + c0, best_sc + r, best_pos + r, bad + r, trips + r, 0, nullptr);
  }
}
#define ENTRY(name, L)                                                                                              \
  extern "C" void name(const int* rt, const int* esc, const int64_t* mega, const void* acc, int ms, int bs,        \
                       const int* node_c, const int* pre, const int* n_node, const int64_t* rows, int64_t W, int NC,  \
                       int P, int n_best, int end_len, long long* scratch, int* lo, int* hi, int* rc, long long* w,  \
                       int* best_sc, int* best_pos, uint8_t* bad, int* trips) {                                     \
    const L ix{rb3c::Tables{rt, esc, mega, acc, ms, bs}};                                                          \
    if (n_best <= 32)                                                                                              \
      run<L, 128>(ix, node_c, pre, n_node, rows, W, NC, P, n_best, end_len, scratch, lo, hi, rc, w, best_sc,       \
                  best_pos, bad, trips);                                                                           \
    else                                                                                                           \
      run<L, 256>(ix, node_c, pre, n_node, rows, W, NC, P, n_best, end_len, scratch, lo, hi, rc, w, best_sc,       \
                  best_pos, bad, trips);                                                                           \
  }
ENTRY(sw_dense32, rb3c::Dense<int>)
ENTRY(sw_dense64, rb3c::Dense<int64_t>)
"""
    d = tmp_path_factory.mktemp("sw_host")
    (d / "sw_host.cpp").write_text(src)
    so = d / "libsw_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so),
                        str(d / "sw_host.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("layout", ["dense32", "dense64"])
def test_card_routine_on_the_host_matches_plain(case, sw_host, corpus_index, layout):  # noqa: F811
    """The kernel's read routine (csrc/sw.cu), run on the host with one lane
    a read: bad, best_sc and best_pos on every read, the archive and the
    trips of the reads not flagged, equal to sw_plain's (dense32 rows; the
    DP does not depend on the layout)."""
    idx = OccIndex.from_dense(corpus_index, "cpu", **({"int64": True, "mega_shift": 6} if layout == "dense64" else {}))
    node_c, pre, n_node = (np.ascontiguousarray(t.numpy()) for t in (case["node_c"], case["pre"], case["n_node"]))
    W, (NC, P), N = len(n_node), pre.shape[1:], sw.N_BEST
    rows = sw.arch_rows(case["n_node"]).numpy()
    T = int(rows[-1])
    scratch = np.zeros((T, N, 4), np.int64)
    lo, hi, rc = (np.full((T, N), 7, np.int32) for _ in range(3))
    w = np.full((T, N), 7, np.int64)
    best_sc, best_pos, trips = (np.zeros(W, np.int32) for _ in range(3))
    bad = np.zeros(W, np.uint8)
    V = ctypes.c_void_p
    t = idx.kernel_tables()
    getattr(sw_host, f"sw_{layout}")(*(V(p) for p in t[:4]), ctypes.c_int(t[4]), ctypes.c_int(t[5]),
                                     *(V(a.ctypes.data) for a in (node_c, pre, n_node, rows)), ctypes.c_int64(W),
                                     ctypes.c_int(NC), ctypes.c_int(P), ctypes.c_int(N),
                                     ctypes.c_int(case["opt"].end_len),
                                     *(V(a.ctypes.data) for a in (scratch, lo, hi, rc, w, best_sc, best_pos, bad, trips)))
    got, want = (lo, hi, rc, w, best_sc, best_pos, bad.astype(bool), trips), case["got"]
    for a, b in zip(got[4:7], want[4:7]):
        np.testing.assert_array_equal(a, b)
    ok = ~want[6]
    keep = np.repeat(ok, n_node)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a[keep], b[keep])
    np.testing.assert_array_equal(got[7][ok], want[7][ok])


@pytest.mark.parametrize("e2e,mml", [(False, 0), (True, 0), (False, 17)])
def test_stage_matches_dawg_gen(corpus_index, genomes, e2e, mml):  # noqa: F811
    """rb3t_sw_stage's verdicts and DAWGs equal the JAX package's prefilter
    (smem_present) and DAWGs (bwtl.dawg_gen / dawg_gen_linear): the node
    order, each node's symbol and its predecessors in order."""
    reads = sw_reads(genomes, 30, seed=2) + [genomes[1][100:400]]  # the last: more nodes than the card takes
    opt = bwasw.SwOpt(flag=bwasw.RB3_SWF_E2E if e2e else 0, end_len=1 if e2e else 11, min_mem_len=mml)
    flat, seq_off = bwasw.flat_reads(reads)
    ok, n_node, max_pre, node_c, pre = bwasw.sw_stage(opt, corpus_index, flat, seq_off, sw.NC_MAX, sw.P_MAX)
    n_card = 0
    for i, s in enumerate(reads):
        assert ok[i] == (not (mml > opt.end_len) or smem_present(corpus_index, s, mml))
        if not ok[i]:
            continue
        g = dawg_gen_linear(s) if e2e else dawg_gen(bwtl_gen(s))
        assert (n_node[i], max_pre[i]) == (g.n_node, max(len(nd.pre) for nd in g.node))
        if g.n_node > sw.NC_MAX or max_pre[i] > sw.P_MAX:
            continue
        n_card += 1
        assert node_c[i, : g.n_node].tolist() == [max(nd.c, 0) for nd in g.node]
        assert pre[i, : g.n_node].tolist() == [list(nd.pre) + [-1] * (sw.P_MAX - len(nd.pre)) for nd in g.node]
    assert n_card >= 20 and (e2e or n_node[-1] > sw.NC_MAX)
    assert (mml == 0) == bool(ok.all())


@pytest.mark.parametrize("max_pos,mml", [(0, 0), (3, 17)])
def test_engine_matches_rb3_sw_batch(corpus_index, genomes, max_pos, mml):  # noqa: F811
    """SwDeviceEngine on the CPU (the plain version, the native finish, the
    flagged reads and a read of too many DAWG nodes on the native engine)
    equals the JAX package's rb3_sw_batch hit for hit, positions included."""
    f = corpus_index
    f.ssa = ssa_gen_native(f, 4)
    try:
        reads = sw_reads(genomes, 16, seed=1) + [genomes[2][500:760]]
        eng = sw.SwDeviceEngine(f, bwasw.SwOpt(max_pos=max_pos, min_mem_len=mml), device="cpu")
        with one_thread():
            got = eng.run(reads)
        want = jbw.rb3_sw_batch(jbw.SwOpt(max_pos=max_pos, min_mem_len=mml), f, reads)
    finally:
        f.ssa = None
    assert [sig(h) for h in got] == [sig(h) for h in want]
    assert sum(map(len, want)) >= 8 and any(len(h.pos) > 1 for hs in want for h in hs) == (max_pos > 1)
    assert eng.n_card > 0 and eng.n_bad >= 1 and eng.n_shape == 1


@pytest.fixture(scope="module")
def small_reads(corpus, genomes, tmp_path_factory):
    """Four reads of the corpus and six of sw_reads', as FASTA."""
    fa = tmp_path_factory.mktemp("sw_cli") / "q.fa"
    recs = [(rec.name, rec.seq) for rec in list(read_seqs(str(corpus / "reads.fa")))[:4]]
    recs += [(f"q{i}", "".join("$ACGTN"[c] for c in r)) for i, r in enumerate(sw_reads(genomes, 6, seed=3))]
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in recs))
    return fa


@pytest.mark.parametrize("argv", [["sw"], ["sw", "-e"], ["sw", "--all-e2e", "-b"], ["sw", "-u", "-m40"],
                                  ["sw", "--no-ssa", "-N16"], ["mem", "-d"], ["search", "-d", "-p3"],
                                  ["search", "-a31", "-w20"]], ids=" ".join)
def test_cli_matches_reference(corpus_fmd, small_reads, argv):  # noqa: F811
    """The port's `sw` (`mem -d`, `search -d` and `search -a`, which runs
    hapdiv) on the CPU, jax unimportable: stdout byte-equal to `python -m
    ropebwt3_tpu`, whose engines are the native ones."""
    files = [str(corpus_fmd), str(small_reads)]
    want = _run("ropebwt3_tpu", argv + files)
    got = _run_port_without_jax(argv + ["--device=cpu"] + files)
    assert want.returncode == 0, want.stderr.decode()
    assert got.returncode == 0, got.stderr.decode()
    assert want.stdout.count(b"\n") >= 8 and got.stdout == want.stdout
    assert b"0 sw launches (dense32)" in got.stderr or b"0 hapdiv launches (dense32)" in got.stderr


def test_sw_without_cuda_exits_nonzero(corpus_fmd, small_reads):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    r = _run("ropebwt3_tpu_torch", ["sw", str(corpus_fmd), str(small_reads)], strict=True)
    assert r.returncode != 0 and not r.stdout
    lines = r.stderr.decode().splitlines()
    assert len(lines) == 1 and lines[0].startswith("ERROR: ") and "CUDA" in lines[0]


def test_pack_arch_matches_jax():
    rng = np.random.default_rng(0)
    n = 1000
    fields = [rng.integers(0, 2, n), rng.integers(0, 4096, n), rng.integers(0, 3, n), rng.integers(0, 2, n),
              rng.integers(0, 2, n), rng.integers(0, 2, n), rng.integers(0, 32, n), rng.integers(0, 1 << 16, n),
              rng.integers(0, 1 << 16, n)]
    want = np.asarray(jsw._pack_arch(*(jnp.asarray(a.astype(np.int32)) for a in fields)))
    got = sw.pack_arch(torch.from_numpy(fields[0].astype(bool)), *(torch.from_numpy(a) for a in fields[1:]))
    np.testing.assert_array_equal(got.numpy(), want)
