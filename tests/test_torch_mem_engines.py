"""The port's `mem` / `search` SMEM engines (`--engine=auto|jax|native|
hybrid|py`) against the JAX package's native engine, on the CPU tests'
corpus.  Every comparison is exact:

- (a) the port's smem_tg_flat_native (ops/smem_native.py, the threaded
  native engine) against the JAX package's and against smem_ref.smem_tg
  read by read: counts and rows at -l 11/19/31 and -c 1/3, on the corpus
  reads with reads holding N, reads shorter than -l and an empty read, on
  both sides of the pline rule (a batch below one symbol per two blocks
  without the records, one above with them, then below again with them
  held), on one thread and on four, and an empty batch;
- (b) `mem` and `search -l21` through the port's CLI with each engine
  (--device=cpu: the card's engine is the plain PyTorch one), and -p,
  --gap and --cov on native: stdout byte-equal to `python -m ropebwt3_tpu
  mem --engine=native`, each run here, not on a server; the hybrid
  (RB3TPU_MEM_SPLIT=0.5) shows reads on its card half;
- (c) F9: `--engine=native` and `py` run no smem_tg (the card engine's
  functions raise if called) and log their engine's own line; without
  CUDA, native and hybrid on the default --device=cuda are one ERROR line;
- (d) HybridEngine.run_flat on stand-in engines: the cut, the card's rows
  first, the share's start, ceiling (0.8) and floor (0.05);
- (e) the `.pl` record file written by one package, read by the other.
- hybrid under two gloo processes (--mesh=2x1): process 0 writes the
  reference BED.
"""

import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu.index import sidecar as jsidecar
from ropebwt3_tpu.ops import smem_native as jnative
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch import server
from ropebwt3_tpu_torch.align import cli_hooks
from ropebwt3_tpu_torch.index import sidecar as tsidecar
from ropebwt3_tpu_torch.nt6 import char2nt6
from ropebwt3_tpu_torch.ops import smem as tsmem
from ropebwt3_tpu_torch.ops import smem_native as tnative
from ropebwt3_tpu_torch.ops import smem_ref
from ropebwt3_tpu_torch.seqio import read_seqs

from .test_torch_cli import ROOT, corpus_fmd  # noqa: F401  (fixture reuse)
from .test_torch_hybrid import HYBRID
from .test_torch_mesh import _free_port
from .test_torch_oldmem import run_main

NATIVE_LINE = re.compile(r"native SMEM engine \(ops/smem_native\.py\): (\d+) reads")
PY_LINE = re.compile(r"Python SMEM engine \(ops/smem_ref\.py smem_tg, read by read\): (\d+) reads")


def flat_of(reads: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=off[1:])
    return (np.concatenate(reads) if reads else np.zeros(0, np.uint8)).astype(np.uint8), off


@pytest.fixture(scope="module")
def edge_reads(corpus):
    """The corpus reads, every fifth with an N, then reads of 0, 5, 10, 18
    and 30 symbols (each shorter than some -l) and one of all N."""
    rng = np.random.default_rng(7)
    reads = [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))]
    for r in reads[::5]:
        r[rng.integers(0, len(r), 2)] = 5
    reads += [reads[1][:k].copy() for k in (0, 5, 10, 18, 30)] + [np.full(40, 5, np.uint8)]
    return reads


def both_indexes(fmd: str):
    """The corpus index freshly decoded by each package (no records held)."""
    return tcli.load_index(fmd), jcli.load_index(fmd)


@pytest.mark.parametrize("min_len,min_occ", [(11, 1), (11, 3), (19, 1), (19, 3), (31, 1), (31, 3)])
def test_flat_native_matches_jax_and_ref(monkeypatch, corpus_fmd, edge_reads, min_len, min_occ):  # noqa: F811
    monkeypatch.setenv("RB3TPU_CACHE", "0")  # no sidecar: the records stay in memory, built by each call
    tf, jf = both_indexes(str(corpus_fmd))
    small = edge_reads[:3] + edge_reads[-6:]
    big_flat, big_off = flat_of(edge_reads)
    small_flat, small_off = flat_of(small)
    assert small_off[-1] * 2 < len(tf.occ_block) <= big_off[-1] * 2  # the two sides of the pline rule
    ref = [smem_ref.smem_tg(tf, r, min_occ, min_len) for r in edge_reads]
    ref_counts = np.array([len(m) for m in ref], np.int64)
    ref_rows = np.array([(m.start, m.end, m.size, m.lo, m.lo_rc) for ms in ref for m in ms], np.int64).reshape(-1, 5)
    assert ref_counts[-6:].tolist()[:4] == [0, 0, 0, 0] and ref_counts.sum() > len(edge_reads)
    for step, (flat, off, pline_after) in enumerate(((small_flat, small_off, False), (big_flat, big_off, True),
                                                     (small_flat, small_off, True))):
        want = jnative.smem_tg_flat_native(jf, flat, off, min_occ, min_len)
        for threads in (1, 4):
            got = tnative.smem_tg_flat_native(tf, flat, off, min_occ, min_len, n_threads=threads)
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), (step, threads)
        assert (getattr(tf, "_pline_recs", None) is not None) == pline_after
        if step == 1:
            assert np.array_equal(got[0], ref_counts) and np.array_equal(got[1], ref_rows)
    counts, rows = tnative.smem_tg_flat_native(tf, np.zeros(0, np.uint8), np.zeros(1, np.int64), min_occ, min_len)
    assert counts.shape == (0,) and rows.shape == (0, 5)
    mems = tnative.smem_tg_batch_native(tf, edge_reads[:4], min_occ, min_len)
    assert [[(m.start, m.end, m.size, m.lo, m.lo_rc) for m in ms] for ms in mems] == [
        [(m.start, m.end, m.size, m.lo, m.lo_rc) for m in ms] for ms in ref[:4]]


@pytest.fixture(scope="module")
def want_bed(corpus, corpus_fmd):  # noqa: F811
    """`python -m ropebwt3_tpu mem --engine=native OPTS` of the corpus, run
    in this process, by OPTS."""
    cache = {}

    def get(opts: tuple) -> bytes:
        if opts not in cache:
            rc, out, _ = run_main(jcli.main, ["mem", "--engine=native", *opts, str(corpus_fmd),
                                              str(corpus / "reads.fa")])
            assert rc == 0 and out.count(b"\n") >= 60
            cache[opts] = out
        return cache[opts]

    return get


@pytest.mark.parametrize("cmd,engine,opts", [
    *[(c, e, ()) for c in ("mem", "search") for e in ("auto", "jax", "native", "hybrid", "py")],
    ("mem", "native", ("-p3",)), ("mem", "native", ("--gap=5",)), ("mem", "native", ("--cov",)),
], ids=lambda v: " ".join(v) if isinstance(v, tuple) else v)
def test_cli_engine_matches_native(monkeypatch, corpus, corpus_fmd, want_bed, cmd, engine, opts):  # noqa: F811
    monkeypatch.setenv("RB3TPU_MEM_SPLIT", "0.5")
    rc, got, err = run_main(tcli.run, [cmd, "--device=cpu", f"--engine={engine}", "-l21", *opts, str(corpus_fmd),
                                       str(corpus / "reads.fa")])
    assert rc == 0 and got == want_bed(("-l21", *opts)), err
    assert server.MARKER not in err  # no server answered: it ran here
    m = HYBRID.search(err)
    if engine == "hybrid":
        assert m is not None and 1 <= int(m.group(1)) < int(m.group(2)) == 60 and m.group(3) == "reads", err
    else:
        assert m is None
    host = {"native": NATIVE_LINE, "py": PY_LINE}.get(engine)
    if host is not None:
        assert int(host.search(err).group(1)) == 60 and "smem_tg launches" not in err, err
    else:
        assert re.search(r"\d+ smem_tg launches \(dense32\)", err), err


@pytest.mark.parametrize("engine", ["native", "py"])
def test_host_engines_run_no_smem_tg(monkeypatch, corpus, corpus_fmd, want_bed, engine):  # noqa: F811
    """F9: the host engines write the reference BED with every function of
    the card's engine (the kernels' wrappers and their plain version)
    raising, and log their own line, not the smem_tg launches line."""

    def ran(*_a, **_k):
        raise AssertionError("an smem_tg function ran")

    for name in ("smem_tg", "smem_tg_plain", "smem_tg_cuda", "smem_tgc_cuda", "BatchedSmemTG"):
        monkeypatch.setattr(tsmem, name, ran)
    if engine == "native":
        monkeypatch.setattr(smem_ref, "smem_tg", ran)
    rc, got, err = run_main(tcli.run, ["mem", "--device=cpu", f"--engine={engine}", "-l21", str(corpus_fmd),
                                       str(corpus / "reads.fa")])
    assert rc == 0 and got == want_bed(("-l21",)), err
    assert (NATIVE_LINE if engine == "native" else PY_LINE).search(err) and "smem_tg launches" not in err


@pytest.mark.parametrize("engine", ["native", "hybrid"])
def test_engine_on_default_cuda_without_cuda_is_one_error(corpus, corpus_fmd, engine):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    rc, out, err = run_main(tcli.run, ["mem", f"--engine={engine}", "-l21", str(corpus_fmd), str(corpus / "reads.fa")])
    assert rc == 1 and not out
    assert err.count("\n") == 1 and err.startswith("ERROR: ") and "CUDA" in err


class FlatStand:
    """A stand-in mem engine: one row a read, tagged with the engine's id;
    notes its thread; `delay` seconds a read on the test's clock."""

    def __init__(self, tag: int, delay: float):
        self.tag, self.delay, self.threads, self.sizes = tag, delay, set(), []

    def run_flat(self, flat, seq_off):
        self.threads.add(threading.get_ident())
        self.sizes.append(len(seq_off) - 1)
        n = len(seq_off) - 1
        rows = np.stack([np.full(n, self.tag), flat[seq_off[:-1]], np.diff(seq_off), np.zeros(n), np.zeros(n)], 1)
        return np.ones(n, np.int64), rows.astype(np.int64)


def fake_timed(fn, flat, seq_off):
    return fn.__self__.delay * (len(seq_off) - 1), fn(flat, seq_off)


def test_hybrid_run_flat_split_floor_ceiling(monkeypatch):
    monkeypatch.delenv("RB3TPU_MEM_SPLIT", raising=False)
    monkeypatch.setattr(cli_hooks.HybridEngine, "_timed", staticmethod(fake_timed))
    dev, nat = FlatStand(1, 0.001), FlatStand(2, 0.004)
    eng = cli_hooks.HybridEngine(dev, nat.run_flat, cli_hooks.MEM_SPLIT, cli_hooks.MEM_SPLIT_MAX)
    assert (eng.share, eng.floor, eng.ceiling) == (0.35, 0.05, 0.8)
    reads = [np.full(k + 1, k % 5 + 1, np.uint8) for k in range(20)]
    flat, off = flat_of(reads)
    counts, rows = eng.run_flat(flat, off)
    assert dev.sizes == [7] and nat.sizes == [13]  # int(20 * 0.35)
    assert counts.tolist() == [1] * 20 and rows[:, 0].tolist() == [1] * 7 + [2] * 13
    assert rows[:, 1].tolist() == [k % 5 + 1 for k in range(20)] and rows[:, 2].tolist() == list(range(1, 21))
    assert dev.threads and threading.get_ident() not in dev.threads and nat.threads == {threading.get_ident()}
    assert eng.share == 0.8  # 4x the native rate: 0.8 of the reads, at the ceiling
    eng.run_flat(flat, off)
    assert dev.sizes[-1] == 16 and (eng.n_items, eng.n_dev) == (40, 23)
    dev.delay = 1.0  # a slow card: the share falls to the floor
    eng.run_flat(flat, off)
    assert eng.share == 0.05 and dev.sizes == [7, 16, 16]
    _, rows = eng.run_flat(*flat_of(reads[:10]))  # int(10 * 0.05) = 0: none sent to the card
    assert rows[:, 0].tolist() == [2] * 10 and dev.sizes == [7, 16, 16] and (eng.n_items, eng.n_dev) == (70, 39)
    eng.close()


class NoBuild:
    """A native library whose record build fails: the records must be read."""

    def rb3t_pline_build(self, *_a):
        raise AssertionError("the records were built, not read from the file")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pline_file_read_by_the_other_package(monkeypatch, tmp_path, corpus, corpus_fmd, writer):  # noqa: F811
    """The records of a sidecar-mapped index: one package's pline_table
    writes `<idx>.dense.pl`; the other's read_pline maps the same bytes,
    and its pline_table takes them from the file (its build would fail);
    both engines then give the same MEMs."""
    fmd = tmp_path / "idx.fmd"
    fmd.write_bytes(corpus_fmd.read_bytes())
    mine, theirs = (tnative, jnative) if writer == "port" else (jnative, tnative)
    load = {tnative: tcli.load_index, jnative: jcli.load_index}
    n = int(load[mine](str(fmd)).n)  # decodes the index and writes its `.dense` sidecar
    recs = np.array(mine.pline_table(load[mine](str(fmd))))  # an index mapped from the sidecar
    pl = str(tmp_path / "idx.fmd.dense.pl")
    assert os.path.exists(pl) and len(recs) == ((n >> 7) + 1) * 64
    read = (jsidecar if writer == "port" else tsidecar).read_pline(pl, n)
    assert read is not None and np.array_equal(read[0], recs)
    if writer == "port":
        monkeypatch.setattr(jnative, "native_smem_lib", NoBuild)
    else:
        monkeypatch.setattr(tnative.native, "lib", NoBuild)
    f2 = load[theirs](str(fmd))
    assert np.array_equal(theirs.pline_table(f2), recs)
    monkeypatch.undo()
    flat, off = flat_of([char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))])
    want = jnative.smem_tg_flat_native(jcli.load_index(str(fmd)), flat, off, 1, 19)
    got = tnative.smem_tg_flat_native(tcli.load_index(str(fmd)), flat, off, 1, 19)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_hybrid_under_two_gloo_processes(monkeypatch, corpus, corpus_fmd, want_bed):  # noqa: F811
    """`mem --device=cpu --mesh=2x1 --engine=hybrid` in two processes of one
    gloo group: each runs the hybrid on its share of every batch, process 0
    writes the reference BED, process 1 nothing."""
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), RB3TPU_MEM_SPLIT="0.5")
    argv = [sys.executable, "-m", "ropebwt3_tpu_torch", "mem", "--device=cpu", "--mesh=2x1", "--engine=hybrid",
            "-l21", str(corpus_fmd), str(corpus / "reads.fa")]
    procs = [subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1].decode()[-2000:] for o in outs]
    assert outs[0][0] == want_bed(("-l21",)) and outs[1][0] == b""
    for _, err in outs:
        m = HYBRID.search(err.decode())
        assert m is not None and int(m.group(2)) == 30 and int(m.group(1)) >= 1
