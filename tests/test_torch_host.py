"""The port's own host layer against the JAX package's, on the CPU tests'
corpus: the index loader (FMD, FMR and BRE; the dense tables, acc, the
runs and the `.dense` sidecar both ways), the SSA writer, the flat read
batches, the native multi-locate, `stat` byte for byte, and `version` and
an unknown command."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu import seqio as jseqio
from ropebwt3_tpu.formats import ssa as jssa
from ropebwt3_tpu.index import sidecar as jsidecar
from ropebwt3_tpu.ssa_ops import ssa_gen_native
from ropebwt3_tpu.ssa_ops import ssa_multi_batch as j_multi
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch import seqio as tseqio
from ropebwt3_tpu_torch.formats import ssa as tssa
from ropebwt3_tpu_torch.index import sidecar as tsidecar
from ropebwt3_tpu_torch.ssa_ops import ssa_multi_batch as t_multi

from .test_torch_cli import _run, _run_without_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("bwt", "acc", "occ_block", "occ_super")


@pytest.fixture(scope="module")
def indexes(corpus, tmp_path_factory):
    """The corpus genomes built by the JAX package as FMD, FMR and BRE."""
    d = tmp_path_factory.mktemp("torch_host")
    out = {}
    for fmt, flag in (("fmd", "-do"), ("fmr", "-bo"), ("bre", "-eo")):
        out[fmt] = str(d / f"idx.{fmt}")
        r = _run("ropebwt3_tpu", ["build", flag, out[fmt], str(corpus / "genomes.fa")])
        assert r.returncode == 0, r.stderr.decode()
    return out


def assert_same_index(a, b):
    for name in FIELDS:
        assert np.array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name))), name
    assert a.n == b.n and a.n_runs == b.n_runs and a.is_symmetric() == b.is_symmetric()


@pytest.mark.parametrize("fmt", ["fmd", "fmr", "bre"])
def test_load_index_matches(monkeypatch, indexes, fmt):
    """Decoded without a sidecar, both loaders give the same tables."""
    monkeypatch.setenv("RB3TPU_CACHE", "0")
    syms, lens = tcli.load_runs(indexes[fmt])
    want_syms, want_lens = jcli.load_runs(indexes[fmt])
    assert np.array_equal(syms, want_syms) and np.array_equal(lens, want_lens)
    assert_same_index(tcli.load_index(indexes[fmt]), jcli.load_index(indexes[fmt]))


def test_sidecar_round_trip(indexes, tmp_path):
    """Each package reads the `.dense` sidecar the other wrote, and a load
    through the sidecar equals the decode."""
    f = jcli.load_index(indexes["fmd"])
    for write, read in ((tsidecar.write_sidecar, jsidecar.read_sidecar), (jsidecar.write_sidecar, tsidecar.read_sidecar)):
        path = str(tmp_path / "x.dense")
        write(path, f)
        assert_same_index(read(path), f)
    fmd = str(tmp_path / "idx.fmd")
    shutil.copy(indexes["fmd"], fmd)
    tcli.load_index(fmd)  # writes fmd.dense
    assert os.path.exists(fmd + ".dense")
    g = tcli.load_index(fmd)  # maps it
    assert g._sidecar_path == fmd + ".dense"
    assert_same_index(g, f)
    assert_same_index(jcli.load_index(fmd), f)


@pytest.mark.parametrize("ss", [0, 4, 8])
def test_write_ssa_bytes_match(indexes, tmp_path, ss):
    sa = ssa_gen_native(jcli.load_index(indexes["fmd"]), ss)
    data = jssa.write_ssa_bytes(sa)
    assert tssa.write_ssa_bytes(sa) == data
    back = tssa.read_ssa_bytes(data)
    assert (back.ss, back.ms, back.m) == (sa.ss, sa.ms, sa.m)
    assert np.array_equal(back.r2i, sa.r2i) and np.array_equal(back.ssa, sa.ssa)


@pytest.mark.parametrize("is_line,batch_size", [(False, 100_000_000), (False, 1000), (True, 700)])
def test_iter_flat_batches_match(corpus, tmp_path, is_line, batch_size):
    fn = str(corpus / "reads.fa")
    if is_line:  # one sequence per line
        fn = str(tmp_path / "reads.txt")
        with open(fn, "w") as fh:
            fh.writelines(line for line in open(corpus / "reads.fa") if not line.startswith(">"))
    got = list(tseqio.iter_flat_batches(fn, is_line, batch_size))
    want = list(jseqio.iter_flat_batches(fn, is_line, batch_size))
    assert len(got) == len(want) > (1 if batch_size < 10_000 else 0)
    for (n1, f1, o1), (n2, f2, o2) in zip(got, want):
        assert n1 == n2 and np.array_equal(f1, f2) and np.array_equal(o1, o2)


def test_ssa_multi_batch_matches(indexes):
    """The port's native multi-locate equals the JAX package's, order and all."""
    f = jcli.load_index(indexes["fmd"])
    sa = ssa_gen_native(f, 3)
    rng = np.random.default_rng(3)
    m = int(f.acc[1])
    lo = rng.integers(m, f.n, 500)
    reqs = [(int(a), int(min(f.n, a + rng.integers(1, 400))), int(rng.integers(0, 50))) for a in lo]
    assert t_multi(f, sa, reqs) == j_multi(f, sa, reqs)
    assert t_multi(f, sa, []) == []


def test_stat_matches(indexes):
    want = _run("ropebwt3_tpu", ["stat", indexes["fmd"]])
    got = _run("ropebwt3_tpu_torch", ["stat", indexes["fmd"]])
    assert got.returncode == 0, got.stderr.decode()
    assert want.stdout and got.stdout == want.stdout


def test_version_and_unknown_command():
    r = subprocess.run([sys.executable, "-m", "ropebwt3_tpu_torch", "version"], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0 and r.stdout == tcli.REF_VERSION + "\n"
    r = _run_without_jax(["bogus"])
    assert r.returncode == 1 and r.stderr.decode().strip() == "ERROR: unknown command 'bogus'"
