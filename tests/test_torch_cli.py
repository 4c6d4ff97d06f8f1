"""`python -m ropebwt3_tpu_torch mem` against `python -m ropebwt3_tpu mem
--engine=native` on the corpus: stdout byte for byte."""

import gzip
import os
import subprocess
import sys

import pytest
import torch

from ropebwt3_tpu.seqio import read_seqs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, args):
    # neither package is installed: both are found from the repo root
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT, capture_output=True, env=env)


@pytest.fixture(scope="module")
def corpus_fmd(corpus, tmp_path_factory):
    """FMD with the sampled suffix array and sequence lengths that `-p` reads."""
    fmd = tmp_path_factory.mktemp("torch_cli") / "idx.fmd"
    for cmd in (["build", "-do", str(fmd), str(corpus / "genomes.fa")], ["ssa", "-o", f"{fmd}.ssa", str(fmd)]):
        r = _run("ropebwt3_tpu", cmd)
        assert r.returncode == 0, r.stderr.decode()
    with gzip.open(f"{fmd}.len.gz", "wt") as fh:
        for rec in read_seqs(str(corpus / "genomes.fa")):
            fh.write(f"{rec.name}\t{len(rec.seq)}\n")
    return fmd


@pytest.mark.parametrize("opts", [["-l21"], ["-c2", "-l21"], ["--gap=5", "-l21"], ["--cov", "-l21"], ["-p3", "-l21"]])
def test_mem_matches_native(corpus, corpus_fmd, opts):
    files = [str(corpus_fmd), str(corpus / "reads.fa")]
    want = _run("ropebwt3_tpu", ["mem", "--engine=native"] + opts + files)
    got = _run("ropebwt3_tpu_torch", ["mem", "--device=cpu"] + opts + files)
    assert want.returncode == 0, want.stderr.decode()
    assert got.returncode == 0, got.stderr.decode()
    assert want.stdout and got.stdout == want.stdout
    assert b"smem_tg launches" in got.stderr  # the port's engine ran, not the native one


@pytest.mark.parametrize("occ,layout", [("rb", "rb32"), ("dense", "dense32")])
def test_mem_occ_matches_native(corpus, corpus_fmd, occ, layout):
    """`--occ` picks the rows the engine runs on; the BED stays the writer's."""
    files = [str(corpus_fmd), str(corpus / "reads.fa")]
    want = _run("ropebwt3_tpu", ["mem", "--engine=native", "-l21"] + files)
    got = _run("ropebwt3_tpu_torch", ["mem", "--device=cpu", f"--occ={occ}", "-l21"] + files)
    assert got.returncode == 0, got.stderr.decode()
    assert want.stdout and got.stdout == want.stdout
    assert f"occ layout {layout}".encode() in got.stderr and f"launches ({layout})".encode() in got.stderr


def test_mem_rejects_bad_occ(corpus, corpus_fmd):
    r = _run("ropebwt3_tpu_torch", ["mem", "--device=cpu", "--occ=bogus", str(corpus_fmd), str(corpus / "reads.fa")])
    assert r.returncode != 0 and not r.stdout
    assert b"invalid --occ value" in r.stderr


def test_mem_without_cuda_exits_nonzero(corpus, corpus_fmd):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    r = _run("ropebwt3_tpu_torch", ["mem", "-l21", str(corpus_fmd), str(corpus / "reads.fa")])
    assert r.returncode != 0 and not r.stdout
    assert b"CUDA" in r.stderr


def test_mem_run_imports_no_jax(corpus, corpus_fmd):
    code = (
        "import contextlib, io, sys\n"
        "from ropebwt3_tpu_torch.cli import main\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    rc = main(['mem', '--device=cpu', '-l21', {str(corpus_fmd)!r}, {str(corpus / 'reads.fa')!r}])\n"
        "print(rc, sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0 and r.stdout.strip() == "0 []", r.stdout + r.stderr
