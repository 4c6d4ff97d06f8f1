"""`python -m ropebwt3_tpu_torch.tools` (the port's copy of rb3tools)
against `python -m ropebwt3_tpu.tools`: every subcommand on the same inputs,
in this process, stdout byte for byte: real `sw --all-e2e` output of the
corpus (windows cut by `fa2kmer`) and the seeded synthetic streams of
tests/test_tools_differential.py; and the module run in a process where
`import jax` fails."""

import contextlib
import io
import random
import subprocess
import sys

import pytest

from ropebwt3_tpu import tools as jtools
from ropebwt3_tpu_torch import tools as ttools

from .test_torch_cli import ROOT, _run, corpus_fmd  # noqa: F401  (fixture reuse)
from .test_tools_differential import _rand_e2e


def _out(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def e2e(corpus, corpus_fmd, tmp_path_factory):  # noqa: F811
    """`sw --all-e2e` of the 101-mers at step 50 of the corpus's first two
    genomes (QS names `g:start-end`, as `call` reads them), from the JAX
    package's native engine."""
    d = tmp_path_factory.mktemp("tools")
    two = d / "two.fa"
    two.write_text("\n".join((corpus / "genomes.fa").read_text().split("\n")[:4]) + "\n")
    km = _run("ropebwt3_tpu", ["fa2kmer", "-k101", "-w50", str(two)])
    (d / "kmers.fa").write_bytes(km.stdout)
    r = _run("ropebwt3_tpu", ["sw", "--all-e2e", str(corpus_fmd), str(d / "kmers.fa")])
    assert r.returncode == 0 and r.stdout.count(b"QS\t") > 300, r.stderr.decode()[-2000:]
    (d / "aln.e2e").write_bytes(r.stdout)
    vcf = _out(jtools.main, ["call", "3", str(d / "aln.e2e")])[1]
    (d / "calls.vcf").write_text(vcf)
    return d


REAL = [["call", "8", "E2E"], ["call", "3", "-a2", "-r20", "-d3", "-1", "-c", "E2E"], ["mapflt", "1", "E2E"],
        ["mapflt", "5", "-d2", "-g10", "E2E"], ["mapflt2", "2", "E2E", "E2E"], ["uniqmer", "E2E"],
        ["uniqmer", "-d3", "-e2", "-E50", "E2E"], ["getsnp", "VCF"], ["getsnp", "-a", "VCF"], ["version"], []]


@pytest.mark.parametrize("argv", REAL, ids=lambda a: "-".join(a) or "usage")
def test_tools_match_on_real_output(e2e, argv):
    argv = [{"E2E": str(e2e / "aln.e2e"), "VCF": str(e2e / "calls.vcf")}.get(a, a) for a in argv]
    got, want = _out(ttools.main, argv), _out(jtools.main, argv)
    assert got == want and (got[1] or argv[:2] == ["getsnp", "-a"])  # -a: the corpus has no auto-only SNP
    if argv[:2] == ["call", "8"]:
        assert any(not ln.startswith("#") for ln in got[1].splitlines())  # variants were called


@pytest.mark.parametrize("seed", range(4))
def test_tools_match_on_synthetic_streams(tmp_path, seed):
    """call, mapflt, mapflt2 and uniqmer on a seeded stream with every cs
    op, score ties at the cutoff and contig changes."""
    rng = random.Random(7000 + seed)
    p = tmp_path / "r.e2e"
    p.write_text(_rand_e2e(rng))
    for argv in (["call", str(rng.choice([1, 3, 25])), f"-a{rng.randrange(0, 8)}", f"-d{rng.randrange(0, 6)}", "-1", "-c"],
                 ["mapflt", str(rng.choice([1, 2, 10])), f"-d{rng.randrange(0, 8)}", f"-g{rng.choice([0, 10, 50])}"],
                 ["mapflt2", "2"], ["uniqmer", f"-d{rng.randrange(0, 8)}"]):
        argv = argv + [str(p)] * (2 if argv[0] == "mapflt2" else 1)
        assert _out(ttools.main, argv) == _out(jtools.main, argv), argv


def test_tools_module_runs_without_jax(e2e):
    """`python -m ropebwt3_tpu_torch.tools call` with jax and the JAX
    package unimportable: the same VCF as the JAX package's module."""
    argv = ["call", "8", str(e2e / "aln.e2e")]
    code = ("import runpy, sys\nsys.modules['jax'] = None\nsys.modules['ropebwt3_tpu'] = None\n"
            "sys.argv = ['tools'] + sys.argv[1:]\nrunpy.run_module('ropebwt3_tpu_torch.tools', run_name='__main__')\n")
    got = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT, capture_output=True)
    want = subprocess.run([sys.executable, "-m", "ropebwt3_tpu.tools", *argv], cwd=ROOT, capture_output=True)
    assert got.returncode == 0, got.stderr.decode()
    assert got.stdout == want.stdout and got.stdout.startswith(b"##fileformat=VCF")
