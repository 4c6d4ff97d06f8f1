"""`python -m ropebwt3_tpu_torch` against `python -m ropebwt3_tpu` on the
corpus: `mem` stdout byte for byte against `--engine=native`, the `ssa` file
byte for byte; and the options that would reach the JAX package's device
code refused with jax unimportable."""

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


def _run_without_jax(args):
    """The port's CLI in a process where `import jax` fails."""
    code = "import sys\nsys.modules['jax'] = None\nfrom ropebwt3_tpu_torch.cli import main\nsys.exit(main(sys.argv[1:]))\n"
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code] + args, cwd=ROOT, capture_output=True, env=env)


@pytest.fixture(scope="module")
def corpus_fmd(corpus, tmp_path_factory):
    """FMD with the sampled suffix array (from the port's `ssa`) and the
    sequence lengths that `-p` reads."""
    fmd = tmp_path_factory.mktemp("torch_cli") / "idx.fmd"
    for module, cmd in (("ropebwt3_tpu", ["build", "-do", str(fmd), str(corpus / "genomes.fa")]),
                        ("ropebwt3_tpu_torch", ["ssa", "--device=cpu", "-o", f"{fmd}.ssa", str(fmd)])):
        r = _run(module, cmd)
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


@pytest.mark.parametrize("opts", [[], ["-s", "4"]], ids=["default", "s4"])
def test_ssa_matches_reference(corpus_fmd, tmp_path, opts):
    want, got = tmp_path / "ref.ssa", tmp_path / "port.ssa"
    r = _run("ropebwt3_tpu", ["ssa", *opts, "-o", str(want), str(corpus_fmd)])
    assert r.returncode == 0, r.stderr.decode()
    r = _run("ropebwt3_tpu_torch", ["ssa", "--device=cpu", *opts, "-o", str(got), str(corpus_fmd)])
    assert r.returncode == 0, r.stderr.decode()
    assert want.read_bytes() and got.read_bytes() == want.read_bytes()
    assert b"0 ssa_gen launches (dense32)" in r.stderr  # the port's walk ran, on the CPU


def test_ssa_without_cuda_exits_nonzero(corpus_fmd, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    r = _run("ropebwt3_tpu_torch", ["ssa", "-o", str(tmp_path / "x.ssa"), str(corpus_fmd)])
    assert r.returncode != 0 and b"CUDA" in r.stderr and not (tmp_path / "x.ssa").exists()


@pytest.mark.parametrize("argv,why", [
    (["sw", "--engine=jax"], b"sw --engine=jax"),
    (["hapdiv", "--engine", "hybrid"], b"hapdiv --engine=hybrid"),
    (["search", "--engine=server"], b"search --engine=server"),
    (["ssa", "--mesh=2"], b"ssa --mesh"),
    (["mem", "--device=cpu", "--mesh", "2x1", "-l21"], b"mem --mesh"),
    (["build", "--mesh=4", "-do", "x.fmd"], b"build --mesh"),
    (["serve"], b"serve"),
])
def test_refuses_jax_device_options(corpus_fmd, argv, why):
    """One ERROR line naming the option and the ROADMAP item, no traceback."""
    r = _run_without_jax(argv + [str(corpus_fmd)])
    assert r.returncode != 0 and not r.stdout
    lines = r.stderr.decode().splitlines()
    assert len(lines) == 1 and lines[0].startswith("ERROR: ") and why.decode() in lines[0], lines
    assert "ROADMAP queue 1 item" in lines[0] and "Traceback" not in r.stderr.decode()


def test_host_commands_pass_without_jax(corpus_fmd):
    """`stat`, a host command of the JAX package, is handed through unchanged."""
    want = _run("ropebwt3_tpu", ["stat", str(corpus_fmd)])
    got = _run_without_jax(["stat", str(corpus_fmd)])
    assert got.returncode == 0, got.stderr.decode()
    assert want.stdout and got.stdout == want.stdout
