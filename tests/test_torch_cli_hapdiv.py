"""`hapdiv` and `mem -a/-w` of `python -m ropebwt3_tpu_torch` against
`python -m ropebwt3_tpu` on the corpus, stdout byte for byte.  These are
the CLI file's slowest cases, in a file of their own so that another
worker runs them; the helpers and the index fixture are copies of
tests/test_torch_cli.py's."""

import gzip
import os
import subprocess
import sys

import pytest

from ropebwt3_tpu.seqio import read_seqs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT = {"RB3TPU_STRICT_EXIT": "1"}  # the command's own exit code (cli.main gives 0 for a known command)


def _run(module, args, strict=False):
    # neither package is installed: both are found from the repo root; with
    # `strict`, RB3TPU_STRICT_EXIT=1: the command's own exit code, not 0
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", **(STRICT if strict else {}))
    return subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT, capture_output=True, env=env)


def _run_without_jax(args, strict=False):
    """The port's CLI in a process where `import jax` fails."""
    code = "import sys\nsys.modules['jax'] = None\nfrom ropebwt3_tpu_torch.cli import main\nsys.exit(main(sys.argv[1:]))\n"
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", **(STRICT if strict else {}))
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


@pytest.mark.parametrize("cmd,device_engine", [
    (["hapdiv"], True), (["mem", "-a51", "-w20"], True), (["hapdiv", "--engine=native"], False)],
    ids=["hapdiv", "mem-a51-w20", "native"])
def test_hapdiv_matches_reference(corpus, corpus_fmd, cmd, device_engine):
    """`hapdiv` and `mem -a/-w` (whose -k end_len stays 11) through the
    port's device engine on the CPU (the plain version, flagged windows on
    the native DP), or its native DP alone, with jax unimportable: stdout
    byte-equal to `python -m ropebwt3_tpu`, whose engine is the native DP."""
    files = [str(corpus_fmd), str(corpus / "reads.fa")]
    want = _run("ropebwt3_tpu", cmd + files)
    got = _run_without_jax(cmd + ["--device=cpu"] + files)
    assert want.returncode == 0, want.stderr.decode()
    assert got.returncode == 0, got.stderr.decode()
    assert want.stdout.count(b"\n") >= 60 and got.stdout == want.stdout
    assert (b"0 hapdiv launches (dense32)" in got.stderr) == device_engine
