"""The port's exit codes against the JAX package's, both mains run in this
process: 0 for every known command, its errors included, and 1 for an
unknown command; with RB3TPU_STRICT_EXIT=1 the command's own code (1 on an
ERROR line) and 127 for an unknown command (ropebwt3_tpu/cli.py main)."""

import contextlib
import io

import pytest

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu_torch import cli as tcli

MISSING = "/nonexistent/idx.fmd"
# (the port's argv, the JAX package's): the port's device commands on the CPU
CASES = {
    "get-missing-index": (["get", "--device=cpu", MISSING, "0"], ["get", MISSING, "0"]),
    "suffix-missing-index": (["suffix", "--device=cpu", MISSING, "READS"], ["suffix", MISSING, "READS"]),
    "mem-missing-index": (["mem", "--device=cpu", "-l21", MISSING, "READS"], ["mem", "-l21", MISSING, "READS"]),
    "fa2kmer-unknown-option": (["fa2kmer", "--mesh=2", "READS"], ["fa2kmer", "--mesh=2", "READS"]),
    "bad-device": (["get", "--device=bogus", MISSING, "0"], ["get", "--device=bogus", MISSING, "0"]),
    "unknown-command": (["bogus", "x"], ["bogus", "x"]),
}


@pytest.fixture
def reads(tmp_path):
    fa = tmp_path / "reads.fa"
    fa.write_text(">r\nACGTACGTAC\n")
    return str(fa)


def _code(main, argv) -> tuple[int, str]:
    """(exit code, stderr) of a CLI's main called in this process."""
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


@pytest.mark.parametrize("strict", [False, True], ids=["mirrored", "strict"])
@pytest.mark.parametrize("case", list(CASES))
def test_exit_code_matches_jax(monkeypatch, reads, case, strict):
    """The same code from both packages; an ERROR line on stderr from each."""
    if strict:
        monkeypatch.setenv("RB3TPU_STRICT_EXIT", "1")
    else:
        monkeypatch.delenv("RB3TPU_STRICT_EXIT", raising=False)
    port, ref = ([reads if a == "READS" else a for a in argv] for argv in CASES[case])
    got, got_err = _code(tcli.main, port)
    want, want_err = _code(jcli.main, ref)
    unknown = case == "unknown-command"
    assert got == want == ((127 if unknown else 1) if strict else int(unknown)), (got_err, want_err)
    assert "ERROR: " in got_err and "ERROR: " in want_err
    if case in ("get-missing-index", "unknown-command", "fa2kmer-unknown-option"):
        assert got_err == want_err


@pytest.mark.parametrize("strict", [False, True], ids=["mirrored", "strict"])
def test_refused_option_exits_as_an_error(monkeypatch, reads, strict):
    """`mem --old-mem`, refused until the port ran it, now runs as the JAX
    package's does: on a missing index one ERROR line, exit 0, or 1 under
    RB3TPU_STRICT_EXIT=1, as the JAX package's error on the same index."""
    monkeypatch.setenv("RB3TPU_STRICT_EXIT", "1" if strict else "0")
    got, err = _code(tcli.main, ["mem", "--device=cpu", "--old-mem", MISSING, reads])
    want, want_err = _code(jcli.main, ["mem", "--old-mem", MISSING, reads])
    assert got == want == int(strict)
    assert err.count("\n") == 1 and err.startswith("ERROR: ") and "ROADMAP" not in err
    assert "failed to load" in err and "failed to load" in want_err


def test_run_returns_the_commands_own_code(reads):
    """`run`, which the port's timing tools call, gives the real code
    whatever the variable says."""
    assert _code(tcli.run, ["get", "--device=cpu", MISSING, "0"])[0] == 1
    assert _code(tcli.run, ["bogus"])[0] == tcli.UNKNOWN_CMD == 127
    assert _code(tcli.run, ["version"])[0] == 0
