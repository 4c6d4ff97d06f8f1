"""`sw`, `hapdiv`, `mem -d`, `mem -a/-w` and `search -d` past the card, on
the CPU (F10).  The JAX package's auto runs the native DP at every index
size; the port's auto runs the card's DP unless the index's dense rows do
not belong there (align/cli_hooks.py auto_on_card: mem's rule, dense rows
past AUTO_RB_SHARE of the card, or past its free bytes).  The budget is
forced in-process: ops/smem.py AUTO_RB_BYTES_CPU shrunk, cli.card_bytes
patched.

- On auto past the budget, each command's stdout is byte-equal to `python
  -m ropebwt3_tpu`'s default run, no device engine is made and no rows are
  built, and the log names the native choice with the rows' bytes; a
  resident server answers auto by the same rule;
- `--engine=jax` and `--engine=hybrid` (and `--mesh`) with the rows past
  `cli.card_bytes` stop with one CapacityError line before any rows are
  built; a torch.OutOfMemoryError from the card is one ERROR line, never a
  traceback.
Every comparison is exact.
"""

import contextlib
import io

import pytest
import torch

from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch import server
from ropebwt3_tpu_torch.align import hapdiv, sw
from ropebwt3_tpu_torch.ops import rank, smem

from .test_torch_cli import _run
from .test_torch_cli import corpus_fmd  # noqa: F401  (fixture reuse)

AUTO = [["sw"], ["hapdiv"], ["mem", "-d"], ["mem", "-a51", "-w20"], ["search", "-d", "-p3"]]


def _port(argv):
    """(exit code, stdout, stderr) of the port's `cli.run` in this process."""
    buf, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.run(argv)
    out.flush()
    return rc, buf.getvalue(), err.getvalue()


def _no_card_work(monkeypatch):
    """Makes building a device engine's rows, or any occ rows, fail the test."""
    def refuse(*a, **kw):
        raise AssertionError("occ rows built for the card")

    monkeypatch.setattr(rank.OccIndex, "from_dense", refuse)
    monkeypatch.setattr(rank.OccIndex, "from_bwt", refuse)


@pytest.fixture(scope="module")
def refs(corpus, corpus_fmd):  # noqa: F811
    """`python -m ropebwt3_tpu <argv>` stdout of each AUTO command on the corpus's reads (its default engine)."""
    out = {}
    for argv in AUTO:
        r = _run("ropebwt3_tpu", argv + [str(corpus_fmd), str(corpus / "reads.fa")])
        assert r.returncode == 0 and r.stdout.count(b"\n") >= 8, r.stderr.decode()
        out[" ".join(argv)] = r.stdout
    return out


@pytest.mark.parametrize("argv", AUTO, ids=" ".join)
def test_auto_past_the_card_runs_the_native_dp(corpus, corpus_fmd, refs, monkeypatch, argv):  # noqa: F811
    """AUTO_RB_BYTES_CPU below the dense rows: auto runs the native DP, its
    stdout byte-equal to the JAX package's default, no K8/K9 launch and no
    rows; the one log line names the rows' bytes and the budget."""
    monkeypatch.setattr(smem, "AUTO_RB_BYTES_CPU", 1)
    monkeypatch.delenv("RB3TPU_DEVICE_OCC", raising=False)
    _no_card_work(monkeypatch)
    before = (dict(sw.sw_cuda.launches), dict(hapdiv.hapdiv_cuda.launches))
    rc, got, err = _port([argv[0], "--device=cpu", *argv[1:], str(corpus_fmd), str(corpus / "reads.fa")])
    assert rc == 0 and got == refs[" ".join(argv)], err
    assert (dict(sw.sw_cuda.launches), dict(hapdiv.hapdiv_cuda.launches)) == before
    lines = [ln for ln in err.splitlines() if "auto runs the native DP" in ln]
    assert len(lines) == 1 and "the dense rows need " in lines[0] and "rb rows by mem's rule (dense rows past 1 B" in lines[0]
    assert "launches (dense32)" not in err


def test_auto_past_the_free_bytes_runs_the_native_dp(corpus, corpus_fmd, refs, monkeypatch):  # noqa: F811
    """The dense rows within mem's share but past cli.card_bytes: auto runs
    the native DP, byte-equal, and says so with both numbers."""
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: 1000)
    monkeypatch.delenv("RB3TPU_DEVICE_OCC", raising=False)
    _no_card_work(monkeypatch)
    rc, got, err = _port(["sw", "--device=cpu", str(corpus_fmd), str(corpus / "reads.fa")])
    assert rc == 0 and got == refs["sw"], err
    assert "auto runs the native DP: the dense rows need " in err and "past the card's 1000 B" in err


def test_server_answers_auto_by_the_same_rule(corpus, corpus_fmd, refs, monkeypatch):  # noqa: F811
    """A resident server whose index's dense rows pass mem's share answers
    `sw` and `hapdiv` on auto with the native DP (no dense rows built),
    byte-equal, and still builds them for `--engine=jax`."""
    monkeypatch.setattr(smem, "AUTO_RB_BYTES_CPU", 1)
    monkeypatch.delenv("RB3TPU_DEVICE_OCC", raising=False)
    idx, reads = str(corpus_fmd), str(corpus / "reads.fa")
    cache = server.EngineCache(idx, tcli.load_index(idx, load_ssa=True, load_sid=True), torch.device("cpu"))
    assert cache.dp_engine("auto") == {} and list(cache._rows) == ["rb"]
    for cmd in ("sw", "hapdiv"):
        rc, out, err, halt = server.answer(cache, cmd, ["--device=cpu", idx, reads])
        assert (rc, halt) == (0, False) and out == refs[cmd] and b"auto runs the native DP" in err, err
    assert list(cache._rows) == ["rb"]
    assert cache.dp_engine("jax")["rows"] is cache._rows["dense"]


@pytest.mark.parametrize("argv", [["sw", "--engine=jax"], ["sw", "--engine=hybrid"], ["hapdiv", "--engine=jax"],
                                  ["hapdiv", "--engine=hybrid"], ["mem", "-d", "--engine=jax"],
                                  ["sw", "--engine=jax", "--mesh=2"]], ids=" ".join)
def test_device_engine_past_the_card_is_one_error(corpus, corpus_fmd, monkeypatch, argv):  # noqa: F811
    """--engine=jax|hybrid (and over a mesh) with the dense rows past
    cli.card_bytes: one CapacityError line naming the bytes, exit 1 under
    RB3TPU_STRICT_EXIT=1, before any rows are built, no output."""
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: 1000)
    _no_card_work(monkeypatch)
    rc, got, err = _port([argv[0], "--device=cpu", *argv[1:], str(corpus_fmd), str(corpus / "reads.fa")])
    lines = [ln for ln in err.splitlines() if not ln.startswith("[M::")]
    assert rc == 1 and not got and len(lines) == 1 and "Traceback" not in err, err
    what = "the replicated occ rows of a mesh (cpu)" if "--mesh=2" in argv else "the occ rows of 1 index(es)"
    assert lines[0].startswith(f"ERROR: {what} need ~") and lines[0].endswith("B of the card (dense rows), which has 1000 B")


def test_out_of_card_memory_is_one_error(corpus, corpus_fmd, monkeypatch):  # noqa: F811
    """A torch.OutOfMemoryError on a DP path (here raised by the engine) is
    one ERROR line and exit 1, not a traceback."""
    def oom(self, seqs):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB\nmore detail")

    monkeypatch.setattr(sw.SwDeviceEngine, "run", oom)
    rc, got, err = _port(["sw", "--device=cpu", "--engine=jax", str(corpus_fmd), str(corpus / "reads.fa")])
    lines = [ln for ln in err.splitlines() if not ln.startswith("[M::")]
    assert rc == 1 and not got and lines == ["ERROR: out of card memory: CUDA out of memory. Tried to allocate 80.00 GiB"]
