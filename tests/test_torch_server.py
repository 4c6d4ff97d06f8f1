"""The port's resident server (ropebwt3_tpu_torch/server.py) on the CPU:
`serve --device=cpu` in a subprocess on the corpus index; `mem` (auto),
`mem --engine=hybrid`, `sw --engine=jax`, and `mem -p`, `hapdiv` and `sw`
with `--engine=server` answered by it, stdout
byte-equal to `python -m ropebwt3_tpu ... --engine=native` (the native
engines), the route marker on stderr, the client run with torch and jax
unimportable; `--engine=server` with no server and a request for another
device give one ERROR line; `serve --stop` ends it and removes its socket
and pid file.  In process: the rows the server holds at start (rb where
dense would crowd the device), and a start that does not fit.  Every wait
has its own timeout."""

import contextlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu import server as jserver
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch import server
from ropebwt3_tpu_torch.ops import smem

from .test_torch_cli import ROOT, _in_process, corpus_fmd  # noqa: F401  (fixture reuse)

READY_S, REQUEST_S = 120, 120  # seconds to wait for the server to answer, and for a request


def _client(argv, tmpdir, no_torch=False, **env):
    """The port's CLI in a subprocess sharing the server's temp directory
    (where the socket lies), with `env` added; with `no_torch`, torch and
    jax unimportable."""
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", TMPDIR=tmpdir, **env)
    pre = "sys.modules['torch'] = None\nsys.modules['jax'] = None\n" if no_torch else ""
    code = f"import sys\n{pre}from ropebwt3_tpu_torch.cli import main\nsys.exit(main(sys.argv[1:]))\n"
    return subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT, capture_output=True, env=env,
                          timeout=REQUEST_S)


@pytest.fixture(scope="module")
def served(corpus, corpus_fmd):  # noqa: F811
    """(index, its temp directory, the server process): `serve
    --device=cpu` on a copy of the corpus index, its hapdiv and sw engines
    warmed, ready."""
    tmpdir = tempfile.mkdtemp(prefix="rb3s")
    idx = os.path.join(tmpdir, "idx.fmd")
    for ext in ("", ".ssa", ".len.gz"):
        shutil.copyfile(f"{corpus_fmd}{ext}", idx + ext)
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", TMPDIR=tmpdir)
    log = open(os.path.join(tmpdir, "serve.log"), "wb")
    proc = subprocess.Popen([sys.executable, "-m", "ropebwt3_tpu_torch", "serve", "--device=cpu", "--warm=",
                             "--warm-hapdiv=21", "--warm-sw=150", idx],
                            cwd=ROOT, env=env, stdout=log, stderr=log)
    try:
        with _temp_dir(tmpdir):
            _wait_for(idx, lambda: proc.poll() is None)
            yield idx, tmpdir, proc
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        log.close()
        shutil.rmtree(tmpdir, ignore_errors=True)


@contextlib.contextmanager
def _temp_dir(tmpdir):
    """This process's temp directory (where server.sock_path looks) set to
    tmpdir."""
    old = os.environ.get("TMPDIR")
    os.environ["TMPDIR"], tempfile.tempdir = tmpdir, None
    try:
        yield
    finally:
        if old is None:
            del os.environ["TMPDIR"]
        else:
            os.environ["TMPDIR"] = old
        tempfile.tempdir = None


def _wait_for(idx, ok=lambda: True):
    """Until a CPU server answers for idx (READY_S at most, while ok())."""
    t_end = time.monotonic() + READY_S
    while server.server_device(idx) != "cpu":
        assert ok() and time.monotonic() < t_end, open(server.log_path(idx)).read() if os.path.exists(
            server.log_path(idx)) else "no server"
        time.sleep(0.1)


def _want(argv):
    return _in_process(jcli.main, argv)[1]


def test_engine_server_without_a_server_is_one_error(corpus, corpus_fmd, tmp_path):  # noqa: F811
    """No server answers for this index: one ERROR line, nothing on stdout."""
    for cmd in ("mem", "sw", "hapdiv"):
        r = _client([cmd, "--device=cpu", "--engine=server", str(corpus_fmd), str(corpus / "reads.fa")], str(tmp_path),
                    RB3TPU_STRICT_EXIT="1")
        lines = r.stderr.decode().splitlines()
        assert r.returncode == 1 and not r.stdout and len(lines) == 1 and lines[0].startswith("ERROR: no server")


def test_mem_auto_goes_to_the_server_without_torch(corpus, served):
    """`mem` on auto, torch and jax unimportable in the client: BED
    byte-equal to the native engine's, answered by the server."""
    idx, tmpdir, _ = served
    reads = str(corpus / "reads.fa")
    r = _client(["mem", "--device=cpu", "-l21", idx, reads], tmpdir, no_torch=True)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == _want(["mem", "--engine=native", "-l21", idx, reads]) and r.stdout
    assert server.MARKER.encode() in r.stderr


@pytest.mark.parametrize("argv", [["mem", "-l21", "-p3"], ["hapdiv", "-a31", "-w60"], ["sw"], ["mem", "-d", "-e"]],
                         ids=["mem-p", "hapdiv", "sw", "mem-d"])
def test_engine_server_matches_native(corpus, served, tmp_path, argv):
    """`--engine=server` requests: `mem -p3` (the SSA's positions), hapdiv,
    sw (PAF with positions) and `mem -d -e`, on the server's index and rows;
    sw on the corpus's first 4 reads (the plain DP runs ~0.5 s a read)."""
    idx, tmpdir, _ = served
    reads = str(corpus / "reads.fa")
    if "sw" in argv or "-d" in argv:
        reads = str(tmp_path / "few.fa")
        with open(reads, "w") as fh:
            fh.write("".join((corpus / "reads.fa").read_text().splitlines(keepends=True)[:8]))
    r = _client([argv[0], "--device=cpu", "--engine=server", *argv[1:], idx, reads], tmpdir)
    assert r.returncode == 0, r.stderr.decode()
    native = [] if argv[0] == "hapdiv" else ["--engine=native"]
    assert r.stdout == _want([argv[0], *native, *argv[1:], idx, reads]) and r.stdout
    assert server.MARKER.encode() in r.stderr


@pytest.mark.parametrize("argv", [["mem", "--engine=hybrid", "-l21"], ["sw", "--engine=jax"]],
                         ids=["mem-hybrid", "sw-jax"])
def test_device_engines_go_to_the_server(corpus, served, tmp_path, argv):
    """`mem --engine=hybrid` and `sw --engine=jax` go to the server that
    holds their index, as ropebwt3_tpu/cli.py:1161-1166 sends them, torch
    and jax unimportable in the client: stdout byte-equal to the native
    engine's; the hybrid splits each batch between the resident rows and
    the native engine.  sw on the corpus's first 4 reads."""
    idx, tmpdir, _ = served
    reads = str(corpus / "reads.fa")
    if argv[0] == "sw":
        reads = str(tmp_path / "few.fa")
        with open(reads, "w") as fh:
            fh.write("".join((corpus / "reads.fa").read_text().splitlines(keepends=True)[:8]))
    r = _client([argv[0], "--device=cpu", *argv[1:], idx, reads], tmpdir, no_torch=True)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == _want([argv[0], "--engine=native", *argv[2:], idx, reads]) and r.stdout
    assert server.MARKER.encode() in r.stderr
    if argv[0] == "mem":
        m = re.search(rb"hybrid: (\d+) of 60 reads on the card", r.stderr)
        assert m is not None and int(m.group(1)) >= 1, r.stderr.decode()


def test_request_for_another_device(corpus, served):
    """A `--device=cuda` request to a CPU server: `--engine=server` is one
    ERROR line; auto runs here (and without CUDA stops with one)."""
    idx, tmpdir, _ = served
    r = _client(["mem", "--engine=server", "-l21", idx, str(corpus / "reads.fa")], tmpdir, RB3TPU_STRICT_EXIT="1")
    lines = r.stderr.decode().splitlines()
    assert r.returncode == 1 and not r.stdout and len(lines) == 1 and "runs on cpu, not cuda" in lines[0]
    r = _client(["mem", "-l21", idx, str(corpus / "reads.fa")], tmpdir)
    assert server.MARKER.encode() not in r.stderr


def test_warm_dp_engines_before_ready(served):
    """--warm-hapdiv and --warm-sw ran their engines before `ready`."""
    log = open(os.path.join(served[1], "serve.log")).read()
    assert log.index("warming hapdiv -a21") < log.index("warming sw on reads of 150") < log.index("[serve] ready")


def test_rb_rows_at_start_dense_on_demand(corpus, corpus_fmd, monkeypatch):  # noqa: F811
    """Where dense rows would crowd the device (AUTO_RB_BYTES_CPU patched
    low), the server holds rb rows from its start, answers `mem` on them,
    and builds dense rows on the first hapdiv request; both outputs are the
    native engines'."""
    monkeypatch.setattr(smem, "AUTO_RB_BYTES_CPU", 1)
    monkeypatch.delenv("RB3TPU_DEVICE_OCC", raising=False)
    idx, reads = str(corpus_fmd), str(corpus / "reads.fa")
    cache = server.EngineCache(idx, tcli.load_index(idx, load_ssa=True, load_sid=True), torch.device("cpu"))
    assert list(cache._rows) == ["rb"]
    rc, out, err, halt = server.answer(cache, "mem", ["--device=cpu", "-l21", idx, reads])
    assert (rc, halt) == (0, False) and out == _want(["mem", "--engine=native", "-l21", idx, reads]), err
    assert list(cache._rows) == ["rb"]
    rc, out, err, halt = server.answer(cache, "hapdiv", ["--device=cpu", "--engine=server", "-a31", "-w60", idx, reads])
    assert (rc, halt) == (0, False) and out == _want(["hapdiv", "-a31", "-w60", idx, reads]) and out, err
    assert sorted(cache._rows) == ["dense", "rb"]


def test_start_that_does_not_fit_is_one_error(corpus_fmd, monkeypatch, capsys):  # noqa: F811
    """Rows that do not fit the card stop `serve` with one ERROR line, after
    the index load's log and before any socket."""
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: 1)
    assert server.main_serve(["--device=cpu", "--warm=", str(corpus_fmd)]) == 1
    lines = capsys.readouterr().err.splitlines()
    assert lines[-1].startswith("ERROR: the occ rows of 1 index(es) need"), lines
    assert all(x.startswith("[M::") for x in lines[:-1]) and not os.path.exists(server.sock_path(str(corpus_fmd)))


def test_sock_path_differs_from_jax(served):
    """Neither package's client can reach the other's server."""
    idx = served[0]
    assert server.sock_path(idx) != jserver.sock_path(idx)
    assert os.path.dirname(server.sock_path(idx)) == os.path.dirname(jserver.sock_path(idx))
    assert os.path.exists(server.sock_path(idx)) and not os.path.exists(jserver.sock_path(idx))


def test_stop_cleans_up(served):
    """`serve --stop`: the server exits 0 and its socket and pid file go."""
    idx, tmpdir, proc = served
    pid = int(open(server.pid_path(idx)).read())
    assert pid == proc.pid
    r = _client(["serve", "--stop", idx], tmpdir)
    assert r.returncode == 0, r.stderr.decode()
    assert proc.wait(timeout=30) == 0
    assert not os.path.exists(server.sock_path(idx)) and not os.path.exists(server.pid_path(idx))
    r = _client(["mem", "--device=cpu", "--engine=server", idx, idx], tmpdir, RB3TPU_STRICT_EXIT="1")
    assert r.returncode == 1 and b"ERROR: no server" in r.stderr


def test_auto_serve_starts_a_server(corpus, corpus_fmd):  # noqa: F811
    """RB3TPU_AUTO_SERVE=1: `mem` with no server runs here and starts one
    (`serve --device=cpu` and RB3TPU_SERVE_ARGS) in the background; a
    second `mem` while it starts does not start another; once it answers,
    `mem` goes to it; `serve --stop` ends it."""
    tmpdir = tempfile.mkdtemp(prefix="rb3a")
    idx, reads = os.path.join(tmpdir, "idx.fmd"), str(corpus / "reads.fa")
    shutil.copyfile(corpus_fmd, idx)
    want = _want(["mem", "--engine=native", "-l21", idx, reads])
    argv, auto = ["mem", "--device=cpu", "-l21", idx, reads], dict(RB3TPU_AUTO_SERVE="1", RB3TPU_SERVE_ARGS="--warm=")
    try:
        with _temp_dir(tmpdir):
            first, second = _client(argv, tmpdir, **auto), _client(argv, tmpdir, **auto)
            assert first.stdout == want and b"starting a resident server" in first.stderr
            assert second.stdout == want and b"starting a resident server" not in second.stderr
            _wait_for(idx)
            pid = int(open(server.pid_path(idx)).read())
            r = _client(argv, tmpdir)
            assert r.stdout == want and server.MARKER.encode() in r.stderr
            assert _client(["serve", "--stop", idx], tmpdir).returncode == 0 and not server.alive(pid)
    finally:
        _client(["serve", "--stop", idx], tmpdir)
        shutil.rmtree(tmpdir, ignore_errors=True)
