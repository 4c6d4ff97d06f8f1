"""The port's debug streams against the JAX package's, on the CPU tests'
corpus: `sw`, `mem -d`, `hapdiv` and `mem -a` with `--dbg-dawg`,
`--dbg-sw`, `--dbg-qname` and `--dbg-bt` through the Python BWA-SW DP
(align/bwasw.py, bwtl.py, khashl_compat.py).

- (c) `sw` with each flag and with all four: stdout byte-equal, and the
  stderr lines that start with `DG\\t`, `SW\\t`, `BT\\t` or `Q\\t` equal and in
  the same order (each package's `[M::...]` log lines differ, and are
  filtered out as tests/test_bwasw.py:116-119 does);
- (d) `hapdiv` with `--dbg-sw --dbg-bt` on more than 64 windows, batched
  across reads: the Python DP takes its windows in batches cut where the
  JAX package cuts them, so the SW lines of a batch interleave alike;
- the flags live in the command's options: a command after a debug run
  writes no trace;
- `--engine=jax` writes only the `Q` lines: its device engine gets the
  options without the flags, and its reruns stay native.

Both CLIs run in this process; the JAX package's global flags are zeroed
before each of its runs (`run_main`)."""

import re

import pytest

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu_torch import cli as tcli

from .test_torch_cli import corpus_fmd  # noqa: F401  (fixture reuse)
from .test_torch_cuda import sw_reads
from .test_torch_oldmem import first_reads, run_main
from .test_torch_sw import genomes  # noqa: F401  (fixture reuse)

TRACE = re.compile(r"^(DG|SW|BT|Q)\t", re.M)


def traces(err: str) -> list[str]:
    return [line for line in err.splitlines() if TRACE.match(line)]


@pytest.fixture(scope="module")
def dbg_reads(genomes, tmp_path_factory):  # noqa: F811
    """Three of sw_reads' reads (150, 90 and 45 bp): N bases in a tandem
    repeat that merges DAWG nodes, substitutions, a deletion that exercises
    the F closure; the last without a name."""
    fa = tmp_path_factory.mktemp("dbg") / "q.fa"
    recs = [(f"q{i}", "".join("$ACGTN"[c] for c in r)) for i, r in enumerate(sw_reads(genomes, 3, seed=3))]
    recs[-1] = ("", recs[-1][1])
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in recs))
    return fa


@pytest.fixture(scope="module")
def hap_reads(corpus, tmp_path_factory):
    """Eight corpus reads of 150 bp: 12 windows each at -a31 -w10, 96 in
    all, so the first batch closes at 72 (at the read that passes 64) and a
    second batch holds 24."""
    return first_reads(corpus, tmp_path_factory, 8, "dbg_hap")


def both(monkeypatch, argv, files):
    """(stdout, traces) of the JAX package and of the port (--device=cpu)
    on argv + files; both exit 0."""
    want_rc, want, want_err = run_main(jcli.main, argv + files, monkeypatch)
    got_rc, got, got_err = run_main(tcli.run, [argv[0], "--device=cpu"] + argv[1:] + files)
    assert want_rc == got_rc == 0, got_err
    return (want, traces(want_err)), (got, traces(got_err))


@pytest.mark.parametrize("argv", [
    ["sw", "--dbg-dawg"],
    ["sw", "--dbg-sw"],
    ["sw", "--dbg-qname"],
    ["sw", "--dbg-bt"],
    ["sw", "--dbg-dawg", "--dbg-sw", "--dbg-qname", "--dbg-bt"],
    ["sw", "-e", "--dbg-sw", "--dbg-bt"],
    ["sw", "-j31", "-p3", "--engine=native", "--dbg-sw"],
    ["mem", "-d", "--dbg-dawg", "--dbg-bt"],
], ids=" ".join)
def test_sw_traces_match(monkeypatch, corpus_fmd, dbg_reads, argv):  # noqa: F811
    """stdout byte-equal, the trace lines equal and in order."""
    (want, want_tr), (got, got_tr) = both(monkeypatch, argv, [str(corpus_fmd), str(dbg_reads)])
    assert want.count(b"\n") >= 1 and got == want
    assert want_tr and got_tr == want_tr
    kinds = {line.split("\t")[0] for line in got_tr}
    flags = {"--dbg-dawg": "DG", "--dbg-sw": "SW", "--dbg-qname": "Q", "--dbg-bt": "BT"}
    assert kinds <= {flags[a] for a in argv if a in flags}


@pytest.mark.parametrize("argv", [
    ["hapdiv", "--dbg-sw", "--dbg-bt", "-a31", "-w10"],
    ["hapdiv", "--dbg-sw"],
    ["mem", "-a31", "--dbg-qname"],
    ["hapdiv", "--dbg-dawg", "--engine=native", "-a31"],
], ids=" ".join)
def test_hapdiv_traces_match(monkeypatch, corpus_fmd, hap_reads, argv):  # noqa: F811
    """stdout byte-equal and the trace lines equal and in order, over more
    than one batch of the Python DP; hapdiv writes no DG or Q line (its
    DAWGs are chains, its loop names no read)."""
    (want, want_tr), (got, got_tr) = both(monkeypatch, argv, [str(corpus_fmd), str(hap_reads)])
    assert want.count(b"\n") >= 8 and got == want
    assert got_tr == want_tr
    assert bool(got_tr) == ("--dbg-sw" in argv or "--dbg-bt" in argv)
    if "-w10" in argv:
        # the first batch's windows, node by node: its 72 windows' rows of
        # node 1 come first (a batch cut at 64 windows would give 64, one
        # batch of all 96 windows 96)
        lead = next(i for i, line in enumerate(got_tr) if not line.startswith("SW\t1\t"))
        assert lead == 72


def test_flags_do_not_leak(corpus_fmd, dbg_reads):  # noqa: F811
    """A run with debug flags, then one without, in one process: the second
    writes no trace (the native engine), with the same stdout as the
    first."""
    files = [str(corpus_fmd), str(dbg_reads)]
    rc1, out1, err1 = run_main(tcli.run, ["sw", "--device=cpu", "--engine=native", "--dbg-sw", "--dbg-qname"] + files)
    rc2, out2, err2 = run_main(tcli.run, ["sw", "--device=cpu", "--engine=native"] + files)
    assert rc1 == rc2 == 0 and out1 == out2 and out1
    assert traces(err1) and not traces(err2)


def test_jax_engine_writes_only_q_lines(monkeypatch, corpus_fmd, dbg_reads):  # noqa: F811
    """`--engine=jax` keeps the device engine: its stdout is the JAX
    package's default run's, and of the traces only the Q lines come."""
    files = [str(corpus_fmd), str(dbg_reads)]
    _, want, _ = run_main(jcli.main, ["sw"] + files, monkeypatch)
    argv = ["sw", "--device=cpu", "--engine=jax", "--dbg-qname", "--dbg-sw", "--dbg-bt"]
    rc, got, err = run_main(tcli.run, argv + files)
    assert rc == 0 and got == want
    tr = traces(err)
    assert tr == [f"Q\t{n}\t0" for n in ("q0", "q1", "seq3")]
    assert "sw launches (dense32)" in err
