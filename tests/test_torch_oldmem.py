"""The port's host rank and `--old-mem` against the JAX package's, on the
CPU tests' corpus:

- (a) `DenseFMIndex.rank1a`, `extend` (both directions), `set_intv` and
  `lf` of the port equal the JAX package's on seeded positions and
  intervals, at k = 0, n and the block and superblock edges;
- `smem_orig`, `smem_tg` and `smem_present` of the port's ops/smem_ref.py
  equal the JAX package's on the corpus reads;
- (b) `mem --old-mem` (and `search --old-mem`, and `--old-mem` given after
  `-d`) through the port's CLI on the CPU: BED byte-equal to `python -m
  ropebwt3_tpu` with the same argv, with `-p`, `--gap`, `--cov` and `-c`.

Both CLIs run in this process (`run_main`); the original algorithm is a
Python loop a read in both packages, so the reads are few."""

import contextlib
import io

import numpy as np
import pytest

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu.align import bwasw as jbw
from ropebwt3_tpu.index.dense import BLOCK, SUPER
from ropebwt3_tpu.ops import smem_ref as jref
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch.nt6 import char2nt6
from ropebwt3_tpu_torch.ops import smem_ref as tref

from .test_torch_cli import corpus_fmd  # noqa: F401  (fixture reuse)

N_READS = 8  # reads of the corpus in the CLI cases


def run_main(main, argv: list[str], monkeypatch=None) -> tuple[int, bytes, str]:
    """(exit code, stdout bytes, stderr) of a CLI's main called in this
    process; with `monkeypatch`, the JAX package's global debug flags are
    zeroed first (they are never reset there, and monkeypatch restores
    them after the test)."""
    if monkeypatch is not None:
        monkeypatch.setattr(jbw, "dbg_flag", 0)
    out, err = io.TextIOWrapper(io.BytesIO(), encoding="utf-8", write_through=True), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    out.flush()
    return rc, out.buffer.getvalue(), err.getvalue()


def first_reads(corpus, tmp_path_factory, n: int, name: str):
    """The corpus's first n reads as a FASTA file of their own."""
    fa = tmp_path_factory.mktemp(name) / "q.fa"
    recs = list(read_seqs(str(corpus / "reads.fa")))[:n]
    fa.write_text("".join(f">{r.name}\n{r.seq.decode() if isinstance(r.seq, bytes) else r.seq}\n" for r in recs))
    return fa


@pytest.fixture(scope="module")
def indexes(corpus_fmd):  # noqa: F811
    """The corpus index loaded by each package: (port's, JAX package's)."""
    return tcli.load_index(str(corpus_fmd)), jcli.load_index(str(corpus_fmd))


@pytest.fixture(scope="module")
def reads(corpus):
    return [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))]


@pytest.fixture(scope="module")
def few_reads(corpus, tmp_path_factory):
    return first_reads(corpus, tmp_path_factory, N_READS, "oldmem")


def edge_positions(n: int, rng) -> np.ndarray:
    """0, n, each block and superblock edge below n and its neighbours, and
    seeded positions."""
    edges = np.concatenate([np.arange(0, n + 1, BLOCK), np.arange(0, n + 1, SUPER)])
    k = np.concatenate([[0, 1, n - 1, n], edges, edges - 1, edges + 1, rng.integers(0, n + 1, 4096)])
    return k[(k >= 0) & (k <= n)]


def test_rank1a_matches(indexes):
    t, j = indexes
    k = edge_positions(t.n, np.random.default_rng(1))
    got = t.rank1a(k)
    assert got.shape == (len(k), 6) and np.array_equal(got, j.rank1a(k))
    assert np.array_equal(t.rank1a(np.array(t.n)), t.acc[1:] - t.acc[:-1])  # every symbol before n
    for a, b in zip(t.rank2a(k[:100], k[100:200]), j.rank2a(k[:100], k[100:200])):
        assert np.array_equal(a, b)
    inside = k[k < t.n]
    assert np.array_equal(t.symbol_at(inside), j.symbol_at(inside))
    for a, b in zip(t.lf(inside), j.lf(inside)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("is_back", [True, False], ids=["backward", "forward"])
def test_extend_matches(indexes, is_back):
    """extend on seeded bi-intervals, those from set_intv of every symbol,
    and ones whose ends sit at 0, n and block edges."""
    t, j = indexes
    rng = np.random.default_rng(2 if is_back else 3)
    n = t.n
    x0 = edge_positions(n, rng)
    size = np.minimum(rng.integers(0, 3 * BLOCK, len(x0)), n - x0)
    x1 = rng.integers(0, n + 1, len(x0))
    ik = np.stack([x0, np.minimum(x1, n - size), size], axis=-1).astype(np.int64)
    ik = np.concatenate([ik, np.stack([t.set_intv(c) for c in range(6)]), [[0, 0, n], [n, n, 0]]])
    for c in range(6):
        assert np.array_equal(t.set_intv(c), j.set_intv(c))
    got = t.extend(ik, is_back)
    assert got.shape == (len(ik), 6, 3) and np.array_equal(got, j.extend(ik, is_back))


@pytest.mark.parametrize("min_len,min_occ", [(19, 1), (21, 1), (31, 2)])
def test_smem_ref_matches(indexes, reads, min_len, min_occ):
    """The original algorithm and the long-MEM one, MEM for MEM, and the
    early-exit check, on the corpus's reads."""
    t, j = indexes
    for q in reads[:6]:
        for algo in ("smem_orig", "smem_tg"):
            want = [tref.Mem(**m.__dict__) for m in getattr(jref, algo)(j, q, min_occ, min_len)]
            assert getattr(tref, algo)(t, q, min_occ, min_len) == want, algo
        assert tref.smem_present(t, q, min_len + 40) == jref.smem_present(j, q, min_len + 40)


@pytest.mark.parametrize("argv", [
    ["mem", "--old-mem", "-l21"],
    ["mem", "--old-mem", "-l21", "-p3"],
    ["mem", "--old-mem", "-l21", "--gap=5"],
    ["mem", "--old-mem", "-l21", "--cov"],
    ["mem", "--old-mem", "-l19", "-c2"],
    ["mem", "--old-mem", "-l21", "--gap=5", "-p3"],
    ["search", "--old-mem", "-l21"],
    ["mem", "-d", "--old-mem", "-l21"],
], ids=" ".join)
def test_old_mem_matches_reference(monkeypatch, corpus_fmd, few_reads, argv):  # noqa: F811
    """BED byte-equal to the JAX package's on the same argv (the last of
    -d / --old-mem wins); `-p` writes positions from the SSA."""
    files = [str(corpus_fmd), str(few_reads)]
    want_rc, want, _ = run_main(jcli.main, argv + files, monkeypatch)
    got_rc, got, err = run_main(tcli.run, [argv[0], "--device=cpu"] + argv[1:] + files)
    assert want_rc == got_rc == 0, err
    assert want.count(b"\n") >= N_READS and got == want
    assert "smem_tg launches" not in err  # the original algorithm, not the card's engine
    if "-p3" in argv and "--gap=5" not in argv:
        assert b"s0:" in got or b"s1:" in got
