"""`build` and `merge` past the card, on the CPU (F11): the host placement
of construct/merge.py, where B1 and the merged BWT stay in host memory and
the card holds B1's rows (dense, or rb), the batch, the records and ins.

The placement is forced in-process through module constants:
construct/merge.py CPU_BUDGET (the card's budget on the CPU), with
ops/rank.py FROM_BWT_BLOCKS cut to 64 rows a chunk, so the dense rows'
chunked build holds 4,096 symbols' temporaries, as a card's 16 M-symbol
chunks are small beside its memory; RB3TPU_DEVICE_OCC=rb takes rb rows.

- B1's rows from a host BWT, chunk by chunk: bit for bit the rows of
  `build_occf(DenseFMIndex.from_bwt(b1))` (dense32, dense64 in megablocks
  of four rows), and the rb rows of its runs those of `from_dense_np`;
- `placement` and `merge_host` (dense and rb rows, the native interleave)
  against the JAX package's merge_plain;
- `build -m 20000 -do` (four batches, three merges), `build -i` and
  `merge` in-process (`cli.run`, `--device=cpu`), each merge on the host:
  FMD and FMR files byte-equal to `python -m ropebwt3_tpu`'s (in process),
  the log naming the placement and the rows; a budget too small even for
  B1's rows and the batch: one ERROR line.
Every comparison is exact.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu.construct.merge import merge_plain as jax_merge_plain
from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch.construct import merge
from ropebwt3_tpu_torch.index.dense import runs_of_bwt
from ropebwt3_tpu_torch.ops import rank, runblock, smem

ENC = np.zeros(256, np.uint8)
ENC[np.frombuffer(b"ACGTN", np.uint8)] = [1, 2, 3, 4, 5]


def both_strands(recs) -> np.ndarray:
    """The records' nt6 sequences, each then its reverse complement, each 0-terminated."""
    parts = []
    for r in recs:
        s = ENC[np.frombuffer(r.seq, np.uint8)]
        parts += [s, [0], np.where((s >= 1) & (s <= 4), 5 - s, s)[::-1], [0]]
    return np.concatenate(parts).astype(np.uint8)


@pytest.fixture(scope="module")
def bwts(corpus):
    """B1: the BWT of the corpus's first five genomes; B2: of the other three."""
    recs = list(read_seqs(str(corpus / "genomes.fa")))
    return gsa_bwt(both_strands(recs[:5])), gsa_bwt(both_strands(recs[5:]))


@pytest.fixture
def host_placed(monkeypatch):
    """The budget that puts every merge of the corpus on the host: below the
    card path's bytes of the first merge, above the host path's of the last."""
    monkeypatch.setattr(rank, "FROM_BWT_BLOCKS", 64)
    monkeypatch.setattr(merge, "CPU_BUDGET", 2_000_000)
    monkeypatch.delenv("RB3TPU_DEVICE_OCC", raising=False)


@pytest.mark.parametrize("chunk", [1, 3, 64, rank.FROM_BWT_BLOCKS])
@pytest.mark.parametrize("int64", [False, True], ids=["dense32", "dense64"])
def test_dense_rows_from_a_host_bwt(bwts, monkeypatch, chunk, int64):
    """OccIndex.from_bwt of a numpy B1 uploads it chunk by chunk of whole
    64-symbol blocks and carries the counts between chunks: the rows, acc
    and megablock bases of build_occf over the same BWT, bit for bit; the
    same from a tensor, and at n = 0, 1, 64, 65."""
    monkeypatch.setattr(rank, "FROM_BWT_BLOCKS", chunk)
    for b1 in (bwts[0], bwts[0][:64], bwts[0][:65], bwts[0][:1], bwts[0][:0]):
        f = DenseFMIndex.from_bwt(b1)
        occf, mega = rank.build_occf(f, int64, 2)
        for src in (b1, torch.from_numpy(b1.copy())):
            x = rank.OccIndex.from_bwt(src, "cpu", int64=int64, mega_shift=2)
            assert np.array_equal(x.occf.numpy(), occf) and np.array_equal(x.acc.numpy(), f.acc)
            assert (x.mega is None) == (not int64) and (not int64 or np.array_equal(x.mega.numpy(), mega))


@pytest.mark.parametrize("S", [None, 256])
def test_rb_rows_from_a_host_bwt(bwts, S):
    """B1's runs (index/dense.py runs_of_bwt, which `build` and the rb
    builder share) give the rb rows of its DenseFMIndex, table for table."""
    b1 = bwts[0]
    f = DenseFMIndex.from_bwt(b1)
    syms, lens = runs_of_bwt(b1)
    assert np.array_equal(np.repeat(syms, lens), b1)
    got = runblock.build_runblock_np(syms, lens, n=len(b1), S=S)
    want = runblock.from_dense_np(f, S=S, cache=None)
    for key in ("rows", "esc", "acc"):
        assert np.array_equal(got[key], want[key]), key
    assert (got["S"], got["n"], got["mega"]) == (want["S"], want["n"], want["mega"])


def test_placement_follows_the_budget_and_the_rows(bwts, monkeypatch):
    """The card while merge_bytes fits the budget (none on the CPU by
    default) and B1's rows are dense; the host past the budget, or where
    resolve_occ gives rb rows (AUTO_RB_BYTES_CPU shrunk, or
    RB3TPU_DEVICE_OCC=rb); each with its bytes in the reason."""
    monkeypatch.delenv("RB3TPU_DEVICE_OCC", raising=False)
    b1, b2 = bwts
    n1, n2, m2 = len(b1), len(b2), int((b2 == 0).sum())
    need = merge.merge_bytes(n1, n2, m2)
    assert merge.placement(n1, n2, m2, "cpu")[0] == "card"
    monkeypatch.setattr(merge, "CPU_BUDGET", need)
    assert merge.placement(n1, n2, m2, "cpu") == ("card", f"the card path needs ~{need} B of the card's {need} B")
    monkeypatch.setattr(merge, "CPU_BUDGET", need - 1)
    assert merge.placement(n1, n2, m2, "cpu")[0] == "host"
    monkeypatch.setattr(merge, "CPU_BUDGET", None)
    monkeypatch.setattr(smem, "AUTO_RB_BYTES_CPU", 0.75 * n1 - 1)
    where, why = merge.placement(n1, n2, m2, "cpu")
    assert where == "host" and why.startswith("B1's rows are rb")
    monkeypatch.setattr(smem, "AUTO_RB_BYTES_CPU", 12e9)
    monkeypatch.setenv("RB3TPU_DEVICE_OCC", "rb")
    assert merge.placement(n1, n2, m2, "cpu")[0] == "host"


@pytest.mark.parametrize("layout", ["dense", "rb"])
def test_merge_host_matches_jax(bwts, monkeypatch, capsys, layout):
    """merge_host: B1's rows on the device (dense, chunk by chunk; rb from
    B1's runs), K6's plain passes, ins down, the native interleave: the
    JAX package's merged BWT, from a B2 tensor or array; its log names
    the rows, their bytes and the pieces; apply_host refuses ins out of
    order."""
    monkeypatch.setattr(rank, "FROM_BWT_BLOCKS", 64)
    b1, b2 = bwts
    want = jax_merge_plain(DenseFMIndex.from_bwt(b1), b2).bwt[: len(b1) + len(b2)]
    for seq2 in (b2, torch.from_numpy(b2.copy())):
        got = merge.merge_host(b1, seq2, "cpu", layout)
        assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    err = capsys.readouterr().err
    assert f"merge in host memory over B1's {layout}32 rows (" in err and "native apply" in err
    assert ("S 8192" in err) == (layout == "rb")
    with pytest.raises(ValueError, match="nondecreasing"):
        merge.apply_host(b1, b2[:2], np.array([5, 4]))


def _port(argv):
    """(exit code, stdout, stderr) of the port's `cli.run` in this process."""
    buf, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.run(argv)
    out.flush()
    return rc, buf.getvalue(), err.getvalue()


def _jax(argv):
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        assert jcli.main(argv) == 0
    out.flush()
    return buf.getvalue()


@pytest.fixture(scope="module")
def halves(corpus, tmp_path_factory):
    """The corpus's genomes in two FASTA halves, and each half's FMD from
    the JAX package's `build -do`."""
    d = tmp_path_factory.mktemp("merge_host")
    recs = list(read_seqs(str(corpus / "genomes.fa")))
    out = []
    for i, part in enumerate((recs[:5], recs[5:])):
        fa, fmd = d / f"h{i}.fa", d / f"h{i}.fmd"
        fa.write_text("".join(f">{r.name}\n{r.seq.decode()}\n" for r in part))
        _jax(["build", "-do", str(fmd), str(fa)])
        out.append((str(fa), str(fmd)))
    return d, out


def _assert_host_log(err: str, layout: str, merges: int) -> None:
    on_host = [ln for ln in err.splitlines() if "symbols into" in ln and " on the host: " in ln]
    rows = [ln for ln in err.splitlines() if f"merge in host memory over B1's {layout}32 rows" in ln]
    assert len(on_host) == merges and len(rows) == merges and "on the card:" not in err, err
    assert on_host[0].split(" on the host: ")[1].startswith("B1's rows are rb" if layout == "rb" else "the card path needs ~")
    assert all(" B of the card's " in ln for ln in on_host)


@pytest.mark.parametrize("layout", ["dense", "rb"])
def test_build_on_the_host_matches_reference(corpus, halves, tmp_path, host_placed, monkeypatch, layout):
    """`build -m 20000 -do` (three merges), `build -i` of the first half's
    FMD with the second half's genomes, and `merge` of the two halves'
    FMDs, every merge on the host over dense32 or rb32 rows: FMD and FMR
    byte-equal to the JAX package's, and the log naming each placement."""
    if layout == "rb":
        monkeypatch.setenv("RB3TPU_DEVICE_OCC", "rb")
    d, ((fa0, fmd0), (fa1, fmd1)) = halves
    fa = str(corpus / "genomes.fa")
    cases = [(["build", "-m", "20000", "-do"], [fa], 3), (["build", "-i", fmd0, "-do"], [fa1], 1)]
    for i, (cmd, inputs, merges) in enumerate(cases):
        want, got = tmp_path / f"want{i}.fmd", tmp_path / f"got{i}.fmd"
        _jax([*cmd, str(want), *inputs])
        rc, _, err = _port([cmd[0], "--device=cpu", *cmd[1:], str(got), *inputs])
        assert rc == 0 and got.read_bytes() == want.read_bytes(), err
        _assert_host_log(err, layout, merges)
    want = _jax(["merge", fmd0, fmd1])
    rc, got, err = _port(["merge", "--device=cpu", fmd0, fmd1])
    assert rc == 0 and want[:3] == b"RB\x02" and got == want
    _assert_host_log(err, layout, 1)


@pytest.mark.parametrize("layout", ["dense", "rb"])
def test_budget_below_the_rows_is_one_error(corpus, halves, tmp_path, host_placed, monkeypatch, layout):
    """A budget that holds neither placement (not even B1's rows beside the
    batch): `build` and `merge` stop with one ERROR line naming the bytes,
    before any rows go to the device, and write nothing."""
    if layout == "rb":
        monkeypatch.setenv("RB3TPU_DEVICE_OCC", "rb")
    monkeypatch.setattr(merge, "CPU_BUDGET", 200_000)

    def no_rows(*a, **kw):
        raise AssertionError("rows built past the budget")

    monkeypatch.setattr(rank.OccIndex, "from_bwt", no_rows)
    monkeypatch.setattr(runblock.RunBlockIndex, "from_np", no_rows)
    d, ((fa0, fmd0), (fa1, fmd1)) = halves
    out = tmp_path / "x.fmd"
    for argv in (["build", "--device=cpu", "-m", "20000", "-do", str(out), str(corpus / "genomes.fa")],
                 ["merge", "--device=cpu", "-o", str(out), fmd0, fmd1]):
        rc, got, err = _port(argv)
        lines = [ln for ln in err.splitlines() if not ln.startswith("[M::")]
        assert rc == 1 and not got and not out.exists() and len(lines) == 1, lines
        assert lines[0].startswith("ERROR: merging ") and "in host memory needs ~" in lines[0], lines
        assert f"B1's {layout} rows" in lines[0] and "which has 200000 B" in lines[0]
