"""`build --mesh` past one card (F12), `build -s/-r` past the suffix sort's
cap (F6) and the native `fa2line`, on the CPU, against the JAX package run
in this process (its native SA-IS: no JAX compile).

The host placement over a mesh (construct/merge.py merge_host_mesh) is
forced in-process, as tests/test_torch_merge_host.py forces the unsharded
one: construct/merge.py CPU_BUDGET below the card path's merge_mesh_bytes,
ops/rank.py FROM_BWT_BLOCKS cut to 64 rows a chunk.  There B1 and the
merged BWT stay in host memory and B1's dense rows are built slab by slab
(ops/rank.py HostBwtRows through parallel/mesh.py ShardedRows):

- slab by slab, the rows equal the same slices of OccIndex.from_bwt's
  whole table, acc and the megablock bases equal (dense32, dense64 in
  megablocks of four rows, 1-4 slabs, slabs that start inside a
  megablock, any range from its carry);
- `placement` over a mesh follows merge_mesh_bytes;
- `build -m 20000 -do --mesh=1x4 | 2x2 | 2x1` (three merges) and `build -m
  20000 -i --mesh=1x4` (two) byte-equal to the JAX package's `build`, every merge on the
  host, no whole table built (OccIndex.from_bwt refused); a budget below
  the host placement's need: one ERROR line naming the device, no file;
- two gloo processes: a host-placed `build --mesh=1x2`, each process's FMD
  byte-equal, each slab built by its owner and mapped by the other;
- `build -s` / `-r` with cli.card_bytes patched to a small cap, on the
  card path's placement, the host's and a mesh's: byte-equal to the JAX
  package's one batch; two files, an exceeded -m and -i stop with the JAX
  package's words;
- `fa2line`: the native program (native/fa2line.cpp, built into _build/)
  and the Python path byte-equal to the JAX package's, with and without
  -R, on two files and on FASTQ; a failed build raises.
Every comparison is exact.
"""

import contextlib
import io
import os

import pytest
import torch

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch import native
from ropebwt3_tpu_torch.construct import merge
from ropebwt3_tpu_torch.construct import sa as tsa
from ropebwt3_tpu_torch.ops import rank
from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, make_mesh

from .test_torch_merge_host import both_strands
from .test_torch_mesh_procs import NO_JAX, _two

CPU = torch.device("cpu")
GENOMES_M = ["-m", "20000"]  # the corpus's genomes in four batches: three merges


def _port(argv):
    """(exit code, stdout, stderr) of the port's `cli.run` in this process."""
    buf, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.run(argv)
    out.flush()
    return rc, buf.getvalue(), err.getvalue()


def _jax(argv):
    """(stdout, stderr) of the JAX package's `main` in this process."""
    buf, err = io.BytesIO(), io.StringIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert jcli.main(argv) == 0
    out.flush()
    return buf.getvalue(), err.getvalue()


def _errors(err: str) -> list[str]:
    return [ln for ln in err.splitlines() if not ln.startswith("[M::")]


@pytest.fixture(scope="module")
def b1(corpus):
    """The BWT of the corpus's genomes and reads, both strands (144,136 symbols)."""
    recs = list(read_seqs(str(corpus / "genomes.fa"))) + list(read_seqs(str(corpus / "reads.fa")))
    return gsa_bwt(both_strands(recs))


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(rank, "FROM_BWT_BLOCKS", 64)
    monkeypatch.delenv("RB3TPU_DEVICE_OCC", raising=False)


@pytest.mark.parametrize("n_idx", [1, 2, 3, 4])
@pytest.mark.parametrize("int64", [False, True], ids=["dense32", "dense64"])
def test_slab_rows_equal_the_whole_table(b1, monkeypatch, n_idx, int64):
    """ShardedRows of a HostBwtRows over a 1 x n_idx CPU mesh (mapping unit
    1 and 5 rows): each slab's rows, built from its own carry, are the
    slice of OccIndex.from_bwt's whole table at its first row, and acc and
    the megablock bases (four rows a megablock, so slabs start inside one)
    equal; HostBwtRows fills any range (from row 0, inside a chunk, the
    last row alone) bit for bit."""
    monkeypatch.setattr(rank, "FROM_BWT_BLOCKS", 5)
    want = rank.OccIndex.from_bwt(b1, CPU, int64=int64, mega_shift=2)
    rows = rank.HostBwtRows(b1, int64=int64, mega_shift=2)
    assert rows.shape == tuple(want.occf.shape) and rows.layout == want.layout
    assert torch.equal(rows.acc, want.acc) and (not int64 or torch.equal(rows.mega, want.mega))
    nb = rows.shape[0]
    for b0, b in ((0, nb), (3, 17), (nb - 1, nb), (1234, 1300)):
        out = torch.empty((b - b0, 12), dtype=torch.int32)
        rows.fill(out, b0)
        assert torch.equal(out, want.occf[b0:b])
    starts = set()
    for unit in (1, 5):
        sh = ShardedRows(rows, make_mesh(1, n_idx, [CPU] * n_idx), unit=unit)
        v = sh.views[0]
        assert torch.equal(v.acc, want.acc) and (not int64 or torch.equal(v.mega, want.mega))
        assert sum(s.rows.shape[0] for s in v.slabs) == nb
        for s in v.slabs:
            assert torch.equal(s.rows, want.occf[s.first : s.first + s.rows.shape[0]])
            starts.add(s.first % 4)
        assert torch.equal(v.occf, want.occf)
    assert n_idx == 1 or starts - {0}  # a slab that starts inside a megablock


def test_placement_over_a_mesh_follows_merge_mesh_bytes(b1, monkeypatch):
    """Over a mesh: the card while merge_mesh_bytes fits the budget on every
    device, the host one byte below it; the host placement's own count
    (merge_mesh_host_bytes) is far below the card path's, which holds B1
    and its whole rows."""
    n1, seq2 = len(b1) // 2, b1[len(b1) // 2 :]
    n2, m2 = len(seq2), int((seq2 == 0).sum())
    mesh = make_mesh(1, 4, [CPU] * 4)
    need = merge.merge_mesh_bytes(n1, n2, m2, mesh)["cpu"]
    assert merge.placement(n1, n2, m2, CPU, mesh)[0] == "card"
    monkeypatch.setattr(merge, "CPU_BUDGET", need)
    assert merge.placement(n1, n2, m2, CPU, mesh) == (
        "card", f"the card path over the 1x4 mesh needs ~{need} B of cpu's {need} B")
    monkeypatch.setattr(merge, "CPU_BUDGET", need - 1)
    assert merge.placement(n1, n2, m2, CPU, mesh)[0] == "host"
    assert merge.merge_mesh_host_bytes(n1, n2, m2, mesh)["cpu"] <= need - n1 - merge.dense_rows_bytes(n1)


@pytest.fixture(scope="module")
def want_fmd(corpus, tmp_path_factory):
    """The JAX package's `build -do` of the genomes, and of the halves: the
    first half's FMD and `build -i` of it with the second half."""
    d = tmp_path_factory.mktemp("mesh_host_merge")
    recs = list(read_seqs(str(corpus / "genomes.fa")))
    halves = []
    for i, part in enumerate((recs[:5], recs[5:])):
        fa = d / f"h{i}.fa"
        fa.write_text("".join(f">{r.name}\n{r.seq.decode()}\n" for r in part))
        halves.append(str(fa))
    _jax(["build", "-do", str(d / "all.fmd"), str(corpus / "genomes.fa")])
    _jax(["build", "-do", str(d / "h0.fmd"), halves[0]])
    _jax(["build", "-i", str(d / "h0.fmd"), "-do", str(d / "i.fmd"), halves[1]])
    return d, halves


def _no_whole_table(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a whole row table built on a host-placed mesh merge")

    monkeypatch.setattr(rank.OccIndex, "from_bwt", refuse)


@pytest.mark.parametrize("spec", ["1x4", "2x2", "2x1", "i-1x4"])
def test_build_mesh_on_the_host_matches_reference(corpus, want_fmd, tmp_path, small_chunks, monkeypatch, spec):
    """`build -m 20000 -do --mesh=SPEC` (three merges) and `build -m 20000 -i`
    of the first half's FMD with the second half over 1x4 (two merges
    into the loaded index), every merge host-placed
    over the mesh: FMD byte-equal to the JAX package's; each merge logs the
    placement and one built slab a distinct slab of the mesh's idx axis;
    OccIndex.from_bwt never runs."""
    monkeypatch.setattr(merge, "CPU_BUDGET", 2_000_000)
    _no_whole_table(monkeypatch)
    d, (_, h1) = want_fmd
    got = tmp_path / "got.fmd"
    mesh = spec.removeprefix("i-")
    if spec.startswith("i-"):
        argv, want, merges = ["build", "--device=cpu", *GENOMES_M, f"--mesh={mesh}", "-i", str(d / "h0.fmd"), "-do",
                              str(got), h1], d / "i.fmd", 2
    else:
        argv, want, merges = ["build", "--device=cpu", *GENOMES_M, f"--mesh={mesh}", "-do", str(got),
                              str(corpus / "genomes.fa")], d / "all.fmd", 3
    rc, _, err = _port(argv)
    assert rc == 0 and got.read_bytes() == want.read_bytes(), err[-3000:]
    lines = err.splitlines()
    placed = [ln for ln in lines if " on the host: the card path over the " in ln]
    built = [ln for ln in lines if f"merge in host memory over B1's dense32 rows sharded over a {mesh} mesh" in ln]
    assert len(placed) == len(built) == merges, err[-3000:]
    idx = int(mesh.split("x")[1])
    assert all(ln.split("slabs built here: ")[1].split(";")[0].count(" on cpu ") == idx for ln in built)
    assert all(p in built[0] for p in ("counts on the host", "rows by slab", "lf2 and K6", "ins download",
                                       "native apply"))


def test_budget_below_the_host_mesh_placement_is_one_error(corpus, tmp_path, small_chunks, monkeypatch):
    """A budget below even the host placement's need over the mesh (its
    slabs beside the batch): one ERROR line naming the device and the
    bytes, no rows built and no file written."""
    monkeypatch.setattr(merge, "CPU_BUDGET", 200_000)

    def no_rows(*a, **kw):
        raise AssertionError("rows built past the budget")

    monkeypatch.setattr(merge, "HostBwtRows", no_rows)
    _no_whole_table(monkeypatch)
    out = tmp_path / "x.fmd"
    rc, got, err = _port(["build", "--device=cpu", *GENOMES_M, "--mesh=1x4", "-do", str(out),
                          str(corpus / "genomes.fa")])
    lines = _errors(err)
    assert rc == 1 and not got and not out.exists() and len(lines) == 1, lines
    assert lines[0].startswith("ERROR: merging ") and "in host memory over the 1x4 mesh needs ~" in lines[0]
    assert "B of cpu (its slabs of B1's dense rows" in lines[0] and lines[0].endswith("which has 200000 B"), lines


HOST_CLI = NO_JAX + """from ropebwt3_tpu_torch.construct import merge
from ropebwt3_tpu_torch.ops import rank
merge.CPU_BUDGET, rank.FROM_BWT_BLOCKS = 2_000_000, 64
from ropebwt3_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


def test_host_mesh_build_across_two_processes(corpus, want_fmd, tmp_path):
    """`build -m 20000 --mesh=1x2 -do` over two gloo processes, every merge
    host-placed: each process builds its own slab of B1's rows from its own
    B1 in host memory and maps the other's; each writes an FMD byte-equal
    to the JAX package's `build -do`."""
    d, _ = want_fmd
    outs = _two([HOST_CLI, "build", "--device=cpu", *GENOMES_M, "--mesh=1x2", "-do", str(tmp_path / "p$RANK.fmd"),
                 str(corpus / "genomes.fa")])
    assert [o[0] for o in outs] == [0, 0], [o[2][-2000:] for o in outs]
    for r, (_, _, err) in enumerate(outs):
        assert (tmp_path / f"p{r}.fmd").read_bytes() == (d / "all.fmd").read_bytes()
        built = [ln for ln in err.splitlines() if "merge in host memory over B1's dense32 rows sharded over a 1x2" in ln]
        assert len(built) == 3 and all(ln.split("slabs built here: ")[1].count(" on cpu ") == 1 for ln in built)
        assert err.count(f"] imported slab {1 - r} of dp row 0 (rows") == 3, err[-2000:]


CAP = 9_000  # symbols a batch of K7's, from a budget of CAP x 2 x (SA_BYTES_PER_SYMBOL + 1)


@pytest.mark.parametrize("fa,where,order", [("reads.fa", w, o) for w in ("card", "host", "mesh") for o in ("-s", "-r")]
                         + [("genomes.fa", "host", "-s"), ("genomes.fa", "mesh", "-r")])
def test_sorted_build_past_the_cap_matches_one_batch(corpus, tmp_path, small_chunks, monkeypatch, fa, where, order):
    """`build -s` / `-r` with the card's budget patched to a cap of 9,000
    symbols a batch: the sorted stream is cut at unit boundaries (16
    batches of the genomes, 3 of the reads), each merged in order on the
    card path (construct/merge.py budget patched: the merges see no
    limit), on the host placement, or host-placed over a 1x2 mesh; the FMD
    is byte-equal to the JAX package's single batch."""
    want = tmp_path / "want.fmd"
    _jax(["build", order, "-do", str(want), str(corpus / fa)])
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: CAP * 2 * (tsa.SA_BYTES_PER_SYMBOL + 1))
    if where == "card":  # the budget sizes the batches, the merges see none
        monkeypatch.setattr(merge, "budget", lambda dev: None)
    got = tmp_path / "got.fmd"
    extra = ["--mesh=1x2"] if where == "mesh" else []
    rc, _, err = _port(["build", "--device=cpu", order, *extra, "-do", str(got), str(corpus / fa)])
    assert rc == 0 and got.read_bytes() == want.read_bytes(), err[-3000:]
    n_cut = {"genomes.fa": 16, "reads.fa": 3}[fa]
    assert f"into {n_cut} batches of whole sequences, at most {CAP} symbols each" in err
    merges = [ln for ln in err.splitlines() if "] merging " in ln]
    assert len(merges) == n_cut - 1 and all(f" on the {'card' if where == 'card' else 'host'}: " in ln
                                              for ln in merges), merges


@pytest.mark.parametrize("case", ["two files", "-m", "-i"])
def test_sorted_build_stops_where_the_jax_package_does(corpus, tmp_path, small_chunks, monkeypatch, case):
    """Two input files, an input past -m (two batches read) and -s with -i
    stop with the JAX package's own ERROR line, the cap patched or not."""
    genomes, reads = str(corpus / "genomes.fa"), str(corpus / "reads.fa")
    argv = {"two files": ["-s", reads, genomes], "-m": ["-s", "-m", "20000", genomes],
            "-i": ["-r", "-i", str(tmp_path / "idx.fmd"), reads]}[case]
    _jax(["build", "-do", str(tmp_path / "idx.fmd"), reads])
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: CAP * 2 * (tsa.SA_BYTES_PER_SYMBOL + 1))
    outs = []
    for main, dev in ((jcli.main, []), (tcli.run, ["--device=cpu"])):
        out = tmp_path / "out.fmd"
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            main(["build", *dev, "-do", str(out), *argv])
        outs.append(_errors(err.getvalue()))
        assert not out.exists()
    want = {"-i": "ERROR: -s/-r cannot be combined with -i yet"}.get(
        case, "ERROR: -s/-r only supported within a single batch; raise -m")
    assert outs[0] == outs[1] == [want], outs


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    """A FASTQ of three reads (lower case, N, an empty one) and CRLF lines."""
    fq = tmp_path_factory.mktemp("fa2line") / "q.fq"
    fq.write_bytes(b"@a\r\nACGTNacgtRY\r\n+\r\nIIIIIIIIIII\r\n@b\nTTTTGGGGCCAA\n+\nIIIIIIIIIIII\n@c\n\n+\n\n")
    return str(fq)


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("argv", [["genomes.fa"], ["-R", "reads.fa"], ["reads.fa", "genomes.fa"],
                                  ["FASTQ", "-R", "genomes.fa"], ["FASTQ"], ["nope.fa", "reads.fa"]])
def test_fa2line_matches_reference(corpus, fastq, monkeypatch, path, argv):
    """`fa2line [-R] files` through the native program (the Python reader
    refused) and through the Python path: stdout byte-equal to the JAX
    package's, and a missing file one ERROR line."""
    argv = [fastq if a == "FASTQ" else str(corpus / a) if a.endswith(".fa") else a for a in argv]
    want, want_err = _jax(["fa2line", *argv])
    if path == "native":
        def refuse(*a, **kw):
            raise AssertionError("the Python reader ran")

        monkeypatch.setattr(tcli, "iter_flat_batches", refuse)
        monkeypatch.setattr(tcli, "read_seqs", refuse)
    else:
        monkeypatch.setattr(tcli, "_fa2line_shape", lambda a: False)
    rc, got, err = _port(["fa2line", *argv])
    assert rc == 0 and got == want
    assert _errors(err) == _errors(want_err) == (["ERROR: failed to open file '" + argv[0] + "'"]
                                                 if "nope" in argv[0] else [])


def test_fa2line_builds_into_build_dir_or_raises(corpus, tmp_path, monkeypatch):
    """The program lands in the port's gitignored _build/, keyed on its
    source; a source that does not compile raises with g++'s words, and
    `fa2line` does not fall back to Python."""
    path = native.fa2line_binary()
    assert os.path.dirname(path) == native.BUILD_DIR and os.access(path, os.X_OK)
    assert os.path.basename(path).startswith("fa2line_")
    bad = tmp_path / "fa2line.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "FA2LINE_SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tcli.main_fa2line([str(corpus / "reads.fa")])
    assert not [f for f in os.listdir(native.BUILD_DIR) if ".tmp." in f]
    assert tcli._fa2line_shape(["-R", "a.fa", "-"]) and not tcli._fa2line_shape(["-R"])
    assert not tcli._fa2line_shape([]) and not tcli._fa2line_shape(["-x", "a.fa"])
    assert open(path, "rb").read(4) == b"\x7fELF"
