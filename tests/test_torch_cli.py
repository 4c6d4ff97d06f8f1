"""`python -m ropebwt3_tpu_torch` against `python -m ropebwt3_tpu` on the
corpus: `build` (every output format and input option, several merges,
`-S` then `-i`), `merge` and `plain2fmd` output byte for byte, `mem` stdout
byte for byte against `--engine=native`, the `ssa` file byte for byte; and
`--engine=jax|hybrid` stopping at a missing card with jax unimportable."""

import contextlib
import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch.construct import sa as tsa

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


def _in_process(main, argv):
    """(exit code, stdout bytes) of a CLI's main called in this process."""
    buf = io.BytesIO()
    out = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    out.flush()
    return rc, buf.getvalue()


BUILD_OPTS = [[], ["-d"], ["-b"], ["-e"], ["-T"], ["-L"], ["-F"], ["-R"], ["-s"], ["-r"], ["-m", "20000", "-d"]]


@pytest.fixture(scope="module")
def build_refs(corpus):
    """`python -m ropebwt3_tpu build` stdout for each of BUILD_OPTS (in process)."""
    fa = str(corpus / "genomes.fa")
    return {" ".join(o): _in_process(jcli.main, ["build", *o, fa])[1] for o in BUILD_OPTS}


@pytest.mark.parametrize("opts", BUILD_OPTS, ids=lambda o: "".join(o) or "plain")
def test_build_matches_reference(corpus, build_refs, opts):
    """The plain text, FMD, FMR, BRE and -T outputs, one strand or line
    input, RLO / RCLO order, and -m 20000 (four batches, three merges)."""
    rc, got = _in_process(tcli.main, ["build", "--device=cpu", *opts, str(corpus / "genomes.fa")])
    want = build_refs[" ".join(opts)]
    assert rc == 0 and want and got == want


def test_build_checkpoint_then_input(corpus, tmp_path):
    """-S saves the index after each file as FMR; -i builds on it: both
    files and the final FMD byte-equal to the JAX package's."""
    recs = list(read_seqs(str(corpus / "genomes.fa")))
    halves = []
    for i, part in enumerate((recs[:3], recs[3:])):
        halves.append(str(tmp_path / f"h{i}.fa"))
        with open(halves[-1], "w") as fh:
            fh.writelines(f">{r.name}\n{r.seq.decode()}\n" for r in part)
    out = {}
    for tag, main, extra in (("ref", jcli.main, []), ("port", tcli.main, ["--device=cpu"])):
        ck, fmd = str(tmp_path / f"{tag}.fmr"), str(tmp_path / f"{tag}.fmd")
        assert _in_process(main, ["build", *extra, "-S", ck, "-m", "30000", halves[0]])[0] == 0
        assert _in_process(main, ["build", *extra, "-i", ck, "-do", fmd, halves[1]])[0] == 0
        out[tag] = (open(ck, "rb").read(), open(fmd, "rb").read())
    assert out["ref"][0] and out["port"] == out["ref"]


def test_merge_and_plain2fmd_match_reference(corpus, tmp_path):
    recs = list(read_seqs(str(corpus / "genomes.fa")))
    fmds = []
    for i, part in enumerate((recs[:5], recs[5:])):
        fa, fmd = tmp_path / f"p{i}.fa", str(tmp_path / f"p{i}.fmd")
        fa.write_text("".join(f">{r.name}\n{r.seq.decode()}\n" for r in part))
        _in_process(jcli.main, ["build", "-do", fmd, str(fa)])
        fmds.append(fmd)
    want = _in_process(jcli.main, ["merge", *fmds])[1]
    rc, got = _in_process(tcli.main, ["merge", "--device=cpu", *fmds])
    assert rc == 0 and want[:3] == b"RB\x02" and got == want
    plain = tmp_path / "plain.txt"
    plain.write_bytes(build_text := _in_process(jcli.main, ["build", str(corpus / "genomes.fa")])[1])
    assert build_text
    for files in ([str(plain)], [str(plain), str(plain)]):
        want = _in_process(jcli.main, ["plain2fmd", *files])[1]
        rc, got = _in_process(tcli.main, ["plain2fmd", *files])
        assert rc == 0 and want[:4] == b"RLD\x03" and got == want


@pytest.mark.parametrize("budget,what", [(10_000, "a batch of"), (3_000_000, "merging")])
def test_build_beyond_the_card_stops_with_one_error(monkeypatch, capsys, corpus, tmp_path, budget, what):
    """A batch, or a merge, that the card's memory (here a budget given to
    the CPU run) cannot hold stops `build` with one ERROR line, exit 1 under
    RB3TPU_STRICT_EXIT=1, and no output.  A merge past the card runs with
    B1 in host memory, so the merge that stops is one whose B1 rows and
    batch do not fit the card either: the corpus given twice, whose later
    merges build their 128,016-symbol B1's rows beside a batch."""
    monkeypatch.setenv("RB3TPU_STRICT_EXIT", "1")
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: budget)
    out = tmp_path / "x.fmd"
    rc = tcli.main(["build", "--device=cpu", "-do", str(out), str(corpus / "genomes.fa"), str(corpus / "genomes.fa")])
    err = [ln for ln in capsys.readouterr().err.splitlines() if not ln.startswith("[M::")]
    assert rc == 1 and not out.exists()
    assert len(err) == 1 and err[0].startswith(f"ERROR: {what}"), err


@pytest.mark.parametrize("order", ["-s", "-r"])
def test_build_sorted_beyond_the_card_names_the_cap(monkeypatch, capsys, corpus, tmp_path, order):
    """-s/-r sort the input as one batch: when the card's batch cap (a
    budget given to the CPU run) is below it, the sorted batch is cut at
    sequence boundaries into batches the cap holds, the log line naming the
    cap, and merged in order (here on the host placement, with
    OccIndex.from_bwt's chunks cut to 64 rows): the FMD of the JAX
    package's one batch."""
    from ropebwt3_tpu_torch.ops import rank as trank

    cap = 40_000
    want = tmp_path / "want.fmd"
    assert _in_process(jcli.main, ["build", order, "-do", str(want), str(corpus / "genomes.fa")])[0] == 0
    capsys.readouterr()
    monkeypatch.setenv("RB3TPU_STRICT_EXIT", "1")
    monkeypatch.setattr(trank, "FROM_BWT_BLOCKS", 64)
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: cap * 2 * (tsa.SA_BYTES_PER_SYMBOL + 1))
    out = tmp_path / "x.fmd"
    rc = tcli.main(["build", "--device=cpu", order, "-do", str(out), str(corpus / "genomes.fa")])
    err = capsys.readouterr().err
    assert rc == 0 and out.read_bytes() == want.read_bytes(), err[-2000:]
    assert f"cut the sorted batch of 128016 symbols into 4 batches of whole sequences, at most {cap} symbols" in err


@pytest.mark.parametrize("budget", [10**9, 48 * 16_002])
def test_build_sizes_wide_batches_apart(monkeypatch, capsys, corpus, tmp_path, budget):
    """With the packed path's limit lowered to 5,000 symbols, the card's
    batch cap stays below it, and a batch past it (one genome, both strands:
    16,002 symbols) is sized at WIDE_BYTES_PER_SYMBOL: a budget that holds
    it builds the same FMD as an uncapped build; one that holds it only at
    SA_BYTES_PER_SYMBOL stops with one ERROR line."""
    fa = str(corpus / "genomes.fa")
    want = tmp_path / "want.fmd"
    assert tcli.main(["build", "--device=cpu", "-do", str(want), fa]) == 0
    capsys.readouterr()
    monkeypatch.setenv("RB3TPU_STRICT_EXIT", "1")
    monkeypatch.setattr(tsa, "PACKED_MAX", 5_000)
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: budget)
    out = tmp_path / "x.fmd"
    rc = tcli.main(["build", "--device=cpu", "-do", str(out), fa])
    err = capsys.readouterr().err
    assert "batch size 4999 symbols" in err and tsa.bytes_per_symbol(16_002) == tsa.WIDE_BYTES_PER_SYMBOL
    if budget > (tsa.WIDE_BYTES_PER_SYMBOL + 1) * 16_002 * 8:
        assert rc == 0 and out.read_bytes() == want.read_bytes()
    else:
        assert (tsa.SA_BYTES_PER_SYMBOL + 1) * 16_002 < budget
        lines = [ln for ln in err.splitlines() if not ln.startswith("[M::")]
        assert rc == 1 and not out.exists() and len(lines) == 1 and lines[0].startswith("ERROR: a batch of"), lines


def test_merge_into_refuses_past_merge_bytes(monkeypatch, corpus):
    """`_merge_into` checks merge_bytes, which counts OccIndex.from_bwt's
    temporaries, against the card's budget: the exact count merges on the
    card; one byte short moves the merge to the host (B1 and the merged
    BWT in host memory, the same BWT); a budget one byte short of the host
    path's (merge_host_bytes: B1's rows and the batch) stops it with a
    CapacityError before any work."""
    from ropebwt3_tpu_torch.construct import merge as tmerge
    from ropebwt3_tpu_torch.ops.rank import OccIndex, from_bwt_temp_bytes

    genomes = [np.frombuffer(r.seq, np.uint8) for r in read_seqs(str(corpus / "genomes.fa"))]
    enc = np.zeros(256, np.uint8)
    enc[np.frombuffer(b"ACGT", np.uint8)] = [1, 2, 3, 4]
    bwt = tsa.gsa_bwt(np.concatenate([x for g in genomes[:5] for x in (enc[g], [0])]).astype(np.uint8), "cpu")[0]
    seq2 = tsa.gsa_bwt(np.concatenate([x for g in genomes[5:] for x in (enc[g], [0])]).astype(np.uint8), "cpu")[0]
    n1, n2, m2 = bwt.numel(), seq2.numel(), int((seq2 == 0).sum())
    need = tmerge.merge_bytes(n1, n2, m2)
    assert need >= n1 + 48 * (n1 // 64 + 1) + n2 + from_bwt_temp_bytes(n1) and m2 == 3
    want = tmerge.merge_plain(OccIndex.from_bwt(bwt), bwt, seq2)
    host = tmerge.merge_host_bytes(n2, m2, tmerge.dense_rows_bytes(n1), from_bwt_temp_bytes(n1))
    assert host < need
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: host - 1)
    with pytest.raises(tcli.CapacityError, match=f"needs ~{host} B"):
        tcli._merge_into(bwt, seq2, torch.device("cpu"))
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: need - 1)
    got = tcli._merge_into(bwt, seq2, torch.device("cpu"))
    assert isinstance(got, np.ndarray) and np.array_equal(got, want.numpy())
    monkeypatch.setattr(tcli, "card_bytes", lambda dev: need)
    got = tcli._merge_into(bwt, seq2, torch.device("cpu"))
    assert torch.equal(got, want)


def test_build_and_merge_without_cuda_exit_nonzero(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = tmp_path / "x.fmd"
    for argv in (["build", "-do", str(out), str(corpus / "genomes.fa")], ["merge", "-o", str(out), "a.fmd", "b.fmd"]):
        r = _run("ropebwt3_tpu_torch", argv, strict=True)
        assert r.returncode != 0 and not r.stdout and b"CUDA" in r.stderr and not out.exists()


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
    r = _run("ropebwt3_tpu_torch", ["mem", "--device=cpu", "--occ=bogus", str(corpus_fmd), str(corpus / "reads.fa")],
             strict=True)
    assert r.returncode != 0 and not r.stdout
    assert b"invalid --occ value" in r.stderr


def test_mem_without_cuda_exits_nonzero(corpus, corpus_fmd):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    r = _run("ropebwt3_tpu_torch", ["mem", "-l21", str(corpus_fmd), str(corpus / "reads.fa")], strict=True)
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
    r = _run("ropebwt3_tpu_torch", ["ssa", "-o", str(tmp_path / "x.ssa"), str(corpus_fmd)], strict=True)
    assert r.returncode != 0 and b"CUDA" in r.stderr and not (tmp_path / "x.ssa").exists()


def test_hapdiv_without_cuda_exits_nonzero(corpus, corpus_fmd):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    r = _run("ropebwt3_tpu_torch", ["hapdiv", str(corpus_fmd), str(corpus / "reads.fa")], strict=True)
    assert r.returncode != 0 and not r.stdout
    lines = r.stderr.decode().splitlines()
    assert len(lines) == 1 and lines[0].startswith("ERROR: ") and "CUDA" in lines[0]


@pytest.mark.parametrize("argv,why", [
    (["sw", "--engine=jax"], b"sw --engine=jax"),
    (["hapdiv", "--engine", "hybrid"], b"hapdiv --engine=hybrid"),
    (["sw", "--engine=hybrid"], b"sw --engine=hybrid"),
    (["search", "--eng=hybrid", "-l21"], b"search --engine=hybrid"),
])
def test_refuses_jax_device_options(corpus_fmd, argv, why):
    """`--engine=jax|hybrid` (`why`) runs the port's own card engine, so on
    the default --device=cuda without CUDA it stops with the one ERROR line
    of every card command, no traceback, and nothing runs on the CPU unasked
    (tests/test_torch_hybrid.py runs them with --device=cpu)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    r = _run_without_jax(argv + [str(corpus_fmd), str(corpus_fmd)], strict=True)
    assert r.returncode != 0 and not r.stdout
    lines = r.stderr.decode().splitlines()
    assert len(lines) == 1 and lines[0].startswith("ERROR: ") and "CUDA" in lines[0], (why, lines)
    assert "ROADMAP" not in lines[0] and "Traceback" not in r.stderr.decode()


def test_search_never_goes_to_a_server(corpus, corpus_fmd):
    """`search --engine=server`: one ERROR line (the JAX package runs it
    here; `--engine=server` routes mem, sw and hapdiv only)."""
    r = _run_without_jax(["search", "--device=cpu", "--engine=server", "-l21", str(corpus_fmd), str(corpus / "reads.fa")],
                         strict=True)
    lines = r.stderr.decode().splitlines()
    assert r.returncode == 1 and not r.stdout and len(lines) == 1
    assert lines[0] == "ERROR: search never goes to a server: `--engine=server` takes mem, sw and hapdiv"


@pytest.mark.parametrize("argv", [["serve"], ["serve", "--engine=jax", "x.fmd"], ["serve", "--device=tpu", "x.fmd"]])
def test_serve_usage_and_bad_options(argv):
    """`serve` without an index prints its usage; `--engine=jax` (the JAX
    package's engine) and an unknown device are one ERROR line; none starts
    a server or imports jax."""
    r = _run_without_jax(argv, strict=True)
    lines = r.stderr.decode().splitlines()
    assert r.returncode == 1 and not r.stdout and len(lines) == 1 and "Traceback" not in r.stderr.decode()
    assert lines[0].startswith("Usage: python -m ropebwt3_tpu_torch serve" if len(argv) == 1 else "ERROR: ")


def test_host_commands_pass_without_jax(corpus_fmd):
    """`stat`, a host command, runs on the port's own loader, jax unimportable."""
    want = _run("ropebwt3_tpu", ["stat", str(corpus_fmd)])
    got = _run_without_jax(["stat", str(corpus_fmd)])
    assert got.returncode == 0, got.stderr.decode()
    assert want.stdout and got.stdout == want.stdout


def test_mem_record_reader_matches_native(corpus, corpus_fmd, tmp_path):
    """FASTA and FASTQ records in one file: the vectorized reader declines
    it, and `mem` reads it record by record, with the same BED."""
    recs = list(read_seqs(str(corpus / "reads.fa")))[:20]
    mixed = tmp_path / "mixed.fq"
    with open(mixed, "w") as fh:
        for i, rec in enumerate(recs):
            seq = rec.seq.decode()
            fh.write(f"@{rec.name}\n{seq}\n+\n{'I' * len(seq)}\n" if i % 2 else f">{rec.name}\n{seq[:70]}\n{seq[70:]}\n")
    files = [str(corpus_fmd), str(mixed)]
    want = _run("ropebwt3_tpu", ["mem", "--engine=native", "-l21"] + files)
    got = _run("ropebwt3_tpu_torch", ["mem", "--device=cpu", "-K", "2000", "-l21"] + files)
    assert got.returncode == 0, got.stderr.decode()
    assert want.stdout and got.stdout == want.stdout
