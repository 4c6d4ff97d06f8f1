"""`get`, `suffix`, `kount`, `fa2line` and `fa2kmer` of the port against
`python -m ropebwt3_tpu` on the corpus, stdout byte for byte (the device
commands with `--device=cpu`: the plain PyTorch walks), their edge cases,
and the plain walks of ops/walk.py against the JAX package's
DenseFMIndex.retrieve and main_suffix on the same seeded inputs."""

import numpy as np
import pytest
import torch

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch.ops import runblock, walk
from ropebwt3_tpu_torch.nt6 import char2nt6
from ropebwt3_tpu_torch.ops.rank import OccIndex

from .test_torch_cli import _in_process, _run, corpus_fmd  # noqa: F401  (fixture reuse)
from .test_torch_walk import one_thread  # noqa: F401  (autouse here too: the plain walks are lock-step)


@pytest.fixture(scope="module")
def port_index(corpus_fmd):  # noqa: F811
    return tcli.load_index(str(corpus_fmd))


@pytest.fixture(scope="module")
def jax_index(corpus_fmd):  # noqa: F811
    return jcli.load_index(str(corpus_fmd))


def _same(argv, device=True):
    """(port's exit code, port's stdout, JAX package's stdout) of argv, both
    in this process; the port's device commands on the CPU."""
    want = _in_process(jcli.main, argv)[1]
    rc, got = _in_process(tcli.main, argv[:1] + (["--device=cpu"] if device else []) + argv[1:])
    return rc, got, want


def _dollar(f) -> int:
    """A position whose BWT symbol is the sentinel: get walks no step."""
    return int(np.flatnonzero(f.bwt[: f.n] == 0)[0])


@pytest.mark.parametrize("case", ["walks", "edges", "none"])
def test_get_matches_reference(corpus_fmd, port_index, case):  # noqa: F811
    """Walks from random positions and 0; k = n - 1, a sentinel row (an
    empty sequence), garbage (atol: 0) and a duplicate; k = -1 and n (no
    output)."""
    f = port_index
    ks = {"walks": [0, 1, 7, 1000, 40_000],
          "edges": [f.n - 1, _dollar(f), "abc", "12x", 3, 3, -1, f.n],
          "none": [-1, f.n, f.n + 5]}[case]
    rc, got, want = _same(["get", str(corpus_fmd), *map(str, ks)])
    assert rc == 0 and got == want
    assert got.count(b">") == sum(1 for k in ks if 0 <= tcli.atoi(str(k)) < f.n)


def _suffix_fa(corpus, tmp_path):
    """reads.fa's first reads, then the edge cases: an empty read, one
    ending in N (no first hit), one with an N inside, one of a genome's own
    60 bases (a whole match) and one unnamed record."""
    recs = (corpus / "reads.fa").read_text().split(">")[1:20]
    g = (corpus / "genomes.fa").read_text().split("\n")[1]
    extra = [">empty\n\n", ">first_n\nACGTACGTTGN\n", ">mid_n\n" + g[100:140] + "N" + g[141:200] + "\n",
             ">whole\n" + g[500:560] + "\n", ">\n" + g[1000:1100] + "\n"]
    p = tmp_path / "suffix.fa"
    p.write_text("".join(">" + r for r in recs) + "".join(extra))
    return p


@pytest.mark.parametrize("case", ["reads", "edges", "line", "missing"])
def test_suffix_matches_reference(corpus, corpus_fmd, tmp_path, case):  # noqa: F811
    """reads.fa; the edge cases in two files (unnamed records count across
    them); -L; a missing file before reads.fa (an ERROR line, then on)."""
    fa = _suffix_fa(corpus, tmp_path)
    if case == "reads":
        argv = ["suffix", str(corpus_fmd), str(corpus / "reads.fa")]
    elif case == "edges":
        argv = ["suffix", str(corpus_fmd), str(fa), str(fa)]
    elif case == "line":
        lines = tmp_path / "reads.txt"
        lines.write_text("".join(r.split("\n", 1)[1].replace("\n", "") + "\n" for r in fa.read_text().split(">")[1:]))
        argv = ["suffix", "-L", str(corpus_fmd), str(lines)]
    else:
        argv = ["suffix", str(corpus_fmd), str(tmp_path / "nope.fa"), str(corpus / "reads.fa")]
    rc, got, want = _same(argv)
    assert rc == 0 and got == want and got


@pytest.fixture(scope="module")
def second_fmd(corpus, tmp_path_factory):
    """An index of the corpus's first genome alone (other counts)."""
    d = tmp_path_factory.mktemp("kount")
    fa = d / "g0.fa"
    fa.write_text("\n".join((corpus / "genomes.fa").read_text().split("\n")[:2]) + "\n")
    r = _run("ropebwt3_tpu", ["build", "-do", str(d / "g0.fmd"), str(fa)])
    assert r.returncode == 0, r.stderr.decode()
    return d / "g0.fmd"


@pytest.mark.parametrize("opts,two", [(["-k", "6", "-m", "20"], False), (["-k5", "-m3"], True), (["-k", "1"], False),
                                      (["-k", "0"], False), (["-k", "4", "-m", "1000000"], False), ([], False),
                                      (["-k", "3", "-m", "4294967299"], False), (["-k", "3", "-m", "-5"], False)])
def test_kount_matches_reference(corpus_fmd, second_fmd, opts, two):  # noqa: F811
    """One index and two (a branch lives when either reaches -m), -k 1,
    -k 0, -m above every count, and the defaults (-k 51 -m 100: nothing in
    the corpus reaches 100); -m 2^32 + 3 (no count reaches it; compared
    with int32 counts as it is, it would wrap to 3) and -m below 0 (every
    branch lives)."""
    idxs = [str(corpus_fmd)] + ([str(second_fmd)] if two else [])
    rc, got, want = _same(["kount", *opts, *idxs])
    assert rc == 0 and got == want
    if opts[:2] == ["-k", "6"] or two:
        assert got.count(b"\n") > 100


@pytest.mark.parametrize("argv", [["fa2line", "genomes.fa"], ["fa2line", "-R", "reads.fa"], ["fa2line", "-R", "nope.fa"],
                                  ["fa2kmer", "-k31", "-w20", "reads.fa"], ["fa2kmer", "genomes.fa"],
                                  ["fa2kmer", "-w", "0", "reads.fa"], ["fa2kmer", "-k", "1000", "reads.fa"]])
def test_host_converters_match_reference(corpus, monkeypatch, argv):
    """fa2line (both strands, -R) and fa2kmer (-w 0: one ERROR line, no
    output, exit 1 under RB3TPU_STRICT_EXIT=1; k past the read: one record
    a read) on the host."""
    monkeypatch.setenv("RB3TPU_STRICT_EXIT", "1")
    argv = [str(corpus / a) if a.endswith(".fa") else a for a in argv]
    rc, got, want = _same(argv, device=False)
    assert got == want
    assert (rc, bool(got)) == ((1, False) if "0" in argv else (0, "nope" not in argv[-1]))


@pytest.mark.parametrize("cmd", [["get", "IDX", "5"], ["suffix", "IDX", "READS"], ["kount", "-k3", "IDX"]])
def test_device_utils_without_cuda_exit_nonzero(corpus, corpus_fmd, cmd):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    argv = [{"IDX": str(corpus_fmd), "READS": str(corpus / "reads.fa")}.get(a, a) for a in cmd]
    r = _run("ropebwt3_tpu_torch", argv, strict=True)
    assert r.returncode != 0 and not r.stdout
    lines = r.stderr.decode().splitlines()
    assert len(lines) == 1 and lines[0].startswith("ERROR: ") and "CUDA" in lines[0]


def test_retrieve_plain_matches_jax(port_index, jax_index):
    """retrieve_plain (the heads-only case of retrieve_seg_plain: one
    lock-step lane a k over ops/rank.py `lf`) against the JAX package's
    DenseFMIndex.retrieve (its native walk) at seeded positions, 0, n - 1
    and a sentinel row, in one walk; retrieve_cuda on a CPU index (the
    plain version at the derived stride) gives the same."""
    f = port_index
    rng = np.random.default_rng(5)
    ks = [0, f.n - 1, _dollar(f), *rng.integers(0, f.n, 12).tolist()]
    want = [jax_index.retrieve(k) for k in ks]
    idx = OccIndex.from_dense(f, "cpu")
    seqs, ends = walk.retrieve_plain(idx, ks)
    for (ws, wk), s, e in zip(want, seqs, ends):
        assert np.array_equal(s, ws) and int(e) == wk
    assert max(len(s) for s in seqs) > 300 and len(seqs[2]) == 0
    seqs2, ends2 = walk.retrieve_cuda(idx, ks)  # a CPU index: the plain version
    assert all(np.array_equal(a, b) for a, b in zip(seqs, seqs2)) and np.array_equal(ends, ends2)


def _suffix_reads(corpus, rng):
    """Seeded reads: pieces of the genomes with substitutions and N's, and
    the edge cases (empty, all N, one base, a whole match)."""
    g = "".join((corpus / "genomes.fa").read_text().split("\n")[1::2])
    out = []
    for _ in range(60):
        st, ln = int(rng.integers(0, len(g) - 300)), int(rng.integers(1, 300))
        r = np.frombuffer(g[st : st + ln].encode(), np.uint8).copy()
        mut = rng.random(ln) < 0.02
        r[mut] = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, int(mut.sum()))]
        out.append(r.tobytes().decode())
    return out + ["", "NNNN", "A", g[2000:2200]]


def test_suffix_plain_matches_jax(corpus, corpus_fmd, port_index, tmp_path):  # noqa: F811
    """suffix_plain on dense32, dense64 (megablocks of 2^10 rows) and rb
    rows (S 256, escapes and run-coded blocks) against the JAX package's
    main_suffix on the same seeded reads, exact."""
    reads = _suffix_reads(corpus, np.random.default_rng(9))
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    want = [ln.split(b"\t") for ln in _in_process(jcli.main, ["suffix", str(corpus_fmd), str(fa)])[1].splitlines()]
    f = port_index
    seqs = [char2nt6(r.encode()) for r in reads]
    off = torch.tensor(np.concatenate([[0], np.cumsum([len(s) for s in seqs])]), dtype=torch.int64)
    flat = torch.from_numpy(np.concatenate(seqs).astype(np.uint8))
    layouts = [OccIndex.from_dense(f, "cpu"), OccIndex.from_dense(f, "cpu", int64=True, mega_shift=10),
               runblock.RunBlockIndex.from_dense(f, "cpu", S=256)]
    for idx in layouts:
        start, last = walk.suffix_cuda(idx, flat, off)  # CPU tensors: suffix_plain
        assert [(int(a), int(b)) for a, b in zip(start, last)] == [(int(w[1]), int(w[3])) for w in want], idx.layout
    assert {int(w[1]) for w in want} >= {0} and int(want[-3][1]) == 4 and int(want[-4][1]) == 0
