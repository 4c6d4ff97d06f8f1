"""`--engine=hybrid` and `--engine=jax` of the port's `sw`, `hapdiv` and
`search` against the JAX package's default run, on the CPU tests' corpus:

- `HybridEngine` on stand-in engines: the first int(n * share) items to
  the device engine on its worker thread, the rest to the native one, the
  device's results first; the share read from its variable and re-set
  after each batch from the two rates, clipped to [floor, 0.5];
- (e) `sw`, `hapdiv`, `search -d` and `search` with `--engine=hybrid`
  (RB3TPU_SW_SPLIT / RB3TPU_HAPDIV_SPLIT at 0.5: at the defaults a handful
  of reads sends none to the device half) and `--engine=jax` through the
  port's CLI with --device=cpu (the device half is the plain PyTorch
  engine): stdout byte-equal to `python -m ropebwt3_tpu` without
  `--engine`, and the hybrid's log line shows the device half ran;
- with a debug flag the hybrid's native half is the Python DP: its traces
  are the JAX package's for those reads alone;
- without CUDA, `--engine=hybrid|jax` on the default --device=cuda stops
  with one ERROR line.

Both CLIs run in this process (the JAX package's engines are its native
ones there); the device half's plain DP is slow on the CPU, so the reads
are few and short."""

import re
import threading

import pytest
import torch

from ropebwt3_tpu import cli as jcli
from ropebwt3_tpu_torch import cli as tcli
from ropebwt3_tpu_torch.align import cli_hooks

from .test_torch_cli import corpus_fmd  # noqa: F401  (fixture reuse)
from .test_torch_cuda import sw_reads
from .test_torch_dbg import traces
from .test_torch_oldmem import first_reads, run_main
from .test_torch_sw import genomes  # noqa: F401  (fixture reuse)

HYBRID = re.compile(r"hybrid: (\d+) of (\d+) (reads|windows) on the card, the card's share at the end ([\d.]+)")


class Stand:
    """A stand-in engine: tags each item with its name, and notes the thread
    it ran on and the items of each call; `delay` is its seconds an item on
    the test's clock (`fake_timed`)."""

    def __init__(self, name: str, delay: float):
        self.name, self.delay, self.threads, self.calls = name, delay, set(), []

    def run(self, items):
        self.threads.add(threading.get_ident())
        self.calls.append(list(items))
        return [(self.name, x) for x in items]


def fake_timed(fn, items):
    """HybridEngine._timed on the stand-ins' clock: delay seconds an item."""
    return fn.__self__.delay * len(items), fn(items)


def test_hybrid_engine_splits_and_adapts(monkeypatch):
    monkeypatch.setenv("RB3TPU_SW_SPLIT", "0.25")
    monkeypatch.setattr(cli_hooks.HybridEngine, "_timed", staticmethod(fake_timed))
    dev, nat = Stand("dev", 0.001), Stand("nat", 0.004)
    eng = cli_hooks.HybridEngine(dev, nat.run, cli_hooks.SW_SPLIT)
    assert eng.share == 0.25 and eng.name == "dev"  # the device engine's attributes show through
    got = eng.run(list(range(8)))
    assert got == [("dev", 0), ("dev", 1)] + [("nat", x) for x in range(2, 8)]
    assert dev.threads and threading.get_ident() not in dev.threads and nat.threads == {threading.get_ident()}
    # the device ran at 4x the native rate: a share of 0.8, clipped to 0.5
    assert eng.rates == {"dev": 1000, "nat": 250} and eng.share == cli_hooks.SPLIT_MAX
    assert eng.run(list(range(10))) == [("dev", x) for x in range(5)] + [("nat", x) for x in range(5, 10)]
    assert (eng.n_items, eng.n_dev) == (18, 7)
    dev.delay, nat.delay = 0.2, 0.0001  # a slow device: the share falls to the floor
    assert eng.run([0, 1]) == [("dev", 0), ("nat", 1)]
    assert eng.share == cli_hooks.SW_SPLIT[2]
    assert eng.run([0, 1]) == [("nat", 0), ("nat", 1)] and dev.calls[-1] == [0]  # int(2 * 0.002) = 0: none sent
    assert eng.share == cli_hooks.SW_SPLIT[2]
    eng.close()


def test_hybrid_engine_defaults(monkeypatch):
    monkeypatch.delenv("RB3TPU_SW_SPLIT", raising=False)
    monkeypatch.delenv("RB3TPU_HAPDIV_SPLIT", raising=False)
    for split, share, floor in ((cli_hooks.SW_SPLIT, 0.01, 0.002), (cli_hooks.HAPDIV_SPLIT, 0.05, 0.02)):
        eng = cli_hooks.HybridEngine(Stand("dev", 0), Stand("nat", 0).run, split)
        assert (eng.share, eng.floor) == (share, floor)
        eng.close()


@pytest.fixture(scope="module")
def short_reads(genomes, tmp_path_factory):  # noqa: F811
    """Two of sw_reads' 90-bp reads: one a half at a share of 0.5."""
    fa = tmp_path_factory.mktemp("hybrid") / "q.fa"
    reads = [r for i, r in enumerate(sw_reads(genomes, 5, seed=3)) if i in (1, 4)]
    fa.write_text("".join(f">h{i}\n{''.join('$ACGTN'[c] for c in r)}\n" for i, r in enumerate(reads)))
    return fa


@pytest.fixture(scope="module")
def hap_reads(corpus, tmp_path_factory):
    """Two corpus reads: two windows each at -a51 -w50."""
    return first_reads(corpus, tmp_path_factory, 2, "hybrid_hap")


@pytest.mark.parametrize("argv,reads", [
    (["sw", "--engine=hybrid"], "short"),
    (["sw", "--engine=jax"], "short"),
    (["search", "-d", "--engine=hybrid", "-p3"], "short"),
    (["hapdiv", "--engine=hybrid", "-a51"], "hap"),
    (["hapdiv", "--engine=jax", "-a51"], "hap"),
    (["search", "--engine=jax", "-l21"], "hap"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_engine_matches_reference(monkeypatch, corpus_fmd, short_reads, hap_reads, argv, reads):  # noqa: F811
    """stdout byte-equal to the JAX package's run without --engine; the
    hybrid's device half took its share."""
    monkeypatch.setenv("RB3TPU_SW_SPLIT", "0.5")
    monkeypatch.setenv("RB3TPU_HAPDIV_SPLIT", "0.5")
    files = [str(corpus_fmd), str(short_reads if reads == "short" else hap_reads)]
    plain = [a for a in argv if not a.startswith("--engine=")]
    want_rc, want, _ = run_main(jcli.main, plain + files, monkeypatch)
    got_rc, got, err = run_main(tcli.run, [argv[0], "--device=cpu"] + argv[1:] + files)
    assert want_rc == got_rc == 0, err
    assert want.count(b"\n") >= 2 and got == want
    m = HYBRID.search(err)
    if "--engine=hybrid" in argv:
        assert m is not None and 1 <= int(m.group(1)) < int(m.group(2)), err
        assert (argv[0] == "hapdiv") == (m.group(3) == "windows")
    else:
        assert m is None and re.search(r"0 (sw|hapdiv|smem_tg) launches", err), err


def test_hybrid_native_half_traces(monkeypatch, corpus_fmd, short_reads, tmp_path):  # noqa: F811
    """`sw --engine=hybrid --dbg-sw --dbg-bt` at a share of 0.5: the first
    read on the device half (no trace), the second on the Python DP, whose
    SW and BT lines are the JAX package's for that read alone."""
    monkeypatch.setenv("RB3TPU_SW_SPLIT", "0.5")
    second = tmp_path / "second.fa"
    second.write_text("".join(short_reads.read_text().splitlines(keepends=True)[2:]))
    _, want, _ = run_main(jcli.main, ["sw", str(corpus_fmd), str(short_reads)], monkeypatch)
    _, _, want_err = run_main(jcli.main, ["sw", "--dbg-sw", "--dbg-bt", str(corpus_fmd), str(second)], monkeypatch)
    rc, got, err = run_main(tcli.run, ["sw", "--device=cpu", "--engine=hybrid", "--dbg-sw", "--dbg-bt",
                                       str(corpus_fmd), str(short_reads)])
    assert rc == 0 and got == want
    assert traces(want_err) and traces(err) == traces(want_err)
    assert HYBRID.search(err).group(1) == "1"


@pytest.mark.parametrize("argv", [["sw", "--engine=hybrid"], ["hapdiv", "--engine=jax"],
                                  ["search", "-d", "--engine=jax"]], ids=" ".join)
def test_engine_without_cuda_is_one_error(corpus_fmd, short_reads, argv):  # noqa: F811
    """No fallback hides the card: on the default --device=cuda without
    CUDA, one ERROR line and exit 1, nothing written."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    rc, out, err = run_main(tcli.run, argv + [str(corpus_fmd), str(short_reads)])
    assert rc == 1 and not out
    assert err.count("\n") == 1 and err.startswith("ERROR: ") and "CUDA" in err
