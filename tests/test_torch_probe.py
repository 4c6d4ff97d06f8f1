"""The port's probe twins (ropebwt3_tpu_torch/probe.py) against the TPU probes
of scripts/fused_probe*.py: the XLA chains `gather_chain` and
`gather_chain_full`, and the Pallas bodies P1-P7 run in Pallas's TPU
interpret mode on the CPU.  Importing the scripts would run their TPU probes
at module level, so each function is taken from its file with `ast` and
compiled alone, with `sync` and `timeit` supplied to capture its output.
Integer outputs: exact."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ropebwt3_tpu_torch import probe

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def script_function(script: str, name: str, captured: list):
    """Function `name` of scripts/`script`, compiled alone: `sync` records
    each output, `timeit` calls its argument once.  It runs with jax's x64
    off, as the scripts run (ropebwt3_tpu turns x64 on when another test
    module has imported it, and then jnp.sum of int32 rows gives int64)."""
    tree = ast.parse(open(os.path.join(SCRIPTS, script)).read())
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)

    def sync(x):
        captured.append(np.asarray(x))
        return captured[-1]

    ns = dict(np=np, jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, sync=sync, timeit=lambda fn, n=5: (fn(), 1.0)[1], NSEM=8)
    exec(compile(ast.Module(body=[node], type_ignores=[]), os.path.join(SCRIPTS, script), "exec"), ns)

    def run(*args):
        with jax.enable_x64(False):
            return ns[name](*args)

    return run


def twin(tab: np.ndarray, idx0: np.ndarray, iters: int, mode: str) -> np.ndarray:
    return probe.gather_plain(torch.from_numpy(tab), torch.from_numpy(idx0), iters, mode).numpy()


@pytest.mark.parametrize("hi", [1 << 30, 1 << 31], ids=["script_values", "full_int32"])
@pytest.mark.parametrize("nb,q,iters", [(1, 5, 3), (7, 16, 0), (1000, 64, 1), (50_000, 4096, 40)])
@pytest.mark.parametrize("mode,script,name", [("chain", "fused_probe.py", "gather_chain"),
                                              ("chain_full", "fused_probe2.py", "gather_chain_full")])
def test_plain_matches_xla_chain(mode, script, name, nb, q, iters, hi):
    """gather_plain's final index equals the XLA chain's: int32 wrap of
    idx * 1103515245 + row[6] (or the row's sum) + 12345, floor mod nb."""
    fn = script_function(script, name, [])
    rng = np.random.default_rng(nb + q + iters)
    tab = rng.integers(-hi if hi == 1 << 31 else 0, hi, (nb, 12)).astype(np.int32)
    idx0 = rng.integers(0, nb, q).astype(np.int32)
    want = np.asarray(fn(jnp.asarray(tab), jnp.asarray(idx0), iters))
    got = twin(tab, idx0, iters, mode)
    assert np.array_equal(got[0], want)
    if iters == 0:
        assert np.array_equal(got[1], idx0) and not got[2].any()


# (script, function, args, fold, columns, high value of the table)
PALLAS_GATHERS = {
    "P2": ("fused_probe.py", "pallas_vmem_gather", (40, 16, 5), "dep", 128, 1 << 30),
    "P3": ("fused_probe.py", "pallas_hbm_dma_gather", (40, 16, 5), "dep", 16, 1 << 30),
    "P5": ("fused_probe2.py", "pallas_vmem_gather", (40, 16, 5), "indep", 128, 1 << 30),
    "P6": ("fused_probe2.py", "pallas_hbm_dma_gather", (40, 16, 5), "indep", 128, 1 << 30),
    "P7-48B": ("fused_probe3.py", "dma_gather", (40, 16, 5, False), "indep", 16, 1 << 20),
    "P7-512B": ("fused_probe3.py", "dma_gather", (40, 16, 5, True), "indep", 128, 1 << 20),
}


def run_interpreted(fn, *args):
    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("this JAX has no pltpu.force_tpu_interpret_mode")
    try:
        with pltpu.force_tpu_interpret_mode():
            return fn(*args)
    except Exception as e:  # a body the interpreter cannot run is not a twin's fault
        pytest.skip(f"the Pallas body does not run in TPU interpret mode: {type(e).__name__}: {str(e)[:200]}")


@pytest.mark.parametrize("probe_id", sorted(PALLAS_GATHERS))
def test_plain_matches_pallas_gather(probe_id):
    """The Pallas gathers return the last rows gathered by lanes 0..7; the
    twin's `last` indices, looked up in the same table, give the same rows.
    The script draws its table and start indices from np.random: seeding it
    and drawing again reproduces them."""
    script, name, args, mode, cols, hi = PALLAS_GATHERS[probe_id]
    captured = []
    fn = script_function(script, name, captured)
    np.random.seed(11)
    run_interpreted(fn, *args)
    assert captured, "the probe produced no output"
    nb, q, iters = args[:3]
    np.random.seed(11)
    tab = np.random.randint(0, hi, (nb, cols), np.int32)
    idx0 = np.random.randint(0, nb, q).astype(np.int32)
    last = twin(tab, idx0, iters, mode)[1]
    for out in captured:
        assert np.array_equal(out, tab[last[:8]])


@pytest.mark.parametrize("probe_id", ["P1", "P4"])
def test_plain_matches_pallas_capacity(probe_id):
    """P4 stores row 0 = 1 and the last row = 2 and returns their sum, as
    smem_capacity_plain does; P1 stores row 0 and returns its first word."""
    script = "fused_probe.py" if probe_id == "P1" else "fused_probe2.py"
    captured = []
    assert run_interpreted(script_function(script, "vmem_probe", captured), 1) is True
    if probe_id == "P4":
        assert np.array_equal(captured[0], probe.smem_capacity_plain(1 << 20).numpy()[None, :])
    else:
        assert captured[0][0, 0] == 1


@pytest.mark.parametrize("mode", probe.MODES)
def test_plain_by_hand(mode):
    """Two steps of one lane, worked out in Python integers."""
    tab = np.arange(5 * 12, dtype=np.int32).reshape(5, 12) * 1000003
    got = twin(tab, np.array([3], np.int32), 2, mode)[:, 0]
    idx, csum, last = 3, 0, 3
    for _ in range(2):
        row = [int(v) for v in tab[idx]]
        last, csum = idx, csum + row[6]
        if mode == "indep":
            idx = (idx + 1) % 5
        else:
            s = sum(row) if mode == "chain_full" else row[6]
            v = (idx * probe.MUL + s + (0 if mode == "dep" else 12345)) % (1 << 32)
            idx = (v - (1 << 32) if v >= 1 << 31 else v) % 5
    assert got.tolist() == [idx, last, csum]


def test_wrappers_on_cpu_take_the_plain_version():
    g = torch.Generator().manual_seed(1)
    tab = torch.randint(0, 1 << 30, (300, 12), dtype=torch.int32, generator=g)
    idx0 = torch.randint(0, 300, (50,), dtype=torch.int32, generator=g)
    for fn in (probe.smem_gather_cuda, probe.hbm_gather_cuda):
        for mode in probe.MODES:
            assert torch.equal(fn(tab, idx0, 9, mode), probe.gather_plain(tab, idx0, 9, mode))
    assert sum(probe.smem_gather_cuda.launches.values()) == sum(probe.hbm_gather_cuda.launches.values()) == 0
    out, err = probe.smem_capacity_cuda(4096, "cpu")
    assert err is None and torch.equal(out, torch.full((128,), 3, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["cols", "dtype", "start", "mode", "iters"])
def test_wrapper_checks_bounds(bad):
    tab = torch.zeros((10, 16 if bad == "cols" else 12), dtype=torch.int64 if bad == "dtype" else torch.int32)
    idx0 = torch.tensor([0, 10 if bad == "start" else 9], dtype=torch.int32)
    with pytest.raises(ValueError):
        probe.hbm_gather_cuda(tab, idx0, -1 if bad == "iters" else 3, "bogus" if bad == "mode" else "dep")
