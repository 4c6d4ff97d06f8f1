"""The port's hapdiv DP (ropebwt3_tpu_torch/align/hapdiv.py) against the JAX
package's on the CPU: `hapdiv_plain` against `hapdiv_device` (JAX,
JAX_PLATFORMS=cpu) on the same windows, exact: `bad` on every window, the
counts on the windows not flagged; dense64 rows against dense32;
`HapdivDeviceEngine` (flagged windows rerun on the port's native DP)
against the JAX package's native `rb3_hapdiv_multi`; and the khashl table
geometry and bucket hash against JAX's.

The windows are cut from the corpus genomes (tests/conftest.py) with
substitutions and indels at the case's rate, made from a seed, plus one
crafted window: four T's inserted at the middle of a genome stretch, where
an E candidate's first attainment of a key's H past its first candidate
(the H_from_pos corner) makes both DPs flag it."""

import numpy as np
import pytest
import torch

from ropebwt3_tpu.align import hapdiv_jax as jh
from ropebwt3_tpu.align.bwasw import SwOpt as JSwOpt
from ropebwt3_tpu.align.bwasw import rb3_hapdiv_multi as j_hapdiv_multi
from ropebwt3_tpu.ops.rank import DeviceIndex
from ropebwt3_tpu_torch.align import hapdiv as th
from ropebwt3_tpu_torch.align.bwasw import RB3_SWF_E2E, RB3_SWF_HAPDIV, SwOpt
from ropebwt3_tpu_torch.ops.rank import OccIndex

from .test_torch_cuda import HAPDIV_W as W
from .test_torch_cuda import corpus_index  # noqa: F401  (fixture reuse)
from .test_torch_cuda import make_windows

# (K, n_best, error rate, start in genome 0 of the crafted window): the
# third case's n_best of 16 gives a 64-bucket table
CASES = [(51, 25, 0.02, 3883), (101, 25, 0.06, 2719), (51, 16, 0.04, 3883)]


@pytest.fixture(scope="module")
def corpus_genomes(corpus):
    from ropebwt3_tpu.nt6 import char2nt6
    from ropebwt3_tpu.seqio import read_seqs

    return [char2nt6(rec.seq) for rec in read_seqs(str(corpus / "genomes.fa"))]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"K{c[0]}-N{c[1]}-err{c[2]}")
def case(request, corpus_index, corpus_genomes):  # noqa: F811
    K, N, err, crafted = request.param
    wins = make_windows(corpus_genomes, K, err, crafted, seed=K * 100 + N)
    want = [np.asarray(a) for a in jh.hapdiv_device(DeviceIndex.from_dense(corpus_index), wins, K, n_best=N)]
    idx = OccIndex.from_dense(corpus_index, "cpu")
    got = [a.numpy() for a in th.hapdiv_plain(idx, torch.from_numpy(wins), K, n_best=N)]
    return dict(K=K, N=N, wins=wins, want=want, got=got)


def test_plain_matches_hapdiv_device(case):
    want, got = case["want"], case["got"]
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32 and got[2].dtype == np.int64 and got[3].dtype == bool
    np.testing.assert_array_equal(got[3], want[3])
    ok = ~want[3]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a[ok], b[ok])
    assert int((want[0][ok] > 0).sum()) >= W // 4  # windows that align


def test_crafted_window_is_flagged(case):
    """The crafted window (the last) is `bad` in JAX, and so in the port."""
    assert case["want"][3][-1] and case["got"][3][-1]


def test_dense64_rows_give_dense32_answers(case, corpus_index):  # noqa: F811
    idx = OccIndex.from_dense(corpus_index, "cpu", int64=True, mega_shift=6)
    assert idx.layout == "dense64" and idx.mega.shape[0] > 1
    got = th.hapdiv_plain(idx, torch.from_numpy(case["wins"]), case["K"], n_best=case["N"])
    for a, b in zip(got, case["got"]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_engine_matches_native(corpus_index, corpus_genomes):  # noqa: F811
    """HapdivDeviceEngine on the CPU (the plain version, then the native DP
    for the flagged windows) equals the JAX package's native DP on every
    window; a window with no alignment is the all-zero HapDiv."""
    K, N, err, crafted = CASES[0]
    wins = list(make_windows(corpus_genomes, K, err, crafted, seed=7))
    opt = SwOpt(flag=RB3_SWF_E2E | RB3_SWF_HAPDIV, end_len=1)
    eng = th.HapdivDeviceEngine(corpus_index, opt, device="cpu")
    got = eng.run(wins)
    want = j_hapdiv_multi(JSwOpt(flag=opt.flag, end_len=1), corpus_index, wins)
    assert eng.supported and eng.n_bad >= 1
    for g, r in zip(got, want):
        assert (g.n_al, g.max_ed, g.n_hap) == ((r.n_al, r.max_ed, r.n_hap) if r is not None else (0, 0, [0] * 7))


@pytest.mark.parametrize("n_best", [2, 16, 25, 32, 48])
def test_table_geometry_and_hash_match_jax(n_best):
    assert th.nb_params(n_best) == jh.nb_params(n_best)
    nb_bits = th.nb_params(n_best)[0]
    rng = np.random.default_rng(n_best)
    lo = rng.integers(0, 1 << 32, 4096, dtype=np.int64)
    hi = rng.integers(0, 1 << 32, 4096, dtype=np.int64)
    keys = np.concatenate([(lo << 32) | hi, [0, (1 << 32) - 1, (((1 << 31) - 1) << 32) | 5]]).astype(np.int64)
    want = np.asarray(jh._home_bucket(jh.jnp.asarray(keys), nb_bits))
    got = th._home_bucket(torch.from_numpy(keys), nb_bits).numpy()
    np.testing.assert_array_equal(got, want)
