"""The port's SMEM-TG engine (ropebwt3_tpu_torch/ops/smem.py) against the JAX
lock-step FSM, the Pallas kernel in interpret mode, the native host engine
and the sequential reference, on every occ layout (dense and run-block rows,
int32 and int64 widths).  Integer outputs: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ropebwt3_tpu.nt6 import char2nt6
from ropebwt3_tpu.ops import rank as jrank
from ropebwt3_tpu.ops import smem_ref
from ropebwt3_tpu.ops.smem import smem_tg_batch
from ropebwt3_tpu.ops.smem_native import smem_tg_batch_native
from ropebwt3_tpu.ops.smem_pallas import smem_tg_pallas
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch.ops import rank as trank
from ropebwt3_tpu_torch.ops import runblock as trb
from ropebwt3_tpu_torch.ops.smem import BatchedSmemTG, resolve_occ, smem_tg_cuda, smem_tg_plain

from .test_torch_cuda import assert_same_mems, corpus_index, flat_of  # noqa: F401  (fixture reuse)
from .test_torch_rank import MEGA_SHIFT, jax_index, jax_index64, occ_index  # noqa: F401  (fixture reuse)


@pytest.fixture(scope="module")
def reads(corpus):
    return [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))]


@pytest.mark.parametrize("engine,M", [("xla", 16), ("xla", 2), ("pallas", 16)])
def test_plain_matches_jax(jax_index, occ_index, reads, engine, M):
    """The padded (128, 256) batch of tests/test_jax_engine.py:406-431;
    M = 2 makes reads overflow, where the last slot holds the latest emit."""
    Q, L = 128, 256
    qs = [reads[t % len(reads)] for t in range(Q)]
    qarr = np.zeros((Q, L), np.uint8)
    qlen = np.zeros(Q, np.int32)
    for t, r in enumerate(qs):
        qarr[t, : len(r)] = r
        qlen[t] = len(r)
    args = dict(min_occ=1, min_len=21, max_mems=M, max_iters=4 * L + 64)
    if engine == "xla":
        mj, nj, _ = smem_tg_batch(jax_index, jnp.asarray(qarr), jnp.asarray(qlen), **args)
    else:
        mj, nj, _ = smem_tg_pallas(jax_index, jnp.asarray(qarr), jnp.asarray(qlen), interpret=True, **args)
    mt, nt = smem_tg_plain(occ_index, *flat_of(qs), min_occ=1, min_len=21, max_mems=M)
    assert mt.dtype == torch.int32 and mt.shape == (Q, M, 5) and nt.dtype == torch.int32
    assert_same_mems(mt.numpy(), nt.numpy(), np.asarray(mj), np.asarray(nj), M)
    if M == 2:
        assert (nt.numpy() > M).any()
    # the kernel wrapper takes the plain version for a CPU tensor
    mw, nw = smem_tg_cuda(occ_index, *flat_of(qs), min_occ=1, min_len=21, max_mems=M)
    assert_same_mems(mw.numpy(), nw.numpy(), mt.numpy(), nt.numpy(), M)


@pytest.mark.parametrize("min_occ,min_len", [(1, 17), (2, 21), (1, 1)])
def test_batched_matches_native_and_ref(corpus_index, reads, min_occ, min_len):
    mixed = [r[: 40 + 13 * (i % 9)] for i, r in enumerate(reads)] + [reads[0][:0], reads[1][:5]]
    eng = BatchedSmemTG(corpus_index, min_occ, min_len, device="cpu")
    got = eng.run(mixed)
    assert got == smem_tg_batch_native(corpus_index, mixed, min_occ, min_len)
    for q, g in zip(mixed, got):
        assert g == smem_ref.smem_tg(corpus_index, q, min_occ, min_len)
    assert eng.n_rerun == 0


def test_batched_reruns_overflow(corpus_index):
    """Long reads overflow a 4-row MEM buffer and are rerun on the host."""
    g, _ = corpus_index.retrieve(0)
    rng = np.random.default_rng(9)
    long_reads = []
    for _ in range(3):
        ln = int(rng.integers(3000, 6000))
        st = int(rng.integers(0, len(g) - ln))
        r = g[st : st + ln].copy()
        mut = rng.random(ln) < 0.05
        r[mut] = rng.integers(1, 5, int(mut.sum()))
        long_reads.append(r)
    eng = BatchedSmemTG(corpus_index, 1, 25, max_mems=4, device="cpu")
    got = eng.run(long_reads)
    assert eng.n_rerun > 0
    assert got == smem_tg_batch_native(corpus_index, long_reads, 1, 25)


def test_smem_rejects_bad_input(occ_index):
    flat, seq_off = flat_of([np.array([1, 2, 6], np.uint8)])
    with pytest.raises(ValueError):  # 6 is not an nt6 code
        smem_tg_plain(occ_index, flat, seq_off, min_occ=1, min_len=2, max_mems=4)
    with pytest.raises(ValueError):  # offsets past the buffer
        smem_tg_plain(occ_index, flat, seq_off + 1, min_occ=1, min_len=2, max_mems=4)


def _port_index(layout, f):
    if layout == "dense64":
        return trank.OccIndex.from_dense(f, "cpu", int64=True, mega_shift=MEGA_SHIFT)
    if layout == "rb32":
        return trb.RunBlockIndex.from_dense(f, "cpu", cache=None)
    return trb.RunBlockIndex.from_dense(f, "cpu", S=256, int64=True, mega_shift=4, cache=None)


@pytest.mark.parametrize("layout,M", [("dense64", 16), ("rb32", 16), ("rb64", 16), ("rb64", 2)])
def test_plain_layouts_match_jax(monkeypatch, corpus_index, jax_index, jax_index64, reads, layout, M):
    """smem_tg_plain on rb rows and int64 rows against the JAX lock-step FSM
    (its int64 DeviceIndex with megablocks shrunk for the int64 layouts)."""
    monkeypatch.setattr(jrank, "MEGA_BLOCK_SHIFT", MEGA_SHIFT)
    idx = _port_index(layout, corpus_index)
    assert idx.layout == layout
    Q, L = 64, 256
    qs = [reads[t % len(reads)][: 60 + 3 * t] for t in range(Q)]
    qarr = np.zeros((Q, L), np.uint8)
    qlen = np.zeros(Q, np.int32)
    for t, r in enumerate(qs):
        qarr[t, : len(r)] = r
        qlen[t] = len(r)
    jidx = jax_index64 if idx.int64 else jax_index
    mj, nj, _ = smem_tg_batch(jidx, jnp.asarray(qarr), jnp.asarray(qlen), min_occ=1, min_len=19, max_mems=M, max_iters=4 * L + 64)
    mt, nt = smem_tg_plain(idx, *flat_of(qs), min_occ=1, min_len=19, max_mems=M)
    assert mt.dtype == idx.dtype == (torch.int64 if idx.int64 else torch.int32)
    assert_same_mems(mt.numpy(), nt.numpy(), np.asarray(mj), np.asarray(nj), M)
    mw, nw = smem_tg_cuda(idx, *flat_of(qs), min_occ=1, min_len=19, max_mems=M)
    assert_same_mems(mw.numpy(), nw.numpy(), mt.numpy(), nt.numpy(), M)


@pytest.mark.parametrize("occ", ["rb", "dense"])
def test_batched_occ_matches_native(corpus_index, reads, occ):
    eng = BatchedSmemTG(corpus_index, 1, 21, device="cpu", occ=occ)
    assert eng.idx.layout == {"rb": "rb32", "dense": "dense32"}[occ]
    assert eng.run(reads) == smem_tg_batch_native(corpus_index, reads, 1, 21)


def test_resolve_occ(monkeypatch):
    monkeypatch.delenv("RB3TPU_DEVICE_OCC", raising=False)
    assert resolve_occ("auto", 1 << 30, "cpu") == "dense"
    assert resolve_occ("auto", 17 * 10**9, "cpu") == "rb"  # 12.75 GB of dense rows
    assert resolve_occ("dense", 17 * 10**9, "cpu") == "dense"
    assert resolve_occ("rb", 100, "cpu") == "rb"
    monkeypatch.setenv("RB3TPU_DEVICE_OCC", "rb")
    assert resolve_occ("auto", 100, "cpu") == "rb"
    with pytest.raises(ValueError):
        resolve_occ("bogus", 100, "cpu")
