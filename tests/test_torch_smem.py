"""The port's SMEM-TG engine (ropebwt3_tpu_torch/ops/smem.py) against the JAX
lock-step FSM, the Pallas kernel in interpret mode, the native host engine
and the sequential reference, on every occ layout (dense and run-block rows,
int32 and int64 widths); and the chunked path (lanes, START logs, the
stitch, the reruns) against the serial answer.  Integer outputs: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ropebwt3_tpu.nt6 import char2nt6
from ropebwt3_tpu.ops import rank as jrank
from ropebwt3_tpu.ops import smem_ref
from ropebwt3_tpu.ops.smem import smem_tg_batch
from ropebwt3_tpu.ops.smem_native import smem_tg_flat_native
from ropebwt3_tpu.ops.smem_pallas import smem_tg_pallas
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch.ops import rank as trank
from ropebwt3_tpu_torch.ops import runblock as trb
from ropebwt3_tpu_torch.ops.smem import (CHUNK, BatchedSmemTG, chunk_lanes, pack_reads, resolve_occ, smem_tg, smem_tg_cuda,
                                         smem_tg_plain, smem_tgc_cuda)

from .test_torch_cuda import assert_same_mems, corpus_index, flat_of  # noqa: F401  (fixture reuse)
from .test_torch_rank import MEGA_SHIFT, jax_index, jax_index64, occ_index  # noqa: F401  (fixture reuse)


@pytest.fixture(scope="module")
def reads(corpus):
    return [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))]


def cut_reads(f, rng, n, lens, err):
    """n reads of lens[0]..lens[1] symbols cut from the index's first
    sequence, each symbol replaced by a random base with probability err."""
    g, _ = f.retrieve(0)
    out = []
    for _ in range(n):
        ln = int(rng.integers(*lens))
        st = int(rng.integers(0, len(g) - ln))
        r = g[st : st + ln].copy()
        mut = rng.random(ln) < err
        r[mut] = rng.integers(1, 5, int(mut.sum()))
        out.append(r)
    return out


def assert_same_flat(counts, rows, want_counts, want_rows):
    assert np.array_equal(np.asarray(counts), want_counts)
    assert np.array_equal(np.asarray(rows).astype(np.int64), want_rows)


def per_read(counts, rows):
    out, k = [], 0
    for c in np.asarray(counts).tolist():
        out.append([tuple(r) for r in np.asarray(rows)[k : k + c].tolist()])
        k += c
    return out


def ref_rows(f, q, min_occ, min_len):
    """The sequential reference's MEMs of one read as row tuples."""
    return [(m.start, m.end, m.size, m.lo, m.lo_rc) for m in smem_ref.smem_tg(f, q, min_occ, min_len)]


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
    mt, nt = smem_tg_plain(occ_index, *flat_of(qs), min_occ=1, min_len=21, max_mems=M)[:2]
    assert mt.dtype == torch.int32 and mt.shape == (Q, M, 5) and nt.dtype == torch.int32
    assert_same_mems(mt.numpy(), nt.numpy(), np.asarray(mj), np.asarray(nj), M)
    if M == 2:
        assert (nt.numpy() > M).any()
    # the kernel wrapper takes the plain version for a CPU tensor
    mw, nw = smem_tg_cuda(occ_index, *flat_of(qs), min_occ=1, min_len=21, max_mems=M)[:2]
    assert_same_mems(mw.numpy(), nw.numpy(), mt.numpy(), nt.numpy(), M)


@pytest.mark.parametrize("min_occ,min_len", [(1, 17), (2, 21), (1, 1)])
def test_batched_matches_native_and_ref(corpus_index, reads, min_occ, min_len):
    mixed = [r[: 40 + 13 * (i % 9)] for i, r in enumerate(reads)] + [reads[0][:0], reads[1][:5]]
    eng = BatchedSmemTG(corpus_index, min_occ, min_len, device="cpu")
    counts, rows = eng.run_flat(*pack_reads(mixed))
    assert_same_flat(counts, rows, *smem_tg_flat_native(corpus_index, *pack_reads(mixed), min_occ, min_len))
    assert per_read(counts, rows) == [ref_rows(corpus_index, q, min_occ, min_len) for q in mixed]
    assert eng.n_rerun == eng.n_unmerged == 0


def test_batched_reruns_overflow(corpus_index):
    """Long reads overflow a 4-row MEM buffer in their chunks' lanes; each is
    rerun through the same kernel with a buffer of its true count (A3)."""
    long_reads = cut_reads(corpus_index, np.random.default_rng(9), 3, (3000, 6000), 0.05)
    eng = BatchedSmemTG(corpus_index, 1, 25, max_mems=4, device="cpu")
    counts, rows = eng.run_flat(*pack_reads(long_reads))
    assert eng.n_rerun == 3 and eng.n_unmerged == 0
    assert_same_flat(counts, rows, *smem_tg_flat_native(corpus_index, *pack_reads(long_reads), 1, 25))


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
    mt, nt = smem_tg_plain(idx, *flat_of(qs), min_occ=1, min_len=19, max_mems=M)[:2]
    assert mt.dtype == idx.dtype == (torch.int64 if idx.int64 else torch.int32)
    assert_same_mems(mt.numpy(), nt.numpy(), np.asarray(mj), np.asarray(nj), M)
    mw, nw = smem_tg_cuda(idx, *flat_of(qs), min_occ=1, min_len=19, max_mems=M)[:2]
    assert_same_mems(mw.numpy(), nw.numpy(), mt.numpy(), nt.numpy(), M)


@pytest.mark.parametrize("occ", ["rb", "dense"])
def test_batched_occ_matches_native(corpus_index, reads, occ):
    eng = BatchedSmemTG(corpus_index, 1, 21, device="cpu", occ=occ)
    assert eng.idx.layout == {"rb": "rb32", "dense": "dense32"}[occ]
    assert_same_flat(*eng.run_flat(*pack_reads(reads)), *smem_tg_flat_native(corpus_index, *pack_reads(reads), 1, 21))


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


@pytest.fixture(scope="module")
def long_reads(corpus_index):
    """Reads of 1-5 kb cut from the corpus at 1% error."""
    return cut_reads(corpus_index, np.random.default_rng(21), 4, (1000, 5001), 0.01)


@pytest.mark.parametrize("min_occ", [1, 2])
@pytest.mark.parametrize("min_len", [1, 19, 31])
def test_chunked_matches_serial(corpus_index, occ_index, long_reads, min_len, min_occ):
    """Chunks of 64 symbols with a 32-symbol margin (dozens of boundaries a
    read), stitched, with any read whose lanes did not meet rerun whole:
    exactly the serial plain version's rows and the sequential reference's."""
    flat, seq_off = flat_of(long_reads)
    out = smem_tg(occ_index, flat, seq_off, min_occ=min_occ, min_len=min_len, chunk=64, margin=32)
    serial = smem_tg_plain(occ_index, flat, seq_off, min_occ=min_occ, min_len=min_len, max_mems=4096)
    assert int(serial.n_mem.max()) <= 4096
    assert per_read(out.counts, out.rows) == per_read(serial.n_mem, serial.mems[
        torch.arange(4096)[None, :] < serial.n_mem[:, None].long()])
    assert per_read(out.counts, out.rows) == [ref_rows(corpus_index, q, min_occ, min_len) for q in long_reads]


def test_chunked_unresolved_reruns_whole(corpus_index, occ_index):
    """A margin of 2 symbols on reads at 5% error: at some boundaries the
    two lanes' chains do not meet before the first lane stops, so those
    reads are rerun whole by one thread; the answer stays exact."""
    reads = cut_reads(corpus_index, np.random.default_rng(5), 4, (1000, 2001), 0.05)
    flat, seq_off = flat_of(reads)
    out = smem_tg(occ_index, flat, seq_off, min_occ=1, min_len=19, chunk=64, margin=2)
    assert out.n_unmerged >= 1
    assert_same_flat(out.counts, out.rows, *smem_tg_flat_native(corpus_index, *pack_reads(reads), 1, 19))


def test_chunked_full_log_reruns_whole(corpus_index, occ_index, long_reads):
    """A one-entry START log keeps only each lane's start, so no boundary
    finds a meeting point: every multi-lane read reruns whole."""
    flat, seq_off = flat_of(long_reads)
    out = smem_tg(occ_index, flat, seq_off, min_occ=1, min_len=31, log_len=1)
    assert out.n_unmerged == len(long_reads)
    assert_same_flat(out.counts, out.rows, *smem_tg_flat_native(corpus_index, *pack_reads(long_reads), 1, 31))


def test_lanes_log_starts_and_stop(occ_index, long_reads):
    """chunk_lanes cuts at multiples of the chunk; a lane logs ascending
    STARTs from its x0, ends at its stop or with END = n + 1, and the lane
    that covers a whole read is the serial chain."""
    flat, seq_off = flat_of(long_reads[:2])
    lanes = chunk_lanes(seq_off)
    n = seq_off.diff()
    assert lanes[:, 0].bincount().tolist() == ((n + CHUNK - 1) // CHUNK).tolist()
    assert (lanes[:, 1] % CHUNK == 0).all() and (lanes[:, 1] < n[lanes[:, 0]]).all()
    ch = smem_tgc_cuda(occ_index, flat, seq_off, lanes, min_occ=1, min_len=31, max_mems=256, log_len=4096, trips=True)
    for lane, (r, x0, stop) in enumerate(lanes.tolist()):
        log = ch.log[lane, : int(ch.n_log[lane])].tolist()
        assert log[0] in (x0, int(n[r]) + 1) and log == sorted(set(log))  # a lane too short for a window ends at once
        assert log[-1] == int(n[r]) + 1 or (log[-1] >= stop and all(x < stop for x in log[:-1]))
    serial = smem_tg_plain(occ_index, flat, seq_off, min_occ=1, min_len=31, max_mems=256)
    assert int(ch.trips.max()) < int(serial.trips.max())  # a lane's chain is shorter than its read's
