"""The port's SMEM-TG engine (ropebwt3_tpu_torch/ops/smem.py) against the JAX
lock-step FSM, the Pallas kernel in interpret mode, the native host engine
and the sequential reference, on every occ layout (dense and run-block rows,
int32 and int64 widths); and the chunked path (lanes, START logs, the
stitch, the reruns) against the serial answer.  Integer outputs: exact."""

import ctypes
import os
import subprocess

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
from ropebwt3_tpu_torch.ops.smem import (CHUNK, NO_STOP, BatchedSmemTG, Chains, chunk_lanes, lane_order, pack_reads,
                                         resolve_occ, smem_tg, smem_tg_cuda, smem_tg_plain, smem_tgc_cuda)

from .test_torch_cli import ROOT
from .test_torch_cuda import assert_same_mems, corpus_index, flat_of, make_index  # noqa: F401  (fixture reuse)
from .test_torch_rank import MEGA_SHIFT, jax_index, jax_index64, occ_index  # noqa: F401  (fixture reuse)
from .test_torch_runblock import HOST_SHIM

CSRC = os.path.join(ROOT, "ropebwt3_tpu_torch", "csrc")


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
    two lanes' chains do not meet before the first lane stops, and not at a
    margin of 4 either, so those reads are rerun whole by one thread; the
    answer stays exact."""
    reads = cut_reads(corpus_index, np.random.default_rng(5), 4, (1000, 2001), 0.05)
    flat, seq_off = flat_of(reads)
    out = smem_tg(occ_index, flat, seq_off, min_occ=1, min_len=19, chunk=64, margin=2)
    assert out.n_unmerged >= out.n_whole >= 1
    assert_same_flat(out.counts, out.rows, *smem_tg_flat_native(corpus_index, *pack_reads(reads), 1, 19))


def test_chunked_full_log_reruns_whole(corpus_index, occ_index, long_reads):
    """A one-entry START log keeps only each lane's start, so no boundary
    finds a meeting point: every multi-lane read reruns whole."""
    flat, seq_off = flat_of(long_reads)
    out = smem_tg(occ_index, flat, seq_off, min_occ=1, min_len=31, log_len=1)
    assert out.n_unmerged == out.n_whole == len(long_reads)
    assert_same_flat(out.counts, out.rows, *smem_tg_flat_native(corpus_index, *pack_reads(long_reads), 1, 31))


def test_chunked_unmerged_rerun_at_twice_the_margin(corpus_index, occ_index):
    """A margin of 6 symbols on reads at 1% error: some reads' lanes do not
    meet, and meet when rerun as lanes with a margin of 12, so no read is
    rerun whole; the answer equals the serial one and the native engine's."""
    reads = cut_reads(corpus_index, np.random.default_rng(5), 4, (1000, 2001), 0.01)
    flat, seq_off = flat_of(reads)
    out = smem_tg(occ_index, flat, seq_off, min_occ=1, min_len=19, chunk=64, margin=6)
    assert out.n_unmerged >= 1 and out.n_whole == 0
    serial = smem_tg_plain(occ_index, flat, seq_off, min_occ=1, min_len=19, max_mems=4096)
    assert per_read(out.counts, out.rows) == per_read(serial.n_mem, serial.mems[
        torch.arange(4096)[None, :] < serial.n_mem[:, None].long()])
    assert_same_flat(out.counts, out.rows, *smem_tg_flat_native(corpus_index, *pack_reads(reads), 1, 19))


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


def test_lane_order_heaviest_first(long_reads, reads):
    """lane_order is a permutation of the lanes by span (x_stop - x0, cut at
    the read's end), heaviest first, ties in lane order: a long read's chunk
    lanes (C + W) before its last lane and before the short reads."""
    qs = [reads[0][:50], *long_reads[:2], reads[1], np.zeros(0, np.uint8), reads[2][:30]]
    flat, seq_off = flat_of(qs)
    lanes = chunk_lanes(seq_off, 64, 32)
    order = lane_order(lanes, seq_off)
    assert order.dtype == torch.int64 and sorted(order.tolist()) == list(range(lanes.shape[0]))
    n = seq_off.diff()[lanes[:, 0]]
    span = (torch.minimum(lanes[:, 2], n) - lanes[:, 1]).tolist()
    want = sorted(range(len(span)), key=lambda i: (-span[i], i))
    assert order.tolist() == want
    top = order[: sum(s == 96 for s in span)]
    assert span[want[0]] == 96 and {1, 2} <= set(lanes[top, 0].tolist()) and bool((lanes[top, 2] < NO_STOP).all())


def test_smem_tgc_refuses_bad_order(occ_index, long_reads):
    """The wrapper refuses an order that is not a permutation of the lanes,
    of another dtype or length, before any lane runs."""
    flat, seq_off = flat_of(long_reads[:1])
    lanes = chunk_lanes(seq_off, 64, 32)
    L = lanes.shape[0]
    kw = dict(min_occ=1, min_len=19, max_mems=8)
    good = lane_order(lanes, seq_off)
    for bad in (good[:-1], good.int(), torch.zeros(L, dtype=torch.int64), good + 1, good - 1, good.view(1, L)):
        with pytest.raises(ValueError):
            smem_tgc_cuda(occ_index, flat, seq_off, lanes, order=bad, **kw)
    ch = smem_tgc_cuda(occ_index, flat, seq_off, lanes, order=good.flip(0), **kw)
    assert torch.equal(ch.n_mem, smem_tgc_cuda(occ_index, flat, seq_off, lanes, **kw).n_mem)


def test_queued_engine_matches_native(corpus_index, occ_index, reads, long_reads):
    """smem_tg, whose chunked launch takes the lanes heaviest first, gives
    the JAX package's native rows on long and short reads together."""
    qs = long_reads + reads[:60]
    out = smem_tg(occ_index, *flat_of(qs), min_occ=1, min_len=19, chunk=64, margin=32)
    assert out.n_unmerged == 0
    assert_same_flat(out.counts, out.rows, *smem_tg_flat_native(corpus_index, *pack_reads(qs), 1, 19))


# csrc/smem_tg.cu's lane routine (the text before `#ifdef __CUDACC__`) built
# for the host with g++: one thread takes every lane of a launch in its order
SMEM_HOST_SRC = HOST_SHIM.split('#include "rb.cuh"')[0] + r"""
static inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  const unsigned long long o = *p;
  *p = o + v;
  return o;
}
#include "smem_tg.cu"

// lanes given: run_queue from position 0, stride 1 (one thread takes every
// lane in `order`); lanes null: run_chain a read from 0, as smem_tg's kernel
#define ENTRY(name, L)                                                                                             \
  extern "C" void lanes_##name(const int* rt, const int* esc, const int64_t* mega, const void* acc, int ms, int bs, \
                               const uint8_t* flat, const int64_t* seq_off, const int64_t* lanes,                  \
                               const int64_t* order, int64_t n_lanes, int min_occ, int min_len, int max_mems,     \
                               int log_len, void* mems, int* n_mem, int* log, int* n_log, int* trips) {           \
    const L ix{rb3c::Tables{rt, esc, mega, acc, ms, bs}};                                                         \
    L::T* m = static_cast<L::T*>(mems);                                                                           \
    if (lanes) {                                                                                                  \
      unsigned long long next = 0;                                                                                \
      run_queue(ix, flat, seq_off, lanes, order, n_lanes, min_occ, min_len, max_mems, log_len, m, n_mem, log,     \
                n_log, trips, 0, 1, &next);                                                                       \
    } else {                                                                                                      \
      for (int64_t r = 0; r < n_lanes; ++r) {                                                                     \
        const int n = (int)(seq_off[r + 1] - seq_off[r]);                                                         \
        n_mem[r] = run_chain<L, false>(ix, flat + seq_off[r], n, 0, n + 1, min_occ, min_len, max_mems,            \
                                       m + r * max_mems * 5, nullptr, 0, nullptr, trips + r);                     \
      }                                                                                                           \
    }                                                                                                             \
  }
RB3C_LAYOUTS(ENTRY)
"""


@pytest.fixture(scope="module")
def smem_host(tmp_path_factory):
    """csrc/smem_tg.cu's chain routine built for the host with g++."""
    d = tmp_path_factory.mktemp("smem_host")
    (d / "smem_host.cpp").write_text(SMEM_HOST_SRC)
    so = d / "libsmem_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so),
                        str(d / "smem_host.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


def host_chains(lib, idx, flat, seq_off, lanes, order, *, min_occ, min_len, max_mems, log_len=1):
    """The host-built routine's Chains, as smem_tgc_cuda returns them with
    trips; lanes None: one chain a read, as smem_tg's kernel runs them."""
    L = seq_off.numel() - 1 if lanes is None else lanes.shape[0]
    mems = torch.zeros((L, max_mems, 5), dtype=idx.dtype)
    n_mem, n_log, trips = (torch.zeros(L, dtype=torch.int32) for _ in range(3))
    log = torch.zeros((L, log_len), dtype=torch.int32)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ptr = lambda t: vp(t.data_ptr() if t is not None else None)  # noqa: E731
    rows, esc, mega, acc, ms, bs = idx.kernel_tables()
    getattr(lib, f"lanes_{idx.layout}")(
        vp(rows), vp(esc), vp(mega), vp(acc), i32(ms), i32(bs), ptr(flat), ptr(seq_off), ptr(lanes), ptr(order),
        i64(L), i32(min_occ), i32(min_len), i32(max_mems), i32(log_len), ptr(mems), ptr(n_mem), ptr(log), ptr(n_log),
        ptr(trips))
    return Chains(mems, n_mem, log, n_log, trips)


def assert_same_chains(got, want, max_mems, log_len):
    assert_same_mems(got.mems.numpy(), got.n_mem.numpy(), want.mems.numpy(), want.n_mem.numpy(), max_mems)
    assert_same_mems(got.log.numpy()[..., None], got.n_log.numpy(), want.log.numpy()[..., None], want.n_log.numpy(),
                     log_len)
    assert torch.equal(got.trips, want.trips)


@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32", "rb64"])
def test_lane_routine_on_the_host_matches_plain(smem_host, corpus_index, reads, long_reads, layout):
    """The card's lane routine, built for the host, on the lanes (64 + 32)
    of long reads, short reads and an empty one, in every layout, taken
    heaviest first and shuffled by one thread: each lane's rows, counts,
    START log and trips equal smem_tg_plain's; and on the
    short reads one lane a read from 0 (smem_tg's kernel) equals the plain
    read lanes."""
    idx = make_index(layout, corpus_index, "cpu")
    qs = long_reads + [r[: 21 + 7 * (i % 19)] for i, r in enumerate(reads[:40])] + [np.zeros(0, np.uint8)]
    flat, seq_off = flat_of(qs)
    lanes = chunk_lanes(seq_off, 64, 32)
    kw = dict(min_occ=1, min_len=19, max_mems=8)
    want = smem_tg_plain(idx, flat, seq_off, lanes=lanes, log_len=16, **kw)
    shuffled = torch.from_numpy(np.random.default_rng(3).permutation(lanes.shape[0]))
    for order in (lane_order(lanes, seq_off), shuffled):
        assert_same_chains(host_chains(smem_host, idx, flat, seq_off, lanes, order, log_len=16, **kw), want, 8, 16)
    one = int(want.one_row.sum())  # the plain version's count of trips whose two ranks share a dense row
    assert (one > int(want.trips.sum()) // 4) if layout.startswith("dense") else one == 0
    flat, seq_off = flat_of(qs[len(long_reads):])
    got = host_chains(smem_host, idx, flat, seq_off, None, None, **kw)
    serial = smem_tg_plain(idx, flat, seq_off, **kw)
    assert_same_mems(got.mems.numpy(), got.n_mem.numpy(), serial.mems.numpy(), serial.n_mem.numpy(), 8)
    assert torch.equal(got.trips, serial.trips)
