"""The port's run-block occ rows (ropebwt3_tpu_torch/ops/runblock.py) against
the JAX package's dense `DeviceIndex` and its `RunBlockIndex`, on indexes
built with the repo's own index build.  Integer outputs: exact.

Two faults of the JAX `RunBlockIndex` are fixed in the port, and tests here
show both: F1 (rank at k = n when S divides n) and F4 (a run reaching the
end of an 8192-symbol block stores 8192 << 3 in a uint16 record, which wraps
to 0).

The port uploads each escape block as S/128 sub-rows of 64 B (counts before
the sub-row, then its plane words) and ranks from one of them; the cache
keeps the JAX package's planes.  Tests here hold the sub-rows against the
cache's planes and the ranks on them against the JAX `RunBlockIndex`."""

import ctypes
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.nt6 import revcomp
from ropebwt3_tpu.ops import rank as jrank
from ropebwt3_tpu.ops import runblock as jrb
from ropebwt3_tpu_torch.kernels import CSRC
from ropebwt3_tpu_torch.ops import rank as trank
from ropebwt3_tpu_torch.ops import runblock as trb

from .test_torch_cuda import edge_intervals, random_intervals

CHUNK = 1 << 16


def _index(seed, n_copies, L, div, with_ns=False):
    """n_copies mutated copies of one random genome, each with its reverse
    complement, 0-terminated."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, 5, L).astype(np.uint8)
    parts = []
    for _ in range(n_copies):
        s = base.copy()
        mut = rng.random(L) < div
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        if with_ns:
            s[rng.random(L) < 0.002] = 5
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))


@pytest.fixture(scope="module")
def pangenome():
    return _index(0, 6, 3000, 0.02, with_ns=True)


@pytest.fixture(scope="module")
def divisible():
    """4 copies of 2,047 bp: n = 16,384, which S = 256 and 1024 divide (F1)."""
    f = _index(1, 4, 2047, 0.01)
    assert f.n == 16384
    return f


@pytest.fixture(scope="module")
def redundant():
    """150 copies of 3,000 bp at 0.02% divergence: n = 900,300, where
    choose_S picks 8192 (F4)."""
    f = _index(3, 150, 3000, 0.0002)
    assert f.n == 900300
    return f


@pytest.fixture(scope="module")
def forced():
    """A random sequence and its reverse complement, n = 80,002: every block
    of every S has more than 64 runs, so every block is an escape."""
    rng = np.random.default_rng(5)
    seq = rng.integers(1, 5, 40000).astype(np.uint8)
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate([seq, [0], revcomp(seq), [0]]).astype(np.uint8)))


def _assert_sub_rows(packed, planes, S):
    """Each sub-row of the packed escape table holds the keyed counts of the
    cache's planes before it (six uint16, low half first), a zero pad word,
    and the planes' words over its 128 symbols."""
    m, W4 = len(planes), S // 128
    assert packed.shape == (m, W4, 16)
    p = np.ascontiguousarray(planes, np.int32).view(np.uint32).reshape(m, 3, W4, 4)
    assert np.array_equal(packed[..., 4:].view(np.uint32), p.transpose(0, 2, 1, 3).reshape(m, W4, 12))
    bits = np.unpackbits(p.view(np.uint8), bitorder="little").reshape(m, 3, W4, 128)
    keyed = bits[:, 0] | bits[:, 1] << 1 | bits[:, 2] << 2
    cnt = np.stack([(keyed == kc).sum(-1) for kc in range(6)], axis=-1)
    assert np.array_equal(np.ascontiguousarray(packed[..., :3]).view(np.uint16).reshape(m, W4, 6), np.cumsum(cnt, 1) - cnt)
    assert not packed[..., 3].any()


def _rank_all(rank_fn, n):
    """rank_fn over every k in [0, n], in chunks: (n + 1, 6) int64."""
    return np.concatenate([np.asarray(rank_fn(np.arange(a, min(a + CHUNK, n + 1), dtype=np.int64))).astype(np.int64)
                           for a in range(0, n + 1, CHUNK)])


def _port_rank(idx):
    return lambda k: idx.rank1a(torch.from_numpy(k)).numpy()


def _jax_rank(idx):
    return lambda k: jrank.rank1a(idx, jnp.asarray(k))


def _totals(f):
    return f.acc[1:] - f.acc[:-1]


@pytest.mark.parametrize("S", [256, 1024, 8192, None])
def test_rank_every_k_and_extend_match_dense(pangenome, S):
    f = pangenome
    rb = trb.RunBlockIndex.from_dense(f, "cpu", S=S, cache=None)
    dense = jrank.DeviceIndex.from_dense(f, prefix=False)
    assert rb.layout == "rb32" and (S is None or rb.S == S)
    assert np.array_equal(_rank_all(_port_rank(rb), f.n), _rank_all(_jax_rank(dense), f.n))
    rng = np.random.default_rng(2)
    ik = random_intervals(rng, f.n, 2000)
    back = rng.random(len(ik)) < 0.5
    c = rng.integers(0, 6, len(ik))
    got = trank.extend(rb, torch.from_numpy(ik), torch.from_numpy(back)).numpy()
    assert np.array_equal(got, np.asarray(jrank.extend(dense, jnp.asarray(ik), jnp.asarray(back))))
    got = trank.extend_c(rb, torch.from_numpy(ik), torch.from_numpy(c), torch.from_numpy(back)).numpy()
    assert np.array_equal(got, np.asarray(jrank.extend_c(dense, jnp.asarray(ik), jnp.asarray(c, jnp.int32), jnp.asarray(back))))
    got = trank.set_intv(rb, torch.arange(6)).numpy()
    assert np.array_equal(got, np.asarray(jrank.set_intv(dense, jnp.arange(6, dtype=jnp.int32))))


@pytest.mark.parametrize("S", [256, 1024])
def test_f1_rank_at_n_when_S_divides_n(divisible, S):
    f = divisible
    assert f.n % S == 0
    rb = trb.RunBlockIndex.from_dense(f, "cpu", S=S, cache=None)
    dense = jrank.DeviceIndex.from_dense(f, prefix=False)
    assert np.array_equal(_rank_all(_port_rank(rb), f.n), _rank_all(_jax_rank(dense), f.n))
    assert np.array_equal(rb.rank1a(torch.tensor([f.n]))[0].numpy(), _totals(f))
    full = np.array([[0, 0, f.n]] * 6, np.int64)
    c, back = np.arange(6), np.ones(6, bool)
    want = np.asarray(jrank.extend_c(dense, jnp.asarray(full), jnp.asarray(c, jnp.int32), jnp.asarray(back)))
    got = trank.extend_c(rb, torch.from_numpy(full), torch.from_numpy(c), torch.from_numpy(back)).numpy()
    assert np.array_equal(got, want)
    # the JAX reference ranks k = n at row n // S, clamped to the last row
    # with offset 0: it drops the last block (F1)
    jax_rb = jrb.from_dense(f, S=S, cache=None)
    assert not np.array_equal(np.asarray(jrank.rank1a(jax_rb, jnp.asarray([f.n])))[0], _totals(f))
    assert not np.array_equal(
        np.asarray(jrank.extend_c(jax_rb, jnp.asarray(full), jnp.asarray(c, jnp.int32), jnp.asarray(back))), want)


def test_f4_full_8192_blocks_every_k(redundant):
    f = redundant
    syms, lens = trb.runs_from_dense(f)
    S, _ = trb.choose_S(lens, f.n)
    assert S == 8192
    rb = trb.RunBlockIndex.from_dense(f, "cpu", cache=None)
    assert rb.S == 8192
    want = _rank_all(_jax_rank(jrank.DeviceIndex.from_dense(f, prefix=False)), f.n)
    assert np.array_equal(_rank_all(_port_rank(rb), f.n), want)
    # the JAX reference's uint16 record of a run ending at 8192 wraps to 0,
    # and its decode gives that run no coverage (F4): wrong in the first
    # four blocks already
    k = np.arange(4 * 8192 + 1)
    got = np.asarray(jrank.rank1a(jrb.from_dense(f, S=8192, cache=None), jnp.asarray(k)))
    assert (got != want[k]).any()


@pytest.mark.parametrize("S", [256, 1024])
def test_matches_jax_runblock(pangenome, S):
    """Where the JAX RunBlockIndex is right (S < 8192, S does not divide n),
    the port agrees with it on the rows and on every answer."""
    f = pangenome
    assert f.n % S
    d = trb.build_runblock_np(*trb.runs_from_dense(f), n=f.n, S=S)
    jd = jrb.build_runblock_np(*jrb.runs_from_dense(f), n=f.n, S=S)
    for key in ("rows", "esc", "acc"):
        assert np.array_equal(d[key], jd[key]), key
    rb, jax_rb = trb.RunBlockIndex.from_np(d, "cpu"), jrb.from_dense(f, S=S, cache=None)
    assert np.array_equal(_rank_all(_port_rank(rb), f.n), _rank_all(_jax_rank(jax_rb), f.n))
    rng = np.random.default_rng(4)
    ik = random_intervals(rng, f.n, 1000)
    back = rng.random(len(ik)) < 0.5
    c = rng.integers(0, 6, len(ik))
    got = trank.extend(rb, torch.from_numpy(ik), torch.from_numpy(back)).numpy()
    assert np.array_equal(got, np.asarray(jrank.extend(jax_rb, jnp.asarray(ik), jnp.asarray(back))))
    got = trank.extend_c(rb, torch.from_numpy(ik), torch.from_numpy(c), torch.from_numpy(back)).numpy()
    assert np.array_equal(got, np.asarray(jrank.extend_c(jax_rb, jnp.asarray(ik), jnp.asarray(c, jnp.int32), jnp.asarray(back))))


def test_forced_escape_blocks():
    """A random sequence at S = 256: blocks of more than 64 runs take the
    escape planes, including offset S at block boundaries."""
    rng = np.random.default_rng(5)
    seq = rng.integers(1, 5, 40000).astype(np.uint8)
    f = DenseFMIndex.from_bwt(gsa_bwt(np.concatenate([seq, [0], revcomp(seq), [0]]).astype(np.uint8)))
    rb = trb.RunBlockIndex.from_dense(f, "cpu", S=256, cache=None)
    assert rb.n_esc > 1 and rb.esc.shape == (rb.n_esc, 256 // 128, 16)
    _assert_sub_rows(rb.esc.numpy(), trb.build_runblock_np(*trb.runs_from_dense(f), n=f.n, S=256)["esc"], 256)
    assert np.array_equal(_rank_all(_port_rank(rb), f.n), f.rank1a(np.arange(f.n + 1)))
    ik = random_intervals(rng, f.n, 1000)
    back = rng.random(len(ik)) < 0.5
    c = rng.integers(0, 6, len(ik))
    got = trank.extend_c(rb, torch.from_numpy(ik), torch.from_numpy(c), torch.from_numpy(back)).numpy()
    assert np.array_equal(got, np.stack([f.extend(ik[t : t + 1], bool(back[t]))[0, c[t]] for t in range(len(ik))]))


@pytest.mark.parametrize("S", [256, 1024, 8192])
@pytest.mark.parametrize("int64", [False, True])
def test_sub_rows_pack_the_cache_planes(forced, pangenome, S, int64):
    """Every sub-row's counts are the keyed popcounts of the cache's planes
    before it, its planes the cache's words, on an all-escape index and on
    one with few escapes."""
    for f in (forced, pangenome):
        d = trb.build_runblock_np(*trb.runs_from_dense(f), n=f.n, S=S, int64=int64)
        rb = trb.RunBlockIndex.from_np(d, "cpu")
        assert rb.n_esc == len(d["esc"]) >= 1
        _assert_sub_rows(rb.esc.numpy(), d["esc"], S)
        assert np.array_equal(trb.pack_escapes(d["esc"], S, "cpu").numpy(), rb.esc.numpy())


def test_pack_escapes_in_chunks(forced, monkeypatch):
    """The pack's chunks of rows (a few words of temporaries each) give the
    table that one chunk gives; planes of another S are refused."""
    d = trb.build_runblock_np(*trb.runs_from_dense(forced), n=forced.n, S=1024)
    whole = trb.pack_escapes(d["esc"], 1024, "cpu")
    monkeypatch.setattr(trb, "PACK_WORDS", 3 * 1024 // 32 * 3)  # 3 rows a chunk
    assert len(d["esc"]) % 3 and torch.equal(trb.pack_escapes(d["esc"], 1024, "cpu"), whole)
    with pytest.raises(ValueError):
        trb.pack_escapes(d["esc"], 2048, "cpu")


@pytest.mark.parametrize("S", [256, 1024, 8192])
def test_packed_escapes_match_jax_runblock(forced, S):
    """On an index where every block escapes, the port's rank1a at every k
    and extend / extend_c on intervals with both ends at sub-row and block
    edges equal the JAX RunBlockIndex's, which reads the planes whole."""
    f = forced
    assert f.n % S
    rb, jax_rb = trb.RunBlockIndex.from_dense(f, "cpu", S=S, cache=None), jrb.from_dense(f, S=S, cache=None)
    assert rb.n_esc == rb.rows.shape[0] and rb.esc.shape == (rb.n_esc, S // 128, 16)
    assert np.array_equal(_rank_all(_port_rank(rb), f.n), _rank_all(_jax_rank(jax_rb), f.n))
    ik = edge_intervals(f.n, S)
    rng = np.random.default_rng(8)
    c = rng.integers(0, 6, len(ik))
    for back in (np.zeros(len(ik), bool), np.ones(len(ik), bool)):
        got = trank.extend(rb, torch.from_numpy(ik), torch.from_numpy(back)).numpy()
        assert np.array_equal(got, np.asarray(jrank.extend(jax_rb, jnp.asarray(ik), jnp.asarray(back))))
        got = trank.extend_c(rb, torch.from_numpy(ik), torch.from_numpy(c), torch.from_numpy(back)).numpy()
        want = jrank.extend_c(jax_rb, jnp.asarray(ik), jnp.asarray(c, jnp.int32), jnp.asarray(back))
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_read_by_either_package(pangenome, tmp_path, writer):
    """A `.rb.npz` that either package writes, the other reads, and both rank
    every k alike from it (S = 256: no JAX fault is in reach)."""
    f = pangenome
    path = str(tmp_path / "idx.fmd.dense.rb.npz")
    if writer == "port":
        trb.save_cache(path, trb.build_runblock_np(*trb.runs_from_dense(f), n=f.n, S=256))
    else:
        jrb.save_cache(path, jrb.build_runblock_np(*jrb.runs_from_dense(f), n=f.n, S=256))
    d, jd = trb.load_cache(path, f.n), jrb.load_cache(path, f.n)
    assert d is not None and jd is not None and d["S"] == jd["S"] == 256
    rb = trb.RunBlockIndex.from_np(d, "cpu")
    assert rb.n_esc >= 1
    got = _rank_all(_port_rank(rb), f.n)
    assert np.array_equal(got, _rank_all(_jax_rank(jrb._to_device(jd)), f.n))
    assert np.array_equal(got, f.rank1a(np.arange(f.n + 1)))


@pytest.mark.parametrize("S,mega_shift", [(256, 2), (1024, 0), (8192, None)])
def test_int64_megablocks_match_jax(pangenome, monkeypatch, S, mega_shift):
    """int64 rb rows, re-based into megablocks of 2^mega_shift rows, against
    the JAX int64 DeviceIndex with its megablocks shrunk too."""
    f = pangenome
    monkeypatch.setattr(jrank, "MEGA_BLOCK_SHIFT", 4)
    dense = jrank.DeviceIndex.from_dense(f, idx_dtype=jnp.int64, prefix=False)
    assert dense.occ_super.shape[0] > 1
    rb = trb.RunBlockIndex.from_dense(f, "cpu", S=S, int64=True, mega_shift=mega_shift, cache=None)
    assert rb.layout == "rb64" and rb.dtype == torch.int64
    if mega_shift is not None:
        assert rb.mega.shape[0] == ((f.n + S - 1) // S - 1 >> mega_shift) + 1 > 1
    else:  # the native builder's 2^32-symbol megablocks: its rows as they are
        jd = jrb.build_runblock_np(*jrb.runs_from_dense(f), n=f.n, S=S, idx_dtype=jnp.int64)
        assert np.array_equal(rb.rows.numpy()[:, :6], jd["rows"][:, :6]) and np.array_equal(rb.mega.numpy(), jd["mega"])
    assert np.array_equal(_rank_all(_port_rank(rb), f.n), _rank_all(_jax_rank(dense), f.n))
    rng = np.random.default_rng(6)
    ik = random_intervals(rng, f.n, 1000)
    back = rng.random(len(ik)) < 0.5
    c = rng.integers(0, 6, len(ik))
    got = trank.extend_c(rb, torch.from_numpy(ik), torch.from_numpy(c), torch.from_numpy(back)).numpy()
    assert np.array_equal(got, np.asarray(jrank.extend_c(dense, jnp.asarray(ik), jnp.asarray(c, jnp.int32), jnp.asarray(back))))
    got = trank.extend(rb, torch.from_numpy(ik), torch.from_numpy(back)).numpy()
    assert np.array_equal(got, np.asarray(jrank.extend(dense, jnp.asarray(ik), jnp.asarray(back))))


def test_kernel_wrappers_take_plain_on_cpu(pangenome):
    f = pangenome
    for rb in (trb.RunBlockIndex.from_dense(f, "cpu", S=512, cache=None),
               trb.RunBlockIndex.from_dense(f, "cpu", S=512, int64=True, mega_shift=1, cache=None)):
        k = torch.tensor([0, 1, 511, 512, 513, f.n - 1, f.n])
        assert np.array_equal(trank.rank1a_cuda(rb, k).numpy(), f.rank1a(k.numpy()))
        assert trank.rank1a_cuda(rb, k).dtype == rb.dtype
        ik = torch.tensor([[0, 0, f.n], [5, 9, 100]], dtype=rb.dtype)
        c, back = torch.tensor([2, 3], dtype=torch.int32), torch.tensor([True, False])
        assert torch.equal(trank.extend_c_cuda(rb, ik, c, back), trank.extend_c(rb, ik, c, back).to(rb.dtype))
        with pytest.raises(ValueError):  # past the end of the BWT
            trank.rank1a_cuda(rb, torch.tensor([f.n + 1]))
        with pytest.raises(ValueError):
            trank.extend_c_cuda(rb, torch.tensor([[0, 0, f.n + 1]], dtype=rb.dtype), c[:1], back[:1])
        with pytest.raises(ValueError):  # ik in the wrong width
            trank.extend_c_cuda(rb, ik.to(torch.int16), c, back)


def test_cache_refuses_stale_and_mismatched(pangenome, tmp_path):
    """`<sidecar>.rb.npz`: the JAX package's format; used only when n, S and
    the width match and it is no older than the index's sidecar (F3)."""
    f = pangenome
    sidecar = tmp_path / "idx.fmd.dense"
    sidecar.write_bytes(b"")
    f._sidecar_path = str(sidecar)
    try:
        cache = str(sidecar) + ".rb.npz"
        d = trb.from_dense_np(f)  # builds and writes the cache
        assert os.path.exists(cache)
        jd = jrb.load_cache(cache, f.n)  # the JAX package reads it
        assert jd is not None and jd["S"] == d["S"] and np.array_equal(jd["rows"], d["rows"])
        got = trb.load_cache(cache, f.n, source=str(sidecar))
        assert got is not None and np.array_equal(got["rows"], d["rows"]) and np.array_equal(got["esc"], d["esc"])
        assert trb.load_cache(cache, f.n + 1) is None  # wrong n
        other = 256 if d["S"] != 256 else 512
        assert trb.load_cache(cache, f.n, S=other) is None  # wrong S
        assert trb.from_dense_np(f, S=other)["S"] == other  # rebuilt, not taken from the cache
        assert trb.load_cache(cache, f.n, int64=True) is None  # wrong width
        t = os.path.getmtime(sidecar)
        os.utime(cache, (t - 10, t - 10))
        assert trb.load_cache(cache, f.n, source=str(sidecar)) is None  # older than the index
        bad = dict(d, rows=d["rows"].copy())
        bad["rows"][0, 6] = len(d["esc"])  # an escape index past the table
        trb.save_cache(cache, bad)
        assert trb.load_cache(cache, f.n) is None
        with pytest.raises(ValueError):
            trb.RunBlockIndex.from_np(bad, "cpu")
        np.savez(str(tmp_path / "marker"), meta=np.array([f.n, d["S"], 0]))
        os.replace(str(tmp_path / "marker.npz"), cache)  # a fresh cache with the same meta...
        assert trb.from_dense_np(f)["rows"].shape == d["rows"].shape  # ...but no rows: rebuilt
    finally:
        del f._sidecar_path


# csrc/rb.cuh's rank routine compiled for the host: a small header stands in
# for the CUDA built-ins it uses, and one loop a width calls Rb<T>::rank6
HOST_SHIM = """
#include <stdint.h>
#include <algorithm>
#define __device__
#define __global__
#define __forceinline__ inline
using std::max;
using std::min;
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
struct longlong2 { long long x, y; };
template <typename T> static inline T __ldg(const T* p) { return *p; }
static inline int __popc(unsigned v) { return __builtin_popcount(v); }
// the warp collectives of csrc/dp.cuh for one lane
static inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
template <typename V> static inline V __shfl_sync(unsigned, V v, int) { return v; }
template <typename V> static inline V __shfl_xor_sync(unsigned, V v, int) { return v; }
template <typename V> static inline unsigned __match_any_sync(unsigned, V) { return 1u; }
static inline void __syncwarp(unsigned = 0xffffffffu) {}
static inline int __ffs(unsigned v) { return __builtin_ffs((int)v); }
static inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
static inline unsigned atomicOr(unsigned* p, unsigned v) { const unsigned o = *p; *p = o | v; return o; }
#include "rb.cuh"
template <typename T>
static void rank_all(const int* rows, const int* esc, const int64_t* mega, const void* acc, int mega_shift, int block_shift,
                     const int64_t* k, int64_t n, T* out) {
  const rb3c::Rb<T> ix{rb3c::Tables{rows, esc, mega, acc, mega_shift, block_shift}};
  for (int64_t i = 0; i < n; ++i) ix.rank6((T)k[i], out + 6 * i);
}
extern "C" void rank_rb32(const int* r, const int* e, const int64_t* m, const void* a, int ms, int bs, const int64_t* k,
                          int64_t n, int* o) { rank_all<int>(r, e, m, a, ms, bs, k, n, o); }
extern "C" void rank_rb64(const int* r, const int* e, const int64_t* m, const void* a, int ms, int bs, const int64_t* k,
                          int64_t n, int64_t* o) { rank_all<int64_t>(r, e, m, a, ms, bs, k, n, o); }
"""


@pytest.fixture(scope="module")
def rb_host(tmp_path_factory):
    d = tmp_path_factory.mktemp("rb_host")
    (d / "rb_host.cpp").write_text(HOST_SHIM)
    so = d / "librb_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so), str(d / "rb_host.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("which", ["forced", "redundant"])
@pytest.mark.parametrize("S", [256, 1024, 8192])
@pytest.mark.parametrize("int64", [False, True])
def test_rb_cuh_rank_on_the_host(rb_host, forced, redundant, which, S, int64):
    """The card's rank routine (csrc/rb.cuh Rb<T>::rank6), built for the host,
    at every k on escape sub-rows (every block of `forced`) and on run
    records (most blocks of `redundant`; at S = 8192 its wrapped ends, F4),
    in both widths with megablocks of two rows: equal to the dense rank."""
    f = forced if which == "forced" else redundant
    rb = trb.RunBlockIndex.from_dense(f, "cpu", S=S, int64=int64, mega_shift=1 if int64 else None, cache=None)
    assert (rb.n_esc == rb.rows.shape[0]) if which == "forced" else (2 * rb.n_esc < rb.rows.shape[0])
    k = torch.arange(f.n + 1)
    out = torch.empty((f.n + 1, 6), dtype=rb.dtype)
    vp = ctypes.c_void_p
    mega = vp(rb.mega.data_ptr()) if int64 else None
    getattr(rb_host, f"rank_{rb.layout}")(vp(rb.rows.data_ptr()), vp(rb.esc.data_ptr()), mega, vp(rb.acc.data_ptr()),
                                          ctypes.c_int(rb.mega_shift), ctypes.c_int(S.bit_length() - 1),
                                          vp(k.data_ptr()), ctypes.c_int64(f.n + 1), vp(out.data_ptr()))
    assert np.array_equal(out.numpy(), f.rank1a(k.numpy()))
