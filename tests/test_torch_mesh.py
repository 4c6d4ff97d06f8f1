"""The port's mesh (ropebwt3_tpu_torch/parallel/) against the JAX package's,
on the CPU: occ rows sharded over a 2x4 mesh, `mem`, `sw` and `hapdiv` with
`--mesh`, and dp over two gloo processes.  Integer outputs: exact; CLI
outputs: byte-equal.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py: the
masked partial rank `rank1a_local` made whole by a psum over `idx` under
shard_map, and `smem_sharded_fn` (two compiles, dense and rb).  The port's
side is its plain path: `rank6_sharded_plain`, and `smem_tg_plain` over it,
on meshes of [cpu] * 8.  On the CPU `ShardedRows` lays the slabs out as the
card maps them, in one host tensor (slabs of whole units, escapes rebased
to their aligned offsets); csrc/occ.cuh's and rb.cuh's unsharded rank and
smem_tg.cu's lane routine are built for the host with g++ and run over that
buffer through the view's base pointers, held against the plain twin."""

import ctypes
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct.sa import gsa_bwt
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.nt6 import char2nt6, revcomp
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch.kernels import CSRC
from ropebwt3_tpu_torch.ops import rank as trank
from ropebwt3_tpu_torch.ops import runblock as trb
from ropebwt3_tpu_torch.ops.smem import BatchedSmemTG, pack_reads
from ropebwt3_tpu_torch.parallel import MeshError
from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, block_of, make_mesh, rank6_sharded_plain
from ropebwt3_tpu_torch.parallel.smem_sharded import split_reads

from .test_torch_runblock import HOST_SHIM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEGA = 3  # dense64: megablocks of 8 rows, so the 257 rows span 33 of them
CPU8 = ["cpu"] * 8


def _run(module, args, env=None):
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", **(env or {}))
    return subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT, capture_output=True, env=env)


@pytest.fixture(scope="module")
def n_index():
    """4 mutated copies of 2,047 bp with N runs, double strand: n = 16,384,
    which S = 256 and 512 divide (F1 at k = n), and 257 dense rows, which
    four shards cut unevenly."""
    rng = np.random.default_rng(7)
    base = rng.integers(1, 5, 2047).astype(np.uint8)
    parts = []
    for _ in range(4):
        s = base.copy()
        mut = rng.random(2047) < 0.02
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        for st in rng.integers(0, 2040, 3):
            s[st : st + int(rng.integers(1, 8))] = 5
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    f = DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))
    assert f.n == 16384
    return f


@pytest.fixture(scope="module")
def corpus_index(corpus):
    """The double-strand index of the corpus genomes (n = 128,016: no S divides it)."""
    parts = []
    for rec in read_seqs(str(corpus / "genomes.fa")):
        s = char2nt6(rec.seq)
        parts += [s, np.zeros(1, np.uint8), revcomp(s), np.zeros(1, np.uint8)]
    return DenseFMIndex.from_bwt(gsa_bwt(np.concatenate(parts)))


@pytest.fixture(scope="module")
def mesh_fmd(corpus, tmp_path_factory):
    """The corpus FMD built by the JAX package, and `mem --engine=native -l21`'s BED of the reads."""
    d = tmp_path_factory.mktemp("torch_mesh")
    fmd = d / "idx.fmd"
    r = _run("ropebwt3_tpu", ["build", "-do", str(fmd), str(corpus / "genomes.fa")])
    assert r.returncode == 0, r.stderr.decode()
    want = _run("ropebwt3_tpu", ["mem", "--engine=native", "-l21", str(fmd), str(corpus / "reads.fa")])
    assert want.returncode == 0 and want.stdout, want.stderr.decode()
    return fmd, want.stdout


def _positions(f, nb_local: int, S: int) -> np.ndarray:
    """k from a seed, 0, n, and both sides of every S-block and shard boundary."""
    rng = np.random.default_rng(12)
    edges = np.concatenate([np.arange(0, f.n + 1, S), np.arange(0, f.n + 1, 64 * nb_local)])
    k = np.concatenate([rng.integers(0, f.n + 1, 3000), [0, f.n], edges - 1, edges, edges + 1])
    return np.unique(np.clip(k, 0, f.n)).astype(np.int64)


def test_sharded_rank_matches_jax_psum(n_index, monkeypatch):
    """rank6_sharded_plain on every view of a 2x4 mesh equals the JAX
    rank1a_local psum'd over `idx` (ropebwt3_tpu/parallel/mesh.py) on a 2x4
    mesh of virtual devices, for dense32, dense64 (megablocks of 8 rows) and
    rb at S 256 and 512, at random k, 0, n and every block and shard edge.
    At k = n on rb rows (S divides n) the JAX rank drops the last block
    (F1): there the port equals the dense rank and the JAX one does not."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from ropebwt3_tpu.ops import rank as jrank
    from ropebwt3_tpu.ops import runblock as jrb
    from ropebwt3_tpu.parallel import mesh as jmesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    f = n_index
    monkeypatch.setattr(jrank, "MEGA_BLOCK_SHIFT", MEGA)
    ports = {
        "dense32": trank.OccIndex.from_dense(f, "cpu"),
        "dense64": trank.OccIndex.from_dense(f, "cpu", int64=True, mega_shift=MEGA),
        "rb256": trb.RunBlockIndex.from_dense(f, "cpu", S=256, cache=None),
        "rb512": trb.RunBlockIndex.from_dense(f, "cpu", S=512, cache=None),
    }
    sharded = {name: ShardedRows(x, make_mesh(2, 4, CPU8)) for name, x in ports.items()}
    assert sharded["dense32"].nb % 4 and not sharded["rb256"].nb % 4
    tables, specs, statics = [], [], []
    for name, int64 in (("dense32", False), ("dense64", True)):
        occf, mega = jrank.build_occf(f, int64=int64)
        assert np.array_equal(occf, ports[name].occf.numpy())
        pad = np.zeros((sharded[name].nb_local * 4, 12), np.int32)
        pad[: len(occf)] = occf
        tables.append((pad,) if mega is None else (pad, mega))
        specs.append((P("idx", None),) if mega is None else (P("idx", None), P()))
        statics.append(None)
    for S in (256, 512):
        d = jrb.from_dense_np(f, S=S, cache=None)
        lay = jrb.shard_layout_np(d, 4)
        assert lay["nb_local"] == sharded[f"rb{S}"].nb_local
        tables.append((lay["rows"], lay["esc"], np.zeros((1, 6), np.int32)))
        specs.append((P("idx", None), P("idx", None), P()))
        statics.append((S, len(d["rows"])))
    names = list(ports)
    k = _positions(f, sharded["dense32"].nb_local, 256)
    nbl = [sharded[name].nb_local for name in names]

    def inner(ts, k32, k64):
        return tuple(jax.lax.psum(jmesh.rank1a_local(t, nl, k64 if name == "dense64" else k32,
                                                     jnp.int64 if name == "dense64" else jnp.int32, rb=rb), "idx")
                     for t, nl, name, rb in zip(ts, nbl, names, statics))

    jm = jmesh.make_mesh(2, 4)
    fn = jax.jit(shard_map(inner, mesh=jm, in_specs=(tuple(specs), P(), P()), out_specs=(P(),) * 4, check_rep=False))
    got = fn(tuple(tuple(jnp.asarray(a) for a in t) for t in tables), jnp.asarray(k, jnp.int32),
             jnp.asarray(k, jnp.int64))
    kt = torch.from_numpy(k)
    dense = ports["dense32"].rank1a(kt).numpy()
    for name, want in zip(names, got):
        want = np.asarray(want).astype(np.int64)
        for v in sharded[name].views:
            port = rank6_sharded_plain(v, kt).numpy()
            m = len(k) - 1 if name.startswith("rb") else len(k)
            if m < len(k):  # F1: the JAX rank at k = n drops the last block
                assert not np.array_equal(want[m], dense[m]) and np.array_equal(port[m], dense[m])
            assert np.array_equal(port[:m], want[:m]), (name, v.dp_row)
        assert np.array_equal(rank6_sharded_plain(sharded[name].views[0], kt).numpy(), dense)


def whole(rows: torch.Tensor) -> torch.Tensor:
    """The host tensor that a slab's rows are a view of: the whole range."""
    return torch.empty(0, dtype=torch.int32).set_(rows.untyped_storage()).view(-1, rows.shape[1])


def test_ownership_and_pad_rows(n_index):
    """Every rank reads a real row of the slab that owns it: on rb rows the
    row of k = n is the last real one (F1: the JAX package's ownership clamp
    has nothing to do); the range's pad rows past the last real one carry
    no escape, and each slab's escapes start at its own aligned offset."""
    x = trb.RunBlockIndex.from_dense(n_index, "cpu", S=512, cache=None)
    sh = ShardedRows(x, make_mesh(1, 3, ["cpu"] * 3), unit=3)  # 32 rows in slabs of 12 (8 real in the last): one pad row
    v = sh.views[0]
    assert int(block_of(v, torch.tensor(n_index.n))) == sh.nb - 1
    assert sh.nb_local == 12 and [x.rows.shape[0] for x in v.slabs] == [12, 12, 8]
    full = whole(v.slabs[2].rows)
    assert full.shape[0] - sh.nb == 1 and int(full[-1, 6]) == -1 and not full[-1, :6].any()
    for s, slab in enumerate(v.slabs):
        ids = slab.rows[slab.rows[:, 6] >= 0, 6]
        assert torch.equal(ids, torch.arange(slab.esc_first, slab.esc_first + ids.numel(), dtype=ids.dtype))
        assert slab.esc.shape[0] == ids.numel()


# the unsharded rank of occ.cuh (Dense<T>) and rb.cuh (Rb<T>) for the host,
# as the card runs it over a mapped range: the view's base pointers
MAPPED_HOST = r"""
template <class L>
static void rank_all(const int* rows, const int* esc, const int64_t* mega, const void* acc, int ms, int bs,
                     const int64_t* k, int64_t n, typename L::T* out) {
  const L ix{rb3c::Tables{rows, esc, mega, acc, ms, bs}};
  for (int64_t i = 0; i < n; ++i) ix.rank6((typename L::T)k[i], out + 6 * i);
}
#define X(name, L)                                                                                               \
  extern "C" void rank_##name(const int* r, const int* e, const int64_t* m, const void* a, int ms, int bs,       \
                              const int64_t* k, int64_t n, void* o) {                                           \
    rank_all<L>(r, e, m, a, ms, bs, k, n, static_cast<L::T*>(o));                                               \
  }
RB3C_LAYOUTS(X)
"""


@pytest.fixture(scope="module")
def mapped_host(tmp_path_factory):
    """csrc/occ.cuh's and rb.cuh's rank, built for the host with g++."""
    d = tmp_path_factory.mktemp("mapped_host")
    (d / "mapped_host.cpp").write_text(HOST_SHIM[: HOST_SHIM.index('#include "rb.cuh"') + 18] + MAPPED_HOST)
    so = d / "libmapped_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so),
                        str(d / "mapped_host.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


def make_layout(f, layout: str):
    """n_index's rows in `layout`: dense64 in megablocks of 8 rows, rb32 at S 256, rb64 at S 512."""
    return {"dense32": lambda: trank.OccIndex.from_dense(f, "cpu"),
            "dense64": lambda: trank.OccIndex.from_dense(f, "cpu", int64=True, mega_shift=MEGA),
            "rb32": lambda: trb.RunBlockIndex.from_dense(f, "cpu", S=256, cache=None),
            "rb64": lambda: trb.RunBlockIndex.from_dense(f, "cpu", S=512, int64=True, mega_shift=2, cache=None)}[layout]()


def host_tables(v) -> list:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    rows, esc, mega, acc, ms, bs = v.kernel_tables()
    return [vp(rows), vp(esc), vp(mega), vp(acc), i32(ms), i32(bs)]


@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32", "rb64"])
@pytest.mark.parametrize("n_idx", [1, 3, 8])
def test_mapped_rank_on_the_host(mapped_host, n_index, layout, n_idx):
    """The card's rank (occ.cuh Dense / rb.cuh Rb, unsharded) over the
    mapped layout, built for the host and given the view's base pointers
    into one host buffer of slabs in units of 3 rows (escapes rebased),
    equals rank6_sharded_plain and the unsharded rank at every k in [0, n],
    over 1, 3 (uneven tails) and 8 slabs."""
    f = n_index
    x = make_layout(f, layout)
    v = ShardedRows(x, make_mesh(1, n_idx, ["cpu"] * n_idx), unit=3).views[-1]
    k = torch.arange(f.n + 1)
    out = torch.empty((f.n + 1, 6), dtype=v.dtype)
    getattr(mapped_host, f"rank_{layout}")(*host_tables(v), ctypes.c_void_p(k.data_ptr()), ctypes.c_int64(f.n + 1),
                                           ctypes.c_void_p(out.data_ptr()))
    want = rank6_sharded_plain(v, k)
    assert torch.equal(out.long(), want) and torch.equal(want, x.rank1a(k))


@pytest.fixture(scope="module")
def mapped_lanes_host(tmp_path_factory):
    """csrc/smem_tg.cu's lane routine (Dense / Rb), built for the host with g++."""
    from .test_torch_smem import SMEM_HOST_SRC

    d = tmp_path_factory.mktemp("mapped_lanes")
    (d / "mapped_lanes.cpp").write_text(SMEM_HOST_SRC)
    so = d / "libmapped_lanes.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so),
                        str(d / "mapped_lanes.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32", "rb64"])
def test_mapped_lane_routine_on_the_host(mapped_lanes_host, n_index, layout):
    """smem_tgc's lane routine over the mapped rows of a 2x4 mesh (the last
    view; slabs in units of 3 rows), built for the host: each lane's rows,
    counts, START log and trips equal smem_tg_plain's over
    rank6_sharded_plain and over the unsharded rows, on reads with N runs
    (ranks at k = n, which S divides)."""
    from ropebwt3_tpu_torch.ops.smem import chunk_lanes, lane_order, smem_tg_plain

    from .test_torch_smem import assert_same_chains, host_chains

    f = n_index
    x = make_layout(f, layout)
    v = ShardedRows(x, make_mesh(2, 4, CPU8), unit=3).views[-1]
    rng = np.random.default_rng(4)
    seq, _ = f.retrieve(0)  # reads: pieces of the first sequence (with its N runs), then one of N's
    reads = []
    for _ in range(3):
        ln = int(rng.integers(80, 400))
        st = int(rng.integers(0, len(seq) - ln))
        reads.append(seq[st : st + ln].copy())
    reads.append(np.full(30, 5, np.uint8))
    flat, off = (torch.from_numpy(a) for a in pack_reads(reads))
    lanes = chunk_lanes(off, 64, 32)
    order = lane_order(lanes, off)
    kw = dict(min_occ=1, min_len=19, max_mems=8)
    got = host_chains(mapped_lanes_host, v, flat, off, lanes, order, log_len=16, **kw)
    for idx in (v, x):
        assert_same_chains(got, smem_tg_plain(idx, flat, off, lanes=lanes, log_len=16, **kw), 8, 16)


@pytest.mark.parametrize("unit", [1, 3, 64])
@pytest.mark.parametrize("layout", ["dense32", "dense64", "rb32", "rb64"])
def test_mapped_layout(n_index, layout, unit):
    """The layout ShardedRows maps (one host buffer on the CPU), over a 1x4
    mesh in units of 1, 3 and 64 rows: slabs of nb_local rows, a multiple
    of the unit; every real row at its global offset, equal to the
    unsharded row (rb: but column 6); the tail's pad rows carry no escape;
    each slab's escapes start at a multiple of the escape alignment past the
    slab before, its rows' column 6 points at its own sub-rows, equal to the
    unsharded escape's; and rank6_sharded_plain over the slabs equals the
    unsharded rank."""
    f = n_index
    x = make_layout(f, layout)
    sh = ShardedRows(x, make_mesh(1, 4, ["cpu"] * 4), unit=unit)
    v = sh.views[0]
    table = x.rows if sh.is_rb else x.occf
    nbl = sh.nb_local
    assert sh.unit == unit and nbl == -(-(-(-sh.nb // 4)) // unit) * unit
    full = whole(v.slabs[0].rows)
    assert full.shape[0] == -(-sh.nb // unit) * unit  # the last slab's rows rounded up to the unit
    pad, real = full[sh.nb :], full[: sh.nb]
    if sh.is_rb:
        assert bool((pad[:, 6] == -1).all()) and not pad[:, :6].any()
    else:
        assert not pad.any()
    if sh.is_rb:
        assert torch.equal(real[:, torch.arange(40) != 6], table[:, torch.arange(40) != 6])
        assert torch.equal(real[:, 6] >= 0, table[:, 6] >= 0)
        esc_b = 64 * x.esc.shape[1]
        align = math.lcm(esc_b, unit * 160) // esc_b
        end = 0
        for s, slab in enumerate(v.slabs):
            assert slab.first == s * nbl and slab.rows.shape[0] == max(0, min(nbl, sh.nb - s * nbl))
            assert slab.esc_first % align == 0 and slab.esc_first == -(-end // align) * align
            has = slab.rows[:, 6] >= 0
            mine = slab.rows[has, 6].long()
            assert torch.equal(mine, torch.arange(slab.esc_first, slab.esc_first + mine.numel()))
            assert torch.equal(v.esc[mine], x.esc[table[s * nbl : s * nbl + slab.rows.shape[0]][has, 6].long()])
            if mine.numel():  # the slab's own tensors are views of the range at its offsets
                assert slab.rows.data_ptr() == full[s * nbl :].data_ptr()
                assert slab.esc.data_ptr() == v.esc[slab.esc_first :].data_ptr()
            end = slab.esc_first + mine.numel()
    else:
        assert torch.equal(real, table)
    k = torch.arange(f.n + 1)
    assert torch.equal(rank6_sharded_plain(v, k), x.rank1a(k))


def test_split_reads_keeps_reads_whole():
    """Shares end at read boundaries, balanced by symbols; empty batches and shares work."""
    off = np.array([0, 10, 10, 40, 41, 100])
    assert split_reads(off, 4).tolist() == [0, 3, 5, 5, 5]  # boundaries at or past 25, 50, 75 symbols
    assert split_reads(np.zeros(1, np.int64), 3).tolist() == [0, 0, 0, 0]
    assert split_reads(off, 1).tolist() == [0, 5]


@pytest.mark.parametrize("occ", ["dense", "rb"])
def test_sharded_engine_matches_jax_sharded_smem(corpus, corpus_index, occ):
    """The port's engine over a 2x4 mesh (the reads split over all eight
    views) equals `smem_sharded_fn` over the JAX ShardedIndex (reads over
    dp, rows over idx, rb at S 256) and the port's unsharded engine, read by
    read, exact."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ropebwt3_tpu.parallel.mesh import ShardedIndex
    from ropebwt3_tpu.parallel.mesh import make_mesh as jax_mesh
    from ropebwt3_tpu.parallel.smem_sharded import smem_sharded_fn

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    f = corpus_index
    reads = [char2nt6(r.seq) for r in read_seqs(str(corpus / "reads.fa"))][:16]
    Q, L = 16, 256
    q = np.zeros((Q, L), np.uint8)
    qlen = np.array([len(r) for r in reads], np.int32)
    for t, r in enumerate(reads):
        q[t, : len(r)] = r
    jm = jax_mesh(2, 4)
    sidx = ShardedIndex.from_dense(f, jm, occ=occ, rb_S=256 if occ == "rb" else None)
    step = smem_sharded_fn(sidx, min_occ=1, min_len=21, max_mems=64, max_iters=4 * L + 64)
    mems, n_mem, _ = step(jax.device_put(q, NamedSharding(jm, P("dp", None))), jax.device_put(qlen, NamedSharding(jm, P("dp"))))
    mems, n_mem = np.asarray(mems), np.asarray(n_mem)
    flat, off = pack_reads(reads)
    eng = BatchedSmemTG(f, 1, 21, device="cpu", occ=occ, mesh=make_mesh(2, 4, CPU8))
    assert eng.idx.layout == ("dense32" if occ == "dense" else "rb32")
    counts, rows = eng.run_flat(flat, off)
    assert np.array_equal(counts, n_mem)
    got = np.split(rows.astype(np.int64), np.cumsum(counts)[:-1])
    for t in range(Q):
        assert np.array_equal(got[t], mems[t, : n_mem[t], :5].astype(np.int64)), t
    c0, r0 = BatchedSmemTG(f, 1, 21, device="cpu", occ=occ).run_flat(flat, off)
    assert np.array_equal(c0, counts) and np.array_equal(r0, rows)


@pytest.mark.parametrize("occ", ["dense", "rb"])
def test_cli_mem_mesh_matches_native(corpus, mesh_fmd, occ):
    """`mem --device=cpu --mesh=2x4 -l21` (and --occ=rb) is byte-equal to
    `python -m ropebwt3_tpu mem --engine=native`, on the sharded rows."""
    fmd, want = mesh_fmd
    got = _run("ropebwt3_tpu_torch", ["mem", "--device=cpu", "--mesh=2x4", f"--occ={occ}", "-l21", str(fmd),
                                      str(corpus / "reads.fa")])
    assert got.returncode == 0, got.stderr.decode()
    assert got.stdout == want
    lay = "dense32" if occ == "dense" else "rb32"
    assert f"occ layout {lay} ({lay} rows sharded over a 2x4 mesh".encode() in got.stderr


@pytest.mark.parametrize("cmd", ["sw", "hapdiv"])
def test_cli_dp_mesh_matches_unsharded(corpus, mesh_fmd, tmp_path, cmd):
    """`sw` and `hapdiv --device=cpu --mesh=2` (the reads or windows split
    over two devices, the rows replicated once) are byte-equal to the same
    commands without --mesh."""
    fmd, _ = mesh_fmd
    if cmd == "sw":
        fa = tmp_path / "r.fa"
        fa.write_text("".join(open(corpus / "reads.fa").readlines()[:6]))
    else:
        rec = next(iter(read_seqs(str(corpus / "genomes.fa"))))
        fa = tmp_path / "h.fa"
        fa.write_text(f">{rec.name}\n{rec.seq[:151]}\n")
    want = _run("ropebwt3_tpu_torch", [cmd, "--device=cpu", str(fmd), str(fa)])
    got = _run("ropebwt3_tpu_torch", [cmd, "--device=cpu", "--mesh=2", str(fmd), str(fa)])
    assert want.returncode == 0 and got.returncode == 0, got.stderr.decode()
    assert want.stdout and got.stdout == want.stdout
    assert b"over 2 devices (cpu, cpu), the rows replicated on 1" in got.stderr


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_mem(corpus, mesh_fmd):
    """Two processes (WORLD_SIZE=2, a gloo group on localhost) run `mem
    --device=cpu --mesh=2x1`: each its half of the batch, process 0 writes
    the whole BED byte-equal to native, process 1 writes nothing."""
    fmd, want = mesh_fmd
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    argv = [sys.executable, "-m", "ropebwt3_tpu_torch", "mem", "--device=cpu", "--mesh=2x1", "-l21", str(fmd),
            str(corpus / "reads.fa")]
    procs = [subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1].decode()[-2000:] for o in outs]
    assert outs[0][0] == want and outs[1][0] == b""
    assert b"over a 1x1 mesh" in outs[1][1]


def test_make_mesh_never_wraps():
    """A mesh of more cards than the machine has stops, naming both counts;
    a mesh of the CPU and a card stops; the idx axis has no limit (the rows
    are one range, not a shard table)."""
    have = torch.cuda.device_count()
    with pytest.raises(MeshError, match=f"needs {have + 1} CUDA cards; this machine has {have}"):
        make_mesh(have + 1, 1)
    with pytest.raises(MeshError, match="not both"):
        make_mesh(1, 2, ["cpu", "cuda:0"])
    assert make_mesh(1, 9, ["cpu"] * 9).idx == 9
