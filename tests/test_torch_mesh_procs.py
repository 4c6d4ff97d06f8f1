"""An idx axis across processes, on the CPU: two processes (WORLD_SIZE=2, a
gloo group on localhost) hold the slots of one global `--mesh`, each
creates and fills the slabs of its own slots in a memfd, and every process
of a dp row maps the others' from their owners (parallel/mesh.py
ShardedRows, parallel/ipc.py), as the card maps the slabs' exported VMM
handles.  The processes import no JAX and nothing of the JAX package.

`mem` over 1x2 (dense and rb rows) and 3x2 (a process holding part of two
dp rows) writes process 0's BED byte-equal to the JAX package's `mem
--engine=native`; `build -m 20000 --mesh=1x2` writes each process's FMD
byte-equal to the JAX package's `build -do` (three merges, each over slabs
of both processes); `rank6_sharded_plain` over each process's view of a
1x2 row is exact against the numpy `DenseFMIndex.rank1a` at 0, n and every
block and slab edge; a slab that one process cannot export stops both.
The layouts of a process's share and the host check are pure functions."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ropebwt3_tpu.cli import load_index
from ropebwt3_tpu_torch.parallel import MeshError, ipc, launch
from ropebwt3_tpu_torch.parallel.mesh import process_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_JAX = "import sys\nsys.modules['jax'] = None\nsys.modules['ropebwt3_tpu'] = None\n"
CLI = NO_JAX + "from ropebwt3_tpu_torch.cli import main\nsys.exit(main(sys.argv[1:]))\n"
RANK = NO_JAX + """import numpy as np, torch
from ropebwt3_tpu_torch.cli import load_index
from ropebwt3_tpu_torch.ops.rank import OccIndex
from ropebwt3_tpu_torch.ops.runblock import RunBlockIndex
from ropebwt3_tpu_torch.parallel import launch
from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, rank6_sharded_plain
fmd, npz, lay = sys.argv[1:4]
f = load_index(fmd)
x = {"dense32": lambda: OccIndex.from_dense(f, "cpu"),
     "dense64": lambda: OccIndex.from_dense(f, "cpu", int64=True, mega_shift=3),
     "rb256": lambda: RunBlockIndex.from_dense(f, "cpu", S=256, cache=None)}[lay]()
mesh = launch.local_mesh("1x2", "cpu")
launch.init()
sh = ShardedRows(x, mesh)
d = np.load(npz)
got = rank6_sharded_plain(sh.views[0], torch.from_numpy(d["k"])).numpy()
real = [s.rows.shape[0] for s in sh.views[0].slabs]
print(int(np.array_equal(got, d["want"])), real[0], real[1], len(sh.imported), sh.nb_local)
del sh, x
launch.finish()
"""


FAIL_EXPORT = NO_JAX + """import os
from ropebwt3_tpu_torch.parallel import MeshError, mesh
from ropebwt3_tpu_torch.cli import main
def refuse(self):
    raise MeshError("no descriptor for this slab")
if os.environ["RANK"] == "1":
    mesh._HostPhys.export = refuse
sys.exit(main(sys.argv[1:]))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two(argv: list[str], timeout: int = 120) -> list[tuple[int, bytes, str]]:
    """`python -c <code> argv` in two processes of one gloo group, each with
    jax and the JAX package unimportable: (exit code, stdout, stderr) each;
    a process's `$RANK` in argv becomes its rank."""
    env = dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), RB3TPU_STRICT_EXIT="1")
    procs = [subprocess.Popen([sys.executable, "-c", *[a.replace("$RANK", str(r)) for a in argv]], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    outs = [p.communicate(timeout=timeout) for p in procs]
    return [(p.returncode, o, e.decode()) for p, (o, e) in zip(procs, outs)]


def _jax(args) -> bytes:
    r = subprocess.run([sys.executable, "-m", "ropebwt3_tpu", *args], cwd=ROOT, capture_output=True,
                       env=dict(os.environ, PYTHONPATH="", JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr.decode()
    return r.stdout


@pytest.fixture(scope="module")
def mesh_fmd(corpus, tmp_path_factory):
    """The corpus FMD built by the JAX package, and `mem --engine=native -l21`'s BED of the reads."""
    fmd = tmp_path_factory.mktemp("torch_mesh_procs") / "idx.fmd"
    _jax(["build", "-do", str(fmd), str(corpus / "genomes.fa")])
    want = _jax(["mem", "--engine=native", "-l21", str(fmd), str(corpus / "reads.fa")])
    assert want
    return fmd, want


@pytest.mark.parametrize("spec,occ,imports", [
    ("1x2", "dense", {0: ["slab 1 of dp row 0 (rows"], 1: ["slab 0 of dp row 0 (rows"]}),
    ("1x2", "rb", {1: ["slab 0 of dp row 0 (rows", "slab 0 of dp row 0 (escape sub-rows"]}),
    ("3x2", "dense", {0: ["slab 1 of dp row 1 (rows"], 1: ["slab 0 of dp row 1 (rows"]}),
], ids=["1x2-dense", "1x2-rb", "3x2-dense"])
def test_mem_idx_across_two_processes(corpus, mesh_fmd, spec, occ, imports):
    """`mem --device=cpu --mesh=SPEC` over two processes: process 0's BED
    byte-equal to the JAX package's native engine, process 1's stdout
    empty; each process logs the slabs it mapped from the other (on rb rows
    the escapes' range too: the corpus's 16 rows at S 8192 all lie in slab
    0, so process 1 maps both of its pieces and process 0 nothing), and a
    3x2 mesh puts dp row 1 across the processes."""
    fmd, want = mesh_fmd
    outs = _two([CLI, "mem", "--device=cpu", f"--mesh={spec}", f"--occ={occ}", "-l21", str(fmd),
                 str(corpus / "reads.fa")])
    assert [o[0] for o in outs] == [0, 0], [o[2][-2000:] for o in outs]
    assert outs[0][1] == want and outs[1][1] == b""
    for r, (_, _, err) in enumerate(outs):
        got = [ln.split("imported ", 1)[1] for ln in err.splitlines() if "] imported slab" in ln]
        assert sorted(g.split(", ")[0] for g in got) == sorted(imports.get(r, [])), err[-2000:]
        assert f"from process {1 - r}" in err or not imports.get(r)
        lay = "dense32" if occ == "dense" else "rb32"
        assert f"smem_tg launches ({lay})" in err


def test_build_idx_across_two_processes(corpus, mesh_fmd, tmp_path):
    """`build --device=cpu -m 20000 --mesh=1x2 -do` over two processes (four
    batches, three merges, each merge's rank over B1's rows in one slab of
    each process): each process writes its own FMD, byte-equal to the JAX
    package's `build -do`."""
    fmd, _ = mesh_fmd
    outs = _two([CLI, "build", "--device=cpu", "-m", "20000", "--mesh=1x2", "-do", str(tmp_path / "p$RANK.fmd"),
                 str(corpus / "genomes.fa")])
    assert [o[0] for o in outs] == [0, 0], [o[2][-2000:] for o in outs]
    want = fmd.read_bytes()
    for r, (_, _, err) in enumerate(outs):
        assert (tmp_path / f"p{r}.fmd").read_bytes() == want
        assert err.count("merge rank over dense32 rows sharded over a 1x2 mesh") == 3
        assert err.count(f"] imported slab {1 - r} of dp row 0 (rows") == 3, err[-2000:]


@pytest.mark.parametrize("lay", ["dense32", "dense64", "rb256"])
def test_rank_over_slabs_of_two_processes(mesh_fmd, tmp_path, lay):
    """rank6_sharded_plain over each process's view of one 1x2 dp row (its
    own slab written, the other's mapped read-only from the other process)
    equals the numpy DenseFMIndex.rank1a at random k, 0, n and both sides
    of every 64-symbol block (so of every rb block at S 256 and of the slab
    edge); dense64 at megablocks of 8 rows."""
    fmd, _ = mesh_fmd
    f = load_index(str(fmd))
    rng = np.random.default_rng(3)
    edges = np.arange(0, f.n + 1, 64)
    k = np.unique(np.clip(np.concatenate([rng.integers(0, f.n + 1, 2000), [0, f.n], edges - 1, edges, edges + 1]),
                          0, f.n)).astype(np.int64)
    np.savez(tmp_path / "k.npz", k=k, want=f.rank1a(k).astype(np.int64))
    outs = _two([RANK, str(fmd), str(tmp_path / "k.npz"), lay])
    assert [o[0] for o in outs] == [0, 0], [o[2][-2000:] for o in outs]
    for _, out, _ in outs:
        ok, real0, real1, n_imported, nb_local = map(int, out.split())
        assert ok == 1 and real0 == nb_local and real1 > 0 and n_imported == 1
        assert any(k_ // (256 if lay == "rb256" else 64) == nb_local for k_ in k)  # the slab edge is ranked


def test_a_failed_export_stops_every_process(corpus, mesh_fmd):
    """No fallback: when one process cannot export its slab, both stop with
    the same one ERROR line naming the step and the process, write no
    BED, and exit nonzero under RB3TPU_STRICT_EXIT=1; neither waits on
    the other."""
    fmd, _ = mesh_fmd
    outs = _two([FAIL_EXPORT, "mem", "--device=cpu", "--mesh=1x2", "-l21", str(fmd), str(corpus / "reads.fa")])
    for rc, out, err in outs:
        errors = [ln for ln in err.splitlines() if ln.startswith("[E::") or "ERROR" in ln]
        assert rc != 0 and out == b"" and len(errors) == 1, err[-2000:]
        assert "sharing the mesh's slabs (export): process 1: no descriptor for this slab" in errors[0]


@pytest.mark.parametrize("dp,idx,size,grids", [
    (2, 1, 2, [(0, [["cpu"]]), (1, [["cpu"]])]),  # whole rows: dp across processes
    (1, 2, 2, [(0, [["cpu", None]]), (0, [[None, "cpu"]])]),  # one row across both
    (3, 2, 2, [(0, [["cpu", "cpu"], ["cpu", None]]), (1, [[None, "cpu"], ["cpu", "cpu"]])]),  # part of two rows
    (2, 3, 3, [(0, [["cpu", "cpu", None]]), (0, [[None, None, "cpu"], ["cpu", None, None]]),
               (1, [[None, "cpu", "cpu"]])]),
], ids=["2x1-over-2", "1x2-over-2", "3x2-over-2", "2x3-over-3"])
def test_process_share_of_the_global_mesh(dp, idx, size, grids):
    """Each process holds dp x idx / world slots, row by row: its rows from
    row0, another process's slots None, their owners and the rows each
    process touches consistent across the processes."""
    m = dp * idx // size
    for rank, (row0, grid) in enumerate(grids):
        mesh = process_mesh(dp, idx, rank, m, ["cpu"] * m)
        assert mesh.row0 == row0 and [[None if d is None else str(d) for d in row] for row in mesh.grid] == grid
        assert list(mesh.rows_of(rank)) == list(range(row0, row0 + len(grid)))
        assert mesh.shared == any(d is None for row in grid for d in row)
        for r, row in enumerate(mesh.grid):
            for s, d in enumerate(row):
                assert (mesh.owner(row0 + r, s) == rank) == (d is not None)
        assert f"{len(grid)}x{idx} mesh of " in str(mesh)


def test_local_mesh_deals_out_the_global_spec(monkeypatch):
    """Under two processes `--mesh=1x2` gives each one slot of the one dp
    row (no refusal); a world that does not divide dp x idx is a MeshError."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    mesh = launch.local_mesh("1x2", "cpu")
    assert mesh.shared and str(mesh) == "1x2 mesh of process 0, cpu"
    with pytest.raises(MeshError, match=r"dp x idx \(3\) must be a multiple of the 2 processes"):
        launch.local_mesh("3x1", "cpu")


def test_a_dp_row_across_hosts_is_refused():
    """A dp row whose processes lie on two hosts stops with a MeshError
    that names ROADMAP item 12.4 (fabric handles); rows within one host pass."""
    ipc.check_one_host([{0, 1}, {2, 3}], ["a", "a", "b", "b"])
    with pytest.raises(MeshError, match=r"dp row 1 spans processes on 2 hosts \(a, b\).*item 12\.4"):
        ipc.check_one_host([{0}, {1, 2}], ["a", "a", "b"])
