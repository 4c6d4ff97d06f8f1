"""The port's mesh (K10): occ rows sharded over the `idx` axis and read where
they lie (mesh.py, csrc/occ.cuh Sharded), reads and windows split over every
device (smem_sharded.py, align/cli_hooks.py), the segments of `build`'s merge
rank and `ssa`'s walk split over every device (construct/merge.py
merge_rank_mesh, ssa_ops.py ssa_gen_mesh), and dp and idx across processes
through torch.distributed (launch.py), each slab of a dp row that spans
processes mapped from its owner (ipc.py)."""


class MeshError(ValueError):
    """A mesh that cannot be built as asked: one ERROR line on the CLI."""
