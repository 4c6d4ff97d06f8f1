"""ropebwt3_tpu_torch — the PyTorch / CUDA port of ropebwt3_tpu.

The port runs ropebwt3's commands (`build`, `merge`, `mem`, `sw`,
`hapdiv`, `ssa`, `get`, `suffix`, `kount`, ...) on an NVIDIA Hopper card:
the BWT and its occ rows live on the device as torch tensors and
hand-written CUDA kernels (csrc/) sort, merge, search and walk them;
`serve` (server.py) keeps them resident between commands.  It stands on its own host layer: the index formats,
the dense host index and its sidecar, the sequence readers, the native host
code and the CLI pieces it runs are copies of the JAX package's modules under
the same names (formats/, index/, seqio, nt6, bufio, log, native/).  It
imports nothing of `ropebwt3_tpu` and never imports jax.

Every function takes its device explicitly; nothing here picks one.
"""

__version__ = "0.1.0"

# numpy's madvise(MADV_HUGEPAGE) makes first-touch page faults far slower on
# some virtualized hosts (ropebwt3_tpu/__init__.py measured 15-170 MB/s
# against ~2 GB/s without it): turn it off before any array is made, and for
# numpy in subprocesses too.
import os as _os

_os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
try:  # numpy private API, best effort
    import numpy as _np

    _np._core.multiarray._set_madvise_hugepage(False)
except Exception:
    pass
