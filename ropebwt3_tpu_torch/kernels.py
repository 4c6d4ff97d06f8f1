"""The port's CUDA kernels: built from csrc/ with nvcc on first use, loaded
with ctypes.

Each `.cu` file under csrc/ compiles to an object with its own nvcc, all
started together; one more nvcc links them into ONE shared library with a
plain C interface (no PyTorch headers: nvcc takes seconds, not minutes).  The
build lands in `_build/` next to this file, keyed on a hash of the sources and
the flags, the same build-on-demand pattern as the port's native/.  Nothing
is built or loaded when this module is imported; `lib()` does it.

Every entry point takes PyTorch's current CUDA stream, allocates nothing, and
returns `cudaGetLastError()` after its launch; `launch` raises on non-zero,
`call` returns the code (the shared-memory capacity probe reports a refusal).
The queries `rb3c_smem_optin`, `rb3c_occupancy_*` (the SMEM, DP,
merge-rank and suffix kernels' resident blocks an SM) and
`rb3c_sa_sort_status_len` take no stream; the DP kernels' `rb3c_timed_*` twins
also write lane 0's phase clocks (ropebwt3_tpu_torch/dp_time.py reads both).
The rank, LF-step and SMEM kernels (smem_tg: one thread per read; smem_tgc:
one thread per lane of a chunked read) come in one variant per occ layout:
dense32 and dense64 (ops/rank.py `OccIndex`), rb32 and rb64 (ops/runblock.py
`RunBlockIndex`, or a mesh's rows mapped into one range, parallel/mesh.py
`ShardView`), and so do `suffix`'s backward search and `get`'s LF walk (its
three walking passes; csrc/walk.cu), ssa_gen's walk (its pass 1 over a
range of the segments) and finish, and `kount`'s level rank
(csrc/kount.cu), and merge_rank (a range of the segments and the passes to
run; rb rows since a merge's B1 may live in host memory); the hapdiv DP
(one warp a window) and the sw DP (one warp a read) come in the two dense
ones.
These take the index's tables first, as the index's `kernel_tables()` gives
them: rows, escape sub-rows, megablock bases, acc, the megablock shift and
log2 of the block size.  ssa_gen's finish pass and its pointer-jumping pass
read no rows (`get` ranks its segments with that same pointer-jumping
pass).  The
probes of csrc/probe.cu take a plain int32 table (probe.py); the suffix
sort's passes of csrc/sa_round.cu and its radix sort, csrc/sa_sort.cu, take
plain arrays (construct/sa.py).  The `rb3c_vmm_*` calls of csrc/vmm.cu
(the mesh's virtual mapping, parallel/mesh.py) take no stream and return a
CUresult or CUDA runtime code, which `rb3c_vmm_error` names.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LAYOUTS = ("dense32", "dense64", "rb32", "rb64")

_V, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_TABLES = [_V, _V, _V, _V, _I32, _I32]  # rows, esc, mega, acc, mega_shift, log2 block
# argtypes of every entry point, stream last: without them ctypes passes
# Python ints as 32-bit C ints and cuts pointers and int64 counts
_ENTRIES = {}
for _lay in LAYOUTS:
    _ENTRIES[f"rb3c_occ_rank1a_{_lay}"] = [*_TABLES, _V, _I64, _V, _V]
    _ENTRIES[f"rb3c_occ_extend_c_{_lay}"] = [*_TABLES, _V, _V, _V, _I64, _V, _V]
    _ENTRIES[f"rb3c_smem_tg_{_lay}"] = [*_TABLES, _V, _V, _I64, _I32, _I32, _I32, _V, _V, _V, _V]
    _ENTRIES[f"rb3c_smem_tgc_{_lay}"] = [*_TABLES, _V, _V, _V, _V, _I64, *[_I32] * 4, *[_V] * 7]
    _ENTRIES[f"rb3c_suffix_walk_{_lay}"] = [*_TABLES, _V, _V, _I64, _V, _V, _V]
    _ENTRIES[f"rb3c_occupancy_suffix_walk_{_lay}"] = [_V, _V, _V]  # no stream
    _ENTRIES[f"rb3c_occupancy_smem_tg_{_lay}"] = [_I32, _V, _V, _V]  # no stream: smem_tgc (1) or smem_tg (0)
    _ENTRIES[f"rb3c_occ_lf_{_lay}"] = [*_TABLES, _V, _I64, _V, _V, _V]
    _ENTRIES[f"rb3c_retrieve_seg_walk_{_lay}"] = [*_TABLES, _V, _I64, _I64, _I32, _I64, _V, _V, _V]
    _ENTRIES[f"rb3c_retrieve_seg_write_{_lay}"] = [*_TABLES, _V, _I64, _I64, _I32, _I64, _V, _V, _V, _V, _V, _I64, _V, _V]
    _ENTRIES[f"rb3c_retrieve_seg_cycle_{_lay}"] = [*_TABLES, _V, _V, _I64, _I64, _V, _V, _V, _V]
    _ENTRIES[f"rb3c_ssa_walk_{_lay}"] = [*_TABLES, _I64, _I32, _I32, _I64, _I64, _I64, _V, _V, _V, _V]
    _ENTRIES[f"rb3c_ssa_finish_{_lay}"] = [_V, _I64, _I64, _I64, _V, _V, _V, _V, _V, _V]
    _ENTRIES[f"rb3c_kount_rank_{_lay}"] = [*_TABLES, _V, _V, _I64, _V, _V, _V]
    # a range of the segments [g0, g1) and the passes to run (1, 2 or both) before seg
    _ENTRIES[f"rb3c_merge_rank_{_lay}"] = [*_TABLES, _V, _V, _I64, _I32, _I64, _I64, _I64, _I64, _I32, _V, _V]
    _ENTRIES[f"rb3c_occupancy_merge_rank_{_lay}"] = [_I32, _V, _V, _V]  # no stream: pass 1's (0) or pass 2's (1)
for _lay in LAYOUTS[:2]:
    _ENTRIES[f"rb3c_hapdiv_{_lay}"] = [*_TABLES, _V, _I64, *[_I32] * 8, _V, _V, _V, _V, _V, _V, _V]
    _ENTRIES[f"rb3c_sw_{_lay}"] = [*_TABLES, _V, _V, _V, _V, _I64, *[_I32] * 8, *[_V] * 10]
    # the DP kernels' timing-only twins (lane 0's phase clocks, clk last)
    _ENTRIES[f"rb3c_timed_hapdiv_{_lay}"] = [*_TABLES, _V, _I64, *[_I32] * 8, *[_V] * 8]
    _ENTRIES[f"rb3c_timed_sw_{_lay}"] = [*_TABLES, _V, _V, _V, _V, _I64, *[_I32] * 8, *[_V] * 11]
    for _k in ("hapdiv", "sw"):  # no stream: attributes of the kernel at an n_best
        _ENTRIES[f"rb3c_occupancy_{_k}_{_lay}"] = [_I32, _V, _V, _V]
_ENTRIES["rb3c_ssa_jump"] = [_V, _I64, _I32, _V]
_ENTRIES["rb3c_sa_keys"] = [_V, _I64, _I64, _V, _V]
_ENTRIES["rb3c_sa_keys_packed"] = [_V, _I64, _I64, _I32, _I32, _V, _V]
_ENTRIES["rb3c_sa_flags"] = [_V, _V, _I64, _V, _V]
_ENTRIES["rb3c_sa_flags_packed"] = [_V, _I64, _I32, _V, _V]
_ENTRIES["rb3c_sa_sort"] = [_V, _V, _V, _V, _V, _I64, _I32, _I32, _V, _V, _I64, _V]
for _name in ("rb3c_sa_scatter", "rb3c_sa_scatter_packed", "rb3c_sa_bwt", "rb3c_sa_bwt_packed"):
    _ENTRIES[_name] = [_V, _V, _I64, _V, _V]
for _name in ("rb3c_probe_smem_gather", "rb3c_probe_hbm_gather"):
    _ENTRIES[_name] = [_V, _I32, _I32, _I32, _V, _I32, _I32, _V, _V]
_ENTRIES["rb3c_probe_smem_capacity"] = [_I32, _V, _V]
_ENTRIES["rb3c_smem_optin"] = [_I32]  # no stream: a device attribute
# the virtual mapping of csrc/vmm.cu (no stream; sizes, pointers and handles as uint64)
_U64, _P = ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)
_PI = ctypes.POINTER(ctypes.c_int)
_ENTRIES.update({"rb3c_vmm_granularity": [_I32, _I32, _P], "rb3c_vmm_can_access": [_I32, _I32, _PI],
                 "rb3c_vmm_handle_fd_ok": [_I32, _PI], "rb3c_vmm_reserve": [_U64, _U64, _P],
                 "rb3c_vmm_create": [_I32, _U64, _I32, _P], "rb3c_vmm_export": [_U64, _PI],
                 "rb3c_vmm_import": [_I32, _P], "rb3c_vmm_map": [_U64, _U64, _U64], "rb3c_vmm_release": [_U64],
                 "rb3c_vmm_access": [_U64, _U64, _V, _I32], "rb3c_vmm_free": [_U64, _U64, _U64, _V, _I32]})

_lib = None
_COUNT = threading.Lock()


def count(counter, key: str) -> None:
    """counter[key] += 1, under a lock: a mesh launches from one thread a card."""
    with _COUNT:
        counter[key] += 1


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the output of the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    for cmd, (out, rc) in zip(cmds, outs):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) on {cmd[-1]}:\n{out}")


def build() -> str:
    """Compile csrc/*.cu into `_build/librb3c_<hash>.so` unless that file
    exists; return its path.  Raises with nvcc's output if compilation fails."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as fh:
            h.update(os.path.basename(p).encode() + b"\0" + fh.read())
    tag = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"librb3c_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # concurrent builds never share a path
    tmp = f"{so}.tmp.{os.getpid()}"
    objs = {p: os.path.join(BUILD_DIR, f"{os.path.basename(p)}.{tag}.{os.getpid()}.o") for p in srcs if p.endswith(".cu")}
    nvcc = _nvcc()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", o, p] for p, o in objs.items()])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs.values()]])
        os.replace(tmp, so)
    finally:
        for f in (tmp, *objs.values()):
            if os.path.exists(f):
                os.unlink(f)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        dll = ctypes.CDLL(build())
        for name, argtypes in _ENTRIES.items():
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        dll.rb3c_sa_sort_status_len.argtypes = [_I64]  # no stream: a size
        dll.rb3c_sa_sort_status_len.restype = ctypes.c_int64
        dll.rb3c_error_string.argtypes = [ctypes.c_int]
        dll.rb3c_error_string.restype = ctypes.c_char_p
        dll.rb3c_vmm_error.argtypes = [ctypes.c_int]
        dll.rb3c_vmm_error.restype = ctypes.c_char_p
        _lib = dll
    return _lib


def call(name: str, device, *args) -> int:
    """Call entry point `name` with `args` on `device`, on PyTorch's current
    stream there; return its CUDA error code (0: launched)."""
    import torch

    with torch.cuda.device(device):
        return getattr(lib(), name)(*args, torch.cuda.current_stream(device).cuda_stream)


def error_string(err: int) -> str:
    return lib().rb3c_error_string(err).decode()


def vmm(name: str, *args) -> None:
    """Call csrc/vmm.cu's `rb3c_vmm_<name>`; raise a MeshError, naming the
    call and the CUDA code, if it fails: no fallback."""
    err = getattr(lib(), f"rb3c_vmm_{name}")(*args)
    if err != 0:
        from .parallel import MeshError

        raise MeshError(f"rb3c_vmm_{name}: CUDA error {err}: {lib().rb3c_vmm_error(err).decode()}")


def launch(name: str, device, *args) -> None:
    """`call`, raising if the launch was refused."""
    err = call(name, device, *args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {error_string(err)}")
