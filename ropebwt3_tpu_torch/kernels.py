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
The rank and SMEM kernels (smem_tg: one thread per read; smem_tgc: one
thread per lane of a chunked read) come in one variant per occ layout: dense32 and
dense64 (ops/rank.py `OccIndex`), rb32 and rb64 (ops/runblock.py
`RunBlockIndex`); ssa_gen and merge_rank in the two dense ones.  Each takes
the index's tables first, as the index's `kernel_tables()` gives them: rows,
escape planes, megablock bases, acc, the megablock shift and log2 of the
block size.  The probes of csrc/probe.cu take a plain int32 table
(probe.py); the suffix sort's passes of csrc/sa_round.cu take plain arrays
(construct/sa.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

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
    _ENTRIES[f"rb3c_smem_tgc_{_lay}"] = [*_TABLES, _V, _V, _V, _I64, _I32, _I32, _I32, _I32, _V, _V, _V, _V, _V, _V]
for _lay in LAYOUTS[:2]:
    _ENTRIES[f"rb3c_ssa_gen_{_lay}"] = [*_TABLES, _I64, _I32, _V, _V, _V, _V, _V]
    _ENTRIES[f"rb3c_merge_rank_{_lay}"] = [*_TABLES, _V, _V, _I64, _I32, _I64, _I64, _V, _V]
_ENTRIES["rb3c_sa_keys"] = [_V, _I64, _I64, _I32, _V, _V]
_ENTRIES["rb3c_sa_flags"] = [_V, _V, _I64, _V, _V]
_ENTRIES["rb3c_sa_scatter"] = [_V, _V, _I64, _V, _V]
_ENTRIES["rb3c_sa_bwt"] = [_V, _V, _I64, _V, _V]
for _name in ("rb3c_probe_smem_gather", "rb3c_probe_hbm_gather"):
    _ENTRIES[_name] = [_V, _I32, _I32, _I32, _V, _I32, _I32, _V, _V]
_ENTRIES["rb3c_probe_smem_capacity"] = [_I32, _V, _V]
_ENTRIES["rb3c_smem_optin"] = [_I32]  # no stream: a device attribute

_lib = None


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
        dll.rb3c_error_string.argtypes = [ctypes.c_int]
        dll.rb3c_error_string.restype = ctypes.c_char_p
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


def launch(name: str, device, *args) -> None:
    """`call`, raising if the launch was refused."""
    err = call(name, device, *args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {error_string(err)}")
