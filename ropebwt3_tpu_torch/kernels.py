"""The port's CUDA kernels: built from csrc/ with nvcc on first use, loaded
with ctypes.

All `.cu` files under csrc/ compile into ONE shared library with a plain C
interface (no PyTorch headers: nvcc takes seconds, not minutes).  The build
lands in `_build/` next to this file, keyed on a hash of the sources and the
flags, the same build-on-demand pattern as ropebwt3_tpu/native.  Nothing is
built or loaded when this module is imported; `lib()` does it.

Every entry point takes PyTorch's current CUDA stream, allocates nothing, and
returns `cudaGetLastError()` after its launch; `launch` raises on non-zero.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_V, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# argtypes of every entry point, stream last: without them ctypes passes
# Python ints as 32-bit C ints and cuts pointers and int64 counts
_ENTRIES = {
    "rb3c_occ_rank1a": [_V, _V, _I64, _V, _V],
    "rb3c_occ_extend_c": [_V, _V, _V, _V, _V, _I64, _V, _V],
    "rb3c_smem_tg": [_V, _V, _V, _V, _I64, _I32, _I32, _I32, _V, _V, _V],
}

_lib = None


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def build() -> str:
    """Compile csrc/*.cu into `_build/librb3c_<hash>.so` unless that file
    exists; return its path.  Raises with nvcc's output if compilation fails."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as fh:
            h.update(os.path.basename(p).encode() + b"\0" + fh.read())
    so = os.path.join(BUILD_DIR, f"librb3c_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"  # concurrent builds never share a path
    cu = [p for p in srcs if p.endswith(".cu")]
    try:
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, *cu], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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


def launch(name: str, device, *args) -> None:
    """Call entry point `name` with `args` on `device`, on PyTorch's current
    stream there; raise if the launch was refused."""
    import torch

    dll = lib()
    with torch.cuda.device(device):
        err = getattr(dll, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {dll.rb3c_error_string(err).decode()}")
