"""The port's native host code, built with g++ on first use and loaded with
ctypes: the FMD decoder and encoder, run expansion, dense tables and
run-block row builder (rld_codec.cpp), the sampled-suffix-array
multi-locate that `mem -p` and `sw` run (locate.cpp), and the BWA-SW engine
(bwasw_core.cpp): the hapdiv DP and the full sw path, which `hapdiv` and
`sw` rerun flagged windows and reads on or run alone with
`--engine=native`, and the staging and finish of the device sw engine;
the threaded SMEM-TG engine that `mem --engine=native|hybrid` runs
(ops/smem_native.py), and the merge's interleave of a B1 held in host
memory (`rb3t_merge_apply`, construct/merge.py's host placement), in the
same file.
They are copies of the functions the port calls from ropebwt3_tpu/native,
and two entry points of the port's own built from them, compiled into one
library.  `fa2line` (fa2line.cpp, with zlib) is a program of its own, which
`fa2line [-R] files` runs (`fa2line_binary`).

The library lands in `../_build/` (gitignored), keyed on a hash of the
sources, the flags and the machine, since `-march=native` code must never
run on another CPU; the program beside it, keyed on its source and flags.
The port has no pure-Python fallback: `lib()` and `fa2line_binary()` raise
with the compiler's output when the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_DIR, f) for f in ("rld_codec.cpp", "locate.cpp", "bwasw_core.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_V, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_ENTRIES = {
    "rb3t_fmd_decode": (_I64, [ctypes.c_char_p, _I64, _V, _V, _I64]),
    "rb3t_fmd_encode": (_V, [_V, _V, _I64, ctypes.POINTER(_I64)]),
    "rb3t_free": (None, [_V]),
    "rb3t_runs_expand": (None, [_V, _V, _I64, _V]),
    "rb3t_dense_tables": (None, [_V, _I64, _I64, _I64, _V, _V, _V, _I32]),
    "rb3t_runblock_count": (None, [_V, _I64, _I64, _V]),
    "rb3t_runblock_fill": (None, [_V, _V, _I64, _I64, _I64, _I64, _V, _V, _V]),
    "rb3t_ssa_multi_batch": (None, [_V, _V, _V, _V, _I64, _I32, _I32, _V, _V, _I64, _V, _V, _V, _V, _V, _V, _V, _I32]),
    "rb3t_hapdiv_batch": (None, [_V, _V, _V, _V, _I64, _V, _V, _I64, _I64, _I32, _V, _V]),
    "rb3t_sw_batch": (_V, [_V, _V, _V, _V, _I64, _V, _V, _V, _I64, _I32, ctypes.POINTER(_I64), _V]),
    "rb3t_sw_stage": (None, [_V, _V, _V, _V, _I64, _V, _V, _V, _I64, _I32, _I32, _I32, _V, _V, _V, _V, _V]),
    "rb3t_sw_finish": (_V, [_V, _V, _V, _V, _I64, _V, _V, _V, _V, _I64, _I32, _V, _V, _V, _V, _V, _V, _V,
                            ctypes.POINTER(_I64)]),
    "rb3t_pline_build": (None, [_V, _V, _I64, _I64, _V, _I32]),
    "rb3t_smem_batch": (_V, [_V, _V, _V, _V, _I64, _I64, _I32, _V, _V, _I64, _I32, ctypes.POINTER(_I64), _V]),
    "rb3t_buf_free": (None, [_V]),
    "rb3t_merge_apply": (None, [_V, _I64, _V, _V, _I64, _V]),
}

_lib = None


def _machine() -> bytes:
    """What `-march=native` compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = [ln for ln in fh.read().splitlines() if ln.startswith((b"model name", b"flags", b"Features"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return platform.machine().encode()


FA2LINE_SOURCE = os.path.join(_DIR, "fa2line.cpp")
FA2LINE_FLAGS = ["-O2", "-std=c++17"]


def _compile(out: str, args: list[str], what: str) -> str:
    """g++ `args` into `out` unless it exists, through a name of this
    process's own (concurrent builds never share a path); return `out`."""
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        r = subprocess.run(["g++", "-o", tmp, *args], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}) on {what}:\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def fa2line_binary() -> str:
    """The fa2line program (fa2line.cpp), compiled into
    `_build/fa2line_<hash>` unless it exists; its path."""
    with open(FA2LINE_SOURCE, "rb") as fh:
        h = hashlib.sha256(" ".join(FA2LINE_FLAGS).encode() + fh.read())
    return _compile(os.path.join(BUILD_DIR, f"fa2line_{h.hexdigest()[:16]}"),
                    [*FA2LINE_FLAGS, FA2LINE_SOURCE, "-lz"], "native/fa2line.cpp")


def build() -> str:
    """Compile the sources into `_build/libhost_<hash>.so` unless it exists;
    return its path."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode() + _machine())
    for p in SOURCES:
        with open(p, "rb") as fh:
            h.update(fh.read())
    return _compile(os.path.join(BUILD_DIR, f"libhost_{h.hexdigest()[:16]}.so"), [*CXXFLAGS, *SOURCES],
                    "the port's native sources")


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call."""
    global _lib
    if _lib is None:
        dll = ctypes.CDLL(build())
        for name, (restype, argtypes) in _ENTRIES.items():
            fn = getattr(dll, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = dll
    return _lib
