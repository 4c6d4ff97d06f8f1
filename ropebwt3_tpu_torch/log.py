"""Progress tracing in the reference's format (misc.c:116-157):
``[M::<func>::<realtime>*<%cpu>] message`` lines on stderr at verbosity >= 3,
plus the final Version/CMD/Real-time footer (main.c:73-80).  A copy of
ropebwt3_tpu/log.py.
"""

from __future__ import annotations

import inspect
import os
import resource
import sys
import time

verbose = int(os.environ.get("RB3TPU_VERBOSE", "3"))


def _process_start_time() -> float:
    """Wall-clock at exec, not at (possibly lazy) module import — the
    reference anchors its Real-time footer at main() entry (misc.c:152-157),
    and this module may only be imported when the footer is printed."""
    try:
        with open("/proc/self/stat", "rb") as fp:
            stat = fp.read()
        # field 22 (1-based) after the parenthesized comm: starttime in ticks
        start_ticks = int(stat[stat.rindex(b")") + 2 :].split()[19])
        with open("/proc/uptime") as fp:
            uptime = float(fp.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - start_ticks / hz)
    except Exception:
        return time.time()


_t0 = _process_start_time()


def realtime() -> float:
    return time.time() - _t0


def cputime() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    rc = resource.getrusage(resource.RUSAGE_CHILDREN)
    return ru.ru_utime + ru.ru_stime + rc.ru_utime + rc.ru_stime


def percent_cpu() -> float:
    rt = realtime()
    return cputime() / rt if rt > 0 else 0.0


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0 / 1024.0


def info(fmt: str, *args, func: str | None = None) -> None:
    if verbose < 3:
        return
    if func is None:
        func = inspect.stack()[1].function
    msg = fmt % args if args else fmt
    sys.stderr.write(f"[M::{func}::{realtime():.3f}*{percent_cpu():.2f}] {msg}\n")


def footer(argv: list[str], version: str) -> None:
    if verbose < 3:
        return
    sys.stderr.write(f"[M::main] Version: {version}\n")
    sys.stderr.write("[M::main] CMD: " + " ".join(["rb3tpu"] + argv) + "\n")
    sys.stderr.write(f"[M::main] Real time: {realtime():.3f} sec; CPU: {cputime():.3f} sec; Peak RSS: {peak_rss_gb():.3f} GB\n")
