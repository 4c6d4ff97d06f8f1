"""A resident engine for the port: `python -m ropebwt3_tpu_torch serve idx.fmd`.

A one-shot `python -m ropebwt3_tpu_torch mem` spends most of its wall time
before the index is loaded (`import torch`, the CUDA context) and then
builds the occ rows on the host; the card is busy for milliseconds.  A
server pays those once: it imports torch, loads the index with its SSA and
sequence lengths, builds ONE set of occ rows on its device (those `mem`
takes on auto; dense ones for sw and hapdiv on their first request) and
hands them to every engine a request makes (`BatchedSmemTG`, `SwDeviceEngine`,
`HapdivDeviceEngine`: with the rows given, an engine holds nothing else
that costs to build).  Clients stream `mem`, `sw` and `hapdiv` requests
over a unix socket and get stdout and stderr back; the client side of this
module imports no torch, so a client process never does.

    python -m ropebwt3_tpu_torch serve --daemon idx.fmd   # start one for idx.fmd
    python -m ropebwt3_tpu_torch mem -l31 idx.fmd q.fa     # answered by it
    python -m ropebwt3_tpu_torch serve --stop idx.fmd

The socket is keyed on the index's realpath (rb3torch-serve-<sha1>.sock in
the temp directory: not the JAX package's rb3tpu-serve-*, so neither
package's client reaches the other's server).  A request runs through the
CLI's own main_mem / main_sw / main_hapdiv on the resident index and rows,
one at a time; a request on another index or device is refused.  A request
that raises gets rc 1 and its ERROR line; a CUDA error (the context is then
unusable) also stops the server after its reply.  The protocol is
length-prefixed JSON plus raw payloads, as ropebwt3_tpu/server.py's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import time

MAGIC_Q, MAGIC_R = b"RBTQ", b"RBTR"
MARKER = "[server] request served by resident engine"
WARM_LENS = ["19:150", "31:150"]  # mem engines warmed at start: -l MINLEN on reads of READLEN
STOP_WAIT = 30.0  # seconds `serve --stop` waits for the server to exit
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USAGE = ("Usage: python -m ropebwt3_tpu_torch serve [--device=cuda|cpu] [--engine=auto|native] "
         "[--warm=MINLEN:READLEN,...] [--warm-hapdiv=K,...] [--warm-sw=READLEN,...] [--daemon] [--stop] <idx>")


def sock_path(index_path: str) -> str:
    h = hashlib.sha1(os.path.realpath(index_path).encode()).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(), f"rb3torch-serve-{h}.sock")


def pid_path(index_path: str) -> str:
    return sock_path(index_path)[: -len(".sock")] + ".pid"


def log_path(index_path: str) -> str:
    return sock_path(index_path)[: -len(".sock")] + ".log"


def _err(msg: str) -> int:
    print(f"ERROR: {msg}", file=sys.stderr)
    return 1


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


def _send(conn, magic: bytes, meta: dict, *payloads: bytes) -> None:
    m = json.dumps(meta).encode()
    conn.sendall(magic + struct.pack("<I", len(m)) + m + struct.pack("<I", len(payloads)))
    for p in payloads:
        conn.sendall(struct.pack("<Q", len(p)))
        conn.sendall(p)


def _recv_exact(conn, n: int) -> bytes:
    parts, got = [], 0
    while got < n:
        b = conn.recv(min(1 << 20, n - got))
        if not b:
            raise ConnectionError("peer closed")
        parts.append(b)
        got += len(b)
    return b"".join(parts)


def _recv(conn, magic: bytes) -> tuple[dict, list[bytes]]:
    got = _recv_exact(conn, 4)
    if got != magic:
        raise ConnectionError(f"bad magic {got!r}")
    (mlen,) = struct.unpack("<I", _recv_exact(conn, 4))
    meta = json.loads(_recv_exact(conn, mlen))
    (n,) = struct.unpack("<I", _recv_exact(conn, 4))
    payloads = []
    for _ in range(n):
        (plen,) = struct.unpack("<Q", _recv_exact(conn, 8))
        payloads.append(_recv_exact(conn, plen))
    return meta, payloads


def _ask(index_path: str, meta: dict, timeout: float | None) -> tuple[dict, list[bytes]]:
    with socket.socket(socket.AF_UNIX) as s:
        s.settimeout(timeout)
        s.connect(sock_path(index_path))
        _send(s, MAGIC_Q, meta)
        return _recv(s, MAGIC_R)


# ---------------------------------------------------------------------------
# the client (no torch)
# ---------------------------------------------------------------------------


def server_device(index_path: str) -> str | None:
    """The device ("cuda" or "cpu") of the server that answers for
    index_path, or None when none does."""
    if not os.path.exists(sock_path(index_path)):
        return None
    try:
        meta, _ = _ask(index_path, {"cmd": "ping"}, 2.0)
    except (OSError, ValueError):
        return None
    return meta.get("device") if meta.get("rc") == 0 else None


def client_run(index_path: str, argv: list[str], cmd: str, timeout: float | None = None) -> int:
    """Run `cmd argv` on the server for index_path; its stdout and stderr
    are written here, then MARKER on stderr.  Returns its exit code; raises
    OSError when the transport fails."""
    # file arguments as absolute paths: the server has its own cwd
    argv = [os.path.abspath(a) if os.path.exists(a) else a for a in argv]
    meta, payloads = _ask(index_path, {"cmd": cmd, "argv": argv}, timeout)
    for stream, data in zip((sys.stdout, sys.stderr), payloads):
        stream.flush()
        if hasattr(stream, "buffer"):
            stream.buffer.write(data)
            stream.buffer.flush()
        else:
            stream.write(data.decode())
    print(f"{MARKER} ({meta.get('seconds', 0.0):.3f} s on the server)", file=sys.stderr)
    return int(meta.get("rc", 1))


def spawn_daemon(index_path: str, extra: list[str]) -> int:
    """Start a detached `serve` for index_path (its log at log_path); record
    its pid, so `serve --stop` finds it before its socket exists.  Returns
    the pid."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (_PKG_PARENT, os.environ.get("PYTHONPATH")) if p))
    with open(log_path(index_path), "ab") as lf:
        child = subprocess.Popen([sys.executable, "-m", "ropebwt3_tpu_torch", "serve", *extra,
                                  os.path.abspath(index_path)],
                                 stdout=lf, stderr=lf, stdin=subprocess.DEVNULL, start_new_session=True, env=env)
    with open(pid_path(index_path), "w") as pf:
        pf.write(str(child.pid))
    return child.pid


def _pid(index_path: str) -> int | None:
    try:
        with open(pid_path(index_path)) as fh:
            return int(fh.read().strip())
    except (OSError, ValueError):
        return None


def alive(pid: int) -> bool:
    """Whether process `pid` runs (a zombie, exited but not yet reaped by
    its parent, does not)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        with open(f"/proc/{pid}/stat", "rb") as fh:
            return fh.read().rsplit(b")", 1)[1].split()[0] != b"Z"
    except OSError:
        return True


def maybe_autospawn(index_path: str, device: str) -> None:
    """With RB3TPU_AUTO_SERVE=1, start a server for index_path on `device`
    (RB3TPU_SERVE_ARGS adds options) unless one is already starting; the
    request that asks runs here."""
    if os.environ.get("RB3TPU_AUTO_SERVE") != "1":
        return
    pid = _pid(index_path)
    if pid is not None and alive(pid):
        return
    pid = spawn_daemon(index_path, [f"--device={device}", *os.environ.get("RB3TPU_SERVE_ARGS", "").split()])
    print(f"[rb3torch] starting a resident server (pid {pid}, log {log_path(index_path)}); this request runs here",
          file=sys.stderr)


def stop(index_path: str) -> int:
    """`serve --stop`: ask the server to stop, or end a daemon still
    starting by its pid; wait until it has exited and its socket and pid
    file are gone."""
    pid, rc = _pid(index_path), 1
    try:
        _ask(index_path, {"cmd": "stop"}, 5.0)
        print("server stopped", file=sys.stderr)
        rc = 0
    except (OSError, ValueError) as e:
        if pid is not None and alive(pid):
            os.kill(pid, signal.SIGTERM)
            print(f"ended the starting server, pid {pid}", file=sys.stderr)
            rc = 0
        else:
            print(f"no server to stop ({e})", file=sys.stderr)
    t_end = time.monotonic() + STOP_WAIT
    while time.monotonic() < t_end and (os.path.exists(sock_path(index_path)) or (pid is not None and alive(pid))):
        time.sleep(0.05)
    with contextlib.suppress(FileNotFoundError):
        os.unlink(pid_path(index_path))
    return rc


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class RequestError(Exception):
    """A request the server does not take (another index)."""


class EngineCache:
    """The server's resident state: the index (with its SSA and sequence
    lengths) and its occ rows on `device`: at start those `mem` takes on
    auto (dense, or rb where dense would crowd the card), others on the
    first request that asks for them, each through the card's capacity
    check.  It decides which engine and rows a request gets.  `native`: sw
    and hapdiv requests run on the native engines."""

    # a request's --engine (server: the server's own).  A request's auto is
    # the card, as a one-shot command's is; the JAX package's server turns
    # auto into hybrid (ropebwt3_tpu/cli.py:1214-1221) because there the
    # split beat its TPU kernel alone.  Here the rows are resident and K1
    # takes milliseconds of a batch, so the native half only adds to the
    # wall: bench.py's `mem -l31` took 0.975 s on the server on auto and
    # 1.986 s on hybrid (PERF.md section 5, an H100).  jax is the card
    # engine, hybrid each batch split between the resident rows and the
    # native engine.
    ENGINES = ("auto", "native", "jax", "hybrid", "server")

    def __init__(self, path: str, f, device, native: bool = False):
        self.path, self.f, self.device, self.native = os.path.realpath(path), f, device, native
        self._rows: dict = {}
        self._bare = None
        self.mem_rows("auto")

    def rows(self, occ: str):
        """The index's rows of layout family `occ` ("dense" or "rb");
        CapacityError when they do not fit the card."""
        if occ not in self._rows:
            from . import cli

            self._rows[occ] = cli.occ_rows([self.f], self.device, "serve", occ)[0]
        return self._rows[occ]

    def mem_rows(self, occ: str):
        """The rows of a `mem` request with --occ `occ` (auto|dense|rb)."""
        from .ops.smem import resolve_occ

        return self.rows(resolve_occ(occ, self.f.n, self.device))

    def dp_engine(self, engine: str) -> dict:
        """run_sw_cli / run_hapdiv_cli's engine arguments for a request with
        --engine `engine`: none (the native engines) on a native server,
        when the request asks for them, and on auto where the one-shot
        command's auto would run them (align/cli_hooks.py auto_on_card: the
        index's dense rows do not belong on the card), else the device and
        its dense rows (auto, jax and server: the device engine; hybrid:
        its half of each batch), built through the card's check."""
        from .align.cli_hooks import auto_on_card

        if self.native or engine == "native" or engine == "auto" and not auto_on_card(self.f, self.device, "serve"):
            return {}
        return {"device": self.device.type, "rows": self.rows("dense")}

    def index(self, fn: str, load_all: bool):
        """The resident index for a request on `fn`, with its SSA and
        sequence lengths only when the request would load them (`load_all`),
        so its output is the one-shot command's."""
        if os.path.realpath(fn) != self.path:
            raise RequestError(f"the server holds '{self.path}', not '{fn}'")
        if load_all:
            return self.f
        if self._bare is None:  # one copy, so what an engine attaches to it (pline_table's records) persists
            self._bare = dataclasses.replace(self.f, ssa=None, sid=None)
        return self._bare


def _card_failed(device, exc: BaseException) -> bool:
    """Whether `exc` left the card's context unusable: a CUDA error, or a
    synchronize that fails after it."""
    if device.type != "cuda":
        return False
    if "CUDA error" in str(exc) or type(exc).__name__ == "AcceleratorError":
        return True
    import torch

    try:
        torch.cuda.synchronize(device)
    except Exception:
        return True
    return False


def answer(cache: EngineCache, cmd: str, argv: list[str]) -> tuple[int, bytes, bytes, bool]:
    """Run one request through the CLI on the resident state: (rc, stdout,
    stderr, whether the server must stop)."""
    import getopt

    from . import cli

    out_b, err_t = io.BytesIO(), io.StringIO()
    out_t = io.TextIOWrapper(out_b, encoding="utf-8", write_through=True)
    halt = False
    with contextlib.redirect_stdout(out_t), contextlib.redirect_stderr(err_t):
        try:
            device, rest = cli._split_device(argv)
            if device != cache.device.type:
                rc = _err(f"the server runs on {cache.device.type}, not {device}")
            else:
                rc = {"mem": cli.main_mem, "sw": cli.main_sw, "hapdiv": cli.main_hapdiv}[cmd](rest, device, cmd,
                                                                                            served=cache)
        except (RequestError, cli.IndexLoadError, cli.CapacityError, getopt.GetoptError) as e:
            rc = _err(str(e))
        except Exception as e:
            rc = _err(f"{type(e).__name__}: {e}")
            halt = _card_failed(cache.device, e)
            if halt:
                _err("the card's context failed: the server stops")
    out_t.flush()
    return rc, out_b.getvalue(), err_t.getvalue().encode(), halt


def warm(cache: EngineCache, lens: list[str], hapdiv_ks: list[int], sw_lens: list[int]) -> None:
    """One small batch through each engine asked for (random reads from a
    fixed seed): loads the kernel and native libraries before the first
    request."""
    import numpy as np

    rng = np.random.default_rng(0)
    for spec in lens:
        min_len, _, L = spec.partition(":")
        from .ops.smem import BatchedSmemTG, pack_reads

        print(f"[serve] warming mem -l{int(min_len)} on reads of {int(L or 150)}", file=sys.stderr, flush=True)
        eng = BatchedSmemTG(cache.f, 1, int(min_len), device=cache.device, rows=cache.mem_rows("auto"))
        eng.run_flat(*pack_reads([rng.integers(1, 5, int(L or 150)).astype(np.uint8) for _ in range(64)]))
    if cache.native:
        return
    from .align.bwasw import RB3_SWF_E2E, RB3_SWF_HAPDIV, SwOpt

    for k in hapdiv_ks:
        from .align.hapdiv import HapdivDeviceEngine

        print(f"[serve] warming hapdiv -a{k}", file=sys.stderr, flush=True)
        opt = SwOpt(flag=RB3_SWF_E2E | RB3_SWF_HAPDIV, end_len=1)
        HapdivDeviceEngine(cache.f, opt, cache.device, idx=cache.rows("dense")).run(
            [rng.integers(1, 5, k).astype(np.uint8) for _ in range(32)])
    for L in sw_lens:
        from .align.sw import SwDeviceEngine

        print(f"[serve] warming sw on reads of {L}", file=sys.stderr, flush=True)
        SwDeviceEngine(cache.f, SwOpt(), cache.device, idx=cache.rows("dense")).run(
            [rng.integers(1, 5, L).astype(np.uint8) for _ in range(8)])


def serve(cache: EngineCache, index_path: str) -> int:
    """Answer requests until a `stop`, a SIGTERM or a failed card; the
    socket and pid file are removed on the way out."""
    sp = sock_path(index_path)
    with contextlib.suppress(FileNotFoundError):
        os.unlink(sp)
    srv = socket.socket(socket.AF_UNIX)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    try:
        srv.bind(sp)
        srv.listen(8)
        with open(pid_path(index_path), "w") as pf:
            pf.write(str(os.getpid()))
        print(f"[serve] ready on {sp} ({cache.device.type}, {'native' if cache.native else 'device'} engines)",
              file=sys.stderr, flush=True)
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    meta, _ = _recv(conn, MAGIC_Q)
                    cmd = meta.get("cmd")
                    if cmd == "ping":
                        _send(conn, MAGIC_R, {"rc": 0, "device": cache.device.type, "index": cache.path})
                    elif cmd == "stop":
                        _send(conn, MAGIC_R, {"rc": 0})
                        return 0
                    elif cmd not in ("mem", "sw", "hapdiv"):
                        _send(conn, MAGIC_R, {"rc": 1}, b"", f"ERROR: unknown request '{cmd}'\n".encode())
                    else:
                        t0 = time.perf_counter()
                        rc, out, err, halt = answer(cache, cmd, list(meta["argv"]))
                        _send(conn, MAGIC_R, {"rc": rc, "seconds": time.perf_counter() - t0}, out, err)
                        if halt:
                            return 1
                except (ConnectionError, OSError, ValueError) as e:
                    print(f"[serve] dropped a request: {e}", file=sys.stderr, flush=True)
    finally:
        srv.close()
        for p in (sp, pid_path(index_path)):
            with contextlib.suppress(FileNotFoundError):
                os.unlink(p)


def main_serve(argv: list[str]) -> int:
    """`serve [--device=cuda|cpu] [--engine=auto|native] [--warm=...]
    [--warm-hapdiv=...] [--warm-sw=...] [--daemon] [--stop] idx`."""
    device, engine, lens, hapdiv_ks, sw_lens = "cuda", "auto", WARM_LENS, [], []
    halt = daemon = False
    fwd, args = [], []
    it = iter(argv)
    for a in it:
        if a in ("--device", "--engine"):  # the separate-value spelling
            a = f"{a}={next(it, '')}"
        if a.startswith(("--device=", "--engine=", "--warm")):
            fwd.append(a)
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--engine="):
            engine = a.split("=", 1)[1]
        elif a.startswith("--warm="):
            lens = [x for x in a.split("=", 1)[1].split(",") if x]
        elif a.startswith("--warm-hapdiv="):
            hapdiv_ks = [int(x) for x in a.split("=", 1)[1].split(",") if x]
        elif a.startswith("--warm-sw="):
            sw_lens = [int(x) for x in a.split("=", 1)[1].split(",") if x]
        elif a == "--stop":
            halt = True
        elif a == "--daemon":
            daemon = True
        elif a.startswith("--"):
            return _err(f"serve: unknown option '{a}'")
        else:
            args.append(a)
    if engine == "jax":
        return _err("serve --engine=jax would hold the JAX package's engine: the port serves its own "
                    "(auto: the device engines; native: sw and hapdiv on the native ones)")
    if engine not in ("auto", "native"):
        return _err(f"invalid --engine '{engine}' (auto|native)")
    if device not in ("cuda", "cpu"):
        return _err(f"invalid --device '{device}' (cuda|cpu)")
    if not args:
        print(USAGE, file=sys.stderr)
        return 1
    index_path = args[0]
    if halt:
        return stop(index_path)
    if daemon:
        pid = spawn_daemon(index_path, fwd)
        print(f"[serve] daemon started (pid {pid}, log {log_path(index_path)})", file=sys.stderr)
        return 0
    import torch

    from . import cli

    if device == "cuda" and not torch.cuda.is_available():
        return _err("CUDA is not available; pass --device=cpu to serve the plain PyTorch engines")
    try:
        f = cli.load_index(index_path, load_ssa=True, load_sid=True)
        cache = EngineCache(index_path, f, torch.device(device), native=engine == "native")
        warm(cache, lens, hapdiv_ks, sw_lens)
    except (cli.IndexLoadError, cli.CapacityError, ValueError) as e:
        return _err(str(e))
    return serve(cache, index_path)
