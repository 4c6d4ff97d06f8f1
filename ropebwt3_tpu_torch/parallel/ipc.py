"""File descriptors between the processes of one node: how a dp row whose
slots several processes hold shares its slabs (parallel/mesh.py
ShardedRows).

The process that owns a slab hands every other process of the slab's dp
row a file descriptor of it: on the card the POSIX descriptor that
csrc/vmm.cu's `rb3c_vmm_export` makes of the slab's physical allocation,
on the CPU the `memfd` that holds the slab.  The descriptors travel as
SCM_RIGHTS messages over Unix sockets in the abstract namespace (no file
on disk), one listening socket a process and an exchange, named by the job
(TORCHELASTIC_RUN_ID, else MASTER_ADDR:MASTER_PORT), the exchange's number
in this process and the rank; the names go round the job's gloo group.
Every send is queued before any process accepts, so no order of the
processes can block.  A Unix socket reaches only its own node: a dp row
whose processes lie on two hosts is a MeshError (`check_one_host`).
"""

from __future__ import annotations

import itertools
import json
import os
import socket

from . import MeshError

ACROSS_NODES = "ROADMAP item 12.4 (a dp row across nodes: fabric handles)"
TIMEOUT_S = 300.0  # how long a process waits for a peer's message once every peer has said it will send
_SEQ = itertools.count()  # exchanges in this process: the same sequence in every process of the job


def job_key() -> str:
    """The torchrun job's name, the same in each of its processes."""
    env = os.environ
    return env.get("TORCHELASTIC_RUN_ID") or f"{env.get('MASTER_ADDR', '')}:{env.get('MASTER_PORT', '')}"


def check_one_host(groups: list, hosts: list[str]) -> None:
    """MeshError when the processes of one group (the processes that hold a
    slot of one dp row) lie on more than one host: a Unix socket cannot
    carry a slab's descriptor between nodes."""
    for i, group in enumerate(groups):
        on = sorted({hosts[p] for p in group})
        if len(on) > 1:
            raise MeshError(f"dp row {i} spans processes on {len(on)} hosts ({', '.join(on)}): a row's slabs are "
                            f"shared within one node only; across nodes is not ported, {ACROSS_NODES}")


class Mailbox:
    """This process's listening socket for one exchange.  `name` goes to the
    peers (through the gloo group); `send` queues one message with its
    descriptors at a peer's socket; `receive` takes n messages."""

    def __init__(self, rank: int, peers: int):
        self.name = f"rb3torch-{job_key()}-{next(_SEQ)}-{rank}"
        self.rank = rank
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_SEQPACKET)
        try:
            self.sock.bind("\0" + self.name)
            self.sock.listen(max(1, peers))
        except OSError as e:
            self.sock.close()
            raise MeshError(f"cannot listen for the mesh's slabs at @{self.name}: {e}") from e

    def send(self, peer_name: str, payload, fds: list[int]) -> None:
        """Queue (this rank, payload) and the descriptors fds at the peer's
        socket; the peer gets its own copies of fds, the caller keeps its."""
        with socket.socket(socket.AF_UNIX, socket.SOCK_SEQPACKET) as s:
            try:
                s.connect("\0" + peer_name)
                socket.send_fds(s, [json.dumps([self.rank, payload]).encode()], fds)
            except OSError as e:
                raise MeshError(f"cannot send {len(fds)} slab descriptor(s) to @{peer_name}: {e}") from e

    def receive(self, n: int) -> list[tuple[int, object, list[int]]]:
        """n messages as (sender's rank, payload, descriptors); the caller
        owns (and closes) the descriptors."""
        out = []
        self.sock.settimeout(TIMEOUT_S)
        try:
            for _ in range(n):
                conn, _ = self.sock.accept()
                with conn:
                    data, fds, flags, _ = socket.recv_fds(conn, 1 << 20, 256)
                    out.append((-1, None, fds))  # closed below if the message is bad
                    if flags & (socket.MSG_CTRUNC | socket.MSG_TRUNC):
                        raise MeshError("a slab message came truncated")
                    out[-1] = (*json.loads(data), fds)
        except (OSError, ValueError) as e:
            for _, _, fds in out:
                for fd in fds:
                    os.close(fd)
            raise MeshError(f"waiting for {n} slab message(s) at @{self.name}: {e}") from e
        return out

    def close(self) -> None:
        self.sock.close()


__all__ = ["ACROSS_NODES", "Mailbox", "check_one_host", "job_key"]
