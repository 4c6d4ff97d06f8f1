"""Query-side lightweight BWT + prefix DAWG (dawg.c re-implementation), a
copy of ropebwt3_tpu/align/bwtl.py for the Python BWA-SW DP (bwasw.py),
with its own numpy suffix sort (`suffix_array_doubling`, a copy of
ropebwt3_tpu/construct/sa.py:20-50) and the `DG` trace asked for by the
caller (`--dbg-dawg`) rather than by a module global.

The query's BWT/SA (bwtl) supports the rank queries that drive DAWG
construction; node ids are assigned by the same stack-DFS topological order as
the reference so downstream DP rows align 1:1.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..nt6 import NT6_TABLE


def suffix_array_doubling(keys: np.ndarray) -> np.ndarray:
    """Suffix array of `keys` (int64, all suffixes distinct eventually) via
    prefix doubling with numpy lexsort."""
    n = len(keys)
    rank = np.unique(keys, return_inverse=True)[1].astype(np.int64)
    k = 1
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        sa = np.lexsort((rank2, rank))
        key_r, key_r2 = rank[sa], rank2[sa]
        neq = np.empty(n, dtype=np.int64)
        neq[0] = 0
        neq[1:] = (key_r[1:] != key_r[:-1]) | (key_r2[1:] != key_r2[:-1])
        nr = np.cumsum(neq)
        if nr[-1] == n - 1:
            return sa
        rank = np.empty(n, dtype=np.int64)
        rank[sa] = nr
        k *= 2


@dataclass
class Bwtl:
    seq_len: int
    sa: np.ndarray  # int32 [len+1], sa[0] = len
    bwt: np.ndarray  # uint8 [len] 2-bit symbols (0..3), $ removed
    occ: np.ndarray  # int32 [(len+16)//16*4] checkpoints every 16
    acc: np.ndarray  # int32 [5]
    primary: int

    def rank1a(self, k: int) -> np.ndarray:
        if k > self.primary:
            k -= 1  # $ is not in bwt
        blk = k >> 4
        cnt = self.occ[blk * 4 : blk * 4 + 4].copy()
        for i in range(blk << 4, k):
            cnt[self.bwt[i]] += 1
        return cnt

    def rank2a(self, k: int, l: int) -> tuple[np.ndarray, np.ndarray]:
        return self.rank1a(k), self.rank1a(l)


def bwtl_gen(seq: np.ndarray) -> Bwtl:
    """Build the query BWT (dawg.c:28-76). seq: raw or nt6 bytes."""
    n = len(seq)
    s8 = NT6_TABLE[np.asarray(seq, dtype=np.uint8)].copy()
    s8[s8 == 5] = 1  # ambiguous -> A
    sa = np.empty(n + 1, dtype=np.int32)
    sa[0] = n
    if n > 0:
        sa[1:] = suffix_array_doubling(s8.astype(np.int64))
    primary = int(np.flatnonzero(sa == 0)[0])
    s = np.zeros(n + 1, dtype=np.uint8)
    nz = sa != 0
    s[nz] = s8[sa[nz] - 1] - 1
    s = np.delete(s, primary)  # drop the $ column
    occ_len = (n + 16) // 16 * 4
    occ = np.zeros(occ_len, dtype=np.int32)
    c = np.zeros(4, dtype=np.int32)
    for i in range(n):
        if i % 16 == 0:
            occ[(i // 16) * 4 : (i // 16) * 4 + 4] = c
        c[s[i]] += 1
    if n % 16 == 0 and n // 16 * 4 < occ_len:
        occ[(n // 16) * 4 : (n // 16) * 4 + 4] = c
    acc = np.zeros(5, dtype=np.int32)
    acc[0] = 1
    acc[1:] = c
    acc = np.cumsum(acc).astype(np.int32)
    return Bwtl(seq_len=n, sa=sa, bwt=s[:n], occ=occ, acc=acc, primary=primary)


@dataclass
class DawgNode:
    lo: int
    hi: int
    c: int  # nt6 symbol labeling the edge into this node (-1/0 for root)
    pre: list = field(default_factory=list)


@dataclass
class Dawg:
    n_node: int
    node: list
    bwt: Bwtl | None = None


def dawg_gen(q: Bwtl, trace: bool = False) -> Dawg:
    """Two-pass prefix-DAWG construction (dawg.c:109-228); with `trace`,
    each node as a `DG` line on stderr."""
    # pass 1: in-degrees, stack DFS over distinct SA intervals
    deg: dict[int, int] = {}
    root_key = q.seq_len + 1
    deg[root_key] = 0
    stack = [root_key]
    while stack:
        x = stack.pop()
        rlo, rhi = q.rank2a(x >> 32, x & 0xFFFFFFFF)
        for c in range(3, -1, -1):
            lo = int(q.acc[c] + rlo[c])
            hi = int(q.acc[c] + rhi[c])
            if lo == hi:
                continue
            key = lo << 32 | hi
            if key not in deg:
                deg[key] = 0
                stack.append(key)
            deg[key] += 1
    # pass 2: emit nodes in topological order
    n_node = len(deg)
    nodes = [DawgNode(0, q.seq_len + 1, 0)]
    ids: dict[int, int] = {}
    cnt: dict[int, int] = {}
    stack = [root_key]
    while stack:
        x = stack.pop()
        rlo, rhi = q.rank2a(x >> 32, x & 0xFFFFFFFF)
        for c in range(3, -1, -1):
            lo = int(q.acc[c] + rlo[c])
            hi = int(q.acc[c] + rhi[c])
            if lo == hi:
                continue
            key = lo << 32 | hi
            cnt[key] = cnt.get(key, 0) + 1
            if cnt[key] == deg[key]:
                ids[key] = len(nodes)
                nodes.append(DawgNode(lo, hi, c + 1))
                stack.append(key)
    assert len(nodes) == n_node
    # populate predecessors
    for i, nd in enumerate(nodes):
        rlo, rhi = q.rank2a(nd.lo, nd.hi)
        for c in range(4):
            lo = int(q.acc[c] + rlo[c])
            hi = int(q.acc[c] + rhi[c])
            if lo == hi:
                continue
            nodes[ids[lo << 32 | hi]].pre.append(i)
    if trace:
        for i, nd in enumerate(nodes):
            sys.stderr.write("DG\t%d\t[%d,%d)\t%s\n" % (i, nd.lo, nd.hi, ",".join(str(p) for p in nd.pre)))
    return Dawg(n_node=n_node, node=nodes, bwt=q)


def dawg_gen_linear(seq: np.ndarray) -> Dawg:
    """Linear-chain DAWG for end-to-end alignment (dawg.c:230-250)."""
    n = len(seq)
    nodes = [DawgNode(n, -1, -1)]
    for i in range(n):
        lo = n - 1 - i
        nodes.append(DawgNode(lo, -1, int(NT6_TABLE[seq[lo]]), pre=[i]))
    return Dawg(n_node=n + 1, node=nodes, bwt=None)
