"""Sequence input: FASTA/FASTQ (optionally gzipped), line mode, and the
``.len.gz`` sequence-name/length sidecar.

Mirrors the behavior of the reference reader (io.c:60-155).  The readers
that `mem` and `build` use, copied from ropebwt3_tpu/seqio.py: the record
reader and its construction batches, the vectorized flat reader, its
batches and their construction layout, and the sidecar reader.  A
construction batch concatenates nt6 sequences each followed by a 0
separator, the forward strand then (optionally) its reverse complement.
"""

from __future__ import annotations

import gzip
import io
import os
import sys
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .nt6 import COMP_TABLE, NT6_TABLE, char2nt6, revcomp


def _open_maybe_gzip(fn: str):
    if fn == "-":
        raw = sys.stdin.buffer
    else:
        raw = open(fn, "rb")
    head = raw.peek(2) if hasattr(raw, "peek") else b""
    if fn != "-":
        if raw.read(2) == b"\x1f\x8b":
            raw.seek(0)
            return io.BufferedReader(gzip.GzipFile(fileobj=raw))
        raw.seek(0)
        return raw
    if head[:2] == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=raw))
    return raw


@dataclass
class SeqRecord:
    name: str | None
    seq: bytes  # raw ASCII, not yet nt6-encoded


def read_seqs(fn: str, is_line: bool = False) -> Iterator[SeqRecord]:
    """Yield records from FASTA/FASTQ/line input, like rb3_seq_read1."""
    fp = _open_maybe_gzip(fn)
    if is_line:
        for line in fp:
            yield SeqRecord(None, line.rstrip(b"\n").rstrip(b"\r"))
        return
    # FASTX autodetect, kseq-style: '>' FASTA, '@' FASTQ.
    name = None
    seq_parts: list[bytes] = []
    line = fp.readline()
    while line:
        if line.startswith(b">"):
            if name is not None:
                yield SeqRecord(name, b"".join(seq_parts))
            toks = line[1:].split()
            name = toks[0].decode() if toks else ""
            seq_parts = []
            line = fp.readline()
        elif line.startswith(b"@"):
            if name is not None:
                yield SeqRecord(name, b"".join(seq_parts))
                name, seq_parts = None, []
            toks = line[1:].split()
            qname = toks[0].decode() if toks else ""
            seq = fp.readline().rstrip(b"\n").rstrip(b"\r")
            plus = fp.readline()
            if plus.startswith(b"+"):
                fp.readline()  # quality
                yield SeqRecord(qname, seq)
                line = fp.readline()
            else:  # malformed; treat as FASTA-ish
                name, seq_parts = qname, [seq]
                line = plus
        else:
            seq_parts.append(line.rstrip(b"\n").rstrip(b"\r"))
            line = fp.readline()
    if name is not None:
        yield SeqRecord(name, b"".join(seq_parts))


def read_batch_nt6(
    records: Iterator[SeqRecord],
    max_len: int,
    is_for: bool = True,
    is_rev: bool = True,
) -> tuple[int, np.ndarray]:
    """Read a batch like rb3_seq_read (io.c:104-125): returns (n_seq, buffer)
    where buffer holds nt6 codes with a 0 after every sequence; for each input
    sequence the forward strand (if is_for) then its reverse complement (if
    is_rev) is appended, each 0-terminated. Stops once total length exceeds
    max_len (if positive)."""
    if not (is_for or is_rev):
        raise ValueError("a batch needs at least one strand")
    parts: list[np.ndarray] = []
    zero = np.zeros(1, dtype=np.uint8)
    n_seq, tot = 0, 0
    for rec in records:
        s = char2nt6(rec.seq)
        if is_for:
            parts.append(s)
            parts.append(zero)
            tot += len(s) + 1
            n_seq += 1
        if is_rev:
            parts.append(revcomp(s))
            parts.append(zero)
            tot += len(s) + 1
            n_seq += 1
        if max_len > 0 and tot > max_len:
            break
    if n_seq == 0:
        return 0, np.zeros(0, dtype=np.uint8)
    return n_seq, np.concatenate(parts)


def read_seqs_flat(fn: str, is_line: bool = False, max_bytes: int = 1 << 30):
    """Whole-input vectorized parse: (names, flat_nt6, offs) where read i is
    ``flat[offs[i]:offs[i+1]]`` — the Python-loop-free analog of kseq + the
    nt6 table (io.c:12-28, 84-125), ~10x the per-record reader on short-read
    files.  Returns None when the input doesn't qualify (too large, mixed
    FASTA/FASTQ, irregular FASTQ, pathological line endings) — callers fall
    back to `read_seqs`.  Record semantics match `read_seqs` exactly
    (property-tested in tests/test_edge_cases.py)."""
    if fn != "-":
        try:
            if os.path.getsize(fn) > max_bytes:
                return None
        except OSError:
            return None
    with _open_maybe_gzip(fn) as fp:
        # stdin must be read fully: a partial read could not be handed back
        # to the streaming fallback parser
        buf = fp.read() if fn == "-" else fp.read(max_bytes + 1)
        if fn != "-" and len(buf) > max_bytes:
            return None
    data = np.frombuffer(buf, np.uint8)
    n = len(data)
    empty = np.zeros(0, np.uint8)
    if n == 0:
        return [], empty, np.zeros(1, np.int64)
    nl = np.flatnonzero(data == 10).astype(np.int64)
    ends = nl if len(nl) and nl[-1] == n - 1 else np.concatenate([nl, [n]])
    starts = np.concatenate([np.zeros(1, np.int64), ends[:-1] + 1])
    # strip trailing \r (all of them, like rstrip); cap the rare multi-\r case
    for _ in range(4):
        cr = (ends > starts) & (data[np.maximum(ends - 1, 0)] == 13)
        if not cr.any():
            break
        ends = ends - cr
    else:
        return None

    def _assemble(s2, e2, rec, n_rec):
        """Concatenate spans (s2, e2) in order; rec = record id per span.

        Spans are line slices — disjoint and separated by at least the
        newline byte — so after dropping empty ones all start/end indices
        are distinct and the span mask is two plain fancy assignments into
        an int8 diff array (np.add.at measured ~100x slower at 1M records)."""
        lens = e2 - s2
        keep = lens > 0
        d = np.zeros(n + 1, np.int8)
        d[s2[keep]] = 1
        d[e2[keep]] = -1
        mask = np.cumsum(d[:n], dtype=np.int8).view(np.bool_)
        flat = NT6_TABLE[data][mask]
        rec_len = np.bincount(rec, weights=lens, minlength=n_rec).astype(np.int64)
        offs = np.zeros(n_rec + 1, np.int64)
        np.cumsum(rec_len, out=offs[1:])
        return flat, offs

    def _names(hs, he, skip):
        out = []
        for s, e in zip(hs.tolist(), he.tolist()):
            toks = buf[s + skip : e].split()
            out.append(toks[0].decode() if toks else "")
        return out

    if is_line:
        flat, offs = _assemble(starts, ends, np.arange(len(starts)), len(starts))
        return [None] * len(starts), flat, offs
    nonempty = ends > starts
    first = data[np.minimum(starts, n - 1)]
    is_hdr = nonempty & (first == ord(">"))
    is_at0 = nonempty & (first == ord("@"))
    if is_at0.any() and len(starts) and first[0] == ord("@"):
        # FASTQ fast path: rigid 4-line records, single-line sequences
        if len(starts) % 4 != 0:
            return None
        if not (is_at0[0::4].all() and (nonempty[2::4] & (first[2::4] == ord("+"))).all()):
            return None
        names = _names(starts[0::4], ends[0::4], 1)
        s2, e2 = starts[1::4], ends[1::4]
        flat, offs = _assemble(s2, e2, np.arange(len(s2)), len(s2))
        return names, flat, offs
    if is_at0.any() or not is_hdr.any():
        # mixed/ambiguous (or headerless: read_seqs yields nothing)
        return None if is_at0.any() else ([], empty, np.zeros(1, np.int64))
    hdr_idx = np.flatnonzero(is_hdr)
    rec_of_line = np.searchsorted(hdr_idx, np.arange(len(starts)), side="right") - 1
    seq_line = ~is_hdr & (rec_of_line >= 0)
    names = _names(starts[hdr_idx], ends[hdr_idx], 1)
    flat, offs = _assemble(starts[seq_line], ends[seq_line], rec_of_line[seq_line], len(hdr_idx))
    return names, flat, offs


def iter_flat_batches(fn: str, is_line: bool, batch_size: int):
    """Yield (names, flat_nt6, offs) chunks of ~batch_size symbols via the
    vectorized reader; None when the input needs the streaming parser."""
    got = read_seqs_flat(fn, is_line)
    if got is None:
        return None
    names, flat, offs = got

    def gen():
        n_rec = len(names)
        a = 0
        while a < n_rec:
            b = int(np.searchsorted(offs, offs[a] + max(1, batch_size), side="left"))
            b = min(max(b, a + 1), n_rec)
            yield names[a:b], flat[offs[a] : offs[b]], offs[a : b + 1] - offs[a]
            a = b

    return gen()


def batch_nt6_flat(flat: np.ndarray, offs: np.ndarray, is_for: bool = True, is_rev: bool = True) -> tuple[int, np.ndarray]:
    """Vectorized read_batch_nt6: from a flat nt6 buffer + offsets, build the
    construction batch [fwd, 0][, rc, 0] per record (io.c:104-125 layout) with
    two fancy scatters instead of a per-record Python loop."""
    if not (is_for or is_rev):
        raise ValueError("a batch needs at least one strand")
    n = len(offs) - 1
    if n == 0:
        return 0, np.zeros(0, dtype=np.uint8)
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.diff(offs)
    strands = int(is_for) + int(is_rev)
    unit = (lens + 1) * strands
    base = np.zeros(n, np.int64)
    np.cumsum(unit[:-1], out=base[1:])
    total = int(base[-1] + unit[-1])
    dest = np.zeros(total, dtype=np.uint8)  # separators stay 0
    # int32 index vectors halve the fill/scatter traffic (all dest indices
    # are < total, and fwd offsets are nonnegative since unit >= lens)
    idt = np.int32 if total < 2**31 else np.int64
    pos = np.arange(len(flat), dtype=idt)
    # per-record dest offsets expanded with np.repeat (C-speed, no gathers):
    # fwd bytes land ascending from base - offs; rc bytes land DESCENDING
    # from the rc span's end, which reverses each record in the scatter
    if is_for:
        dest[pos + np.repeat((base - offs[:-1]).astype(idt), lens)] = flat
    if is_rev:
        end_rc = base + (lens + 1 if is_for else 0) + (lens - 1) + offs[:-1]
        dest[np.repeat(end_rc.astype(idt), lens) - pos] = COMP_TABLE[flat]
    return n * strands, dest


@dataclass
class SeqNames:
    """Parsed ``.len.gz`` file: names and lengths (io.c:161-204)."""

    names: list[str]
    lens: np.ndarray  # int64

    @property
    def n_seq(self) -> int:
        return len(self.names)


def read_sid(fn: str) -> SeqNames:
    names: list[str] = []
    lens: list[int] = []
    with _open_maybe_gzip(fn) as fp:
        for line in fp:
            fields = line.split()
            if len(fields) >= 2:
                try:
                    ln = int(fields[1])
                except ValueError:
                    continue
                if ln > 0:
                    names.append(fields[0].decode())
                    lens.append(ln)
    return SeqNames(names, np.asarray(lens, dtype=np.int64))
