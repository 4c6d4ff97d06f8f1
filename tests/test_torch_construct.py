"""The port's suffix sort (ropebwt3_tpu_torch/construct/sa.py, K7's plain
passes on the CPU) and its row builder `OccIndex.from_bwt` against the JAX
package: the BWT of `gsa_bwt_jax` (XLA, on the CPU) and of the native SA-IS,
the suffix array of the numpy prefix doubling, and `build_occf` of the dense
host index, in int32 and in int64 megablock mode.  Every comparison is exact
(tolerance 0): inputs from a numpy seed."""

import numpy as np
import pytest
import torch

from ropebwt3_tpu.construct import sa as jsa
from ropebwt3_tpu.construct.sa_jax import gsa_bwt_jax
from ropebwt3_tpu.index.dense import DenseFMIndex
from ropebwt3_tpu.nt6 import char2nt6, revcomp
from ropebwt3_tpu.ops import rank as jrank
from ropebwt3_tpu.seqio import read_seqs
from ropebwt3_tpu_torch.construct import sa as tsa
from ropebwt3_tpu_torch.ops import rank as trank


def strands(seqs) -> np.ndarray:
    """The construction batch of `seqs`: each forward, then its reverse
    complement, 0-terminated (seqio.read_batch_nt6's layout)."""
    z = np.zeros(1, np.uint8)
    return np.concatenate([x for s in seqs for x in (s, z, revcomp(s), z)])


@pytest.fixture(scope="module")
def batches(corpus):
    rng = np.random.default_rng(17)
    genomes = [char2nt6(r.seq) for r in read_seqs(str(corpus / "genomes.fa"))]
    odd = []  # empty records, N runs, a record of N only, short ones
    for ln in (0, 35, 0, 1, 120, 7, 0):
        s = rng.integers(1, 5, ln).astype(np.uint8)
        if ln > 20:
            s[rng.integers(0, ln - 10) :][:10] = 5
        odd.append(s)
    odd.append(np.full(12, 5, np.uint8))
    return {
        "genomes": strands(genomes),
        "empty_and_N": strands(odd),
        "one_record": np.concatenate([genomes[0][:3000], np.zeros(1, np.uint8)]),
    }


@pytest.mark.parametrize("name", ["genomes", "empty_and_N", "one_record"])
def test_gsa_bwt_matches_jax_and_native(batches, name):
    seq = batches[name]
    launched = sum(tsa.SA_LAUNCHES.values())
    bwt, sa = tsa.gsa_bwt(seq, "cpu")
    assert sum(tsa.SA_LAUNCHES.values()) == launched  # the CPU runs the plain passes
    assert bwt.dtype == torch.uint8 and sa.dtype == torch.int64
    want = jsa.gsa_bwt(seq, backend="native")
    assert np.array_equal(bwt.numpy(), want)
    assert np.array_equal(bwt.numpy(), gsa_bwt_jax(seq))
    assert np.array_equal(sa.numpy(), jsa.suffix_array_doubling(jsa._initial_ranks(seq)))


@pytest.mark.parametrize("name", ["genomes", "empty_and_N"])
def test_gsa_bwt_wide_path(monkeypatch, batches, name):
    """Two stable sorts (rank2, then rank) in place of the packed key, with
    the threshold shrunk below the batch: the same BWT and suffix array."""
    seq = batches[name]
    monkeypatch.setattr(tsa, "PACKED_MAX", 16)
    bwt, sa = tsa.gsa_bwt(seq, "cpu")
    assert np.array_equal(bwt.numpy(), jsa.gsa_bwt(seq, backend="native"))
    assert np.array_equal(sa.numpy(), jsa.suffix_array_doubling(jsa._initial_ranks(seq)))


def test_gsa_bwt_edges():
    one = np.zeros(1, np.uint8)
    assert np.array_equal(tsa.gsa_bwt(one, "cpu")[0].numpy(), one)
    assert tsa.gsa_bwt(np.zeros(0, np.uint8), "cpu")[0].numel() == 0
    with pytest.raises(ValueError):  # a batch ends with a separator
        tsa.gsa_bwt(np.array([1, 2, 0, 3], np.uint8), "cpu")


def test_round_passes_match_plain(batches):
    """The kernel wrappers on CPU tensors are the plain passes: packed keys
    of int32 ranks (32- and 64-bit words), the wide path's int64 r2 and
    flags; a rank of another dtype is refused."""
    seq = torch.from_numpy(batches["empty_and_N"])
    rank = tsa.initial_ranks(seq)
    assert rank.dtype == torch.int32
    for k in (1, 4, 1000):
        for shift, key32 in ((9, True), (32, False)):
            assert torch.equal(tsa.sa_keys_cuda(rank, k, shift, key32), tsa.sa_keys_plain(rank, k, shift, key32))
        assert torch.equal(tsa.sa_keys_cuda(rank.long(), k), tsa.sa_keys_plain(rank.long(), k))
    key = tsa.sa_keys_plain(rank, 2, 32)
    assert torch.equal(tsa.sa_flags_cuda(key, None), tsa.sa_flags_plain(key, None))
    assert torch.equal(tsa.sa_flags_cuda(key, rank.long()), tsa.sa_flags_plain(key, rank.long()))
    for bad in (rank.float(), rank.to(torch.int16)):
        with pytest.raises(ValueError):
            tsa.sa_keys_cuda(bad, 1, 9, True)


def test_sort_space_is_one_key_word_for_the_plain_sort(monkeypatch, batches):
    """A SortSpace holds one key word until a kernel sort asks for its
    buffers; the plain rounds never do (kernels.lib, which would build
    them, is not reached), and their flags and new ranks take that word."""
    from ropebwt3_tpu_torch import kernels

    monkeypatch.setattr(kernels, "lib", lambda: pytest.fail("the plain rounds reached the kernel library"))
    seq = batches["genomes"]
    space = tsa.SortSpace(seq.size, "cpu")
    assert len(space.keys) == 1 and space.vals is space.hist is space.status is None
    key_s = tsa.sa_sort_plain(space.key(0, False), 8)[0]
    assert space.spare(key_s).data_ptr() == space.keys[0].data_ptr()
    bwt, sa = tsa.gsa_bwt(seq, "cpu")
    assert np.array_equal(bwt.numpy(), jsa.gsa_bwt(seq, backend="native")) and sa.dtype == torch.int64


def test_passes_refuse_mixed_devices():
    """Every pass refuses tensors on two devices (a meta tensor beside CPU
    ones) before it runs either version."""
    rank = torch.arange(8, dtype=torch.int32)
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    calls = [lambda: tsa.sa_keys_cuda(rank, 1, 4, True, out=meta),
             lambda: tsa.sa_flags_cuda(rank, None, out=meta),
             lambda: tsa.sa_flags_cuda(rank.long(), meta.long()),
             lambda: tsa.sa_scatter_cuda(rank, meta, rank.clone()),
             lambda: tsa.sa_bwt_cuda(torch.zeros(8, dtype=torch.uint8, device="meta"), rank)]
    for call in calls:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("size", [1, 255, 3841, 10007])
@pytest.mark.parametrize("bits", [1, 7, 8, 12, 31, 32, 33, 52, 64])
def test_sa_sort_plain_is_a_stable_sort(bits, size):
    """The hand sort's plain twin, LSD passes over 8-bit digits, is the
    stable sort of the keys read as unsigned words: 32-bit words up to 32
    live bits, 64-bit above; many ties, so stability shows.  torch.sort is
    signed, so it sorts the keys with the top bit flipped (the same order)."""
    rng = np.random.default_rng(bits * 100_003 + size)
    hi = np.uint64((1 << bits) - 1)
    pool = rng.integers(0, np.iinfo(np.uint64).max, size // 4 + 1, dtype=np.uint64, endpoint=True) & hi
    u = pool[rng.integers(0, pool.size, size)]
    u[rng.integers(0, size)] = hi  # the largest key
    word = np.uint32 if bits <= 32 else np.uint64
    key = torch.from_numpy(u.astype(word).view(np.int32 if bits <= 32 else np.int64))
    key_s, perm = tsa.sa_sort_plain(key, bits)
    want = np.argsort(u, kind="stable")
    assert perm.dtype == torch.int32 and np.array_equal(perm.numpy(), want)
    assert torch.equal(key_s, key[perm.long()])
    top = -(1 << (8 * key.element_size() - 1))
    assert torch.equal(perm.long(), torch.sort(key ^ top, stable=True).indices)
    launched = sum(tsa.SA_LAUNCHES.values())
    got = tsa.sa_sort_cuda(key, bits)  # a CPU tensor: the plain version
    assert torch.equal(got[0], key_s) and torch.equal(got[1], perm) and sum(tsa.SA_LAUNCHES.values()) == launched


@pytest.mark.parametrize("top,shift,bits", [
    (2**15 - 1, 16, 31), (2**15, 16, 32), (2**16 - 2, 16, 32), (2**16 - 1, 17, 33), (2**16, 17, 34),
    (2**30 - 1, 31, 61), (2**30, 31, 62), (0, 1, 1)])
def test_sa_keys_live_bit_packing(top, shift, bits):
    """A round's key rank << shift | r2 over the live bits of ranks at most
    `top` (its maximum exactly 2^b - 1 or 2^b, and b1 + b2 at 32 and 33):
    a 32-bit word up to 32 bits, below 2^bits, unsigned order that of
    (rank, r2), the wrapper on the CPU equal to the plain version."""
    assert tsa.live_bits(top) == (shift, bits)
    rng = np.random.default_rng(top)
    r = rng.integers(0, top + 1, 1000)
    r[rng.integers(0, 1000, 3)] = top
    rank = torch.from_numpy(r.astype(np.int32))
    key32 = bits <= 32
    k = 3
    key = tsa.sa_keys_cuda(rank, k, shift, key32)
    assert key.dtype == (torch.int32 if key32 else torch.int64)
    assert torch.equal(key, tsa.sa_keys_plain(rank, k, shift, key32))
    u = key.numpy().view(np.uint32 if key32 else np.uint64).astype(np.uint64)
    r2 = np.zeros_like(r)
    r2[:-k] = r[k:] + 1
    assert np.array_equal(u, (r.astype(np.uint64) << np.uint64(shift)) | r2.astype(np.uint64))
    assert int(u.max()) < 1 << bits and int(u.max()) >= 1 << (bits - 1)
    assert np.array_equal(np.argsort(u, kind="stable"), np.lexsort((r2, r)))


def jax_occf(f: DenseFMIndex, int64: bool, shift: int, monkeypatch):
    monkeypatch.setattr(jrank, "MEGA_BLOCK_SHIFT", shift)
    return jrank.build_occf(f, int64=int64)


@pytest.mark.parametrize("n", [64 * 300, 64 * 300 + 17, 40])
@pytest.mark.parametrize("int64", [False, True])
def test_occ_from_bwt_matches_build_occf(monkeypatch, n, int64):
    """Rows built from a BWT tensor equal the host build's bit for bit: the
    padded last block, the extra row, and in int64 mode the megablocks
    (shrunk to 4 rows, so the BWT spans many)."""
    rng = np.random.default_rng(n)
    bwt = rng.integers(0, 6, n).astype(np.uint8)
    f = DenseFMIndex.from_bwt(bwt)
    shift = 2 if int64 else trank.MEGA_BLOCK_SHIFT
    idx = trank.OccIndex.from_bwt(torch.from_numpy(bwt), int64=int64, mega_shift=shift)
    want, mega = jax_occf(f, int64, shift, monkeypatch)
    assert idx.occf.dtype == torch.int32 and np.array_equal(idx.occf.numpy(), want)
    assert np.array_equal(idx.acc.numpy(), f.acc) and idx.acc.dtype == (torch.int64 if int64 else torch.int32)
    assert idx.int64 == int64 and (mega is None) == (idx.mega is None)
    if int64:
        assert np.array_equal(idx.mega.numpy(), mega)
    same = trank.OccIndex.from_dense(f, "cpu", int64=int64, mega_shift=shift)
    assert torch.equal(same.occf, idx.occf) and torch.equal(same.acc, idx.acc)


def test_occ_from_bwt_chunks(monkeypatch):
    """Chunks of rows (shrunk to 3) give the one-chunk rows."""
    bwt = torch.from_numpy(np.random.default_rng(3).integers(0, 6, 64 * 10 + 5).astype(np.uint8))
    whole = trank.OccIndex.from_bwt(bwt, int64=True, mega_shift=1)
    monkeypatch.setattr(trank, "FROM_BWT_BLOCKS", 3)
    part = trank.OccIndex.from_bwt(bwt, int64=True, mega_shift=1)
    assert torch.equal(part.occf, whole.occf) and torch.equal(part.mega, whole.mega)
