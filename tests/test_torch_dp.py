"""The shared core of the port's DP kernels (ropebwt3_tpu_torch/csrc/dp.cuh,
hapdiv.cu, sw.cu) built for the host with g++, one lane: no JAX, no card.

- csrc/hapdiv.cu's window routine, one lane a window, against `hapdiv_plain`
  on the CPU corpus, dense32 and dense64 rows: the four arrays, `bad`, and
  the trips of the windows not flagged (K8's routine is otherwise held only
  on the card; csrc/sw.cu's read routine is held the same way in
  tests/test_torch_sw.py);
- the bitmask placement (`first_free`, `place`) against a sequential
  linear probe, from given home buckets (wraps at nb - 1, loads up to
  maxc) and from keys through the khashl hash and `probe`;
- the warp select (`sort_desc`) at one lane against a sort.

The 32-lane paths of the same routines run on the card
(tests/test_torch_cuda.py)."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from ropebwt3_tpu_torch.align import hapdiv
from ropebwt3_tpu_torch.ops.rank import OccIndex

from .test_torch_cli import ROOT
from .test_torch_cuda import corpus_index, low_complexity  # noqa: F401  (fixture reuse)
from .test_torch_cuda import make_windows
from .test_torch_runblock import HOST_SHIM

CSRC = os.path.join(ROOT, "ropebwt3_tpu_torch", "csrc")
SORT_SIZES = (128, 256, 512)  # the top-N sorts of nb 128 and 256 at one lane, and sw's prune at nb 256

HOST_SRC = HOST_SHIM.split('#include "rb.cuh"')[0] + r"""
#include <memory>
#include "hapdiv.cu"

template <class L, int NB>
static void hapdiv_run(const L& ix, const int* seqs, int64_t W, int K, int n_best, int* arch, int* n_al, int* max_ed,
                       int64_t* n_hap, uint8_t* bad, int* trips) {
  const rb3c::hapdiv::Opt o = rb3c::hapdiv::make_opt(n_best, 30, 1, 1, 3, 5, 2);
  auto s = std::make_unique<rb3c::hapdiv::State<typename L::T, NB>>();
  for (int64_t w = 0; w < W; ++w)
    rb3c::hapdiv::hapdiv_window<1, false>(ix, *s, seqs + w * K, K, o, arch + w * (int64_t)K * n_best * 2, n_al + w,
                                          max_ed + w, n_hap + 7 * w, bad + w, trips + w, 0, nullptr);
}
#define ENTRY(name, L)                                                                                             \
  extern "C" void name(const int* rt, const int* esc, const int64_t* mega, const void* acc, int ms, int bs,       \
                       const int* seqs, int64_t W, int K, int n_best, int* arch, int* n_al, int* max_ed,          \
                       int64_t* n_hap, uint8_t* bad, int* trips) {                                                \
    const L ix{rb3c::Tables{rt, esc, mega, acc, ms, bs}};                                                         \
    if (n_best <= 32)                                                                                             \
      hapdiv_run<L, 128>(ix, seqs, W, K, n_best, arch, n_al, max_ed, n_hap, bad, trips);                          \
    else                                                                                                          \
      hapdiv_run<L, 256>(ix, seqs, W, K, n_best, arch, n_al, max_ed, n_hap, bad, trips);                          \
  }
ENTRY(hapdiv_dense32, rb3c::Dense<int>)
ENTRY(hapdiv_dense64, rb3c::Dense<int64_t>)

// buckets of n inserts from the given home buckets, each the first free one
extern "C" void place_homes(const int* homes, int n, int nb, int* out) {
  uint32_t occ[8];
  for (int w = 0; w < 8; ++w) occ[w] = nb < 32 ? 0xffffffffu << nb : 0u;
  for (int i = 0; i < n; ++i) out[i] = rb3c::dp::place<1>(occ, nb, 1u, rb3c::dp::first_free(occ, nb, homes[i]), 0);
}

// buckets of n keys inserted in order into an empty table of 2^nb_bits
// buckets, as the merge inserts a new key (a key seen before keeps its bucket)
extern "C" void insert_keys(const unsigned long long* keys, int n, int nb_bits, int* out) {
  auto t = std::make_unique<rb3c::dp::Table<int, 256, false>>();
  const int nb = 1 << nb_bits;
  rb3c::dp::clear<1>(*t, nb, 0);
  for (int i = 0; i < n; ++i) {
    int b = rb3c::dp::probe(*t, keys[i], nb, nb_bits);
    if (t->key[b] != keys[i]) {
      b = rb3c::dp::place<1>(t->occ, nb, 1u, b, 0);
      t->key[b] = keys[i];
    }
    out[i] = b;
  }
}

template <int E>
static void sort1(uint32_t* v) {
  uint32_t a[E];
  for (int e = 0; e < E; ++e) a[e] = v[e];
  rb3c::dp::sort_desc<1, E>(a, 0);
  for (int e = 0; e < E; ++e) v[e] = a[e];
}
extern "C" int sort_keys(uint32_t* v, int n) {
  if (n == 128) sort1<128>(v);
  else if (n == 256) sort1<256>(v);
  else if (n == 512) sort1<512>(v);
  else return 1;
  return 0;
}
"""


@pytest.fixture(scope="module")
def dp_host(tmp_path_factory):
    """csrc/hapdiv.cu (and dp.cuh) built for the host with g++: one lane."""
    d = tmp_path_factory.mktemp("dp_host")
    (d / "dp_host.cpp").write_text(HOST_SRC)
    so = d / "libdp_host.so"
    r = subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", CSRC, "-o", str(so),
                        str(d / "dp_host.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def corpus_genomes(corpus):
    from ropebwt3_tpu_torch.nt6 import char2nt6
    from ropebwt3_tpu_torch.seqio import read_seqs

    return [char2nt6(rec.seq) for rec in read_seqs(str(corpus / "genomes.fa"))]


# (K, n_best, error rate, start in genome 0 of the crafted window, index):
# n_best 48 takes the 256-bucket geometry, 16 a 64-bucket table in the 128
# one; the low-complexity index gives long probe chains and wraps
CASES = [(51, 25, 0.06, 3883, "corpus"), (101, 25, 0.04, 2719, "corpus"), (51, 16, 0.04, 3883, "corpus"),
         (31, 48, 0.06, 3883, "corpus"), (51, 25, 0.06, 3883, "low_complexity")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"K{c[0]}-N{c[1]}-err{c[2]}-{c[4]}")
def case(request, corpus_genomes, corpus_index, low_complexity):  # noqa: F811
    """make_windows' windows (one crafted to be flagged) and a
    low-complexity run through hapdiv_plain on the CPU."""
    K, N, err, crafted, kind = request.param
    gen, f = (corpus_genomes, corpus_index) if kind == "corpus" else low_complexity
    wins = np.concatenate([make_windows(gen, K, err, crafted, seed=K + N), np.ones((1, K), np.int32)])
    idx = OccIndex.from_dense(f, "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the lock-step plain version runs thousands of small ops
    try:
        want = [a.numpy() for a in hapdiv.hapdiv_plain(idx, torch.from_numpy(wins), K, n_best=N, trips=True)]
    finally:
        torch.set_num_threads(n)
    return dict(K=K, N=N, wins=wins, want=want, f=f, kind=kind)


@pytest.mark.parametrize("layout", ["dense32", "dense64"])
def test_hapdiv_routine_on_the_host_matches_plain(case, dp_host, layout):
    """K8's window routine, one lane a window: n_al, max_ed, n_hap and bad
    on every window and the trips of the windows not flagged equal to
    hapdiv_plain's; the corpus has windows of both kinds."""
    kw = {"int64": True, "mega_shift": 6} if layout == "dense64" else {}
    idx = OccIndex.from_dense(case["f"], "cpu", **kw)
    K, N, wins = case["K"], case["N"], np.ascontiguousarray(case["wins"])
    W = len(wins)
    arch = np.zeros((W, K, N, 2), np.int32)
    n_al, max_ed, trips = (np.zeros(W, np.int32) for _ in range(3))
    n_hap = np.zeros((W, 7), np.int64)
    bad = np.zeros(W, np.uint8)
    V = ctypes.c_void_p
    t = idx.kernel_tables()
    getattr(dp_host, f"hapdiv_{layout}")(*(V(p) for p in t[:4]), ctypes.c_int(t[4]), ctypes.c_int(t[5]),
                                         V(wins.ctypes.data), ctypes.c_int64(W), ctypes.c_int(K), ctypes.c_int(N),
                                         *(V(a.ctypes.data) for a in (arch, n_al, max_ed, n_hap, bad, trips)))
    want = case["want"]
    for a, b in zip((n_al, max_ed, n_hap, bad.astype(bool)), want[:4]):
        np.testing.assert_array_equal(a, b)
    ok = ~want[3]
    np.testing.assert_array_equal(trips[ok], want[4][ok])
    assert ok.any() and (case["kind"] != "corpus" or (~ok).any())


def linear_probe(homes, nb: int) -> list[int]:
    """Buckets of inserts from `homes` in order into nb empty buckets: each
    the first free one at or after its home, cyclically."""
    used, out = [False] * nb, []
    for h in homes:
        b = int(h)
        while used[b]:
            b = (b + 1) % nb
        used[b] = True
        out.append(b)
    return out


@pytest.mark.parametrize("n_best", [2, 4, 16, 25, 48])
@pytest.mark.parametrize("homes", ["random", "last", "clustered"])
def test_bitmask_placement_matches_linear_probe(dp_host, n_best, homes):
    """first_free + place from given home buckets, up to maxc - 1 inserts
    (the most a node keeps unflagged): every home at nb - 1 (each insert
    wraps), clustered homes near the end, and random ones."""
    _, nb, maxc = hapdiv.nb_params(n_best)
    rng = np.random.default_rng(n_best)
    n = maxc - 1
    h = {"random": rng.integers(0, nb, n), "last": np.full(n, nb - 1),
         "clustered": rng.integers(max(0, nb - 8), nb, n)}[homes].astype(np.int32)
    out = np.zeros(n, np.int32)
    dp_host.place_homes(ctypes.c_void_p(h.ctypes.data), ctypes.c_int(n), ctypes.c_int(nb), ctypes.c_void_p(out.ctypes.data))
    assert out.tolist() == linear_probe(h, nb)


@pytest.mark.parametrize("n_best", [4, 25, 48])
def test_keys_take_their_linear_probe_buckets(dp_host, n_best):
    """Keys (lo << 32 | hi) through the khashl hash and `probe`, repeats
    among them, inserted as the merge does: each new key in its sequential
    linear-probe bucket from hapdiv._home_bucket, a repeat in its first."""
    nb_bits, nb, maxc = hapdiv.nb_params(n_best)
    rng = np.random.default_rng(7)
    uniq = rng.integers(0, 1 << 31, (maxc - 1, 2))
    uniq = (uniq[:, 0] << 32) | np.maximum(uniq[:, 0], uniq[:, 1])
    keys = np.concatenate([uniq, uniq[rng.integers(0, len(uniq), 20)]]).astype(np.uint64)
    rng.shuffle(keys[len(uniq) // 2 :])  # repeats interleaved with the later new keys
    home = hapdiv._home_bucket(torch.from_numpy(keys.astype(np.int64)), nb_bits).numpy()
    first, new_homes = {}, []
    for k, h in zip(keys.tolist(), home.tolist()):
        if k not in first:
            first[k] = len(new_homes)
            new_homes.append(h)
    placed = linear_probe(new_homes, nb)
    want = [placed[first[k]] for k in keys.tolist()]
    out = np.zeros(len(keys), np.int32)
    dp_host.insert_keys(ctypes.c_void_p(keys.ctypes.data), ctypes.c_int(len(keys)), ctypes.c_int(nb_bits),
                        ctypes.c_void_p(out.ctypes.data))
    assert out.tolist() == want


@pytest.mark.parametrize("n", SORT_SIZES)
@pytest.mark.parametrize("fill", ["full", "sparse"])
def test_warp_select_matches_sort(dp_host, n, fill):
    """sort_desc at one lane: unique (H << 9 | bucket) keys, every bucket
    occupied or a quarter of them (empties keep their bucket number), sorted
    descending as np.sort gives them."""
    rng = np.random.default_rng(n)
    b = np.arange(n, dtype=np.uint32)
    H = rng.integers(1, 4096, n).astype(np.uint32)
    on = np.ones(n, bool) if fill == "full" else rng.random(n) < 0.25
    v = np.where(on, (H << 9) | (b & 0x1FF), b).astype(np.uint32)
    got = v.copy()
    assert dp_host.sort_keys(ctypes.c_void_p(got.ctypes.data), ctypes.c_int(n)) == 0
    np.testing.assert_array_equal(got, np.sort(v)[::-1])
