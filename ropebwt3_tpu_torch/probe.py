"""Probes of the occ-row access pattern on a CUDA card:
`python -m ropebwt3_tpu_torch.probe` prints the sweep.

The card's counterpart of the TPU probes scripts/fused_probe.py,
fused_probe2.py and fused_probe3.py (csrc/probe.cu says which kernel stands
for which).  What it answers: how much shared memory one block gets, and what
a row gather costs in a dependent chain (each gathered row folded into the
next index, as an LF step or an extension is) and in independent streams,
from a table staged in shared memory and from device memory at sizes below
and past the card's 50 MB L2.

Each kernel has a plain PyTorch version here (`gather_plain`,
`smem_capacity_plain`): torch loops over `tab[idx]`, the int32 wrap spelled
out in int64, floor mod as `torch.remainder`.  A wrapper takes the plain
version for a CPU tensor, and for a CUDA tensor launches its kernel or
raises.  Every mode returns (3, q) int32: per lane the index after `iters`
steps, the index of the last row gathered, and a wrapping int32 sum of col
6 of every gathered row.
"""

from __future__ import annotations

import subprocess
import sys
from collections import Counter

import torch

from . import kernels

MODES = ("dep", "chain", "chain_full", "indep")  # csrc/probe.cu Mode, in order
MUL = 1103515245  # the probes' multiplier (fused_probe.py:82, :111, :161)
U32 = 0xFFFFFFFF
ROW_COLS = (12, 128)  # 48-B occ rows, 512-B rows
SEED = 20260817


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 and read as int32 (two's complement)."""
    v = v & U32
    return v - ((v >> 31) << 32)


def gather_plain(tab: torch.Tensor, idx0: torch.Tensor, iters: int, mode: str) -> torch.Tensor:
    """`iters` steps of row gathers from tab (nb, cols) int32 for lanes
    starting at idx0 (q,) int32 in [0, nb):
      dep         idx <- (idx * MUL + row[6]) mod nb          (P2, P3)
      chain       idx <- (idx * MUL + row[6] + 12345) mod nb  (gather_chain)
      chain_full  idx <- (idx * MUL + sum(row) + 12345) mod nb (gather_chain_full)
      indep       idx <- (idx + 1) mod nb                     (P5, P6, P7)
    with int32 wrap before the floor mod.  Returns (3, q) int32: final
    index, last index gathered, col-6 checksum."""
    nb = tab.shape[0]
    idx = idx0.long()
    last, csum = idx, torch.zeros_like(idx)
    for _ in range(iters):
        row = tab[idx].long()
        last = idx
        csum = csum + row[:, 6]
        if mode == "indep":
            idx = torch.remainder(idx + 1, nb)
        else:
            s = row.sum(1) if mode == "chain_full" else row[:, 6]
            idx = torch.remainder(wrap32(idx * MUL + s + (0 if mode == "dep" else 12345)), nb)
    return torch.stack([idx, last, wrap32(csum)]).int()


def smem_capacity_plain(nbytes: int, device="cpu") -> torch.Tensor:
    """P4 on `nbytes` of scratch in rows of 128 int32: row 0 = 1, the last
    row = 2, out = their sum, (128,) int32."""
    scratch = torch.zeros((nbytes // 512, 128), dtype=torch.int32, device=device)
    scratch[0] = 1
    scratch[-1] = 2
    return scratch[0] + scratch[-1]


def check_gather(tab: torch.Tensor, idx0: torch.Tensor, iters: int, mode: str) -> None:
    if tab.dtype != torch.int32 or tab.dim() != 2 or tab.shape[1] not in ROW_COLS or not tab.is_contiguous():
        raise ValueError(f"tab must be a contiguous (nb, 12 | 128) int32 tensor, got {tuple(tab.shape)} {tab.dtype}")
    if not 0 < tab.shape[0] < 1 << 31 or tab.numel() >= 1 << 31:
        raise ValueError(f"table of {tab.shape[0]} rows outside the int32 index range")
    if idx0.dtype != torch.int32 or idx0.dim() != 1 or not 0 < idx0.numel() < 1 << 31 or idx0.device != tab.device:
        raise ValueError("idx0 must be a non-empty 1-D int32 tensor on the table's device")
    if int(idx0.min()) < 0 or int(idx0.max()) >= tab.shape[0]:
        raise ValueError(f"start indices outside [0, {tab.shape[0]})")
    if mode not in MODES or not 0 <= iters < 1 << 31:
        raise ValueError(f"mode {mode!r} (one of {MODES}), iters {iters}")


def launch_gather(fn, tab: torch.Tensor, idx0: torch.Tensor, iters: int, mode: str) -> torch.Tensor:
    """Launch the kernel of wrapper `fn` (smem_gather_cuda or hbm_gather_cuda)
    on CUDA tensors that `check_gather` has passed, and count the launch.
    Timing loops call this: the wrapper's bounds check reads idx0 back to the
    host, a sync that would sit between the launches being timed."""
    out = torch.empty((3, idx0.numel()), dtype=torch.int32, device=tab.device)
    kernels.launch(fn.entry, tab.device, tab.data_ptr(), tab.shape[0], tab.shape[1], MODES.index(mode), idx0.data_ptr(),
                   idx0.numel(), iters, out.data_ptr())
    fn.launches[mode] += 1
    return out


def _gather(fn, tab: torch.Tensor, idx0: torch.Tensor, iters: int, mode: str) -> torch.Tensor:
    check_gather(tab, idx0, iters, mode)
    if tab.device.type == "cpu":
        return gather_plain(tab, idx0, iters, mode)
    return launch_gather(fn, tab, idx0.contiguous(), iters, mode)


def smem_gather_cuda(tab: torch.Tensor, idx0: torch.Tensor, iters: int, mode: str) -> torch.Tensor:
    """`gather_plain` with the table staged in each block's shared memory
    (probe_smem_gather; P2, P5): the table must fit the card's opt-in
    shared memory, or the launch is refused and this raises."""
    return _gather(smem_gather_cuda, tab, idx0, iters, mode)


def hbm_gather_cuda(tab: torch.Tensor, idx0: torch.Tensor, iters: int, mode: str) -> torch.Tensor:
    """`gather_plain` from the table in device memory (probe_hbm_gather; P3,
    P6, P7 and the XLA chains): plain loads in the dependent modes, cp.async
    copies with 8 rows in flight per thread in `indep`."""
    return _gather(hbm_gather_cuda, tab, idx0, iters, mode)


smem_gather_cuda.entry = "rb3c_probe_smem_gather"
hbm_gather_cuda.entry = "rb3c_probe_hbm_gather"
smem_gather_cuda.launches = Counter()
hbm_gather_cuda.launches = Counter()


def smem_capacity_cuda(nbytes: int, device) -> tuple[torch.Tensor | None, str | None]:
    """P1 / P4 on the card: one block with `nbytes` (a multiple of 512) of
    dynamic shared memory.  Returns (out (128,) int32, None) when it ran,
    or (None, the CUDA error) when the card refused the size: past the
    opt-in limit that refusal is the measurement.  A CPU device takes the
    plain version."""
    if nbytes < 512 or nbytes % 512:
        raise ValueError(f"{nbytes} bytes: a positive multiple of 512")
    device = torch.device(device)
    if device.type == "cpu":
        return smem_capacity_plain(nbytes), None
    out = torch.zeros(128, dtype=torch.int32, device=device)
    err = kernels.call("rb3c_probe_smem_capacity", device, nbytes, out.data_ptr())
    if err:
        return None, f"CUDA error {err}: {kernels.error_string(err)}"
    smem_capacity_cuda.launches[nbytes] += 1
    return out, None


smem_capacity_cuda.launches = Counter()


def smem_optin(device) -> int:
    """The card's cudaDevAttrMaxSharedMemoryPerBlockOptin, in bytes."""
    device = torch.device(device)
    v = kernels.lib().rb3c_smem_optin(device.index if device.index is not None else torch.cuda.current_device())
    if v < 0:
        raise RuntimeError(f"cudaDeviceGetAttribute: CUDA error {-v}: {kernels.error_string(-v)}")
    return v


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

# (label, rows, cols): bench.py's dense occ rows (48 MB, inside the 50 MB L2),
# the bytes of the rank64 rb rows (126 MB), fused_probe.py:89's 640 M-symbol
# scale (480 MB), and fused_probe2.py:162 / fused_probe3.py:96's 1 GB of 512-B rows
HBM_TABLES = (("48 B x 1 M (48 MB)", 1_000_000, 12), ("48 B x 2.62 M (126 MB)", 2_621_440, 12),
              ("48 B x 10 M (480 MB)", 10_000_000, 12), ("512 B x 2 M (1 GB)", 2_000_000, 128))
# latency_sweep: tables of 4 MB and 24 MB, well inside the L2, first as the
# control; 64 steps keep 32 chains on a 1 M-row table nearly free of merges
# (~2% of steps) and cycles; 20 launches with new starts each
LAT_TABLES = (("48 B x 87 k (4 MB)", 87_381, 12), ("48 B x 500 k (24 MB)", 500_000, 12)) + HBM_TABLES
LAT_ITERS, LAT_REPS = 64, 20
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clock: time to queue a sweep point's launches


def lane_counts(device) -> tuple[int, ...]:
    """32 (bench.py's m: one warp), 4,096 (the XLA probes' q), and every SM
    at its most resident threads."""
    p = torch.cuda.get_device_properties(device)
    return (32, 4096, p.multi_processor_count * p.max_threads_per_multi_processor)


def sweep_iters(q: int) -> int:
    """Steps per lane: ~2^24 gathers a launch, 32 to 10,000 steps."""
    return min(10_000, max(32, (1 << 24) // q))


def random_table(rows: int, cols: int, device, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 1 << 30, (rows, cols), dtype=torch.int32, device=device, generator=gen)


def random_starts(q: int, nb: int, device, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, nb, (q,), dtype=torch.int32, device=device, generator=gen)


def queued_ms(fns, warm=None) -> float:
    """Mean milliseconds on the card of the launches that each of `fns`
    makes, after one warm-up call (`warm`, default the first of `fns`).  The
    launches are queued behind a spin kernel, so they run back to back
    however long the host takes to issue them."""
    (warm or fns[0])()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for fn in fns:
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / len(fns)


def capacity_sweep(device) -> tuple[int, list[dict]]:
    """P1 / P4 on the card: 48, 96, 160 and 200 KB, the opt-in limit (in
    whole 512-B rows), and one row past it.  Each size that runs must return
    P4's sum (3 in every word); no size up to the opt-in limit may be
    refused.  Returns (opt-in bytes, records in size order)."""
    optin = smem_optin(device)
    top = optin // 512 * 512
    recs = []
    for nbytes in sorted({48 << 10, 96 << 10, 160 << 10, 200 << 10, top, top + 512}):
        out, err = smem_capacity_cuda(nbytes, device)
        ok = out is not None and torch.equal(out.cpu(), smem_capacity_plain(nbytes))
        if out is not None and not ok:
            raise RuntimeError(f"probe_smem_capacity at {nbytes} B: wrong sum {out[:4].tolist()}")
        if nbytes <= optin and err:
            raise RuntimeError(f"probe_smem_capacity refused {nbytes} B at or below the opt-in limit {optin}: {err}")
        recs.append(dict(bytes=nbytes, ran=ok, error=err))
    return optin, recs


def gather_sweep(device, gen: torch.Generator) -> list[dict]:
    """Every table x lane count x mode, timed with CUDA events: shared-memory
    tables of 48-B and 512-B rows filling the opt-in limit, then the device
    memory tables of HBM_TABLES."""
    optin = smem_optin(device)
    recs = []
    tables = [("smem", f"48 B x {optin // 48} (staged)", optin // 48, 12),
              ("smem", f"512 B x {optin // 512} (staged)", optin // 512, 128)]
    tables += [("hbm", label, rows, cols) for label, rows, cols in HBM_TABLES]
    for where, label, rows, cols in tables:
        tab = random_table(rows, cols, device, gen)
        fn = smem_gather_cuda if where == "smem" else hbm_gather_cuda
        modes = ("dep", "indep") if where == "smem" else ("dep", "chain_full", "indep")
        for q in lane_counts(device):
            idx0 = random_starts(q, rows, device, gen)
            iters = sweep_iters(q)
            for mode in modes:
                check_gather(tab, idx0, iters, mode)
                ms = queued_ms([lambda: launch_gather(fn, tab, idx0, iters, mode)] * 3)
                recs.append(dict(kernel=f"probe_{where}_gather", table=label, table_bytes=rows * cols * 4, q=q,
                                 iters=iters, mode=mode, ms=ms, ns_per_step=ms * 1e6 / iters,
                                 mrows_per_s=q * iters / ms / 1e3))
        del tab
    return recs


def latency_sweep(device, gen: torch.Generator, tables=LAT_TABLES) -> list[dict]:
    """ns per dependent step from each (label, rows, cols) table of `tables`
    (default LAT_TABLES), read whole first
    (a table that fits the L2 may then stay there): 32 lanes of
    LAT_ITERS `dep` steps, new random starts in each of LAT_REPS launches
    (queued back to back: each adds its launch gap, a few us, to 64 steps).
    gather_sweep's long chains from fixed starts cannot tell the table sizes
    apart: the fold is a random mapping, so a chain falls into a cycle of
    ~sqrt(nb) rows and chains merge, and from then on it re-reads rows that
    L1 or L2 already hold."""
    recs = []
    for label, rows, cols in tables:
        tab = random_table(rows, cols, device, gen)
        starts = [random_starts(32, rows, device, gen) for _ in range(LAT_REPS)]
        for s in starts:
            check_gather(tab, s, LAT_ITERS, "dep")
        # every row once through the gather's own loads (cp.async.cg allocates
        # in L2); a torch reduction's streaming reads leave no table behind
        sweep = torch.arange(0, rows, LAT_ITERS, dtype=torch.int32, device=device)
        fns = [lambda s=s: launch_gather(hbm_gather_cuda, tab, s, LAT_ITERS, "dep") for s in starts]
        ms = queued_ms(fns, warm=lambda: launch_gather(hbm_gather_cuda, tab, sweep, LAT_ITERS, "indep"))
        recs.append(dict(kernel="probe_hbm_gather", table=label, table_bytes=rows * cols * 4, q=32, iters=LAT_ITERS,
                         mode="dep, new starts", ms=ms, ns_per_step=ms * 1e6 / LAT_ITERS,
                         mrows_per_s=32 * LAT_ITERS / ms / 1e3))
        del tab
    return recs


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    if not torch.cuda.is_available():
        print("probe: needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()
    print(f"[probe] {card}", flush=True)
    optin, caps = capacity_sweep(device)
    for r in caps:
        print(f"[probe] shared memory {r['bytes']} B: " + ("ran, sum exact" if r["ran"] else f"refused ({r['error']})"),
              flush=True)
    ran = [r["bytes"] for r in caps if r["ran"]]
    refused = [r["bytes"] for r in caps if not r["ran"]]
    print(f"[probe] opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin) {optin} B; measured: largest run "
          f"{max(ran)} B, smallest refused " + (f"{min(refused)} B" if refused else "none"), flush=True)
    gen = torch.Generator(device=device).manual_seed(SEED)
    for r in gather_sweep(device, gen) + latency_sweep(device, gen):
        print(f"[probe] {r['kernel']} {r['table']} q={r['q']} {r['mode']}: {r['iters']} steps in {r['ms']:.4f} ms, "
              f"{r['ns_per_step']:.1f} ns/step, {r['mrows_per_s']:.1f} M rows/s ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
