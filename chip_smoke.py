#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (ropebwt3_tpu_torch).

Drives the port's entry points on one CUDA card (and `mem`, `sw`,
`hapdiv`, `ssa` and `build` over meshes of it): `build` (and `merge`) of
bench.py's genomes and of its short reads, `hapdiv` of a 17th haplotype
against bench.py's index, `sw` of its short reads, `get`, `suffix`, `kount`,
the host converters and `tools`, `serve` with `mem`, `hapdiv` and `sw`
through it, `mem -l31` on the workload
of bench.py (16 x 2 Mbp genomes at 1% divergence, indexed double strand:
~64 M symbols, ~48 MB of dense occ rows; 100,000 x 150 bp reads at 1% error)
plus 200 reads of 5-20 kb, once on the default rows (the main path) and once
with `--occ=rb`; `ssa` on bench.py's index and two more; and the row-gather
probes.  Every rank and SMEM kernel runs on each of the four occ layouts
(dense32, dense64, rb32, rb64), ssa_gen on both dense ones.  The reference
outputs come from `python -m ropebwt3_tpu` in subprocesses (`build`,
`merge`, `mem --engine=native`, `ssa -o`): this script imports nothing of
it.  Those reference commands, and [mesh]'s one-shot and torchrun
runs, go one at a time on a background thread (`Background`), started as
soon as their inputs exist and read where a phase checks them, so their
walls are taken beside the phases' own work.  A plain check's result is
the BWT's function, whatever the rows: dense64's kernels are held against
dense32's plain run (PLAIN_ROWS).  Phases:

  build     compile the kernels from csrc/ (nvcc, sm_90a, one nvcc per source)
  corpus    generate the data from a seed; build the FMD with the repo's own
            index build (cached under .bench/torch_smoke/); the four layouts'
            rows on the card, with the rb escapes packed into 64-B sub-rows
            (pack_escapes timed alone) and each layout's B/sym
  construct `build` on the card (csrc/sa_round.cu and csrc/sa_sort.cu K7,
            csrc/merge_rank.cu K6): bench.py's genomes in one batch (its
            peak card memory at or under SA_BYTES_PER_SYMBOL), then with
            -m 16M (three merges of 8 sequences of 2 M steps: the build
            path, counts reset before and read after), then the 100,000
            short reads with -m 12M, each FMD byte-equal to the repo's index
            build; K7 round by round (sa_time.timed_rounds: the passes, the
            hand sort over the round's live bits, and torch.sort of the same
            keys) against its plain passes on the card, each round's rank
            and sort permutation, the final sa and BWT exact; K6 on each -m 16M merge and
            on the short reads' first merge (80,000 sequences; dense32 and
            dense64, megablocks of 2^20 symbols) at the derived stride, its
            ins exact against merge_rank_chunked_plain on the card (segment
            records too), the JAX package's native walk (a subprocess) and,
            on the short reads, merge_rank_plain on the card (of the -m 16M
            merges, the first only: the FMD holds the others); its stride,
            lanes, meeting lengths and hand-overs; each -m 16M
            merge's peak card memory at or under merge_bytes; `merge` of the
            genomes' two halves byte-equal to `python -m ropebwt3_tpu merge`;
            beside each, the JAX package's native command timed.  `build
            -s` of the short reads past K7's cap (F6: cli.card_bytes cut
            in-process to a 12 M-symbol cap; the sorted batch cut at read
            boundaries, the pieces merged in order), byte-equal to `python
            -m ropebwt3_tpu build -s` (one batch, on the background lane).  The host
            placement (B1 and the merged BWT in host memory, B1's rows on
            the card): `build -m 16M -do` with RB3TPU_DEVICE_OCC=rb (every
            merge there, on rb32 rows), counts reset and read, its FMD
            byte-equal, one merge_rank_rb32 launch a merge; each -m 16M
            merge again through merge_host on dense32 and rb32 rows, equal
            to the card path's BWT, its wall by piece (rows, lf2 and K6, ins
            download, native apply) beside the card path's; merge_rank_rb32
            timed beside dense32 on each, its ins equal to dense32's, on the
            first exact against merge_rank_chunked_plain over the rb32 rows
            (segment records too; its ranks' sectors give the bound); and
            merge_rank_rb64 (S 256, megablocks of 2^20 symbols) on the short
            reads' first merge, as dense64
  rank      occ_rank1a / occ_extend_c / occ_lf of each layout vs the plain
            PyTorch rank1a / extend_c / lf on the card, on the bench index:
            1 M positions (0, n, block and megablock boundaries included;
            occ_lf those below n), 1 M intervals; exact.  rb32 at choose_S's S; rb64 at S = 256; dense64 and rb64
            with megablocks shrunk to 2^20 symbols
  rank64    rb64 rows of a synthetic BWT given as runs, n = 2^32 + 2^31
            (no suffix array): S = 8192 from choose_S, escape blocks from a
            high-entropy stretch across 2^32; occ_rank1a / occ_extend_c vs
            the plain rb rank on the card and rank1a vs an independent rank
            from the run lengths, on 1 M positions incl. 0, n, 2^32 +- 1 and
            block boundaries; occ_lf_rb64 at those below n vs the plain lf
            and the runs (the symbol of the run that holds k, acc plus its
            run-length rank); kount_rank_rb64 on 2^18 random intervals and
            on intervals from the special positions vs kount_rank_plain and
            the run-length rank at both ends; exact
  probe     the three probe kernels (csrc/probe.cu) vs their plain versions
            on the card, exact: shared-memory capacity at the opt-in limit
            (one 512-B row past it must be refused), the shared-memory and
            device-memory row gathers in every mode, 48-B and 512-B rows, and
            `tab[idx]` beside the `indep` gathers as the library yardstick;
            then the probe path, `python -m ropebwt3_tpu_torch.probe`'s main,
            with launch counts reset before and read after: its latency sweep
            gives this run's ns per dependent step, which the chain floors use;
            the same sweep on a table of each rb layout's size gives the rb
            chain floors' step
  smem      per layout: smem_tg (one thread per read) vs smem_tg_plain on the
            card, 4,096 reads, exact; smem_tgc (the lanes taken heaviest first
            from a queue) vs the plain lanes on the main path's lanes of 32
            long reads and 1,024 short ones (rows, counts, START logs,
            trips), exact; then on the main path's
            batch the chunked engine (smem_tgc, stitch, reruns) must equal
            the one-thread kernel's rows and counts (rerun with a buffer of
            the true counts) and dense32's; times of both kernels and of the
            long reads' lanes alone, n_unmerged, trip counts, the ns a trip
            of the longest lane, the share of trips whose two ranks fall in
            one dense row, smem_tgc's registers and resident threads, the roofline bound
            and the chain floor; on dense32 also a sweep of the chunk size;
            with --parent TREE, smem_time from TREE and from this tree, A B B
            A, their lanes and rows equal.  On rb rows the bytes
            bound counts the 32-B sectors that the plain twin's ranks read
            (on the main path's batch: its lanes on the dense32 rows, the
            same positions), and the chain floor takes two dependent load
            rounds a trip; the plain time of an rb layout is its run that
            marks the sectors
  ssa       ssa_gen (csrc/ssa_gen.cu: segments walked at once, ranked by
            pointer jumping) in the four layouts on three indexes: bench.py's
            (m = 32 walks of 2 M steps, dense64 with megablocks of 2^20
            symbols; its rb walks checked against the dense64 rows' plain
            walk, the same BWT's),
            one of the 100,000 short reads (m = 200,000, cached under
            .bench/torch_smoke/many/) and the CPU tests' corpus, at the
            derived stride: the SSA byte-equal to `python -m ropebwt3_tpu ssa`
            (whose run gives the native walk's time), the kernel's arrays and
            segment records equal to ssa_gen_seg_plain on the card, its
            arrays to ssa_gen_plain (lock-step, dense rows; not on bench.py's
            index: ~2 M trips), each walk's peak card memory at or under
            ssa_bytes; S, segments, the longest segment, chain floor, bounds,
            each pass's ms and (dense) the heads-only walk (one thread a
            sequence) in the same call; on bench.py's index a stride sweep
            (32 to 1024, heads only); then `ssa` through
            ropebwt3_tpu_torch.cli.main on each index (bench.py's is the ssa
            path: counts reset before, read after; again on rb rows,
            RB3TPU_DEVICE_OCC=rb, rb32 launches) and once as
            `python -m ropebwt3_tpu_torch ssa`
  mem       the main path: `mem -l31` through ropebwt3_tpu_torch.cli.main with
            launch counts reset before and read after; its BED must equal
            `python -m ropebwt3_tpu mem --engine=native` byte for byte; then
            its host work piece by piece; then `mem -l31 --engine=native`
            (the threaded native SMEM engine alone: no occ rows, no launch)
            and `--engine=hybrid` (each batch split between K1 and the
            native engine) on the full batch through cli.main, counts reset
            before and read after, each BED byte-equal to the same
            reference; the hybrid launches smem_tgc at least once and puts
            at least one read on the card, and prints its share; the
            in-process walls by engine
  mem-rb    the second path: `mem -l31 --occ=rb`, counts reset before and
            read after; BED byte-equal to native, >= 1 rb32 smem_tgc launch
  hapdiv    K8 (csrc/hapdiv.cu, one warp a window) on bench.py's index: a
            17th haplotype (genome 0 at 1% substitutions, 2 Mbp, 39,998
            windows of 101 at step 50); per dense layout the kernel vs
            hapdiv_plain on the card, exact, on 960 of its windows, 64 with
            an insertion and 16 at -A 100 (all flagged), timed beside the
            bytes bound and the chain floor; resident blocks an SM at
            n_best 25 and 48 and the phase split of the timing-only twin
            (ropebwt3_tpu_torch.dp_time); then the hapdiv path, `hapdiv`
            through cli.main (counts reset before, read after), byte-equal to
            `python -m ropebwt3_tpu hapdiv`, and its wall time by piece;
            then `hapdiv --engine=hybrid` (the windows split between K8 and
            the native DP) byte-equal to the same reference, >= 1 K8
            launch, its wall and the windows on the card; then past the
            card (F10): `hapdiv` on auto with mem's share of the card cut
            below the dense rows (the native DP: byte-equal, 0 launches,
            its choice logged) and `--engine=jax` with cli.card_bytes
            patched small (one ERROR line, exit 1, no traceback)
  sw        K9 (csrc/sw.cu, one warp a read) on bench.py's index: per dense
            layout the kernel vs sw_plain on the card, exact, on the first
            128 short reads the card takes (general DAWGs) and 64 (-e), 16
            of each at -A 100 (all flagged), timed
            beside the bytes bound and the chain floor, and a launch of
            4,096 reads; resident blocks an SM and the phase split as in
            [hapdiv]; then the sw paths through cli.main (counts reset
            before, read after): `sw` on the first 10,000 short reads and
            `sw --all-e2e -b` on the first 1,000, byte-equal to `python -m
            ropebwt3_tpu sw`, with the shares of reads on the card, flagged
            and sent to the host, and the wall time by piece; then `sw
            --engine=hybrid` (the reads split between K9 and the native
            engine) and `sw --engine=jax` on the 10,000 reads, byte-equal to
            the same reference, >= 1 K9 launch each, their walls and the
            reads on the card; then past the card as [hapdiv]
  utils     `get` of the 32 sequences (from their sentinel rows), 0, n - 1
            and n; `suffix` of all the reads; `kount -k 11 -m 8` (a frontier
            of ~2.6 M 11-mers, at least 10^6 required) through cli.main,
            counts reset before and read after, then each again on rb rows
            (RB3TPU_DEVICE_OCC=rb: rb32 launches, stdout equal to the same
            reference bytes); `fa2line` and `fa2kmer` of
            the genomes and `python -m ropebwt3_tpu_torch.tools call` on
            `sw --all-e2e` of 1,000 101-mers of the 17th haplotype, as
            subprocesses; each byte-equal to `python -m ropebwt3_tpu`.  K11
            (csrc/walk.cu retrieve_seg, four layouts: segments ranked by
            ssa_gen.cu's pointer jumping) against retrieve_seg_plain on the
            card over the whole get walk, symbols, end rows and segment
            records exact (one plain walk, on dense32 rows: the walk is the
            BWT's), each pass timed (CUDA events) beside the heads-only walk
            (one thread a walk, on dense32), its bound, its chain floor,
            pass 1's ns a row (extrapolated to the human100 index's 603.2 G
            symbols) and the JAX package's native walk (a subprocess); K12
            (suffix_walk, four layouts) against suffix_plain on the card,
            exact, on all the reads, timed beside its bound and chain floor,
            the row fetches and sectors a launch its design requests
            (counted on the plain walk's steps, walk_time.traffic) and
            their time at 3.35 TB/s, registers and blocks an SM;
            kount's level rank on kount's own frontiers (kount_time: every
            level, A B C C B A, occ_rank1a of the node-major and of the
            symbol-major cat([k, l]) and kount_rank, csrc/kount.cu, each
            beside its bound), and at the widest level kount_rank against
            kount_rank_plain on the card, four layouts, exact, there and on
            as many random unsorted (k, l)
  serve     `python -m ropebwt3_tpu_torch serve --daemon` on bench.py's
            index; one-shot `mem -l31`, `mem -l31 --engine=hybrid` (split on
            the server between its resident rows and the native engine), and
            `hapdiv` and `sw` with `--engine=server`, as subprocesses
            answered by it: stdout
            byte-equal to the references of [mem], [hapdiv] and [sw], the
            route marker on stderr, each timed beside the local one-shot
            port and the native reference; then `serve --stop`, after which
            its process, socket and pid file must be gone
  mesh      K10's port (parallel/, csrc/vmm.cu): per layout the rows
            sharded over a 2x4 mesh whose eight slots are this card, the
            slabs mapped into one virtual range (its granularity, unit and
            bytes printed); smem_tg_* and smem_tgc_* over the mapped rows vs
            their plain version (smem_tg_plain over rank6_sharded_plain, on
            the card) on 512 reads and on the lanes of 128 short + 4 long
            reads, exact, the other seven views' kernels equal; on the main
            path's batch smem_tgc over the mapped rows beside the unsharded
            rows, A B B A, lane trips equal, registers and blocks an SM of
            both; dense32 and rb32 through the mesh engine (one share a
            card) equal to the unsharded engine; `mem
            --mesh=1x1` (and --occ=rb) through cli.main, counts reset
            before and read after, and as a subprocess, and `mem
            --mesh=2x1` under torchrun (two gloo processes on this card):
            BED byte-equal to native; `hapdiv` of the 17th haplotype and
            `sw` of the 10,000 reads over [this card] x 2 (through the API:
            the CLI maps N to N cards), byte-equal to [hapdiv]'s and [sw]'s
            unsharded runs; `ssa` over a 2x4 mesh of this card on bench.py's
            index (K5's pass 1 by range, each of the eight slots' ranges
            exact against the plain pass 1 on the card, the SSA byte-equal
            to `python -m ropebwt3_tpu ssa` in one range launch a card, the
            slots' ranges and the walk timed beside the unsharded ones, A B
            B A) and `ssa --mesh=1x1` through cli.main; `build -m 16M` of
            bench.py's genomes with each merge's rank over a 2x4 mesh of
            this card (merge_rank_dense32 over the mapped rows, one launch a
            pass, exact against the unsharded K6 and, on the first merge,
            merge_rank_chunked_plain over rank6_sharded_plain on the card, segment
            records too, timed beside it A B B A, registers and blocks an
            SM; each merge's peak card memory, mapped bytes included, at or
            under merge_mesh_bytes; the FMD byte-equal), dense64 on the
            short reads' first merge, and `build -m 16M --mesh=1x1`
            through cli.main; `ssa --mesh=2x1` under torchrun, each process
            writing its own file, both byte-equal; `build -m 16M
            --mesh=2x4` through cli.main with every merge on the host
            placement over a 2x4 mesh of this card (F12: the merge budget
            cut in-process; B1 in host memory, its dense rows built slab by
            slab, OccIndex.from_bwt never called), byte-equal to
            [construct]'s `python -m ropebwt3_tpu build -m 16M`, slabs and
            pieces logged, two merge_rank_dense32 launches a merge; an idx axis across
            processes: `mem -l31`, `build -m 16M` and `ssa` with
            --mesh=1x2 under torchrun (two processes on this card, one dp
            row, each slab created by the process that holds its slot,
            exported as a POSIX file descriptor and mapped by the other):
            BED, both FMDs and both SSA files byte-equal, each process's
            log naming the slab it imported and its launches (smem_tgc
            over a mapping with one imported slab, merge_rank, ssa_gen's
            range), each wall beside the one-process run; with two cards or more,
            `mem`, `ssa` and `build --mesh=2x1` and `1x2` on real cards and
            the mapping they report, else a line that says they were skipped

Any failure exits non-zero.  The last line is {"ok": true, "device": ...}.
Run from the repository root: python3 chip_smoke.py [--parent TREE]
(TREE: another checkout, e.g. the parent commit's, whose K1 [smem] times
beside this one's; it needs this tree's smem_time.py and corpus.py if it
lacks them).
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".bench", "torch_smoke")
# bench.py:78-85
N_GENOMES, GENOME_LEN, DIVERGENCE = 16, 2_000_000, 0.01
N_READS, READ_LEN, READ_ERR, MIN_LEN = 100_000, 150, 0.01, 31
SEED = 20260817
N_LONG, LONG_LEN = 200, (5_000, 20_000)
PROBE_Q, PROBE_ITERS = 4096, 200  # probe phase checks: lanes, steps
PROBE_HBM_SHAPES = ((1_000_000, 12), (2_000_000, 128))  # 48 MB of 48-B rows, 1 GB of 512-B rows
SSA_SHIFT = 8  # `ssa`'s default -s; the CPU tests' corpus runs -s 4
N_CHECK = 1 << 20  # rank phase positions and intervals
N_SMEM = 4096  # smem phase: reads of the one-thread kernel's plain check
N_TGC_SHORT, N_TGC_LONG = 1024, 32  # smem phase: reads of the chunked kernel's plain check
CHUNK_SWEEP = (64, 128, 256, 512, 1024)  # smem phase, dense32: chunk sizes timed (margin = chunk / 2)
MAX_MEMS = 64  # BatchedSmemTG's MEM buffer rows per chain
HBM_BYTES_PER_MS = 3.35e9  # the H100 SXM's 3.35 TB/s HBM3 rate, in bytes a millisecond
# the latency sweep's tables (probe.LAT_TABLES) whose ns per dependent step
# the chain floors use: one the L2 holds, and one of the bench index's 48 MB
LAT_L2, LAT_48MB = "48 B x 87 k (4 MB)", "48 B x 1 M (48 MB)"
SUBPROCESS_TIMEOUT = 600
LAYOUTS = ("dense32", "dense64", "rb32", "rb64")
# bench-index int64 layouts: megablocks of 2^20 symbols; rb64 at the smallest
# S, where run-coded blocks remain (choose_S's S makes every block an escape)
DENSE64_SHIFT, RB64_S, RB64_SHIFT = 14, 256, 12
# [construct]: bench.py's genomes in four batches of four (three merges of 8
# lanes); the short reads in batches of 40,000, 40,000 and 20,000 reads
CONSTRUCT_M, MANY_M = "16M", "12M"
N64 = (1 << 32) + (1 << 31)  # rank64: 6,442,450,944 symbols, a multiple of 8192
# the paper's human100 index: 301.6 Gb x 2 strands (SURVEY.md), where only rb
# rows fit one card; K11's pass 1 time a row is extrapolated to it
HUMAN100_N = 603_200_000_000
# dependent load rounds of one rank on rb rows (csrc/rb.cuh): the row's
# header, then its records or one escape sub-row; an SMEM trip's two ranks
# run side by side
RB_ROUNDS = 2
DEVICE = "cuda"
# a plain check's result is the BWT's function, whatever the rows: dense64's
# kernels ([smem], [hapdiv], [sw], [mesh]) are held against dense32's plain
# run, the rows the plain time is taken on
PLAIN_ROWS = {"dense64": "dense32"}
# [hapdiv]: a 17th haplotype (genome 0 at 1% substitutions) at `hapdiv`'s
# -a101 -w50; the kernel's check takes HAPDIV_CHECK of its windows, then
# HAPDIV_INS windows with four T's inserted at the middle (where flags
# arise), and HAPDIV_BIG windows scored -A 100, which every aligning window
# flags (a score past 4095)
HAPDIV_K, HAPDIV_STEP, HAPDIV_CHECK, HAPDIV_INS, HAPDIV_BIG = 101, 50, 960, 64, 16
# [sw]: K9's check takes the first SW_CHECK reads (general DAWGs) and the
# first SW_CHECK_E2E (-e) of bench.py's short reads that the card takes; the
# sw path runs `sw` on the first SW_PATH of them, `sw --all-e2e -b` on the
# first SW_E2E_PATH; SW_BIG of the check's reads are scored -A 100, which
# flags every one (a score past 4095)
SW_CHECK, SW_CHECK_E2E, SW_PATH, SW_E2E_PATH, SW_BIG = 128, 64, 10_000, 1_000, 16
# [mesh]: a MESH_DP x MESH_IDX mesh whose slots are all this card; the
# kernels' check over its mapped rows takes MESH_TG reads (one thread each)
# and the lanes of MESH_TGC_SHORT short + MESH_TGC_LONG long reads; the main
# path's batch times smem_tgc over the mapped rows and the unsharded ones,
# A B B A, MESH_REPS launches each
MESH_DP, MESH_IDX, MESH_TG, MESH_TGC_SHORT, MESH_TGC_LONG, MESH_REPS = 2, 4, 512, 128, 4, 3
MERGE_MESH_REPLACES = ("ropebwt3_tpu/parallel/merge_sharded.py:28 (merge_rank_sharded_fn: K6's window step, B1's rows "
                       "over idx with a psum, lanes over dp), driven by merge_rank_sharded :67")
MESH_REPLACES = ("ropebwt3_tpu/parallel/mesh.py:132 (rank1a_local, its psum over idx in extend_sharded_c :211) "
                 "inside ropebwt3_tpu/parallel/smem_sharded.py:34 (smem_sharded_fn); K1 ropebwt3_tpu/ops/smem_pallas.py:91")


def plain_note(name: str) -> str:
    """Where a layout's plain result and time come from (PLAIN_ROWS)."""
    if name in PLAIN_ROWS:
        return f"the plain run over {PLAIN_ROWS[name]} rows, the same result"
    return "its own plain run over these rows" + (", marking the sectors it reads" if name.startswith("rb") else "")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def say(msg: str) -> None:
    print(msg, flush=True)


def make_corpus(work: str, n_genomes: int, genome_len: int, n_reads: int, n_long: int, seed: int) -> tuple[str, str, list[np.ndarray]]:
    """genomes.fa and reads.fa under `work` (short reads first, then the long
    ones), made from `seed`; returns their paths and the reads as nt6."""
    from ropebwt3_tpu_torch import corpus

    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(seed)
    base, gens = corpus.genomes(rng, n_genomes, genome_len)
    alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    fa, reads_fa = os.path.join(work, "genomes.fa"), os.path.join(work, "reads.fa")
    with open(fa, "wb") as fh:
        fh.write(b"".join(b">g%d\n" % g + alpha[s].tobytes() + b"\n" for g, s in enumerate(gens)))
    reads = list(corpus.short_reads(rng, base, n_reads)) + corpus.long_reads(rng, base, n_long)
    with open(reads_fa, "wb") as fh:
        fh.write(b"".join(b">r%d\n" % i + alpha[r].tobytes() + b"\n" for i, r in enumerate(reads)))
    return fa, reads_fa, reads


def build_index(fa: str) -> str:
    """The FMD of `fa` from the repo's own index build (native SA-IS), cached
    next to it."""
    fmd = os.path.join(os.path.dirname(fa), "idx.fmd")
    stamp = fmd + ".from"
    key = f"{os.path.getsize(fa)} {SEED}"
    if not (os.path.exists(fmd) and os.path.exists(stamp) and open(stamp).read() == key):
        run([sys.executable, "-m", "ropebwt3_tpu", "build", "-do", fmd, fa])
        with open(stamp, "w") as fh:
            fh.write(key)
    return fmd


def run(cmd: list[str], stdout=subprocess.DEVNULL) -> tuple[float, str]:
    """Run `cmd` from the repo root; fail unless it exits 0.  Returns its wall
    seconds and its stderr."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, stdout=stdout, stderr=subprocess.PIPE, timeout=SUBPROCESS_TIMEOUT)
    if r.returncode != 0:
        fail(f"{' '.join(cmd)} exited {r.returncode}: {r.stderr.decode()[-2000:]}")
    return time.perf_counter() - t0, r.stderr.decode()


class Background:
    """Subprocesses run one at a time on a thread beside the phases' work:
    the JAX package's reference commands and the port's one-shot and
    torchrun runs, started as soon as their inputs exist and read where a
    phase checks them.  `submit` takes the environment as it is then;
    `result` waits and gives `run`'s (seconds, stderr) or fails as `run`
    would.  Their walls are measured beside the phases' own load."""

    def __init__(self):
        import queue
        import threading

        self.jobs, self.done, self.proc, self.closed = queue.Queue(), {}, None, False
        self.cv = threading.Condition()
        threading.Thread(target=self._work, daemon=True).start()

    def submit(self, key: str, cmd: list[str], stdout: str | None = None) -> None:
        with self.cv:
            if key in self.done:
                fail(f"background job {key} submitted twice")
            self.done[key] = None
        self.jobs.put((key, list(cmd), stdout, dict(os.environ)))

    def _work(self) -> None:
        while True:
            key, cmd, stdout, env = self.jobs.get()
            t0 = time.perf_counter()
            # the child keeps its own handle on `out`; under the lock, so stop() starts nothing after it
            with open(stdout, "wb") if stdout else contextlib.nullcontext(subprocess.DEVNULL) as out, self.cv:
                if self.closed:
                    return
                p = self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.PIPE, env=env,
                                                 start_new_session=True)
            try:
                _, err = p.communicate(timeout=SUBPROCESS_TIMEOUT)
            except subprocess.TimeoutExpired:
                self.kill()
                _, err = p.communicate()
            s, err = time.perf_counter() - t0, err.decode()
            res = (s, err) if p.returncode == 0 else SystemExit(
                f"chip_smoke: FAIL: {' '.join(cmd)} exited {p.returncode} (in the background): {err[-2000:]}")
            with self.cv:
                self.proc = None
                self.done[key] = res
                self.cv.notify_all()

    def result(self, key: str) -> tuple[float, str]:
        with self.cv:
            if key not in self.done:
                fail(f"background job {key} was never submitted")
            self.cv.wait_for(lambda: self.done[key] is not None)
            res = self.done[key]
        if isinstance(res, BaseException):
            raise res
        return res

    def kill(self) -> None:
        """Ends the running job's whole process group (torchrun's workers too)."""
        import signal

        with self.cv:
            p = self.proc
        if p is not None and p.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(p.pid, signal.SIGKILL)

    def stop(self) -> None:
        """Kills what still runs and starts nothing more (at exit, or on a failure)."""
        with self.cv:
            self.closed = True
        self.kill()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over `reps` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def wall_ms(fn) -> float:
    return wall_ms_of(fn)[1]


def wall_ms_of(fn) -> tuple:
    """(fn(), its wall milliseconds, the card synchronized before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def first_diff(a: bytes, b: bytes) -> str:
    la, lb = a.splitlines(), b.splitlines()
    for t, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return f"line {t + 1}: {x!r} != {y!r}"
    return f"{len(la)} vs {len(lb)} lines"


def max_abs(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def intervals(rng, n: int, size: int, max_size: int) -> np.ndarray:
    """Bi-intervals (x0, x1, s) whose primary span lies in [0, n] in both
    directions, so either endpoint may be the one ranked."""
    lo = rng.integers(0, n + 1, size)
    s = np.minimum(rng.integers(0, n + 1 - lo), rng.integers(0, max_size, size))
    hi = rng.integers(0, n + 1 - s)
    return np.stack([lo, hi, s], axis=1).astype(np.int64)


def boundaries(n: int, step: int, limit: int) -> np.ndarray:
    """Multiples of `step` in [0, n] and their neighbours, at most `limit` of them."""
    b = np.arange(0, n + 1, step, dtype=np.int64)[:limit]
    return np.clip(np.concatenate([b - 1, b, b + 1]), 0, n)


def bound_ms(nbytes: int) -> float:
    """Milliseconds to move `nbytes` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_MS


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def rb_sectors(idx, k):
    """The 32-B sectors of an rb index's tables that a rank at each k reads
    on the card (csrc/rb.cuh), as the plain twin finds its block and
    sub-row: (N, 5) ids, rows' sectors first, then the escape table's.  A
    run-coded block: its row's five (header and records); an escape block:
    the header's and the two of the sub-row that holds the offset (the
    header's repeated)."""
    import torch

    bi, off = idx.block_and_offset(k.long())
    row = bi * 5
    e = idx.rows[bi, 6].long()
    W4 = idx.esc.shape[1]
    sub = idx.rows.shape[0] * 5 + (e.clamp(min=0) * W4 + (off >> 7).clamp(max=W4 - 1)) * 2
    return torch.where((e >= 0)[:, None], torch.stack([row, sub, sub + 1, row, row], dim=-1),
                       row[:, None] + torch.arange(5, device=k.device))


class SectorCount:
    """An index for the plain twins that marks, at every position they rank,
    the sectors the card's rank would read in each of the rb indexes `rbs`
    (and their megablock bases): the positions are the same on every layout."""

    def __init__(self, idx, rbs):
        import torch

        self.idx, self.rbs = idx, rbs
        self.seen = [torch.zeros(x.rows.shape[0] * 5 + x.esc.numel() // 8, dtype=torch.bool, device=x.device) for x in rbs]
        self.mega = [torch.zeros(x.mega.shape[0] if x.int64 else 0, dtype=torch.bool, device=x.device) for x in rbs]

    def __getattr__(self, name):
        return getattr(self.idx, name)

    def mark(self, k) -> None:
        k = k.flatten().long()
        for x, seen, mega in zip(self.rbs, self.seen, self.mega):
            seen[rb_sectors(x, k).flatten()] = True
            if x.int64:
                mega[x.block_and_offset(k)[0] >> x.mega_shift] = True

    def rank1a(self, k):
        self.mark(k)
        return self.idx.rank1a(k)

    def bytes(self) -> list[int]:
        """Per rb index: the distinct sectors read, 32 B each, its megablock
        bases (48 B) and acc."""
        return [int(s.sum()) * 32 + int(m.sum()) * 48 + nbytes(x.acc) for x, s, m in zip(self.rbs, self.seen, self.mega)]


def table_bytes(rank, idx, k) -> int:
    """Bytes of idx's tables that ranks at positions k need, each once: the
    distinct occ rows (and megablock bases); for rb rows the distinct 32-B
    sectors that the card's rank reads (rb_sectors)."""
    import torch

    if isinstance(idx, rank.OccIndex):
        rows = torch.unique(k.long() >> 6)
        return rows.numel() * 48 + (torch.unique(rows >> idx.mega_shift).numel() * 48 if idx.int64 else 0)
    sc = SectorCount(idx, [idx])
    sc.mark(k)
    return sc.bytes()[0]


def check_occ_kernels(rank, idx, k, ik, c, back, plain_reps: int) -> dict:
    """occ_rank1a, occ_extend_c and occ_lf (at the positions k below n) of
    idx's layout vs the plain versions on the card; fails unless exact.
    Returns errors, times (ms) and bounds, and occ_lf's result."""
    import torch

    got = rank.rank1a_cuda(idx, k)
    want = rank.rank1a(idx, k).to(idx.dtype)
    r_err = max_abs(got, want)
    ik = ik.to(idx.dtype)
    e_got = rank.extend_c_cuda(idx, ik, c, back)
    e_want = rank.extend_c(idx, ik, c, back).to(idx.dtype)
    e_err = max_abs(e_got, e_want)
    kl = k[k < idx.n].contiguous()
    lf_got = rank.lf_cuda(idx, kl)
    lf_err = max(max_abs(a, b) for a, b in zip(lf_got, rank.lf(idx, kl)))
    if r_err or e_err or lf_err:
        fail(f"{idx.layout}: occ_rank1a off by {r_err}, occ_extend_c off by {e_err}, occ_lf off by {lf_err} against "
             "the plain versions")
    prim = torch.where(back, ik[:, 0], ik[:, 1]).long()
    return dict(
        got=got, lf_got=lf_got, rank_err=r_err, ext_err=e_err, lf_err=lf_err,
        lf_ms=cuda_ms(lambda: rank.lf_cuda(idx, kl), 10), lf_plain=cuda_ms(lambda: rank.lf(idx, kl), plain_reps),
        lf_bound=bound_ms(table_bytes(rank, idx, kl) + nbytes(kl, *lf_got)), lf_positions=kl.numel(),
        rank_ms=cuda_ms(lambda: rank.rank1a_cuda(idx, k), 10), rank_plain=cuda_ms(lambda: rank.rank1a(idx, k), plain_reps),
        ext_ms=cuda_ms(lambda: rank.extend_c_cuda(idx, ik, c, back), 10),
        ext_plain=cuda_ms(lambda: rank.extend_c(idx, ik, c, back), plain_reps),
        rank_bound=bound_ms(table_bytes(rank, idx, k) + nbytes(k, got)),
        ext_bound=bound_ms(table_bytes(rank, idx, torch.cat([prim, prim + ik[:, 2].long()])) + nbytes(ik, c, back, e_got)),
    )


def runs_summing_to(rng, total: int, lo: int, hi: int) -> np.ndarray:
    """Random run lengths in [lo, hi) that sum to `total` exactly."""
    lens = rng.integers(lo, hi, int(total / ((lo + hi - 1) / 2) * 1.05) + 64)
    cs = np.cumsum(lens)
    m = int(np.searchsorted(cs, total))
    if m >= len(lens):
        fail("runs_summing_to drew too few runs")
    lens = lens[: m + 1].copy()
    lens[-1] -= int(cs[m]) - total  # >= 1: cs[m - 1] < total
    return lens


def synthetic_runs(seed: int) -> tuple[np.ndarray, np.ndarray, tuple[int, int]]:
    """A BWT of N64 symbols as runs: run lengths 1..1999 (mean ~1000) and a
    high-entropy stretch of 81,920 symbols in runs of 1..3 across 2^32.
    Returns (syms, lens, the stretch's span)."""
    rng = np.random.default_rng(seed)
    a0 = (1 << 32) - 40_960
    parts = [runs_summing_to(rng, a0, 1, 2000), runs_summing_to(rng, 81_920, 1, 4)]
    parts.append(runs_summing_to(rng, N64 - a0 - 81_920, 1, 2000))
    lens = np.concatenate(parts)
    return rng.integers(0, 6, len(lens)).astype(np.uint8), lens, (a0, a0 + 81_920)


def run_length_rank(syms: np.ndarray, lens: np.ndarray, k: np.ndarray) -> np.ndarray:
    """rank1a at k from the runs alone: counts before the run that holds
    position k (a search over run starts) plus the part of that run below k."""
    starts = np.cumsum(lens) - lens
    j = np.searchsorted(starts, k, side="right") - 1
    out = np.empty((len(k), 6), np.int64)
    for c in range(6):
        before = np.cumsum(np.where(syms == c, lens, 0)) - np.where(syms == c, lens, 0)
        out[:, c] = before[j] + np.where(syms[j] == c, k - starts[j], 0)
    return out


def write_fasta(path: str, seqs) -> str:
    """nt6 sequences as FASTA records r0, r1, ..."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    alpha = np.frombuffer(b"$ACGTN", dtype=np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"".join(b">r%d\n" % i + alpha[s].tobytes() + b"\n" for i, s in enumerate(seqs)))
    return path


def make_test_corpus(work: str) -> str:
    """genomes.fa of the CPU tests' `corpus` fixture (tests/conftest.py):
    8 x 8 kb genomes at 1% divergence from seed 42."""
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(42)
    base = rng.integers(0, 4, 8000)
    fa = os.path.join(work, "genomes.fa")
    with open(fa, "w") as fh:
        for i in range(8):
            s = base.copy()
            mut = rng.random(len(s)) < 0.01
            s[mut] = rng.integers(0, 4, mut.sum())
            fh.write(f">s{i}\n" + "".join("ACGT"[c] for c in s) + "\n")
    return fa


def check_probes(probe, dev) -> dict:
    """The three probe kernels vs their plain versions on the card; fails
    unless exact.  Capacity at the opt-in limit (and one row past it, which
    must be refused); each gather in every mode on 48-B and 512-B rows with
    values over the whole int32 range, PROBE_Q lanes and a ragged count.
    Times at the first shape: `dep` (the kernel's time), and `indep` beside
    `tab[idx]` over the same rows (the library yardstick)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    optin = probe.smem_optin(dev)
    top = optin // 512 * 512
    out, err = probe.smem_capacity_cuda(top, dev)
    if err or not torch.equal(out, probe.smem_capacity_plain(top, dev)):
        fail(f"probe_smem_capacity at the opt-in size {top} B: {err or 'wrong sum'}")
    past, refusal = probe.smem_capacity_cuda(top + 512, dev)
    if past is not None:
        fail(f"probe_smem_capacity ran {top + 512} B, past the opt-in limit {optin} B")
    res = {"probe_smem_capacity": dict(
        err=0, ms=cuda_ms(lambda: probe.smem_capacity_cuda(top, dev), 10),
        plain=cuda_ms(lambda: probe.smem_capacity_plain(top, dev), 10), bound=bound_ms(out.numel() * 4), library=None,
        input=f"{top} B of shared memory; {top + 512} B refused ({refusal})",
        replaces="scripts/fused_probe.py:43 (P1), scripts/fused_probe2.py:42 (P4)")}
    say(f"[probe] probe_smem_capacity: {top} B ran, P4's sum exact; {top + 512} B refused ({refusal}); "
        f"cudaDevAttrMaxSharedMemoryPerBlockOptin {optin} B")
    gathers = (
        ("probe_smem_gather", probe.smem_gather_cuda, ((optin // 48, 12), (optin // 512, 128)),
         "scripts/fused_probe.py:100 (P2), scripts/fused_probe2.py:75 (P5)"),
        ("probe_hbm_gather", probe.hbm_gather_cuda, PROBE_HBM_SHAPES,
         "scripts/fused_probe.py:146 (P3), scripts/fused_probe2.py:116 (P6), scripts/fused_probe3.py:44 (P7)"),
    )
    for name, fn, shapes, replaces in gathers:
        err, r = 0, None
        for rows, cols in shapes:
            tab = torch.randint(-(1 << 31), 1 << 31, (rows, cols), dtype=torch.int64, device=dev, generator=gen).int()
            for q in (PROBE_Q, PROBE_Q - 97):
                idx0 = probe.random_starts(q, rows, dev, gen)
                for mode in probe.MODES:
                    err = max(err, max_abs(fn(tab, idx0, PROBE_ITERS, mode), probe.gather_plain(tab, idx0, PROBE_ITERS, mode)))
                if r is None:  # the kernel alone: the wrapper's bounds check syncs
                    rows_idx = (idx0.long()[:, None] + torch.arange(PROBE_ITERS, device=dev)) % rows
                    row_bytes = min(q * PROBE_ITERS, rows) * cols * 4  # at most the table: each row once
                    r = dict(ms=probe.queued_ms([lambda: probe.launch_gather(fn, tab, idx0, PROBE_ITERS, "dep")] * 10),
                             plain=cuda_ms(lambda: probe.gather_plain(tab, idx0, PROBE_ITERS, "dep"), 3),
                             indep_ms=probe.queued_ms([lambda: probe.launch_gather(fn, tab, idx0, PROBE_ITERS, "indep")] * 10),
                             library=cuda_ms(lambda: tab[rows_idx], 10), bound=bound_ms(row_bytes + nbytes(idx0) + 12 * q),
                             input=f"({rows}, {cols}) int32 table, {q} lanes x {PROBE_ITERS} dep steps; indep and "
                                   f"`tab[idx]` over the same {q} x {PROBE_ITERS} rows")
            del tab
        if err:
            fail(f"{name} differs from gather_plain by up to {err}")
        res[name] = dict(r, err=err, replaces=replaces)
        say(f"[probe] {name}: exact in every mode ({', '.join(probe.MODES)}) on "
            + " and ".join(f"({rows}, {cols})" for rows, cols in shapes)
            + f" int32 tables, {PROBE_Q} and {PROBE_Q - 97} lanes x {PROBE_ITERS} steps; {r['input']}: dep "
            f"{r['ms']:.4f} ms vs plain {r['plain']:.4f} ms; indep {r['indep_ms']:.4f} ms vs `tab[idx]` "
            f"{r['library']:.4f} ms; bound {r['bound']:.4f} ms")
    return res


def walk_err(got, want) -> int:
    """Largest difference between the kernel's and the plain version's walk
    arrays (ssa_l only where a lane hit)."""
    filled = want[1] >= 0
    return max(max_abs(got[1], want[1]), max_abs(got[0][filled], want[0][filled]), max_abs(got[2], want[2]),
               max_abs(got[3], want[3]))


def native_walk_s(stderr: str) -> float:
    """The seconds `python -m ropebwt3_tpu ssa` spent after loading the
    index (its native walk and the SSA write), from its log: the footer's
    real time less the time of the `loaded the BWT` line."""
    load = re.search(r"\[M::load_index::([0-9.]+)\*", stderr)
    end = re.search(r"Real time: ([0-9.]+) sec", stderr)
    if load is None or end is None:
        fail(f"`python -m ropebwt3_tpu ssa` logged no load or end time: {stderr[-500:]}")
    return float(end.group(1)) - float(load.group(1))


def walk_passes(ssa_ops, probe, x, m: int, ss: int, S: int) -> list[float]:
    """Milliseconds of each of the walk's three passes at stride S (CUDA
    events between them, the launches queued behind a spin kernel)."""
    import torch

    ssa_ops.launch_walk(x, m, ss, S)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda._sleep(probe.SPIN_CYCLES)
    ssa_ops.launch_walk(x, m, ss, S, marks=ev)
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def check_ssa(cli, ssa_ops, probe, rank, dev, card: str, f, fmd: str, idxs: dict, reads, ns: dict,
              side: Background) -> tuple[dict, dict]:
    """ssa_gen of the four layouts on bench.py's index, the many-sequence
    index and the CPU tests' corpus, at the derived stride: byte-equal to
    `python -m ropebwt3_tpu ssa`, arrays and segment records equal to
    ssa_gen_seg_plain on the card (on bench.py's index the rb walks against
    the plain walk over its dense64 rows: the walk is the BWT's, and a plain
    walk over rb rows there would take tens of seconds), arrays equal to
    ssa_gen_plain where its lock-step walk is short (dense rows), peak card
    memory at or under ssa_bytes; the passes timed, and beside them (dense
    rows) the heads-only walk (one thread a sequence) and, on bench.py's
    index, a stride sweep; then `ssa` through the CLI on each, byte-equal to
    the same file, and on bench.py's index once more on rb rows
    (RB3TPU_DEVICE_OCC=rb).  Returns the per-layout records and the ssa
    paths' launch counts (bench.py's index: dense32, rb32)."""
    import torch

    from ropebwt3_tpu_torch.construct.merge import stride
    from ropebwt3_tpu_torch.formats.ssa import write_ssa_bytes
    from ropebwt3_tpu_torch.ops.runblock import RunBlockIndex

    inputs = [("bench", f, fmd, idxs, SSA_SHIFT)]
    t0 = time.perf_counter()
    for name, fa, ss in (("many", write_fasta(os.path.join(WORK, "many", "reads.fa"), reads[:N_READS]), SSA_SHIFT),
                         ("corpus", make_test_corpus(os.path.join(WORK, "corpus")), 4)):
        x_fmd = build_index(fa)
        xf = cli.load_index(x_fmd)
        inputs.append((name, xf, x_fmd, {
            "dense32": rank.OccIndex.from_dense(xf, dev),
            "dense64": rank.OccIndex.from_dense(xf, dev, int64=True, mega_shift=DENSE64_SHIFT),
            "rb32": RunBlockIndex.from_dense(xf, dev, cache=None),
            "rb64": RunBlockIndex.from_dense(xf, dev, S=RB64_S, int64=True, mega_shift=RB64_SHIFT, cache=None)}, ss))
    sub_fn = os.path.join(WORK, "ssa_many_sub.ssa")
    side.submit("ssa_sub", [sys.executable, "-m", "ropebwt3_tpu_torch", "ssa", "-o", sub_fn, inputs[1][2]])
    say("[ssa] indexes: " + "; ".join(f"{x[0]} n={x[1].n} m={int(x[1].acc[1])}" for x in inputs)
        + f" (built or loaded in {time.perf_counter() - t0:.3f} s)")
    res = {lay: {"err": 0} for lay in LAYOUTS}
    refs = {}
    for name, xf, x_fmd, rows, ss in inputs:
        m = int(xf.acc[1])
        opts = [] if ss == SSA_SHIFT else ["-s", str(ss)]
        ref_fn = os.path.join(WORK, f"ssa_{name}_ref.ssa")
        ref_s, ref_err = run([sys.executable, "-m", "ropebwt3_tpu", "ssa", *opts, "-o", ref_fn, x_fmd])
        want = open(ref_fn, "rb").read()
        native_ms = native_walk_s(ref_err) * 1e3
        refs[name] = (ref_fn, ref_s, opts)
        lat = ns[LAT_48MB] if name == "bench" else ns[LAT_L2]  # the many index's 22.6 MB of rows stay in the L2
        reps = 3 if name == "bench" else 5
        for lay, x in rows.items():
            is_rb = lay.startswith("rb")
            S = ssa_ops.walk_stride(xf.n, m, dev)
            heads = ssa_ops.heads_only(xf.n)
            n_seg = ssa_ops.segments(xf.n, m, S)
            walk = ssa_ops.ssa_gen_cuda(x, m, ss)
            if write_ssa_bytes(ssa_ops.assemble(m, ss, *walk)) != want:
                fail(f"ssa_gen {lay} on the {name} index differs from `python -m ropebwt3_tpu ssa`")
            # the walk's peak card memory: its own allocations and the rows
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            *got, rec = ssa_ops.launch_walk(x, m, ss, S)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before + x.nbytes
            cap = ssa_ops.ssa_bytes(xf.n, m, ss, S, x.mega_shift if x.int64 else None, rb=x if is_rb else None)
            if peak > cap:
                fail(f"ssa_gen {lay} on the {name} index: peak card memory {peak} B above ssa_bytes {cap} B")
            if not (is_rb and name == "bench"):  # else the dense rows' plain walk, the same BWT's
                plain_rows = lay
                t1 = time.perf_counter()
                *want_seg, want_rec = ssa_ops.ssa_gen_seg_plain(x, m, ss, S)
                torch.cuda.synchronize()
                seg_plain_ms = (time.perf_counter() - t1) * 1e3
            err = max(walk_err(got, want_seg), max_abs(rec, want_rec[1:]), walk_err(walk, want_seg))
            if err:
                fail(f"ssa_gen {lay} on the {name} index: arrays or segment records differ from ssa_gen_seg_plain "
                     f"by up to {err}")
            longest_seg, longest = int(want_rec[0].max()), int(walk[2].max())
            ms = probe.queued_ms([lambda: ssa_ops.launch_walk(x, m, ss, S)] * reps)
            passes = walk_passes(ssa_ops, probe, x, m, ss, S)
            heads_ms = None if is_rb else probe.queued_ms([lambda: ssa_ops.launch_walk(x, m, ss, heads)]
                                                          * (1 if name == "bench" else reps))
            S_cut = stride(xf.n - m, dev)  # the shared stride rule alone, without walk_stride's heads-only cases
            cut_ms = ms if S_cut == S or is_rb else probe.queued_ms([lambda: ssa_ops.launch_walk(x, m, ss, S_cut)] * reps)
            out_bytes = nbytes(*walk)
            # an rb step: RB_ROUNDS dependent loads at the tables' ns, the header's sector then up to 128 B
            step = RB_ROUNDS * (ns[lay] if name == "bench" else ns[LAT_L2]) if is_rb else lat
            r = dict(input=f"{name} index: n={xf.n}, m={m}, -s {ss}", S=S, n_seg=n_seg, ms=ms, pass_ms=passes,
                     heads_only_ms=heads_ms, seg_plain_ms=seg_plain_ms,
                     plain_rows=plain_rows,
                     longest_segment=longest_seg, longest_walk=longest, chain_floor_ms=longest_seg * step / 1e6,
                     heads_only_chain_floor_ms=longest * step / 1e6, bound_ms=bound_ms(x.nbytes + out_bytes),
                     row_load_bound_ms=bound_ms((160 if is_rb else 64) * xf.n), peak_bytes=peak, ssa_bytes=cap,
                     native_ms=native_ms, rule_stride=S_cut, rule_stride_ms=cut_ms)
            note = ""
            if name != "bench" and not is_rb:  # the lock-step walk, as the JAX package defines it: ~2 M trips on bench.py's
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                want_arr = ssa_ops.ssa_gen_plain(x, m, ss)
                torch.cuda.synchronize()
                r["lockstep_plain_ms"] = (time.perf_counter() - t1) * 1e3
                e2 = walk_err(walk, want_arr)
                if e2:
                    fail(f"ssa_gen {lay} on the {name} index: arrays differ from ssa_gen_plain by up to {e2}")
                err = max(err, e2)
                note = f"; ssa_gen_plain (lock-step) {r['lockstep_plain_ms']:.4f} ms, arrays exact"
            elif lay == "dense32":
                sweep = []
                for Sw in (32, 64, 128, 256, 512, 1024, heads):
                    w = ssa_ops.launch_walk(x, m, ss, Sw)
                    if walk_err(w[:4], walk):
                        fail(f"ssa_gen dense32 on the bench index at stride {Sw}: other arrays than at {S}")
                    sweep.append(dict(S=Sw, n_seg=ssa_ops.segments(xf.n, m, Sw),
                                      ms=probe.queued_ms([lambda Sw=Sw: ssa_ops.launch_walk(x, m, ss, Sw)]
                                                         * (1 if Sw == heads else reps)),
                                      pass_ms=walk_passes(ssa_ops, probe, x, m, ss, Sw) if Sw != heads else None))
                r["stride_sweep"] = sweep
                note = "; stride sweep (arrays equal at each): " + "; ".join(
                    f"S {w['S']}: {w['n_seg']} segments, {w['ms']:.4f} ms"
                    + (f" (passes {', '.join(f'{p:.4f}' for p in w['pass_ms'])})" if w["pass_ms"] else "")
                    for w in sweep)
            res[lay]["err"] = max(res[lay]["err"], err)
            res[lay][name] = r
            heads_note = "" if heads_ms is None else f", heads-only walk {heads_ms:.4f} ms"
            say(f"[ssa] {name} {lay}: SSA (-s {ss}) byte-equal to `python -m ropebwt3_tpu ssa`; segment stride {S}, "
                f"{n_seg} segments; kernel {ms:.4f} ms (passes {passes[0]:.4f} / {passes[1]:.4f} / {passes[2]:.4f})"
                f"{heads_note}, at the stride rule's S {S_cut} {cut_ms:.4f} ms; longest segment {longest_seg} "
                f"steps (chain floor {r['chain_floor_ms']:.4f} ms at {step:.1f} ns), longest walk {longest} "
                f"({r['heads_only_chain_floor_ms']:.4f} ms); bounds: tables and outputs {r['bound_ms']:.4f} ms, row "
                f"loads {r['row_load_bound_ms']:.4f} ms; peak card memory {peak} B <= ssa_bytes {cap} B; arrays and "
                f"segment records equal to ssa_gen_seg_plain on the card over {r['plain_rows']} rows "
                f"({seg_plain_ms:.4f} ms){note}; the reference's native walk and write {native_ms:.4f} ms "
                f"({os.cpu_count()} host cores; its log) ({card})")

    paths = {}
    for name, xf, x_fmd, rows, ss in inputs:
        ref_fn, ref_s, opts = refs[name]
        for lay in ("dense32", "rb32") if name == "bench" else ("dense32",):
            port_fn = os.path.join(WORK, f"ssa_{name}_{lay}_port.ssa")
            argv = ["ssa", *opts, "-o", port_fn, x_fmd]
            ssa_ops.ssa_gen_cuda.launches.clear()
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err), rb_rows_chosen() if lay == "rb32" else contextlib.nullcontext():
                rc = cli.main(argv)
            port_s = time.perf_counter() - t0
            launches = dict(ssa_ops.ssa_gen_cuda.launches)
            sys.stderr.write(err.getvalue())
            if rc != 0:
                fail(f"ropebwt3_tpu_torch {' '.join(argv)} exited {rc}")
            if open(port_fn, "rb").read() != open(ref_fn, "rb").read():
                fail(f"port `ssa` on the {name} index ({lay} rows) differs from `python -m ropebwt3_tpu ssa`")
            if launches.get(lay, 0) < 1 or f"{launches[lay]} ssa_gen launches ({lay})" not in err.getvalue() \
                    or f"occ layout {lay}" not in err.getvalue():
                fail(f"port `ssa` on the {name} index: no {lay} rows or ssa_gen launch counted ({launches})")
            if name == "bench":
                paths[lay] = dict(launches=launches, port_s=port_s)
            say(f"[ssa] `{' '.join(['ssa', *opts])}` on the {name} index{' (RB3TPU_DEVICE_OCC=rb)' if lay == 'rb32' else ''}"
                f": file byte-equal to `python -m ropebwt3_tpu ssa`; launches {launches}; port in-process {port_s:.3f} s, "
                f"reference `python -m ropebwt3_tpu ssa` {ref_s:.3f} s")
    sub_s, sub_err = side.result("ssa_sub")
    m_sub = re.search(r"(\d+) ssa_gen launches \(dense32\)", sub_err)
    if m_sub is None or int(m_sub.group(1)) < 1:
        fail(f"`python -m ropebwt3_tpu_torch ssa` reported no dense32 launch: {sub_err[-500:]}")
    if open(sub_fn, "rb").read() != open(refs["many"][0], "rb").read():
        fail("`python -m ropebwt3_tpu_torch ssa` on the many index differs from `python -m ropebwt3_tpu ssa`")
    say(f"[ssa] `python -m ropebwt3_tpu_torch ssa` on the many index: byte-equal, {m_sub.group(1)} dense32 launch, "
        f"{sub_s:.3f} s one-shot (in the background) ({card})")
    return res, paths


def chains_err(got, want, max_mems: int, what: str) -> int:
    """Largest difference between two Chains (kernel vs plain) over the
    filled MEM rows, the filled START log entries and the trips; fails if a
    count differs."""
    import torch

    if not torch.equal(got.n_mem.long(), want.n_mem.long()):
        fail(f"{what}: MEM counts differ from the plain version")
    filled = torch.arange(max_mems, device=got.mems.device) < got.n_mem.long().clamp(max=max_mems)[:, None]
    err = max_abs(got.mems[filled], want.mems[filled])
    if got.trips is not None:
        err = max(err, max_abs(got.trips, want.trips))
    if got.log is not None:
        if not torch.equal(got.n_log.long(), want.n_log.long()):
            fail(f"{what}: START log counts differ from the plain version")
        k = got.log.shape[1]
        filled = torch.arange(k, device=got.log.device) < got.n_log.long().clamp(max=k)[:, None]
        err = max(err, max_abs(got.log[filled], want.log[filled]))
    return err


def serial_answer(smem, x, flat, seq_off) -> tuple:
    """Every read's MEMs from the one-thread kernel, rerun with a buffer of
    the largest true count where the first buffer overflowed; and its trips."""
    import torch

    one = smem.smem_tg_cuda(x, flat, seq_off, min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS, trips=True)
    big = max(int(one.n_mem.max()), 1)
    if big > MAX_MEMS:
        one = smem.smem_tg_cuda(x, flat, seq_off, min_occ=1, min_len=MIN_LEN, max_mems=big, trips=True)
    width = one.mems.shape[1]
    filled = torch.arange(width, device=flat.device) < one.n_mem.long()[:, None]
    return one.n_mem.long(), one.mems[filled], one.trips


def smem_occupancy(kernels, layout: str, sms: int, chunked: int = 1) -> dict:
    """smem_tgc's (or with chunked 0 smem_tg's) resident blocks an SM,
    registers and local bytes a thread in `layout`
    (rb3c_occupancy_smem_tg_*), and its resident threads."""
    import ctypes

    v = [ctypes.c_int(0) for _ in range(3)]
    err = getattr(kernels.lib(), f"rb3c_occupancy_smem_tg_{layout}")(chunked, *(ctypes.byref(x) for x in v))
    if err:
        fail(f"smem_tgc {layout} occupancy query: CUDA error {err}")
    return dict(blocks_per_sm=v[0].value, local_bytes=v[1].value, regs=v[2].value,
                resident_threads=v[0].value * 256 * sms)


def parent_ab(parent: str, card: str) -> list[dict]:
    """`python -m ropebwt3_tpu_torch.smem_time` (K1 on the main path's batch)
    from the parent tree and from this one, in turns A, B, B, A: the two
    kernels' lanes must agree (digests) and the engine's rows too."""
    work = os.path.join(WORK, "smem_time")
    runs = []
    for tag, tree in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        r = subprocess.run([sys.executable, "-m", "ropebwt3_tpu_torch.smem_time", work, tag], cwd=tree,
                           capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
        if r.returncode != 0:
            fail(f"smem_time in {tree} exited {r.returncode}: {r.stderr[-2000:]}")
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
    for key in ("all", "long", "short"):
        if len({d[lay][key]["lanes_digest"] for d in runs for lay in ("dense32", "rb32")}) != 1:
            fail(f"smem_time: the parent's and this tree's smem_tgc lanes ({key}) differ")
    if len({d[lay]["engine"]["rows_digest"] for d in runs for lay in ("dense32", "rb32")}) != 1:
        fail("smem_time: the parent's and this tree's engine rows differ")
    say("[smem] K1 A B B A against the parent tree (smem_time; smem_tgc ms on the main path's batch: all / long lanes "
        "alone / short reads alone): " + "; ".join(
            f"{d['tag']} dense32 " + " / ".join(f"{d['dense32'][k]['ms']:.4f}" for k in ("all", "long", "short"))
            + " rb32 " + " / ".join(f"{d['rb32'][k]['ms']:.4f}" for k in ("all", "long", "short"))
            + f" engine {min(d['dense32']['engine']['wall_ms']):.3f} ms" for d in runs) + f" ({card})")
    return runs


def cli_run(cli, argv: list[str]) -> tuple[float, str]:
    """`python -m ropebwt3_tpu_torch <argv>` in this process (stdout to
    /dev/null); fails unless it exits 0.  Returns its wall seconds (the card
    synchronized) and its stderr."""
    import torch

    err = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    if rc != 0:
        fail(f"ropebwt3_tpu_torch {' '.join(argv)} exited {rc}: {err.getvalue()[-2000:]}")
    return s, err.getvalue()


def same_file(a: str, b: str, what: str) -> None:
    if open(a, "rb").read() != open(b, "rb").read():
        fail(f"{what}: {a} differs from {b}")


def host_batches(fa: str, batch_size: int) -> list[np.ndarray]:
    """The construction batches `build -m batch_size` reads from `fa` (both
    strands), through the port's reader as main_build calls it."""
    from ropebwt3_tpu_torch import seqio

    return [seqio.batch_nt6_flat(fl, of)[1] for _, fl, of in seqio.iter_flat_batches(fa, False, batch_size // 2)]


def longest_walk(seq: np.ndarray) -> int:
    """Steps of the longest LF walk over a batch's sequences: its longest
    0-terminated sequence, sentinel included."""
    ends = np.flatnonzero(seq == 0)
    return int(np.diff(np.concatenate([[-1], ends])).max())


def k6_ms(merge, idx, rec, m2: int, S: int, reps: int) -> tuple[float, object, object]:
    """K6's mean ms over `reps` launches at stride S, each into its own ins
    (allocated beforehand, as merge_rank_cuda's allocation takes no card
    time); returns the time, one result and its segment records."""
    import torch

    ins = [torch.empty_like(rec) for _ in range(reps)]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    segs = [merge.launch_merge_rank(idx, rec, x, m2, S)[1] for x in ins]
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, ins[0], segs[0]


# ins of the JAX package's native merge walk, in a subprocess (this script
# imports nothing of that package): merge_rank_native, which its tests hold
# bit-identical to its merge_rank_plain
NATIVE_INS = ("import sys\nimport numpy as np\nfrom ropebwt3_tpu.construct.merge import merge_rank_native\n"
              "from ropebwt3_tpu.index.dense import DenseFMIndex\nd = np.load(sys.argv[1])\n"
              "np.save(sys.argv[2], merge_rank_native(DenseFMIndex.from_bwt(d['b1']), d['b2'])[1])\n")


def native_ins(b1, b2) -> tuple[np.ndarray, float]:
    """(ins, seconds of the subprocess) of the native merge walk of B2 into B1."""
    src, dst = os.path.join(WORK, "k6_in.npz"), os.path.join(WORK, "k6_ins.npy")
    np.savez(src, b1=b1.cpu().numpy(), b2=b2.cpu().numpy())
    s, _ = run([sys.executable, "-c", NATIVE_INS, src, dst])
    return np.load(dst), s


def check_k6(merge, idx, b1, b2, reps: int, lanes_plain: bool, plain: bool = True) -> dict:
    """K6 on one merge, B2's BWT b2 into B1 (b1, its rows idx), at the
    derived stride, as merge_rank_cuda runs it: timed, and (plain) its ins
    held exactly against merge_rank_chunked_plain on the card (segment
    records too), the native walk, and (lanes_plain) merge_rank_plain on
    the card.  On rb rows the plain run counts the sectors its ranks read,
    the bound's table bytes.  Returns ins and the record of the merge."""
    import torch

    acc2, rec = merge.lf2_packed(b2)
    m2, n2 = int(acc2[1]), rec.numel()
    S = merge.stride(n2, idx.device)
    first, n_seg = merge.segments(n2, m2, S)
    ms, ins, seg = k6_ms(merge, idx, rec, m2, S, reps)
    rb = idx.layout.startswith("rb")
    sc = SectorCount(idx, [idx]) if rb else None
    chunked_plain = nat_s = None
    pseg, err = seg, 0
    if plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pins, pseg = merge.merge_rank_chunked_plain(counted(idx, sc) if rb else idx, rec.clone(), m2, S)
        torch.cuda.synchronize()
        chunked_plain = (time.perf_counter() - t0) * 1e3
        nat, nat_s = native_ins(b1, b2)
        err = max(max_abs(ins, pins), int(np.abs(ins.cpu().numpy() - nat).max()) if n2 else 0)
    plain = None
    if lanes_plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = merge.merge_rank_plain(idx, rec.clone(), m2)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        err = max(err, max_abs(ins, want))
    if err or not torch.equal(seg, pseg):
        fail(f"[construct] merge_rank_{idx.layout} (n1={idx.n}, n2={n2}, S={S}) differs from its plain versions or the "
             f"native walk by {err}, or its segment records differ")
    meet, length, _, _, hand = (x.cpu().numpy() for x in pseg)
    met = meet[m2:][meet[m2:] != merge.NEVER]
    q = np.percentile(met, [50, 99]) if met.size else [0, 0]
    return ins, dict(
        n1=idx.n, n2=n2, m2=m2, S=S, lanes=n_seg, err=err, ms=ms, plain=plain,
        chunked_plain_ms=chunked_plain, native_walk_s=nat_s, meet_median=float(q[0]), meet_p99=float(q[1]),
        meet_max=int(met.max()) if met.size else 0, never_met=int(n_seg - m2 - met.size),
        longest_segment=int(length.max()) if n_seg else 0, longest_hand_over=int(hand.max()) if n_seg else 0,
        # the rows and acc read (rb: the 32-B sectors the plain version's
        # ranks read), the records read and ins written (8 B each a B2
        # symbol), the segment records written
        bound=bound_ms((sc.bytes()[0] if rb else idx.nbytes) + 16 * n2 + 8 * merge.SEG_ROWS * n_seg),
        **({"table_bytes": idx.nbytes, "S_block": idx.S, "escape_blocks": idx.n_esc} if rb else {}))


def counted(idx, sc):
    """A copy of the rb index idx whose rank1a marks, in SectorCount sc,
    the sectors the card's rank reads: the plain merge rank takes it as it
    takes the index (check_merge holds it to RunBlockIndex)."""
    x = copy.copy(idx)
    object.__setattr__(x, "rank1a", sc.rank1a)  # an instance attribute of the frozen dataclass
    return x


def k6_line(m: dict) -> str:
    return (f"n1={m['n1']} n2={m['n2']} m2={m['m2']}: S {m['S']}, {m['lanes']} lanes, meeting length median "
            f"{m['meet_median']:.0f} / p99 {m['meet_p99']:.0f} / max {m['meet_max']} steps ({m['never_met']} strided "
            f"segments never met), longest segment {m['longest_segment']}, longest hand-over "
            f"{m['longest_hand_over']}; K6 {m['ms']:.4f} ms, bytes bound {m['bound']:.4f} ms; "
            + ("no plain check (the first merge's is; the FMD is byte-equal)" if m["chunked_plain_ms"] is None else
               f"merge_rank_chunked_plain on the card {m['chunked_plain_ms']:.1f} ms"
               + (f", merge_rank_plain {m['plain']:.1f} ms" if m["plain"] is not None else "")
               + f"; ins exact against both plain versions and the native walk ({m['native_walk_s']:.2f} s "
                 "subprocess)"))


HOST_PIECES = re.compile(r"merge in host memory over B1's (\S+) rows .*?seconds by piece: (.*)")


def check_host_merges(cli, merge, sa, dev, card: str, fa: str, fmd: str, steps: list, final, merges: list) -> dict:
    """[construct]'s host placement (F11): B1 and the merged BWT in host
    memory, B1's rows on the card.  `build -m 16M -do` with every merge
    placed there, in-process, by RB3TPU_DEVICE_OCC=rb (rb32 rows: the card
    path holds dense rows only), counts reset and read: its FMD byte-equal
    to the index build, one merge_rank_rb32 launch a merge and none of
    dense32, each merge logged with its rows and pieces.  Then the same
    merges (`steps`: B1 in host memory, B2 on the card, dense32 K6's ins)
    one by one through merge_host on dense32 and on rb32 rows, each merged
    BWT equal to the card path's, timed by piece beside the card path's
    (`merges`); and K6 on the rb32 rows at the derived stride, timed beside
    dense32's on the same merge, its ins equal to dense32's, on the first
    merge also ins and segment records exact against
    merge_rank_chunked_plain over the same rows on the card, whose ranks'
    sectors give the bound."""
    import torch

    from ropebwt3_tpu_torch.index.dense import runs_of_bwt
    from ropebwt3_tpu_torch.ops.runblock import RunBlockIndex, build_runblock_np

    port = os.path.join(WORK, "construct_port_m16_host.fmd")
    sa.SA_LAUNCHES.clear()
    merge.merge_rank_cuda.launches.clear()
    os.environ["RB3TPU_DEVICE_OCC"] = "rb"
    try:
        path_s, err = cli_run(cli, ["build", "-m", CONSTRUCT_M, "-do", port, fa])
    finally:
        del os.environ["RB3TPU_DEVICE_OCC"]
    launches = dict(merge.merge_rank_cuda.launches)
    same_file(port, fmd, f"port `build -m {CONSTRUCT_M} -do` on the host placement (rb32 rows) vs the index build")
    logged = HOST_PIECES.findall(err)
    if launches != {"rb32": len(steps)} or len(logged) != len(steps) or any(lay != "rb32" for lay, _ in logged):
        fail(f"[construct] the host placement's build launched {launches} and logged {logged}: one merge_rank_rb32 "
             f"launch and one rb32 host merge for each of the {len(steps)} merges expected")
    path_pieces = [dict((k, float(v)) for k, v in (x.rsplit(" ", 1) for x in p.split(", "))) for _, p in logged]
    say(f"[construct] `build -m {CONSTRUCT_M} -do` with every merge on the host placement (RB3TPU_DEVICE_OCC=rb: "
        f"B1 and the merged BWT in host memory, B1's rb32 rows on the card): FMD byte-equal to the index build; "
        f"launches {launches}; port in-process {path_s:.3f} s (the card path's run above: see its line); seconds by "
        f"piece a merge {path_pieces} ({card})")
    recs = []
    for i, ((b1h, b2, ins_d), m) in enumerate(zip(steps, merges)):
        want = steps[i + 1][0] if i + 1 < len(steps) else final
        rec = dict(n1=len(b1h), n2=b2.numel(), card_path=dict(rows_s=m["rows_s"], k6_ms=m["ms"], apply_s=m["apply_s"]))
        for layout in ("dense", "rb"):
            pieces = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = merge.merge_host(b1h, b2, dev, layout, pieces)
            pieces["wall"] = time.perf_counter() - t0
            if not np.array_equal(got, want):
                fail(f"[construct] merge_host on {layout} rows (merge {i}) gives another BWT than the card path")
            rec[f"host_{layout}"] = pieces
        x = RunBlockIndex.from_np(build_runblock_np(*runs_of_bwt(b1h), n=len(b1h)), dev)
        if i == 0:
            _, k6 = check_k6(merge, x, torch.from_numpy(b1h), b2, 3, lanes_plain=False)
            k6["input"] = f"the first -m {CONSTRUCT_M} merge: n1={len(b1h)}, n2={b2.numel()}"
        else:
            acc2, r2 = merge.lf2_packed(b2)
            S = merge.stride(b2.numel(), dev)
            ms, ins, seg = k6_ms(merge, x, r2, int(acc2[1]), S, 3)
            length, hand = seg[1].max(), seg[4].max()
            k6 = dict(ms=ms, S=S, longest_segment=int(length), longest_hand_over=int(hand), table_bytes=x.nbytes)
            if not np.array_equal(ins.cpu().numpy(), ins_d):
                fail(f"[construct] merge_rank_rb32 on merge {i} differs from merge_rank_dense32's ins")
            del ins, seg, r2
        k6.update(dense32_ms=m["ms"], S_block=x.S, escape_blocks=x.n_esc, table_bytes=x.nbytes)
        rec["k6_rb32"] = k6
        recs.append(rec)
        say(f"[construct] merge {i} (n1={rec['n1']}, n2={rec['n2']}) on the host placement: merge_rank_rb32 over B1's "
            f"rb32 rows (S {x.S}, {x.n_esc} escape blocks, {x.nbytes} B) {k6['ms']:.4f} ms beside merge_rank_dense32 "
            f"{m['ms']:.4f} ms, ins equal" + (f" and exact against merge_rank_chunked_plain over the rb32 rows on the "
                                             f"card ({k6['chunked_plain_ms']:.1f} ms; segment records too), bound "
                                             f"{k6['bound']:.4f} ms" if i == 0 else "")
            + f"; wall by piece, card path: rows {m['rows_s'] * 1e3:.1f} ms, K6 {m['ms']:.1f} ms, merge_apply "
            f"{m['apply_s'] * 1e3:.1f} ms; host path dense32: " + ", ".join(
                f"{k} {v * 1e3:.1f} ms" for k, v in rec["host_dense"].items() if isinstance(v, float))
            + "; host path rb32: " + ", ".join(
                f"{k} {v * 1e3:.1f} ms" for k, v in rec["host_rb"].items() if isinstance(v, float)) + f" ({card})")
        del x
    return dict(launches=launches, path_s=path_s, path_pieces=path_pieces, merges=recs)


def log_merge_s(stderr: str) -> list[float]:
    """Seconds of each merge in a `python -m ropebwt3_tpu build` log: each
    `merged the partial BWT` line's time less the line before it (its dense
    tables, lf2, native merge rank, merge apply and the merged tables)."""
    stamps = [(float(m.group(1)), m.group(2)) for m in re.finditer(r"\[M::main_build::([0-9.]+)\*[0-9.]+\] (.*)", stderr)]
    return [t - stamps[i - 1][0] for i, (t, msg) in enumerate(stamps) if msg.startswith("merged the partial BWT") and i]


CONSTRUCT_REFS = {  # [construct]'s reference builds: tag, output under WORK, argv of `python -m ropebwt3_tpu`
    "construct_ref": ("construct_ref.fmd", ["build", "-do"]),
    "construct_ref16": ("construct_ref_m16.fmd", ["build", "-m", CONSTRUCT_M, "-do"]),
    "construct_ref_many": ("construct_ref_many.fmd", ["build", "-m", MANY_M, "-do"]),
    "construct_ref_s": ("construct_ref_s.fmd", ["build", "-s", "-do"]),
}


def submit_construct_refs(bg: Background, fa: str, many_fa: str) -> None:
    """Starts [construct]'s reference builds in the background: the genomes
    in one batch and with -m 16M, the short reads with -m 12M and with -s
    (one batch, in RLO order)."""
    for tag, (out, argv) in CONSTRUCT_REFS.items():
        bg.submit(tag, [sys.executable, "-m", "ropebwt3_tpu", *argv, os.path.join(WORK, out),
                        many_fa if tag in ("construct_ref_many", "construct_ref_s") else fa])


def check_construct(cli, sa_time, dev, card: str, fa: str, fmd: str, many_fa: str, many_fmd: str,
                    bg: Background, side: Background) -> dict:
    """[construct]: `build` on the card, its FMDs byte-equal to the repo's
    own (native SA-IS) index build; K7 and K6 against their plain versions
    on the card; `merge` byte-equal to the JAX package's.  Returns the
    records of the kernels line (K6's chain floors wait for [probe]'s ns per
    step)."""
    import torch

    from ropebwt3_tpu_torch.construct import merge, sa
    from ropebwt3_tpu_torch.formats.fmd import encode_runs
    from ropebwt3_tpu_torch.index.dense import runs_of_bwt
    from ropebwt3_tpu_torch.ops.rank import OccIndex
    from ropebwt3_tpu_torch.ops.runblock import RunBlockIndex, build_runblock_np

    out = {}
    # 1. bench.py's genomes in one batch (the one-shot port on the side lane
    # meanwhile: its card work ends before K7 is timed below)
    sub_fmd = os.path.join(WORK, "construct_sub.fmd")
    side.submit("construct_sub", [sys.executable, "-m", "ropebwt3_tpu_torch", "build", "-do", sub_fmd, fa])
    port_fmd = os.path.join(WORK, "construct_port.fmd")
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    one_s, _ = cli_run(cli, ["build", "-do", port_fmd, fa])
    peak = torch.cuda.max_memory_allocated(dev) - base_mem
    same_file(port_fmd, fmd, "port `build -do` (one batch) vs the repo's index build")
    ref_fmd = os.path.join(WORK, CONSTRUCT_REFS["construct_ref"][0])
    ref_s, _ = bg.result("construct_ref")
    same_file(ref_fmd, fmd, "a fresh `python -m ropebwt3_tpu build -do`")
    sub_s, _ = side.result("construct_sub")
    same_file(sub_fmd, fmd, "`python -m ropebwt3_tpu_torch build -do`")
    # its pieces, warm: read, sort (upload, K7, download), FMD encode
    t0 = time.perf_counter()
    (seq,) = host_batches(fa, 7_000_000_000)
    t_read = time.perf_counter() - t0
    n = len(seq)
    seq_d = torch.from_numpy(seq).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bwt_host = sa.gsa_bwt(seq_d, dev)[0].cpu().numpy()
    t_sort = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = encode_runs(*runs_of_bwt(bwt_host))
    t_enc = time.perf_counter() - t0
    if data != open(fmd, "rb").read():
        fail("[construct] gsa_bwt's BWT of bench.py's batch, encoded, differs from the index build's FMD")
    if peak > sa.SA_BYTES_PER_SYMBOL * n:
        fail(f"[construct] `build -do` of one batch peaked at {peak / n:.2f} B a symbol, above SA_BYTES_PER_SYMBOL "
             f"{sa.SA_BYTES_PER_SYMBOL}")
    # 4. K7 against its plain passes on the card, round by round: each round's
    # rank and sort permutation (both sorts stable), then the final SA and BWT
    kept = []
    kt = sa_time.timed_rounds(seq_d, sa.CUDA, on_round=lambda i, r, p: kept.append((r.clone(), p.clone())))
    errs = []

    def same_round(i, r, p):
        errs.append((max_abs(kept[i][0], r), max_abs(kept[i][1], p)) if i < len(kept) else (-1, -1))
        kept[i] = None

    pt = sa_time.timed_rounds(seq_d, sa.PLAIN, on_round=same_round, library=False)
    rank_err = max((e[0] for e in errs), default=0)
    sort_err = max([e[1] for e in errs] + [max_abs(kt["sa"], pt["sa"])])
    k7_err = max(rank_err, sort_err, max_abs(kt["bwt"], pt["bwt"]))
    rounds, nr = kt["rounds"], len(kt["rounds"])
    if k7_err or nr != len(pt["rounds"]) or len(errs) != nr - 1 or \
            not np.array_equal(kt["bwt"].cpu().numpy(), bwt_host):
        fail(f"[construct] K7 kernels vs plain passes: ranks off by {rank_err}, sort permutations by {sort_err}, "
             f"sa/bwt by {k7_err}, {nr} vs {len(pt['rounds'])} rounds")
    if any(r["sorted_keys_equal_library"] is False for r in rounds):
        fail("[construct] sa_sort's sorted keys differ from torch.sort's of the same keys")
    del kept, kt["sa"], pt["sa"], kt["bwt"], pt["bwt"]
    ks, ps = sa_time.summary(n, kt), sa_time.summary(n, pt)
    k7 = dict(rounds=nr, per_round=rounds, ms=ks["passes_ms"], plain=ps["passes_ms"], sort_ms=ks["sort_ms"],
              sort_plain_ms=ps["sort_ms"], library_sort_ms=ks["library_sort_ms"], scan_ms=ks["scan_ms"],
              total_ms=ks["total_ms"], err=k7_err, rank_err=rank_err, sort_err=sort_err, bound=ks["passes_bound_ms"],
              sort_bound=ks["sort_bound_ms"], k7_bound=ks["k7_bound_ms"], int64_bound=ks["int64_passes_bound_ms"],
              bits=ks["bits"], digit_passes=ks["digit_passes"], peak_b_per_sym=peak / n,
              input=f"bench.py's batch: {n} symbols, one batch, {nr} rounds")
    say(f"[construct] `build -do` of bench.py's genomes (one batch, n={n}): FMD byte-equal to the repo's index build; "
        f"port in-process {one_s:.3f} s (read {t_read:.3f} s, upload + sort + download {t_sort:.3f} s, FMD encode "
        f"{t_enc:.3f} s), one-shot `python -m ropebwt3_tpu_torch build -do` {sub_s:.3f} s, fresh `python -m "
        f"ropebwt3_tpu build -do` (native SA-IS, {os.cpu_count()} host cores, in the background) {ref_s:.3f} s; peak card memory {peak} B "
        f"({peak / n:.2f} B a symbol, SA_BYTES_PER_SYMBOL {sa.SA_BYTES_PER_SYMBOL}) ({card})")
    say(f"[construct] K7 on bench.py's batch: {nr} rounds, live bits / digit passes and card ms per round (keys / "
        f"sa_sort / torch.sort of the same keys / flags / cumsum / scatter; wall): " + "; ".join(
            f"k={r['k']} {r['bits']}b/{r['digit_passes']}p: {r['keys']:.3f}/{r['sort']:.3f}/{r['library_sort']:.3f}/"
            f"{r['flags']:.3f}/{r['scan']:.3f}/{r['scatter']:.3f}; {r['wall']:.3f}" for r in rounds)
        + f"; final gather {kt['bwt_ms']:.3f} ms; total {k7['total_ms']:.3f} ms, of it sa_sort {k7['sort_ms']:.3f} ms "
        f"({k7['digit_passes']} digit passes; torch.sort of the same keys {k7['library_sort_ms']:.3f} ms, "
        f"sa_sort_plain on the card {k7['sort_plain_ms']:.3f} ms), cumsum {k7['scan_ms']:.3f} ms, the four passes "
        f"{k7['ms']:.3f} ms (plain passes on the card {k7['plain']:.3f} ms); each round's rank and sort permutation, "
        f"and the final sa and BWT, exact; bounds (bytes): passes {k7['bound']:.4f} ms (int64 passes, the parent's "
        f"figure, {k7['int64_bound']:.4f} ms), sa_sort {k7['sort_bound']:.4f} ms, K7 in all {k7['k7_bound']:.4f} ms "
        f"({card})")
    del seq_d
    out["sa_round"], out["sa_bytes_per_symbol"] = k7, sa.SA_BYTES_PER_SYMBOL

    # 2. the same genomes with -m 16M: three merges, the build path
    port16 = os.path.join(WORK, "construct_port_m16.fmd")
    sa.SA_LAUNCHES.clear()
    merge.merge_rank_cuda.launches.clear()
    path_s, path_err = cli_run(cli, ["build", "-m", CONSTRUCT_M, "-do", port16, fa])
    out["path"] = dict(sa=dict(sa.SA_LAUNCHES), merge=dict(merge.merge_rank_cuda.launches), s=path_s)
    same_file(port16, fmd, f"port `build -m {CONSTRUCT_M} -do` vs the one-batch index build")
    if min(out["path"]["sa"].get(p, 0) for p in ("sa_keys", "sa_sort", "sa_flags", "sa_scatter", "sa_bwt")) < 1 or \
            out["path"]["merge"].get("dense32", 0) < 1:
        fail(f"[construct] the build path launched {out['path']} (every sa_round pass, sa_sort and merge_rank_dense32 expected)")
    ref16 = os.path.join(WORK, CONSTRUCT_REFS["construct_ref16"][0])
    ref16_s, ref16_err = bg.result("construct_ref16")
    same_file(ref16, fmd, f"`python -m ropebwt3_tpu build -m {CONSTRUCT_M} -do`")
    merges, bwt, steps = [], None, []  # steps: each merge's B1 in host memory, B2 on the card, dense32 K6's ins
    for seq in host_batches(fa, cli.parse_num(CONSTRUCT_M)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b2 = sa.gsa_bwt(seq, dev)[0]
        torch.cuda.synchronize()
        t_k7 = time.perf_counter() - t0
        if bwt is None:
            bwt = b2
            continue
        t0 = time.perf_counter()
        idx = OccIndex.from_bwt(bwt)
        torch.cuda.synchronize()
        t_rows = time.perf_counter() - t0
        # the plain versions on the first merge only (a depth cut: the later two cost ~15 s on an H100)
        ins, m = check_k6(merge, idx, bwt, b2, 3, lanes_plain=False, plain=not merges)
        steps.append((bwt.cpu().numpy(), b2, ins.cpu().numpy()))
        t0 = time.perf_counter()
        merged = merge.merge_apply(bwt, b2, ins)
        torch.cuda.synchronize()
        t_apply = time.perf_counter() - t0
        del idx, ins
        # the merge as `build` runs it, its peak card memory against merge_bytes (which counts B1 and B2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        other = torch.cuda.memory_allocated(dev) - bwt.numel() - b2.numel()
        got = cli._merge_into(bwt, b2, dev)
        peak = torch.cuda.max_memory_allocated(dev) - other
        count = merge.merge_bytes(bwt.numel(), b2.numel(), m["m2"])
        if peak > count or not torch.equal(got, merged):
            fail(f"[construct] merge of {b2.numel()} symbols into {bwt.numel()}: peak {peak} B against merge_bytes "
                 f"{count} B, or _merge_into's BWT differs from the pieces'")
        m.update(longest=longest_walk(seq), k7_s=t_k7, rows_s=t_rows, apply_s=t_apply, peak_bytes=peak,
                 merge_bytes=count)
        merges.append(m)
        bwt = merged
        del got
    final = bwt.cpu().numpy()
    if encode_runs(*runs_of_bwt(final)) != open(fmd, "rb").read():
        fail(f"[construct] the -m {CONSTRUCT_M} pieces, run one by one, give another FMD")
    del bwt, b2
    native16 = log_merge_s(ref16_err)
    out["merges16"] = merges
    say(f"[construct] `build -m {CONSTRUCT_M} -do` (the build path): FMD byte-equal to the one-batch build; launches "
        f"{out['path']['sa']}, merge_rank {out['path']['merge']}; port in-process {path_s:.3f} s, `python -m "
        f"ropebwt3_tpu build -m {CONSTRUCT_M} -do` (in the background) {ref16_s:.3f} s (its merges {[round(x, 3) for x in native16]} s); "
        f"K7 per later batch (upload, sort) {[round(m['k7_s'] * 1e3, 3) for m in merges]} ms ({card})")
    for m in merges:
        say(f"[construct] -m {CONSTRUCT_M} merge, dense32, {k6_line(m)}; rows (OccIndex.from_bwt) "
            f"{m['rows_s'] * 1e3:.3f} ms, merge_apply {m['apply_s'] * 1e3:.3f} ms; peak card memory {m['peak_bytes']} "
            f"B, merge_bytes {m['merge_bytes']} B ({card})")
    out["host"] = check_host_merges(cli, merge, sa, dev, card, fa, fmd, steps, final, merges)
    del steps, final

    # 3. many short walks: the 100,000 reads with -m 12M
    many_port = os.path.join(WORK, "construct_port_many.fmd")
    many_s, _ = cli_run(cli, ["build", "-m", MANY_M, "-do", many_port, many_fa])
    same_file(many_port, many_fmd, f"port `build -m {MANY_M}` of the short reads vs their index build")
    many_ref = os.path.join(WORK, CONSTRUCT_REFS["construct_ref_many"][0])
    many_ref_s, many_ref_err = bg.result("construct_ref_many")
    same_file(many_ref, many_fmd, f"`python -m ropebwt3_tpu build -m {MANY_M}` of the short reads")
    s1, s2 = host_batches(many_fa, cli.parse_num(MANY_M))[:2]
    b1, b2 = sa.gsa_bwt(s1, dev)[0], sa.gsa_bwt(s2, dev)[0]
    steps = longest_walk(s2)
    b1h = b1.cpu().numpy()
    for layout, idx in (("dense32", OccIndex.from_bwt(b1)),
                        ("dense64", OccIndex.from_bwt(b1, int64=True, mega_shift=DENSE64_SHIFT)),
                        ("rb64", RunBlockIndex.from_np(build_runblock_np(*runs_of_bwt(b1h), n=len(b1h), S=RB64_S,
                                                                         int64=True, mega_shift=RB64_SHIFT), dev))):
        if idx.layout != layout:
            fail(f"[construct] the short reads' B1 rows are {idx.layout}, not {layout}")
        _, r = check_k6(merge, idx, b1, b2, 5, lanes_plain=layout != "rb64")
        r.update(longest=steps, many_native_merges_s=log_merge_s(many_ref_err),
                 input=f"the short reads' first merge (-m {MANY_M}): n1={idx.n}, n2={len(s2)}, m2={r['m2']} sequences "
                       f"of up to {steps} steps")
        out[f"merge_rank_{layout}"] = r
        say(f"[construct] merge_rank_{layout} on the short reads' first merge (longest walk {steps} steps)"
            + (f", B1's rows rb64 at S {idx.S} ({idx.n_esc} escape blocks, {idx.mega.shape[0]} megablocks, "
               f"{idx.nbytes} B; bound: the rb sectors the plain version's ranks read)" if layout == "rb64" else "")
            + f", {k6_line(r)} ({card})")
    say(f"[construct] `build -m {MANY_M}` of the {N_READS} short reads: FMD byte-equal to their index build; port "
        f"in-process {many_s:.3f} s, `python -m ropebwt3_tpu build -m {MANY_M}` (in the background) {many_ref_s:.3f} s (its merges "
        f"{[round(x, 3) for x in log_merge_s(many_ref_err)]} s) ({card})")
    del b1, b2, b1h

    # 4. `build -s` of the short reads past the suffix sort's cap (F6): the
    # card's budget cut in-process to give a cap of MANY_M symbols a batch,
    # the sorted batch cut at read boundaries, each piece sorted by K7 and
    # merged in order (on the host placement: the cut budget holds no card
    # path merge)
    out["sorted"] = check_sorted_build(cli, merge, sa, card, many_fa, bg)

    # 5. merge: the first and the second half of the genomes, built by the port
    halves = []
    with open(fa, "rb") as fh:
        lines = fh.read().splitlines(keepends=True)
    half = N_GENOMES  # lines of N_GENOMES // 2 genomes, two lines each
    for i in range(2):
        part = os.path.join(WORK, f"construct_half{i}.fa")
        with open(part, "wb") as fh:
            fh.writelines(lines[i * half : (i + 1) * half])
        halves.append(os.path.join(WORK, f"construct_half{i}.fmd"))
        cli_run(cli, ["build", "-do", halves[-1], part])
    port_fmr, ref_fmr = os.path.join(WORK, "construct_port.fmr"), os.path.join(WORK, "construct_ref.fmr")
    side.submit("construct_merge_ref", [sys.executable, "-m", "ropebwt3_tpu", "merge", "-o", ref_fmr, *halves])
    merge_s, _ = cli_run(cli, ["merge", "-o", port_fmr, *halves])
    ref_merge_s, _ = side.result("construct_merge_ref")
    same_file(port_fmr, ref_fmr, "port `merge` vs `python -m ropebwt3_tpu merge`")
    say(f"[construct] `merge` of the two halves ({N_GENOMES // 2} genomes each, built by the port): FMR byte-equal to "
        f"`python -m ropebwt3_tpu merge`; port in-process {merge_s:.3f} s, reference {ref_merge_s:.3f} s (beside it, in "
        f"the background) ({card})")
    return out


def check_sorted_build(cli, merge, sa, card: str, many_fa: str, bg: Background) -> dict:
    """[construct] 4: `build -s -do` of the short reads through cli.main
    with cli.card_bytes cut to a budget whose batch cap is MANY_M symbols:
    the log's cut into batches and their merges' placement, K7 launched,
    one merge_rank_dense32 launch a merge (counts reset before, read after),
    the FMD byte-equal to `python -m ropebwt3_tpu build -s -do` (one batch,
    native SA-IS, on the background lane)."""
    cap = cli.parse_num(MANY_M)
    budget = cap * 2 * (sa.SA_BYTES_PER_SYMBOL + 1)
    port = os.path.join(WORK, "construct_port_s.fmd")
    real = cli.card_bytes
    cli.card_bytes = lambda dev: budget
    sa.SA_LAUNCHES.clear()
    merge.merge_rank_cuda.launches.clear()
    try:
        s, err = cli_run(cli, ["build", "-s", "-do", port, many_fa])
    finally:
        cli.card_bytes = real
    launches = dict(merge=dict(merge.merge_rank_cuda.launches), sa=sum(sa.SA_LAUNCHES.values()))
    cut = re.search(r"cut the sorted batch of (\d+) symbols into (\d+) batches", err)
    placed = re.findall(r"merging \d+ symbols into \d+ on the (card|host)", err)
    if not cut or int(cut.group(2)) < 2 or len(placed) != int(cut.group(2)) - 1 or \
            launches["merge"] != {"dense32": len(placed)} or not launches["sa"]:
        fail(f"[construct] `build -s` past a cap of {cap} symbols: cut {cut and cut.group(0)}, placements {placed}, "
             f"launches {launches}: {err[-1500:]}")
    ref_s, _ = bg.result("construct_ref_s")
    same_file(port, os.path.join(WORK, CONSTRUCT_REFS["construct_ref_s"][0]),
              "port `build -s` cut into batches vs `python -m ropebwt3_tpu build -s` (one batch)")
    r = dict(cap=cap, budget=budget, symbols=int(cut.group(1)), batches=int(cut.group(2)), placements=placed,
             launches=launches, s=s, reference_s=ref_s)
    say(f"[construct] `build -s -do` of the {N_READS} short reads with the card's budget cut in-process to {budget} B "
        f"(a batch cap of {cap} symbols): the sorted batch of {r['symbols']} symbols cut into {r['batches']} batches, "
        f"merged on the {'/'.join(placed)}; launches: {launches['sa']} K7, merge_rank {launches['merge']}; FMD "
        f"byte-equal to `python -m ropebwt3_tpu build -s -do` (one batch); port in-process {s:.3f} s, reference "
        f"{ref_s:.3f} s (in the background) ({card})")
    return r


class RowCount:
    """A dense index for the plain versions that marks every occ row (and
    megablock base) their ranks read: the bytes a kernel on the same
    positions must load at least once."""

    def __init__(self, idx):
        import torch

        self.idx = idx
        self.rows = torch.zeros(idx.occf.shape[0], dtype=torch.bool, device=idx.device)

    def __getattr__(self, name):
        return getattr(self.idx, name)

    def rank1a(self, k):
        self.rows[k.flatten().long() >> 6] = True
        return self.idx.rank1a(k)

    def bytes(self, idx=None) -> int:
        """The marked rows' bytes in `idx`'s layout (by default its own):
        the same 48-B rows of 64 symbols, idx's megablock bases and acc."""
        import torch

        idx = idx or self.idx
        rows = self.rows.nonzero().flatten()
        mega = torch.unique(rows >> idx.mega_shift).numel() * 48 if idx.int64 else 0
        return rows.numel() * 48 + mega + nbytes(idx.acc)


PIECES_LOG = re.compile(r"wall seconds by piece[^:]*: (.*)")


def pieces_of(stderr: str, what: str) -> dict:
    """The engine's `wall seconds by piece` log line as {piece: seconds}."""
    p = PIECES_LOG.search(stderr)
    if p is None:
        fail(f"{what}: no `wall seconds by piece` line in its log")
    return {k: float(v) for k, v in (x.rsplit(" ", 1) for x in p.group(1).split(", "))}


def dp_card_lines(dp_time, kind: str, lay: str, split: dict) -> tuple[dict, str]:
    """K8's or K9's occupancy at n_best 25 and 48 and its phase split, as a
    record and as words for the phase's line."""
    occ = {n: dp_time.occupancy(kind, lay, n) for n in (25, 48)}
    if any(o is None for o in occ.values()) or split is None:
        fail(f"{kind} {lay}: the occupancy query or the timing-only kernel is missing")
    words = ("; ".join(f"at n_best {n} {o['blocks_per_sm']} blocks an SM ({o['smem_bytes']} B of shared memory, "
                       f"{o['regs']} registers a thread)" for n, o in occ.items())
             + "; phase split (lane 0's clock64 laps, summed over the unflagged): "
             + ", ".join(f"{p} {v:.1%}" for p, v in split["share"].items() if p != "hpos_scan"))
    return {"occupancy": occ, "split": split}, words


def check_hapdiv(cli, dev, card: str, fa: str, fmd: str, idxs: dict, ns: dict, bg: Background) -> dict:
    """K8 (csrc/hapdiv.cu) on bench.py's index: a 17th haplotype, genome 0
    at 1% substitutions from the seed, cut into `hapdiv`'s windows.  Per
    dense layout the kernel against hapdiv_plain on the card, exact (the
    four arrays, and the trips of the windows not flagged) on HAPDIV_CHECK
    of them, HAPDIV_INS insertion windows and HAPDIV_BIG windows at -A 100
    (all flagged); times, the bytes bound (the rows the plain version's
    ranks read) and the chain floor (the longest window's trips at the 48 MB
    table's ns a step); resident blocks an SM and the phase split of the
    timing-only twin on the 16,384-window batch.  Then `hapdiv` through
    cli.main on the whole haplotype, counts reset before and read after,
    byte-equal to `python -m ropebwt3_tpu hapdiv`, with its wall time by
    piece.  Returns the per-layout records and the path's."""
    import torch

    from ropebwt3_tpu_torch import dp_time
    from ropebwt3_tpu_torch.align import hapdiv
    from ropebwt3_tpu_torch.nt6 import char2nt6
    from ropebwt3_tpu_torch.seqio import read_seqs

    rng = np.random.default_rng(SEED + 10)
    g0 = char2nt6(next(iter(read_seqs(fa))).seq)
    hap = g0.copy()
    mut = rng.random(len(hap)) < DIVERGENCE
    hap[mut] = rng.integers(1, 5, int(mut.sum()))
    hap_fa = os.path.join(WORK, "hap17.fa")
    with open(hap_fa, "wb") as fh:
        fh.write(b">hap17\n" + np.frombuffer(b"$ACGTN", dtype=np.uint8)[hap].tobytes() + b"\n")
    ref_out, port_out = os.path.join(WORK, "hapdiv_ref.txt"), os.path.join(WORK, "hapdiv_port.txt")
    bg.submit("hapdiv_ref", [sys.executable, "-m", "ropebwt3_tpu", "hapdiv", fmd, hap_fa], ref_out)
    K = HAPDIV_K
    offs = np.arange(0, len(hap) - K + 1, HAPDIV_STEP)
    wins = hap[offs[:, None] + np.arange(K)].astype(np.int32)
    ins = []
    for st in rng.integers(0, len(g0) - K, HAPDIV_INS):
        w = g0[st : st + K].astype(np.int32)
        ins.append(np.concatenate([w[: K // 2], [4, 4, 4, 4], w[K // 2 :]])[:K])
    check = np.concatenate([wins[np.linspace(0, len(wins) - 1, HAPDIV_CHECK).astype(np.int64)], np.stack(ins)]).astype(np.int32)
    seqs = torch.from_numpy(check).to(dev)
    big = torch.from_numpy(wins[:HAPDIV_BIG]).to(dev)
    full = torch.from_numpy(wins[: hapdiv.LANES]).to(dev)
    res, plain_ref = {}, None
    for lay in ("dense32", "dense64"):
        x = idxs[lay]
        got = hapdiv.hapdiv_cuda(x, seqs, K, trips=True)
        if lay in PLAIN_ROWS:  # the result is the BWT's function: dense32's plain run, its rows marked
            want, wb, counted, plain_ms = plain_ref
        else:
            counted = RowCount(x)
            t0 = time.perf_counter()
            want = hapdiv.hapdiv_plain(counted, seqs, K, trips=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            wb = hapdiv.hapdiv_plain(x, big, K, match=100)
            plain_ref = (want, wb, counted, plain_ms)
        ok = ~want[3]
        err = max(max_abs(a, b) for a, b in zip(got[:4], want[:4]))
        if err or not torch.equal(got[4][ok], want[4][ok]):
            fail(f"hapdiv {lay}: the kernel differs from hapdiv_plain by {err} (trips equal: "
                 f"{torch.equal(got[4][ok], want[4][ok])})")
        gb = hapdiv.hapdiv_cuda(x, big, K, match=100)
        if not all(torch.equal(a, b) for a, b in zip(gb, wb)) or not bool(gb[3].all()):
            fail(f"hapdiv {lay}: at -A 100 the kernel gives {gb[3].tolist()} flags, the plain version {wb[3].tolist()}")
        arch = torch.empty((len(check), K, hapdiv.N_BEST, 2), dtype=torch.int32, device=dev)
        ms = cuda_ms(lambda: hapdiv.launch_hapdiv(x, seqs, K, arch=arch), 3)
        del arch
        arch = torch.empty((full.shape[0], K, hapdiv.N_BEST, 2), dtype=torch.int32, device=dev)
        full_ms = cuda_ms(lambda: hapdiv.launch_hapdiv(x, full, K, arch=arch), 2)
        del arch
        io_bytes = nbytes(seqs, *got[:4])
        trips = int(got[4][ok].max())
        res[lay] = dict(err=err, ms=ms, plain_ms=plain_ms, n_win=len(check), n_bad=int(want[3].sum()),
                        n_bad_ins=int(want[3][HAPDIV_CHECK:].sum()), rows_bytes=counted.bytes(x),
                        plain_rows=PLAIN_ROWS.get(lay, lay), bound_ms=bound_ms(counted.bytes(x) + io_bytes), max_trips=trips, mean_trips=float(got[4][ok].float().mean()),
                        chain_floor_ms=trips * ns[LAT_48MB] / 1e6, full_ms=full_ms, full_windows=full.shape[0])
        rec, words = dp_card_lines(dp_time, "hapdiv", lay, dp_time.timed_hapdiv(x, full, K))
        res[lay].update(rec)
        r = res[lay]
        say(f"[hapdiv] {lay}: hapdiv_cuda exact vs hapdiv_plain on {r['n_win']} windows ({HAPDIV_CHECK} of the "
            f"haplotype, {HAPDIV_INS} with an insertion; {r['n_bad']} flagged, {r['n_bad_ins']} of them insertion "
            f"windows; trips of the others equal) and on {HAPDIV_BIG} at -A 100 (all flagged); kernel {ms:.4f} ms vs "
            f"plain {plain_ms:.1f} ms ({plain_note(lay)}); bound {r['bound_ms']:.4f} ms ({r['rows_bytes']} B of rows read); chain floor "
            f"{r['chain_floor_ms']:.4f} ms (longest window {trips} trips, mean {r['mean_trips']:.1f}, at "
            f"{ns[LAT_48MB]} ns); a batch of {r['full_windows']} windows {full_ms:.3f} ms ({card})")
        say(f"[hapdiv] {lay}: {words} ({card})")
    del seqs, big, full, plain_ref

    # the hapdiv path: the reference (its run times the native DP) went to the background above
    ref_s, _ = bg.result("hapdiv_ref")
    want = open(ref_out, "rb").read()
    hapdiv.hapdiv_cuda.launches.clear()
    err = io.StringIO()
    t0 = time.perf_counter()
    with open(port_out, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["hapdiv", fmd, hap_fa])
    port_s = time.perf_counter() - t0
    launches = dict(hapdiv.hapdiv_cuda.launches)
    sys.stderr.write(err.getvalue())
    if rc != 0:
        fail(f"ropebwt3_tpu_torch hapdiv exited {rc}")
    got = open(port_out, "rb").read()
    if got != want:
        fail(f"port hapdiv differs from `python -m ropebwt3_tpu hapdiv`: {first_diff(got, want)}")
    m = re.search(r"(\d+) hapdiv launches \(dense32\); (\d+) of (\d+) windows flagged bad", err.getvalue())
    if launches.get("dense32", 0) < 1 or m is None or int(m.group(1)) != launches["dense32"] or int(m.group(3)) != len(wins):
        fail(f"hapdiv path: launches {launches}, log {m and m.group(0)}, {len(wins)} windows")
    path = dict(launches=launches, port_s=port_s, ref_s=ref_s, n_win=len(wins), n_bad=int(m.group(2)),
                lines=want.count(b"\n"), pieces=pieces_of(err.getvalue(), "hapdiv path"))
    say(f"[hapdiv] path `hapdiv` on the haplotype ({len(hap)} bp, {len(wins)} windows of {K} at step {HAPDIV_STEP}): "
        f"stdout byte-equal to `python -m ropebwt3_tpu hapdiv` ({path['lines']} lines); launches {launches}; "
        f"{path['n_bad']} windows flagged ({path['n_bad'] / len(wins):.4%}), rerun on the native DP; port "
        f"in-process {port_s:.3f} s (by piece: " + ", ".join(f"{k} {v:.3f} s" for k, v in path["pieces"].items())
        + f"), reference (native DP, {os.cpu_count()} host cores, in the background) {ref_s:.3f} s ({card})")
    hyb = engine_path(cli, ["hapdiv", "--engine=hybrid", fmd, hap_fa], ref_out, hapdiv.hapdiv_cuda)
    say(f"[hapdiv] path `hapdiv --engine=hybrid` on the haplotype: stdout byte-equal to the reference above; launches "
        f"{hyb['launches']}; {hyb['n_dev']} of {hyb['n_items']} windows on the card (RB3TPU_HAPDIV_SPLIT's default "
        f"share at the start), the card's share at the end {hyb['share']:.4f}; port in-process {hyb['port_s']:.3f} s "
        f"against {port_s:.3f} s on auto ({card})")
    past = past_card(cli, ["hapdiv", fmd, hap_fa], ref_out, hapdiv.hapdiv_cuda, "hapdiv")
    say(f"[hapdiv] past the card (F10): `hapdiv` on auto with the dense rows past mem's share of the card runs the "
        f"native DP, stdout byte-equal to the reference above, 0 hapdiv launches, in-process {past['auto_s']:.3f} s; "
        f"`hapdiv --engine=jax` with the rows past the card's bytes: one line, {past['error']!r} ({card})")
    return dict(res=res, path=path, hybrid=hyb, past_card=past)


HYBRID_LOG = re.compile(r"hybrid: (\d+) of (\d+) (?:reads|windows) on the card, the card's share at the end ([\d.]+)")


def engine_path(cli, argv: list[str], ref_fn: str, counter) -> dict:
    """`argv` (a DP command with another --engine) through cli.main, launch
    counts reset before and read after: its stdout byte-equal to the
    reference output the phase wrote to ref_fn (the split and the engine
    leave it as it is), at least one dense32 launch of `counter`'s kernel;
    with --engine=hybrid, the items the card took (at least one) and the
    share at the end from its log line.  Returns the launches, the
    in-process wall and those."""
    engine = next(a for a in argv if a.startswith("--engine="))[len("--engine="):]
    want = open(ref_fn, "rb").read()
    out_fn = ref_fn.replace("_ref.txt", f"_{engine}.txt")
    counter.launches.clear()
    err = io.StringIO()
    t0 = time.perf_counter()
    with open(out_fn, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    rec = dict(launches=dict(counter.launches), port_s=time.perf_counter() - t0)
    sys.stderr.write(err.getvalue())
    name = " ".join(argv[:2])
    if rc != 0:
        fail(f"ropebwt3_tpu_torch {name} exited {rc}")
    got = open(out_fn, "rb").read()
    if got != want:
        fail(f"port {name} differs from the reference: {first_diff(got, want)}")
    if rec["launches"].get("dense32", 0) < 1:
        fail(f"{name}: launches {rec['launches']}")
    if engine == "hybrid":
        m = HYBRID_LOG.search(err.getvalue())
        if m is None or int(m.group(1)) < 1:
            fail(f"{name}: the card took no item ({m and m.group(0)})")
        rec.update(n_dev=int(m.group(1)), n_items=int(m.group(2)), share=float(m.group(3)))
    return rec


def past_card(cli, argv: list[str], ref_fn: str, counter, what: str) -> dict:
    """F10 on the card: `argv` (a DP command on auto) through cli.main with
    the card's budget for dense rows forced below the index's (ops/smem.py
    AUTO_RB_SHARE cut to 1e-12, mem's rule): stdout byte-equal to the
    reference in ref_fn (the JAX package's default, native), no launch of
    `counter`'s kernel, the native choice logged; then with --engine=jax
    and cli.card_bytes patched to 1,000 B: one ERROR line naming the rows'
    bytes, exit 1, no traceback, no launch, no output.  Returns the walls."""
    from ropebwt3_tpu_torch.ops import smem

    want = open(ref_fn, "rb").read()
    rec = {}
    for engine in ("auto", "jax"):
        counter.launches.clear()
        out_fn, err = ref_fn.replace("_ref.txt", f"_past_card_{engine}.txt"), io.StringIO()
        share, budget = smem.AUTO_RB_SHARE, cli.card_bytes
        if engine == "auto":
            smem.AUTO_RB_SHARE = 1e-12
        else:
            cli.card_bytes = lambda dev: 1000
        t0 = time.perf_counter()
        try:
            with open(out_fn, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main([argv[0], *([] if engine == "auto" else ["--engine=jax"]), *argv[1:]])
        finally:
            smem.AUTO_RB_SHARE, cli.card_bytes = share, budget
        rec[f"{engine}_s"] = time.perf_counter() - t0
        got, log_ = open(out_fn, "rb").read(), err.getvalue()
        errors = [ln for ln in log_.splitlines() if not ln.startswith("[M::")]
        if sum(counter.launches.values()) or "Traceback" in log_:
            fail(f"{what} past the card ({engine}): launches {dict(counter.launches)}, or a traceback: {log_[-2000:]}")
        if engine == "auto" and (rc != 0 or got != want or "auto runs the native DP: the dense rows need" not in log_):
            fail(f"{what} on auto past the card: exit {rc}, stdout {first_diff(got, want)}, or no native choice logged")
        if engine == "jax" and (rc != 1 or got or len(errors) != 1 or not errors[0].startswith(
                "ERROR: the occ rows of 1 index(es) need ~") or "which has 1000 B" not in errors[0]):
            fail(f"{what} --engine=jax past the card: exit {rc}, {len(got)} B out, errors {errors}")
        if engine == "jax":
            rec["error"] = errors[0]
    return rec


SW_LOG = re.compile(r"(\d+) sw launches \(dense32\); (\d+) of (\d+) reads on the card, (\d+) flagged bad and (\d+) of a DAWG")


def sw_path(cli, argv: list[str], fa: str, fmd: str, tag: str, bg: Background) -> dict:
    """`sw <argv>` on `fa` through cli.main, launch counts reset before and
    read after, its stdout byte-equal to `python -m ropebwt3_tpu sw <argv>`
    (`submit_sw_ref`'s, run in the background: it times the native engine).
    Returns the counts, shares, pieces and times."""
    from ropebwt3_tpu_torch.align import sw

    ref_out, port_out = os.path.join(WORK, "sw", f"{tag}_ref.txt"), os.path.join(WORK, "sw", f"{tag}_port.txt")
    ref_s, _ = bg.result(f"sw_{tag}_ref")
    want = open(ref_out, "rb").read()
    sw.sw_cuda.launches.clear()
    err = io.StringIO()
    t0 = time.perf_counter()
    with open(port_out, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["sw", *argv, fmd, fa])
    port_s = time.perf_counter() - t0
    launches = dict(sw.sw_cuda.launches)
    sys.stderr.write(err.getvalue())
    if rc != 0:
        fail(f"ropebwt3_tpu_torch sw {' '.join(argv)} exited {rc}")
    got = open(port_out, "rb").read()
    if got != want:
        fail(f"port sw {' '.join(argv)} differs from `python -m ropebwt3_tpu sw`: {first_diff(got, want)}")
    m = SW_LOG.search(err.getvalue())
    if launches.get("dense32", 0) < 1 or m is None or int(m.group(1)) != launches["dense32"]:
        fail(f"sw path {' '.join(argv)}: launches {launches}, log {m and m.group(0)}")
    n_card, n_reads, n_bad, n_shape = (int(m.group(i)) for i in (2, 3, 4, 5))
    pieces = pieces_of(err.getvalue(), f"sw path {' '.join(argv)}")
    return dict(launches=launches, port_s=port_s, ref_s=ref_s, n_reads=n_reads, card_share=n_card / n_reads,
                bad_share=n_bad / n_reads, shape_share=n_shape / n_reads, pieces=pieces, lines=want.count(b"\n"))


def submit_sw_ref(bg: Background, argv: list[str], fa: str, fmd: str, tag: str) -> None:
    """Starts `python -m ropebwt3_tpu sw <argv>` on `fa` in the background,
    its stdout to sw/<tag>_ref.txt, for `sw_path`."""
    bg.submit(f"sw_{tag}_ref", [sys.executable, "-m", "ropebwt3_tpu", "sw", *argv, fmd, fa],
              os.path.join(WORK, "sw", f"{tag}_ref.txt"))


def check_sw(cli, dev, card: str, fmd: str, reads, idxs: dict, ns: dict, bg: Background) -> dict:
    """K9 (csrc/sw.cu) on bench.py's index.  Per mode (general DAWGs, -e) and
    dense layout the kernel against sw_plain on the card, exact (bad,
    best_sc and best_pos of every read, the archive and the trips of those
    not flagged) on the first SW_CHECK / SW_CHECK_E2E short reads the card
    takes; the launch timed, and one of LANES reads; the bytes bound (the
    rows the plain version's ranks read, the DAWGs in, the archive out) and
    the chain floor (the longest read's trips at the 48 MB table's ns);
    resident blocks an SM and the phase split of the timing-only twin on
    the LANES-read launch (general DAWGs).  Then the sw paths through
    cli.main, byte-equal to the reference, with the index's SSA and
    sequence lengths beside it so PAF carries positions, and their wall
    time by piece (the card's: upload, scratch allocation, K9 with the
    archive's allocation, download)."""
    import gzip
    import shutil

    import torch

    from ropebwt3_tpu_torch import dp_time
    from ropebwt3_tpu_torch.align import bwasw, sw

    shutil.copyfile(os.path.join(WORK, "ssa_bench_ref.ssa"), fmd + ".ssa")  # the [ssa] phase's reference, -s 8
    with gzip.open(fmd + ".len.gz", "wt") as fh:
        fh.write("".join(f"g{g}\t{GENOME_LEN}\n" for g in range(N_GENOMES)))
    path_fa = write_fasta(os.path.join(WORK, "sw", "reads.fa"), reads[:SW_PATH])
    e2e_fa = write_fasta(os.path.join(WORK, "sw", "reads_e2e.fa"), reads[:SW_E2E_PATH])
    submit_sw_ref(bg, [], path_fa, fmd, "sw")
    submit_sw_ref(bg, ["--all-e2e", "-b"], e2e_fa, fmd, "e2e")
    f = cli.load_index(fmd)
    res = {}
    for mode, n_check in (("general", SW_CHECK), ("e2e", SW_CHECK_E2E)):
        opt = bwasw.SwOpt(flag=bwasw.RB3_SWF_E2E if mode == "e2e" else 0, end_len=1 if mode == "e2e" else 11)
        flat, seq_off = bwasw.flat_reads(reads[:SW_PATH])
        ok, n_node, max_pre, node_c, pre = bwasw.sw_stage(opt, f, flat, seq_off, sw.NC_MAX, sw.P_MAX)
        elig = np.flatnonzero(ok & (n_node <= sw.NC_MAX) & (max_pre <= sw.P_MAX))

        def dawgs(sel):
            NC, P = int(n_node[sel].max()), max(1, int(max_pre[sel].max()))
            return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (node_c[sel, :NC], pre[sel, :NC, :P], n_node[sel])]

        check, full = dawgs(elig[:n_check]), dawgs(elig[: sw.LANES])
        kw = dict(end_len=opt.end_len)
        big = [t[:SW_BIG] for t in check]  # scored -A 100, every read passes 4095 and is flagged
        plain_ref = None
        for lay in ("dense32", "dense64"):
            x = idxs[lay]
            got = sw.sw_cuda(x, *check, trips=True, **kw)
            if lay in PLAIN_ROWS:  # the result is the BWT's function: dense32's plain run, its rows marked
                want, wb, counted, plain_ms = plain_ref
            else:
                counted = RowCount(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = sw.sw_plain(counted, *check, trips=True, **kw)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                wb = sw.sw_plain(x, *big, match=100, **kw)
                plain_ref = (want, wb, counted, plain_ms)
            okr = ~want[6]
            rows = torch.repeat_interleave(okr, check[2].long())
            err = max(max(max_abs(a, b) for a, b in zip(got[4:7], want[4:7])),
                      max(max_abs(a[rows], b[rows]) for a, b in zip(got[:4], want[:4])))
            if err or not torch.equal(got[7][okr], want[7][okr]):
                fail(f"sw {mode} {lay}: the kernel differs from sw_plain by {err} (trips equal: "
                     f"{torch.equal(got[7][okr], want[7][okr])})")
            gb = sw.sw_cuda(x, *big, match=100, **kw)
            if not all(torch.equal(a, b) for a, b in zip(gb[4:7], wb[4:7])) or not bool(gb[6].all()):
                fail(f"sw {mode} {lay}: at -A 100 the kernel gives {gb[6].tolist()} flags, the plain version "
                     f"{wb[6].tolist()}")

            def timed(args, reps):
                arows = sw.arch_rows(args[2])
                scratch = torch.empty((int(arows[-1]), sw.N_BEST, 4), dtype=torch.int64, device=dev)
                ms = cuda_ms(lambda: sw.launch_sw(x, *args, rows=arows, scratch=scratch, **kw), reps)
                del scratch
                return ms

            ms, full_ms = timed(check, 3), timed(full, 2)
            io_bytes = nbytes(*check, *got[:7])
            trips = int(got[7][okr].max())
            r = res[f"{mode}_{lay}"] = dict(
                err=err, ms=ms, plain_ms=plain_ms, n_reads=len(check[2]), n_bad=int(want[6].sum()),
                NC=check[0].shape[1], P=check[1].shape[2], rows_bytes=counted.bytes(x), io_bytes=io_bytes,
                plain_rows=PLAIN_ROWS.get(lay, lay), bound_ms=bound_ms(counted.bytes(x) + io_bytes), max_trips=trips, mean_trips=float(got[7][okr].float().mean()),
                chain_floor_ms=trips * ns[LAT_48MB] / 1e6, full_ms=full_ms, full_reads=len(full[2]))
            words = None
            if mode == "general":
                rec, words = dp_card_lines(dp_time, "sw", lay, dp_time.timed_sw(x, full, kw))
                r.update(rec)
            say(f"[sw] {mode} {lay}: sw_cuda exact vs sw_plain on {r['n_reads']} reads (NC {r['NC']}, P {r['P']}; "
                f"{r['n_bad']} flagged; trips of the others equal) and on {SW_BIG} at -A 100 (all flagged); kernel {ms:.4f} ms vs plain {plain_ms:.1f} ms "
                f"({plain_note(lay)}); bound "
                f"{r['bound_ms']:.4f} ms ({r['rows_bytes']} B of rows read, {io_bytes} B in and out); chain floor "
                f"{r['chain_floor_ms']:.4f} ms (longest read {trips} trips, mean {r['mean_trips']:.1f}, at "
                f"{ns[LAT_48MB]} ns); a launch of {r['full_reads']} reads {full_ms:.3f} ms ({card})")
            if words:
                say(f"[sw] {lay}: {words} ({card})")
        del check, full, big, plain_ref

    path = sw_path(cli, [], path_fa, fmd, "sw", bg)
    e2e = sw_path(cli, ["--all-e2e", "-b"], e2e_fa, fmd, "e2e", bg)
    for name, p, fa_n in (("sw", path, SW_PATH), ("sw --all-e2e -b", e2e, SW_E2E_PATH)):
        say(f"[sw] path `{name}` on the first {fa_n} short reads ({p['n_reads']} DP reads): stdout byte-equal to "
            f"`python -m ropebwt3_tpu {name}` ({p['lines']} lines); launches {p['launches']}; reads on the card "
            f"{p['card_share']:.4%}, flagged {p['bad_share']:.4%}, sent to the host for their DAWG "
            f"{p['shape_share']:.4%}; port in-process {p['port_s']:.3f} s (by piece: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in p["pieces"].items())
            + f"), reference (native engine, {os.cpu_count()} host cores, a subprocess in the background) {p['ref_s']:.3f} s ({card})")
    engines = {e: engine_path(cli, ["sw", f"--engine={e}", fmd, path_fa], os.path.join(WORK, "sw", "sw_ref.txt"), sw.sw_cuda)
               for e in ("hybrid", "jax")}
    hyb = engines["hybrid"]
    say(f"[sw] path `sw --engine=hybrid` on the first {SW_PATH} short reads: stdout byte-equal to the reference above; "
        f"launches {hyb['launches']}; {hyb['n_dev']} of {hyb['n_items']} reads on the card (RB3TPU_SW_SPLIT's default "
        f"share at the start), the card's share at the end {hyb['share']:.4f}; port in-process {hyb['port_s']:.3f} s; "
        f"`sw --engine=jax`: byte-equal, launches {engines['jax']['launches']}, {engines['jax']['port_s']:.3f} s; "
        f"against {path['port_s']:.3f} s on auto ({card})")
    past = past_card(cli, ["sw", fmd, path_fa], os.path.join(WORK, "sw", "sw_ref.txt"), sw.sw_cuda, "sw")
    say(f"[sw] past the card (F10): `sw` on auto with the dense rows past mem's share of the card runs the native "
        f"engine, stdout byte-equal to the reference above, 0 sw launches, in-process {past['auto_s']:.3f} s; `sw "
        f"--engine=jax` with the rows past the card's bytes: one line, {past['error']!r} ({card})")
    return dict(res=res, path=path, e2e=e2e, engines=engines, past_card=past)


# [utils]: `kount` at -k KOUNT_K -m KOUNT_M (the frontier of 11-mers seen
# at least 8 times: ~2.6 M nodes on bench.py's index, at least 10^6);
# K11's passes timed K11_REPS times at the derived stride; `tools call` at
# TOOLS_HAP haplotypes on the 1,000 101-mers of the 17th haplotype's first
# TOOLS_BP bases
KOUNT_K, KOUNT_M, KOUNT_MIN_NODES = 11, 8, 1_000_000
K11_REPS, TOOLS_HAP, TOOLS_BP = 3, 16, 50_050
# `python -m ropebwt3_tpu get` (the same cli.main), with the time spent in
# DenseFMIndex.retrieve (its native rb3t_retrieve walk) summed on stderr;
# a subprocess: this script imports nothing of the JAX package
GET_REFERENCE = ("import sys, time\nfrom ropebwt3_tpu.cli import main\nfrom ropebwt3_tpu.index.dense import DenseFMIndex\n"
                 "walk, spent = DenseFMIndex.retrieve, []\n\n\ndef timed(self, k):\n    t0 = time.perf_counter()\n"
                 "    try:\n        return walk(self, k)\n    finally:\n        spent.append(time.perf_counter() - t0)\n\n\n"
                 "DenseFMIndex.retrieve = timed\nrc = main(sys.argv[1:])\n"
                 "print(f'native walks {len(spent)} {sum(spent)}', file=sys.stderr)\nsys.exit(rc)\n")
SERVE_READY_S = 300  # seconds for `serve --daemon` to answer


def utils_refs(f, fmd: str, reads_fa: str) -> dict:
    """[utils]' byte-equal checks: per tag the argv both packages take and
    the reference's command before it (`get`: the 32 sequences from their
    sentinel rows, 0 again, n - 1 and n; `suffix` of every read; `kount`)."""
    m = int(f.acc[1])
    ks = list(range(m)) + [0, f.n - 1, f.n]
    jax = [sys.executable, "-m", "ropebwt3_tpu"]
    return {"get": (["get", fmd, *map(str, ks)], [sys.executable, "-c", GET_REFERENCE]),
            "suffix": (["suffix", fmd, reads_fa], jax),
            "kount": (["kount", "-k", str(KOUNT_K), "-m", str(KOUNT_M), fmd], jax)}


def submit_utils_refs(bg: Background, f, fmd: str, reads_fa: str) -> None:
    """Starts [utils]' reference commands in the background (they read only
    the index and the reads), each writing utils/<tag>_ref.out."""
    os.makedirs(os.path.join(WORK, "utils"), exist_ok=True)
    for tag, (argv, ref) in utils_refs(f, fmd, reads_fa).items():
        bg.submit(f"{tag}_ref", ref + argv, os.path.join(WORK, "utils", f"{tag}_ref.out"))


def same_output(bg: Background, argv: list[str], port_out: str, tag: str) -> tuple[float, bytes, str]:
    """The reference's output for `tag` (`submit_utils_refs`; its wall
    seconds, measured in the background) against the port's already in
    `port_out`; fails unless byte-equal.  Returns (seconds, the reference's
    bytes, its stderr)."""
    ref_s, ref_err = bg.result(f"{tag}_ref")
    want, got = open(os.path.join(WORK, "utils", f"{tag}_ref.out"), "rb").read(), open(port_out, "rb").read()
    if got != want:
        fail(f"port {' '.join(argv[:1])} differs from `python -m ropebwt3_tpu {' '.join(argv[:1])}`: {first_diff(got, want)}")
    return ref_s, want, ref_err


def port_path(cli, argv: list[str], tag: str, counters) -> tuple[float, str, str]:
    """`argv` on DEVICE through the port's cli.main in this process (a host
    command takes no --device), the launch counts of `counters` reset
    before; fails unless rc 0.  Returns (wall seconds, stdout file,
    stderr)."""
    port_out = os.path.join(WORK, "utils", f"{tag}_port.out")
    os.makedirs(os.path.dirname(port_out), exist_ok=True)
    for c in counters:
        c.launches.clear()
    err = io.StringIO()
    t0 = time.perf_counter()
    with open(port_out, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([argv[0], *([f"--device={DEVICE}"] if argv[0] not in ("fa2kmer", "fa2line") else []), *argv[1:]])
    port_s = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    if rc != 0:
        fail(f"ropebwt3_tpu_torch {' '.join(argv[:1])} exited {rc}")
    return port_s, port_out, err.getvalue()


@contextlib.contextmanager
def rb_rows_chosen():
    """RB3TPU_DEVICE_OCC=rb for the commands run inside: the row chooser
    (cli.occ_rows) takes rb rows, as it does where dense ones would not fit
    the card."""
    old = os.environ.get("RB3TPU_DEVICE_OCC")
    os.environ["RB3TPU_DEVICE_OCC"] = "rb"
    try:
        yield
    finally:
        if old is None:
            del os.environ["RB3TPU_DEVICE_OCC"]
        else:
            os.environ["RB3TPU_DEVICE_OCC"] = old


def rb_path(cli, argv: list[str], tag: str, counters, want: bytes, log_line: str) -> tuple[float, dict, dict]:
    """`argv` through the port's cli.main on rb rows (rb_rows_chosen),
    counts reset before and read after; fails unless its stdout equals
    `want`, the reference bytes the dense run fetched, its stderr names the
    rb32 rows and `log_line`, the first kernel of `counters` launched on
    rb32 and the others not at all.  Returns (wall seconds, the first
    kernel's launches, the pieces)."""
    with rb_rows_chosen():
        port_s, port_out, err = port_path(cli, argv, tag, counters)
    launches, others = dict(counters[0].launches), [dict(c.launches) for c in counters[1:]]
    got = open(port_out, "rb").read()
    if got != want:
        fail(f"port {argv[0]} on rb rows differs from `python -m ropebwt3_tpu {argv[0]}`: {first_diff(got, want)}")
    if "occ layout rb32 (block size S " not in err or log_line not in err or not launches.get("rb32") or any(others):
        fail(f"{argv[0]} on rb rows: no rb32 rows or launch logged ({launches}; others {others}): {err[-800:]}")
    return port_s, launches, pieces_of(err, argv[0])


def retrieve_passes(walk, x, k, m: int, S: int) -> tuple[list[float], tuple]:
    """K11's walk of the ks `k` at stride S with CUDA events around each
    pass: (ms of passes 1-4, the walk's result)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    out = walk.launch_retrieve(x, k, m, S, marks=ev)
    torch.cuda.synchronize()
    return [ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), ev[3].elapsed_time(ev[4]),
            ev[4].elapsed_time(ev[5])], out


def check_utils(cli, probe, dev, card: str, fa: str, fmd: str, reads_fa: str, reads, idxs: dict, ns: dict,
                bg: Background) -> dict:
    """`get`, `suffix` and `kount` through cli.main on bench.py's index
    (counts reset before, read after), `fa2line` and `fa2kmer` of the
    genomes and `tools call` on `sw --all-e2e` of a haplotype's k-mers
    (subprocesses), each byte-equal to `python -m ropebwt3_tpu`.  K11
    (dense32, dense64) against retrieve_seg_plain on the card over the
    whole `get` walk, symbols, end rows and segment records exact, each
    pass timed beside the heads-only walk (dense32), its bound, its chain
    floor and the JAX package's native walk (timed inside the `get`
    reference); K12 (four layouts) against suffix_plain on the card, exact,
    on all the reads, timed beside its bound and chain floor; kount's level
    rank on every level of its frontier (kount_time.levels) and kount_rank
    against kount_rank_plain at the widest level, dense32 and dense64."""
    import torch

    from ropebwt3_tpu_torch import kount_time, walk_time
    from ropebwt3_tpu_torch.ops import kount, rank, smem, walk

    f = cli.load_index(fmd)
    res = {}
    refs = utils_refs(f, fmd, reads_fa)
    # the host converters of the genomes, both packages', meanwhile (checked at the end)
    tools = {tag: ([tag, fa], "ropebwt3_tpu_torch") for tag in ("fa2line", "fa2kmer")}
    for tag, (targv, module) in tools.items():
        for pkg, who in ((module, "port"), (module.replace("ropebwt3_tpu_torch", "ropebwt3_tpu"), "ref")):
            bg.submit(f"{tag}_{who}", [sys.executable, "-m", pkg, *targv], os.path.join(WORK, "utils", f"{tag}_{who}.out"))
    # ---- get: the 32 sequences from their sentinel rows, 0 again, n - 1, n
    m = int(f.acc[1])
    argv = refs["get"][0]
    ks = [int(k) for k in argv[2:]]
    port_s, port_out, err = port_path(cli, argv, "get", [walk.retrieve_cuda])
    get_pieces = pieces_of(err, "get")
    get_launches = dict(walk.retrieve_cuda.launches)
    if get_launches.get("dense32", 0) != 1 or "1 retrieve_seg walks (dense32)" not in err:
        fail(f"get: not one dense32 retrieve_seg walk ({get_launches})")
    ref_s, want, ref_err = same_output(bg, argv, port_out, "get")
    valid = [k for k in ks if 0 <= k < f.n]
    lens = [len(ln) for ln in want.split(b"\n")[1::2]]
    mt = re.search(r"native walks (\d+) ([0-9.e-]+)", ref_err)
    if mt is None or int(mt.group(1)) != len(valid):
        fail(f"get: the reference did not time its {len(valid)} native walks: {ref_err[-500:]}")
    native_walk = float(mt.group(2)) / len(valid)
    S = walk.walk_stride(f.n, m, len(valid), dev)
    heads = walk.heads_only(f.n)
    say(f"[utils] get of {len(ks)} positions ({len(valid)} walks, longest {max(lens)} steps): stdout byte-equal to "
        f"`python -m ropebwt3_tpu get`; walks {get_launches} at segment stride {S}; port in-process {port_s:.3f} s, "
        f"reference {ref_s:.3f} s (a subprocess, in the background), its native walks {native_walk:.3f} s a walk (the mean of "
        f"{len(valid)}, timed inside it); port by piece: " + ", ".join(f"{k} {v:.3f} s" for k, v in get_pieces.items())
        + f" ({card})")
    rb_s, rb_get, rb_pieces = rb_path(cli, argv, "get_rb", [walk.retrieve_cuda], want, "1 retrieve_seg walks (rb32)")
    say(f"[utils] get on rb rows (RB3TPU_DEVICE_OCC=rb): stdout byte-equal; walks {rb_get}; port in-process "
        f"{rb_s:.3f} s; by piece: " + ", ".join(f"{k} {v:.3f} s" for k, v in rb_pieces.items()) + f" ({card})")
    # K11 over the whole get walk: the kernel's symbols, end rows and records
    # in every layout against one retrieve_seg_plain on the card (dense32
    # rows: the walk is the BWT's function, whatever the rows, and the plain
    # walk takes ~12 s); the passes timed K11_REPS times; on dense32, the
    # heads-only walk (one thread a walk) in the same call; on rb rows,
    # pass 1's time a row
    k, _ = walk.check_retrieve(idxs["dense32"], valid, S, kernel=True)
    t0 = time.perf_counter()
    w_seqs, w_ends, w_rec = walk.retrieve_seg_plain(idxs["dense32"], valid, S)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    length, d, nxt, term = w_rec.cpu()
    terms, lmax, _, _, _ = walk._layout(d[: len(valid)], nxt[: len(valid)], term[: len(valid)], f.n)
    j = torch.searchsorted(terms, term).clamp(max=terms.numel() - 1)
    writes = (nxt < 0) & (terms[j] == term) & (d - length < lmax[j]) & (length > 0)
    longest1, longest3 = int(length.max()), int(length[writes].max())
    n_seg = walk.segments(f.n, m, len(valid), S)
    for lay in LAYOUTS:
        x = idxs[lay]
        is_rb = lay.startswith("rb")
        seqs, ends, rec = walk.launch_retrieve(x, k, m, S)
        torch.cuda.synchronize()
        err = max([max_abs(rec, w_rec), int(np.abs(ends - w_ends).max())]
                  + [int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) if len(a) == len(b) else 1 << 30
                     for a, b in zip(seqs, w_seqs) if len(a) or len(b)])
        if err or [len(s_) for s_ in seqs] != lens:
            fail(f"retrieve_seg {lay}: off by {err} against retrieve_seg_plain over the get walk at S {S}")
        runs = [retrieve_passes(walk, x, k, m, S)[0] for _ in range(K11_REPS)]
        heads_note = ""
        if lay == "dense32":
            head_passes, (h_seqs, h_ends, _) = retrieve_passes(walk, x, k, m, heads)
            if any(not np.array_equal(a, b) for a, b in zip(h_seqs, seqs)) or not np.array_equal(h_ends, ends):
                fail(f"retrieve_seg {lay}: the heads-only walk gives other symbols than S {S}")
            heads_note = (f"; heads-only walk {sum(head_passes):.3f} ms (passes 1-4: "
                          f"{', '.join(f'{p:.3f}' for p in head_passes)}), chain floor "
                          f"{2 * max(lens) * ns[LAT_48MB] / 1e6:.3f} ms")
            del h_seqs
        rows = (f.n + 63) // 64
        mega = (((rows - 1) >> x.mega_shift) + 1) * 48 if x.int64 else 0
        table = x.nbytes if is_rb else rows * 48 + mega
        step = RB_ROUNDS * ns[lay] if is_rb else ns[LAT_48MB]  # an rb step: the header, then its second round
        totals = [sum(p) for p in runs]
        pass1 = sum(p[0] for p in runs) / len(runs)
        res[f"retrieve_seg_{lay}"] = r = dict(
            err=err, S=S, n_seg=n_seg, rounds=walk.jump_rounds(n_seg, len(valid)), ms=sum(totals) / len(totals),
            walk_ms=totals, pass_ms=runs, plain_ms=plain_ms, plain_rows="dense32",
            bound_ms=bound_ms(table + sum(lens) + 2 * nbytes(k)), table_bytes=table,
            chain_floor_ms=(longest1 + longest3) * step / 1e6, longest_pass1=longest1,
            longest_pass3=longest3, walk_steps=sum(lens), lanes=len(valid),
            launches=(rb_get if is_rb else get_launches).get(lay, 0),
            path="get (RB3TPU_DEVICE_OCC=rb)" if is_rb else "get", pass1_ns_a_row=pass1 * 1e6 / f.n,
            pass1_s_at_human100=pass1 / f.n * HUMAN100_N / 1e3,
            native_walk_s_a_walk=native_walk, get_port_s=rb_s if is_rb else port_s, get_reference_s=ref_s,
            get_pieces=rb_pieces if is_rb else get_pieces)
        if lay == "dense32":
            r.update(heads_only_ms=sum(head_passes), heads_only_pass_ms=head_passes,
                     heads_only_chain_floor_ms=2 * max(lens) * ns[LAT_48MB] / 1e6)
        say(f"[utils] {lay}: retrieve_seg exact vs retrieve_seg_plain over the whole get walk ({len(valid)} heads, "
            f"{sum(lens)} symbols; segment stride {S}, {n_seg} segments, {r['rounds']} jump rounds; symbols, end "
            f"rows and segment records): kernel " + " / ".join(f"{t:.4f}" for t in totals) + " ms (passes 1-4: "
            + "; ".join(", ".join(f"{p:.4f}" for p in run) for run in runs) + f"); plain on the card (dense32 rows) "
            f"{plain_ms:.1f} ms; bound {r['bound_ms']:.4f} ms ({table} B of tables); chain floor "
            f"{r['chain_floor_ms']:.4f} ms (longest segment {longest1} + {longest3} steps at {step:.1f} ns){heads_note}; "
            f"pass 1 {r['pass1_ns_a_row']:.3f} ns a row ({r['pass1_s_at_human100']:.1f} s at {HUMAN100_N} symbols); the "
            f"native walk {native_walk * 1e3:.3f} ms a walk ({card})")
        del seqs, rec
    del w_seqs, w_rec

    # ---- suffix: every read
    argv = refs["suffix"][0]
    port_s, port_out, err = port_path(cli, argv, "suffix", [walk.suffix_cuda])
    sfx_launches = dict(walk.suffix_cuda.launches)
    sfx_pieces = pieces_of(err, "suffix")
    if sfx_launches.get("dense32", 0) < 1 or f"{sfx_launches['dense32']} suffix_walk launches (dense32)" not in err:
        fail(f"suffix: no dense32 suffix_walk launch ({sfx_launches})")
    ref_s, want, _ = same_output(bg, argv, port_out, "suffix")
    say(f"[utils] suffix of {len(reads)} reads: stdout byte-equal to `python -m ropebwt3_tpu suffix`; launches "
        f"{sfx_launches}; port in-process {port_s:.3f} s (by piece: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                                                             sfx_pieces.items())
        + f"), reference {ref_s:.3f} s (in the background) ({card})")
    sfx_rb_s, sfx_rb, sfx_rb_pieces = rb_path(cli, argv, "suffix_rb", [walk.suffix_cuda], want,
                                              "suffix_walk launches (rb32)")
    say(f"[utils] suffix on rb rows (RB3TPU_DEVICE_OCC=rb): stdout byte-equal; launches {sfx_rb}; port in-process "
        f"{sfx_rb_s:.3f} s; by piece: " + ", ".join(f"{k} {v:.3f} s" for k, v in sfx_rb_pieces.items()) + f" ({card})")
    flat, off = (torch.from_numpy(a).to(dev) for a in smem.pack_reads(reads))
    for lay, x in idxs.items():
        is_rb = lay.startswith("rb")
        got = walk.suffix_cuda(x, flat, off)
        # the plain walk marks the rows (rb: sectors) it ranks in and keeps
        # every step's (k, l), on which walk_time.traffic counts the row
        # fetches and sectors rank2's design requests (a model, not a
        # count the kernel makes)
        counted = walk_time.Steps(SectorCount(x, [x]) if is_rb else RowCount(x))
        t0 = time.perf_counter()
        want_t = walk.suffix_plain(counted, flat, off)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs(a, b) for a, b in zip(got, want_t))
        if err:
            fail(f"suffix_walk {lay}: off by {err} against suffix_plain")
        k, l, _, all_steps = walk_time.step_symbols(counted.calls, flat, off, want_t[0])
        fetch = walk_time.traffic(x, k, l)
        del k, l
        start, last = torch.empty_like(got[0]), torch.empty_like(got[1])
        ms = probe.queued_ms([lambda x=x: walk.launch_suffix(x, flat, off, start, last)] * 3)
        steps = int(all_steps.max())  # the longest read's: its matched symbols and the step that fails
        table = counted.idx.bytes()[0] if is_rb else counted.idx.bytes()
        occ = walk_time.occupancy(lay)
        res[f"suffix_walk_{lay}"] = r = dict(
            err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(table + nbytes(flat, off, *got)), table_bytes=table,
            chain_floor_ms=steps * (RB_ROUNDS * ns[lay] if is_rb else ns[LAT_48MB]) / 1e6, longest_steps=steps,
            regs=occ["regs"], blocks_per_sm=occ["blocks_per_sm"], launches=(sfx_rb if is_rb else sfx_launches).get(lay, 0),
            path="suffix (RB3TPU_DEVICE_OCC=rb)" if is_rb else "suffix", suffix_port_s=sfx_rb_s if is_rb else port_s,
            suffix_reference_s=ref_s, suffix_pieces=sfx_rb_pieces if is_rb else sfx_pieces)
        say(f"[utils] {lay}: suffix_walk exact vs suffix_plain on {len(reads)} reads; {ms:.4f} ms vs plain "
            f"{plain_ms:.1f} ms; bound {r['bound_ms']:.4f} ms ({table} B of tables read), chain floor "
            f"{r['chain_floor_ms']:.4f} ms (longest read {steps} steps); counted on the plain walk's "
            f"{int(all_steps.sum())} steps, rank2 requests {fetch['rank2']['fetches']} row fetches and "
            f"{fetch['rank2']['sectors']} sectors a launch ({fetch['rank2']['sectors'] * 32 / HBM_BYTES_PER_MS:.4f} ms "
            f"at 3.35 TB/s); {occ['regs']} registers, {occ['blocks_per_sm']} blocks an SM ({card})")
        del counted

    # ---- kount; then its level rank on its own frontiers (dense32, kount's
    # rows): every level timed A B C C B A by kount_time (occ_rank1a of the
    # node-major cat([k, l]), occ_rank1a of the symbol-major one, kount_rank);
    # at the widest level kount_rank against kount_rank_plain on the card,
    # dense32 and dense64, and on random unsorted (k, l) at that width
    argv = refs["kount"][0]
    port_s, port_out, err = port_path(cli, argv, "kount", [kount.kount_rank_cuda, rank.rank1a_cuda])
    kount_launches, rank_launches = dict(kount.kount_rank_cuda.launches), dict(rank.rank1a_cuda.launches)
    kount_pieces = pieces_of(err, "kount")
    ref_s, want, _ = same_output(bg, argv, port_out, "kount")
    nodes = want.count(b"\n")
    m = re.search(r"(\d+) kount_rank launches \(dense32\), the widest of (\d+) nodes", err)
    if nodes < KOUNT_MIN_NODES or kount_launches != {"dense32": KOUNT_K} or sum(rank_launches.values()) or m is None \
            or int(m.group(1)) != KOUNT_K:
        fail(f"kount: {nodes} k-mers (at least {KOUNT_MIN_NODES} wanted), kount_rank launches {kount_launches} "
             f"({KOUNT_K} dense32 wanted), occ_rank1a launches {rank_launches} (none wanted)")
    width = int(m.group(2))
    kount_rb_s, kount_rb, kount_rb_pieces = rb_path(cli, argv, "kount_rb", [kount.kount_rank_cuda, rank.rank1a_cuda],
                                                    want, f"{KOUNT_K} kount_rank launches (rb32), the widest of {width}")
    if kount_rb != {"rb32": KOUNT_K}:
        fail(f"kount on rb rows: kount_rank launches {kount_rb} ({KOUNT_K} rb32 wanted, no occ_rank1a)")
    say(f"[utils] kount on rb rows (RB3TPU_DEVICE_OCC=rb): stdout byte-equal; launches {kount_rb}; port in-process "
        f"{kount_rb_s:.3f} s; by piece: " + ", ".join(f"{k} {v:.3f} s" for k, v in kount_rb_pieces.items())
        + f" ({card})")
    x = idxs["dense32"]
    levels, frontiers = kount_time.levels(x, KOUNT_K, KOUNT_M, log=lambda line: say(f"[utils] kount {line} ({card})"))
    w = max(range(len(levels)), key=lambda d: levels[d]["nodes"])
    if levels[w]["nodes"] != width:
        fail(f"kount's widest level has {levels[w]['nodes']} nodes here and {width} in the kount run")
    kw, lw, chars = frontiers[w]
    perm = kount_time.node_major(chars)
    rng = np.random.default_rng(SEED + 20)
    ra, rb = rng.integers(0, f.n + 1, (2, width))
    mean = {v: sum(t) / len(t) for v, t in levels[w]["ms"].items()}
    res["kount"] = kr = dict(nodes=nodes, launches=kount_launches, occ_rank1a_launches=rank_launches, port_s=port_s,
                             reference_s=ref_s, pieces=kount_pieces, widest_level=w, widest_nodes=width, levels=levels,
                             widest_ms=mean, widest_bound_ms=levels[w]["bound_ms"], rb_launches=kount_rb,
                             rb_port_s=kount_rb_s, rb_pieces=kount_rb_pieces)
    for lay in LAYOUTS:
        xi = idxs[lay]
        k, l = kw.to(xi.dtype), lw.to(xi.dtype)
        got = kount.kount_rank_cuda(xi, k, l)
        t0 = time.perf_counter()
        want_t = kount.kount_rank_plain(xi, k, l)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(max_abs(a, b) for a, b in zip(got, want_t))
        rk, rl = (torch.from_numpy(v).to(dev, xi.dtype) for v in (np.minimum(ra, rb), np.maximum(ra, rb)))
        rand_err = max(max_abs(a, b) for a, b in zip(kount.kount_rank_cuda(xi, rk, rl), kount.kount_rank_plain(xi, rk, rl)))
        if err or rand_err:
            fail(f"kount_rank {lay}: off by {err} on kount's widest level, by {rand_err} on random (k, l), against "
                 f"kount_rank_plain")
        ok, size = (torch.empty_like(t) for t in got)
        ms = mean["C"] if lay == "dense32" else probe.queued_ms(
            [lambda: kount.launch_kount_rank(xi, k, l, ok, size)] * kount_time.REPS)
        if lay.startswith("rb"):  # the 32-B sectors of the rb tables that the ranks at k and l read
            table = table_bytes(rank, xi, torch.cat([k, l]))
            kr[lay] = dict(err=err, random_err=rand_err, ms=ms, plain_ms=plain_ms, table_bytes=table,
                           bound_ms=bound_ms(table + nbytes(k, l, *got)))
            note = f"{table} B of rb sectors"
        else:
            st = kount_time.level_stats(xi, k, l, perm)
            kr[lay] = dict(err=err, random_err=rand_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(st["bytes"]["C"]),
                           rows=st["rows"], row_fetches=st["warp_rows"]["C"])
            note = f"{st['rows']} rows, {st['warp_rows']['C']} row fetches"
        kr[lay]["launches"] = (kount_rb if lay.startswith("rb") else kount_launches).get(lay, 0)
        say(f"[utils] kount_rank {lay}: exact vs kount_rank_plain on kount's widest level ({width} nodes, level {w}) "
            f"and on {width} random unsorted (k, l); {ms:.4f} ms vs plain {plain_ms:.1f} ms, bound "
            f"{kr[lay]['bound_ms']:.4f} ms ({note}) ({card})")
        del got, want_t, rk, rl, ok, size
    say(f"[utils] kount -k {KOUNT_K} -m {KOUNT_M}: stdout byte-equal to `python -m ropebwt3_tpu kount` ({nodes} "
        f"k-mers: the last level's frontier); kount_rank launches {kount_launches}, occ_rank1a none, the widest of "
        f"{width} nodes; port in-process {port_s:.3f} s (by piece: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in kount_pieces.items()) + f"), reference {ref_s:.3f} s (in the background); widest level: "
        f"occ_rank1a node-major {mean['A']:.4f} ms, symbol-major {mean['B']:.4f} ms (bound "
        f"{levels[w]['bound_ms']['A']:.4f}), kount_rank {mean['C']:.4f} ms (bound {levels[w]['bound_ms']['C']:.4f}); "
        f"all {len(levels)} levels: " + ", ".join(f"{v} {sum(sum(lv['ms'][v]) / 2 for lv in levels):.4f}" for v in "ABC")
        + f" ms ({card})")
    del frontiers, kw, lw

    # ---- host commands, as subprocesses.  `call` takes `sw --all-e2e` of
    # k-mers named `ctg:start-end`, as fa2kmer writes them (on the [sw]
    # phase's reads both packages raise the k8 script's "Bug!"): 101-mers at
    # step 50 of the 17th haplotype's first TOOLS_BP bases, cut and aligned
    # by the port in this process (fa2kmer and `sw --all-e2e` match the JAX
    # package above and in [sw]); both packages' `call` read that file
    head = os.path.join(WORK, "utils", "hap17_head.fa")
    with open(os.path.join(WORK, "hap17.fa"), "rb") as fh:
        name, seq = fh.readline(), fh.readline()
    with open(head, "wb") as fh:
        fh.write(name + seq[:TOOLS_BP] + b"\n")
    _, kmers, _ = port_path(cli, ["fa2kmer", "-k101", "-w50", head], "hap17_kmers", [])
    _, sw_e2e, _ = port_path(cli, ["sw", "--all-e2e", fmd, kmers], "hap17_kmers_e2e", [])
    tools["tools_call"] = (["call", str(TOOLS_HAP), sw_e2e], "ropebwt3_tpu_torch.tools")
    for tag, (argv, module) in tools.items():
        port_out = os.path.join(WORK, "utils", f"{tag}_port.out")
        ref_out = os.path.join(WORK, "utils", f"{tag}_ref.out")
        if tag == "tools_call":  # its input comes from this phase's `sw`
            with open(port_out, "wb") as out:
                port_s, _ = run([sys.executable, "-m", module, *argv], stdout=out)
            with open(ref_out, "wb") as out:
                ref_s, _ = run([sys.executable, "-m", module.replace("ropebwt3_tpu_torch", "ropebwt3_tpu"), *argv],
                               stdout=out)
        else:
            port_s, ref_s = bg.result(f"{tag}_port")[0], bg.result(f"{tag}_ref")[0]
        got, want = open(port_out, "rb").read(), open(ref_out, "rb").read()
        if got != want or not got:
            fail(f"port {tag} differs from the JAX package's: {first_diff(got, want)}")
        res[tag] = dict(port_s=port_s, reference_s=ref_s, bytes=len(got))
        say(f"[utils] {module} {' '.join(argv[:1])}: stdout byte-equal ({len(got)} B); port {port_s:.3f} s, "
            f"reference {ref_s:.3f} s (subprocesses{', in the background' if tag != 'tools_call' else ''}) ({card})")
    return res


def check_serve(card: str, fmd: str, reads_fa: str, mem_one_shot_s: float, mem_native_s: float, mem_hybrid_s: float,
                hd: dict, swr: dict) -> dict:
    """`serve --daemon` on bench.py's index; one-shot `mem -l31` and `mem
    -l31 --engine=hybrid` (which the client sends to the server, whose
    hybrid must log reads on the card), and `hapdiv` and `sw` with
    `--engine=server`, as subprocesses answered by it, stdout byte-equal to
    the reference outputs of [mem], [hapdiv] and [sw], with the route marker
    on stderr; each timed beside the native reference and the local port:
    mem's one-shot process ([mem]'s), the hybrid's, hapdiv's and sw's
    in-process path ([mem]'s, [hapdiv]'s, [sw]'s: a one-shot process adds
    the start that mem's shows); then `serve --stop`, after which the
    server's process, socket and pid file must be gone."""
    from ropebwt3_tpu_torch import server

    port = [sys.executable, "-m", "ropebwt3_tpu_torch"]
    hap_fa, sw_fa = os.path.join(WORK, "hap17.fa"), os.path.join(WORK, "sw", "reads.fa")
    on = f"--device={DEVICE}"
    reqs = [("mem", ["mem", on, f"-l{MIN_LEN}", fmd, reads_fa], os.path.join(WORK, "native.bed"), mem_native_s),
            ("mem-hybrid", ["mem", on, "--engine=hybrid", f"-l{MIN_LEN}", fmd, reads_fa], os.path.join(WORK, "native.bed"),
             mem_native_s),
            ("hapdiv", ["hapdiv", on, "--engine=server", fmd, hap_fa], os.path.join(WORK, "hapdiv_ref.txt"),
             hd["path"]["ref_s"]),
            ("sw", ["sw", on, "--engine=server", fmd, sw_fa], os.path.join(WORK, "sw", "sw_ref.txt"),
             swr["path"]["ref_s"])]
    local = {"mem": ("one-shot", mem_one_shot_s), "mem-hybrid": ("in-process", mem_hybrid_s),
             "hapdiv": ("in-process", hd["path"]["port_s"]),
             "sw": ("in-process", swr["path"]["port_s"])}
    os.makedirs(os.path.join(WORK, "serve"), exist_ok=True)
    t0 = time.perf_counter()
    run(port + ["serve", on, "--daemon", fmd])
    while server.server_device(fmd) != DEVICE:
        if time.perf_counter() - t0 > SERVE_READY_S:
            run(port + ["serve", "--stop", fmd])
            fail(f"serve --daemon did not answer in {SERVE_READY_S} s: {open(server.log_path(fmd)).read()[-2000:]}")
        time.sleep(0.2)
    ready_s = time.perf_counter() - t0
    pid = int(open(server.pid_path(fmd)).read())
    res = dict(ready_s=ready_s, requests={})
    try:
        for name, argv, ref, ref_s in reqs:
            out = os.path.join(WORK, "serve", f"{name}_served.out")
            with open(out, "wb") as fh:
                served_s, err = run(port + argv, stdout=fh)
            got, want = open(out, "rb").read(), open(ref, "rb").read()
            if got != want:
                fail(f"{name} through the server differs from the reference: {first_diff(got, want)}")
            m = re.search(re.escape(server.MARKER) + r" \(([0-9.]+) s on the server\)", err)
            if m is None:
                fail(f"{name}: no `{server.MARKER}` on stderr: {err[-1000:]}")
            on_server = float(m.group(1))
            hyb = HYBRID_LOG.search(err)
            if (hyb is not None) != (name == "mem-hybrid") or (hyb is not None and int(hyb.group(1)) < 1):
                fail(f"{name}: the server's hybrid line is wrong or missing: {err[-1000:]}")
            how, local_s = local[name]
            res["requests"][name] = dict(served_s=served_s, on_server_s=on_server, client_s=served_s - on_server,
                                         **{f"local_{how.replace('-', '_')}_s": local_s}, reference_s=ref_s,
                                         **({} if hyb is None else dict(on_card=int(hyb.group(1)), share=float(hyb.group(3)))))
            say(f"[serve] `{' '.join(argv[:-2])}` through the server: stdout byte-equal, marker on stderr; one-shot "
                f"{served_s:.3f} s (on the server {on_server:.3f} s, the client's process and transfer "
                f"{served_s - on_server:.3f} s), local {how} port {local_s:.3f} s, native reference {ref_s:.3f} s"
                + ("" if hyb is None else f"; {hyb.group(1)} of {hyb.group(2)} reads on the card, the share at the end "
                   f"{hyb.group(3)}") + f" ({card})")
    finally:
        run(port + ["serve", "--stop", fmd])
    gone = not server.alive(pid) and not os.path.exists(server.sock_path(fmd)) and not os.path.exists(server.pid_path(fmd))
    if not gone:
        fail(f"serve --stop left pid {pid} alive ({server.alive(pid)}) or its socket / pid file")
    say(f"[serve] server ready {ready_s:.3f} s after `serve --daemon`; `serve --stop` ended it (pid {pid}), socket and "
        f"pid file gone ({card})")
    return res


def dp_mesh_path(cli, cmd: str, fa: str, fmd: str, devices: list, want_fn: str) -> dict:
    """`hapdiv` / `sw` on `fa` with the windows or reads split over `devices`
    (`--mesh=N` through the API: the CLI maps N to N cards), launch counts
    reset before and read after; stdout byte-equal to the unsharded port's
    run in `want_fn` ([hapdiv] / [sw])."""
    from ropebwt3_tpu_torch.align import cli_hooks, hapdiv, sw

    counted = hapdiv.hapdiv_cuda if cmd == "hapdiv" else sw.sw_cuda
    a = cli._search_args([fmd, fa], cmd)
    if cmd == "hapdiv":
        a.sw_opts["end_len"], a.sw_opts["e2e"] = 1, True
    f = cli._search_index(a, cmd, cmd == "sw" and not a.no_ssa)
    counted.launches.clear()
    err, out_fn = io.StringIO(), os.path.join(WORK, f"{cmd}_mesh.txt")
    t0 = time.perf_counter()
    with open(out_fn, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if cmd == "hapdiv":
            rc = cli_hooks.run_hapdiv_cli(f, a.args[1:], a.is_line, a.sw_opts, a.k, a.w, device=DEVICE, mesh=devices)
        else:
            rc = cli_hooks.run_sw_cli(f, a.args[1:], a.is_line, a.sw_opts, device=DEVICE, mesh=devices)
    port_s = time.perf_counter() - t0
    launches = dict(counted.launches)
    sys.stderr.write(err.getvalue())
    if rc != 0:
        fail(f"[mesh] {cmd} over {devices} exited {rc}")
    got, want = open(out_fn, "rb").read(), open(want_fn, "rb").read()
    if got != want:
        fail(f"[mesh] {cmd} over {len(devices)} devices differs from the unsharded run: {first_diff(got, want)}")
    if launches.get("dense32", 0) < len(devices):
        fail(f"[mesh] {cmd} over {len(devices)} devices launched {launches}")
    return dict(launches=launches, port_s=port_s, lines=want.count(b"\n"))


def mesh_cli(cli, counters, argv: list[str], want: bytes, lay: str) -> dict:
    """`mem` with `--mesh` through cli.main, launch counts reset before and
    read after: its BED byte-equal to native, smem_tgc of `lay` launched
    over the mapped rows (stderr names the mesh)."""
    port_bed = os.path.join(WORK, "port_mesh.bed")
    for counted in counters:
        counted.launches.clear()
    err = io.StringIO()
    t0 = time.perf_counter()
    with open(port_bed, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    port_s = time.perf_counter() - t0
    launches = {c.__name__: dict(c.launches) for c in counters}
    sys.stderr.write(err.getvalue())
    if rc != 0:
        fail(f"ropebwt3_tpu_torch {' '.join(argv)} exited {rc}")
    got = open(port_bed, "rb").read()
    if got != want:
        fail(f"[mesh] {' '.join(argv[:-2])}: BED differs from --engine=native: {first_diff(got, want)}")
    if launches["smem_tgc_cuda"].get(lay, 0) < 1 or f"occ layout {lay} ({lay} rows sharded over a 1x1 mesh" not in \
            err.getvalue():
        fail(f"[mesh] {' '.join(argv[:-2])}: no {lay} smem_tgc launch over the mapped rows ({launches})")
    return dict(launches=launches, port_s=port_s)


def mesh_ssa(cli, probe, dev, card: str, f, fmd: str, x, mesh, lat: float) -> dict:
    """[mesh] (g): `ssa` over a 2x4 mesh of this card on bench.py's index
    (ssa_ops.ssa_gen_mesh: the rows once, K5's pass 1 over one range a card,
    passes 2 and 3 once): each of the eight slots' ranges' pass 1 exact
    against the plain pass 1 over every segment on the card (its slots,
    those its segments wrote, and its columns of the records); the SSA
    byte-equal to `python -m ropebwt3_tpu ssa`'s file of [ssa], one range
    launch a card; the eight slots' range launches timed beside one pass 1
    over every segment (the card's range), and the mesh's walk beside the
    unsharded walk, A B B A; then `ssa --mesh=1x1` through cli.main (the
    path: counts reset before, read after)."""
    import torch

    from ropebwt3_tpu_torch import ssa_ops
    from ropebwt3_tpu_torch.formats.ssa import write_ssa_bytes
    from ropebwt3_tpu_torch.parallel.mesh import replicate, split_segments

    ref_fn = os.path.join(WORK, "ssa_bench_ref.ssa")
    ref = open(ref_fn, "rb").read()
    m, ss = int(f.acc[1]), SSA_SHIFT
    S = ssa_ops.walk_stride(f.n, m, dev)
    n_seg, n_ssa = ssa_ops.segments(f.n, m, S), ssa_ops.n_slots(x, m, ss)
    cuts = split_segments(n_seg, len(mesh.devices))
    ranges = list(zip(cuts, cuts[1:]))

    def share():
        return (torch.zeros(n_ssa, dtype=x.dtype, device=dev), torch.full((n_ssa,), -1, dtype=torch.int32, device=dev),
                torch.full((ssa_ops.SEG_ROWS, n_seg), ssa_ops.LOW, dtype=torch.int64, device=dev))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pl, plane, prec = ssa_ops.ssa_walk_plain(x, m, ss, S, 0, n_seg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, bufs = 0, []
    for g0, g1 in ranges:
        b = share()
        ssa_ops.launch_walk_range(x, m, ss, S, g0, g1, *b)
        mine = (plane >= g0) & (plane < g1)
        want_rec = torch.full_like(prec, ssa_ops.LOW)
        want_rec[:, g0:g1] = prec[:, g0:g1]
        err = max(err, max_abs(b[1], torch.where(mine, plane, -1)), max_abs(b[0], torch.where(mine, pl, 0)),
                  max_abs(b[2], want_rec))
        bufs.append(b)
    if err:
        fail(f"[mesh] ssa_gen's pass 1 by range differs from the plain pass 1 by up to {err}")
    ssa_ops.ssa_gen_mesh.launches.clear()
    t0 = time.perf_counter()
    data = write_ssa_bytes(ssa_ops.ssa_gen_mesh(f, ss, mesh))
    api_s = time.perf_counter() - t0
    api_launches = ssa_ops.ssa_gen_mesh.launches["dense32"]
    if data != ref or api_launches != len(mesh.distinct):
        fail(f"[mesh] ssa_gen_mesh over {mesh}: SSA differs from `python -m ropebwt3_tpu ssa` ({data != ref}) or "
             f"{api_launches} range launches (one a card expected)")
    reps = replicate(x, mesh.devices)
    full = share()
    k5 = {"unsharded": lambda: ssa_ops.launch_walk(x, m, ss, S), "mesh": lambda: ssa_ops.walk_mesh(reps, m, ss, S)}
    abba = [probe.queued_ms([k5[k]] * 3) for k in ("unsharded", "mesh", "mesh", "unsharded")]
    ranges_ms = probe.queued_ms([lambda: [ssa_ops.launch_walk_range(x, m, ss, S, g0, g1, *b)
                                          for (g0, g1), b in zip(ranges, bufs)]] * 3)
    pass1_ms = probe.queued_ms([lambda: ssa_ops.launch_walk_range(x, m, ss, S, 0, n_seg, *full)] * 3)
    longest = [int(prec[0, g0:g1].max()) for g0, g1 in ranges]
    # the path: `ssa --mesh=1x1` through cli.main
    port_fn = os.path.join(WORK, "ssa_bench_mesh.ssa")
    ssa_ops.ssa_gen_mesh.launches.clear()
    path_s, path_err = cli_run(cli, ["ssa", "--mesh=1x1", "-o", port_fn, fmd])
    launches = dict(ssa_ops.ssa_gen_mesh.launches)
    same_file(port_fn, ref_fn, "`ssa --mesh=1x1` vs `python -m ropebwt3_tpu ssa`")
    if launches != {"dense32": 1} or "1 ssa_gen range launches (dense32)" not in path_err:
        fail(f"[mesh] `ssa --mesh=1x1`: {launches} range launches counted (one dense32 expected)")
    r = dict(S=S, n_seg=n_seg, ranges=len(ranges), err=err, plain_ms=plain_ms, ms=pass1_ms, slot_ranges_ms=ranges_ms,
             walk_abba_ms=abba, api_s=api_s, api_launches=api_launches, launches=launches, path_s=path_s,
             longest_segment_by_range=longest, chain_floor_ms=max(longest) * lat / 1e6,
             bound_ms=bound_ms(x.nbytes + n_ssa * (x.dtype.itemsize + 4) + 8 * ssa_ops.SEG_ROWS * n_seg))
    say(f"[mesh] `ssa` over a {mesh.dp}x{mesh.idx} mesh of {dev} (the API: {mesh}): SSA byte-equal to `python -m "
        f"ropebwt3_tpu ssa`, {api_launches} range launch(es), one a card, {api_s:.3f} s; S {S}, {n_seg} segments; "
        f"each of the {len(ranges)} slots' ranges' pass 1 exact vs the plain pass 1 on the card ({plain_ms:.1f} ms); "
        f"the {len(ranges)} slots' range launches {ranges_ms:.4f} ms vs the card's one range launch {pass1_ms:.4f} "
        f"ms; the walk A B B A unsharded {abba[0]:.4f}, mesh {abba[1]:.4f} / {abba[2]:.4f}, unsharded {abba[3]:.4f} "
        f"ms; longest segment by slot range {longest} (chain floor {r['chain_floor_ms']:.4f} ms at {lat:.1f} ns); "
        f"bound {r['bound_ms']:.4f} ms; path `ssa --mesh=1x1` through cli.main: file byte-equal, launches {launches}, "
        f"{path_s:.3f} s ({card})")
    return r


def mesh_merge(merge, idx, b2, mesh, reps: int, lat: float, plain: bool = True) -> dict:
    """One merge of B2's BWT b2 into B1 (its rows idx) with B1's rows sharded
    over `mesh` and mapped into one range (merge_rank_mesh:
    merge_rank_<layout> over the mapped rows, one range a card, each pass a
    launch): ins and segment records exact against merge_rank_chunked_plain
    over rank6_sharded_plain on the card and against the unsharded K6; the
    card's two launches, and the 16 launches of the eight slots' ranges,
    timed on buffers made beforehand, and the mesh's whole merge rank (its
    buffers, launches and merges) beside the unsharded K6, A B B A.  Without
    `plain`, against the unsharded K6 alone (which [construct] holds against
    both plain versions and the native walk on the same merge).  Returns ins
    and the record."""
    import torch

    from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, split_segments

    sh = ShardedRows(idx, mesh)
    views = sh.views
    lay = views[0].layout
    acc2, rec = merge.lf2_packed(b2)
    m2, n2 = int(acc2[1]), rec.numel()
    S = merge.stride(n2, idx.device)
    first, n_seg = merge.segments(n2, m2, S)
    before = merge.merge_rank_cuda.launches[lay]
    ins, seg = merge.merge_rank_mesh(views, rec, m2, S)
    launches = merge.merge_rank_cuda.launches[lay] - before
    uins, useg = merge.launch_merge_rank(idx, rec, torch.empty_like(rec), m2, S)
    (pins, pseg), plain_ms = wall_ms_of(lambda: merge.merge_rank_chunked_plain(views[-1], rec.clone(), m2, S)) \
        if plain else ((uins, useg), None)
    err = max(max_abs(ins, pins), max_abs(ins, uins))
    if err or not (torch.equal(seg, pseg) and torch.equal(seg, useg)) or launches != 2 * len(mesh.distinct):
        fail(f"[mesh] merge_rank_{lay} (n1={idx.n}, n2={n2}, S={S}) differs from the plain version over "
             f"rank6_sharded_plain or the unsharded K6 by {err}, or its records differ, or {launches} launches "
             "(one a pass a card expected)")
    cuts = split_segments(n_seg, len(views))
    bufs = [(torch.empty_like(rec), torch.empty_like(seg)) for _ in views]
    order = [(v, g0, g1, b) for v, g0, g1, b in zip(views, cuts, cuts[1:], bufs)]

    def card():  # the path's launches: one a pass over the card's range
        x, sg = bufs[0]
        merge.launch_merge_range(views[0], rec, x, m2, S, sg, 0, n_seg, merge.WALK)
        merge.launch_merge_range(views[0], rec, x, m2, S, sg, 0, n_seg, merge.HAND_OVER)

    def ranges():
        for v, g0, g1, (x, sg) in order:
            merge.launch_merge_range(v, rec, x, m2, S, sg, g0, g1, merge.WALK)
        for v, g0, g1, (x, _) in order:
            merge.launch_merge_range(v, rec, x, m2, S, seg, g0, g1, merge.HAND_OVER)

    k6 = {"unsharded": lambda: merge.launch_merge_rank(idx, rec, torch.empty_like(rec), m2, S),
          "mesh": lambda: merge.launch_merge_mesh(views, rec, m2, S)}
    abba = [cuda_ms(k6[k], reps) for k in ("unsharded", "mesh", "mesh", "unsharded")]
    _, length, _, _, hand = (t.cpu().numpy() for t in seg)
    return ins, dict(
        layout=lay, n1=idx.n, n2=n2, m2=m2, S=S, lanes=n_seg, ranges=len(views), err=err, plain_ms=plain_ms,
        ms=cuda_ms(card, reps), slot_ranges_ms=cuda_ms(ranges, reps), merge_rank_abba_ms=abba, check_launches=launches,
        granularity=sh.gran, unit=sh.unit, nb_local=sh.nb_local, mapped_bytes=sh.phys_bytes,
        longest_segment=int(length.max()), longest_hand_over=int(hand.max()),
        chain_floor_ms=(int(length.max()) + int(hand.max())) * lat / 1e6,
        bound_ms=bound_ms(views[0].nbytes + 16 * n2 + 8 * merge.SEG_ROWS * n_seg))


def mesh_build(cli, kernels, dev, card: str, fa: str, fmd: str, many_fa: str, mesh, ns: dict) -> dict:
    """[mesh] (h): `build -m 16M` of bench.py's genomes with each merge's rank
    over a 2x4 mesh of this card (through the API: the CLI maps 2x4 to eight
    cards), FMD byte-equal to the one-batch index build; each merge held by
    `mesh_merge`, then run as `build` runs it (cli._merge_into over the
    mesh), its peak card memory (PyTorch's peak and the mapped bytes' peak)
    at or under merge_mesh_bytes; dense64 on the short reads' first merge,
    as [construct] runs dense64; registers and blocks an SM of both passes
    over the mapped rows and the unsharded ones; then `build -m 16M
    --mesh=1x1` through cli.main (the path: counts reset before, read
    after)."""
    import ctypes

    import torch

    from ropebwt3_tpu_torch.construct import merge, sa
    from ropebwt3_tpu_torch.formats.fmd import encode_runs
    from ropebwt3_tpu_torch.ops.rank import OccIndex
    from ropebwt3_tpu_torch.parallel.mesh import mapped_bytes, reset_mapped_peak

    merges, bwt = [], None
    t0 = time.perf_counter()
    for seq in host_batches(fa, cli.parse_num(CONSTRUCT_M)):
        b2 = sa.gsa_bwt(seq, dev)[0]
        if bwt is None:
            bwt = b2
            continue
        ins, r = mesh_merge(merge, OccIndex.from_bwt(bwt), b2, mesh, 3, ns[LAT_48MB], plain=not merges)
        merged = merge.merge_apply(bwt, b2, ins)
        del ins
        # the merge as `build --mesh` runs it: PyTorch's peak and the mapped slabs' (outside its allocator)
        torch.cuda.synchronize()
        card0 = mesh.devices[0]
        torch.cuda.reset_peak_memory_stats(card0)
        reset_mapped_peak(card0)
        other = torch.cuda.memory_allocated(card0) - bwt.numel() - b2.numel()
        got = cli._merge_into(bwt, b2, card0, mesh)
        torch_peak, mapped_peak = torch.cuda.max_memory_allocated(card0) - other, mapped_bytes(card0)[1]
        count = merge.merge_mesh_bytes(bwt.numel(), b2.numel(), r["m2"], mesh)[str(card0)]
        if torch_peak + mapped_peak > count or not torch.equal(got, merged):
            fail(f"[mesh] merge of {b2.numel()} symbols into {bwt.numel()} over {mesh}: peak {torch_peak} B + mapped "
                 f"{mapped_peak} B against merge_mesh_bytes {count} B, or _merge_into's BWT differs from the pieces'")
        r.update(peak_bytes=torch_peak, mapped_peak_bytes=mapped_peak, merge_mesh_bytes=count)
        merges.append(r)
        bwt = merged
        del got, merged
    if encode_runs(*cli.runs_of_bwt(bwt.cpu().numpy())) != open(fmd, "rb").read():
        fail(f"[mesh] `build -m {CONSTRUCT_M}` with the merge rank over {mesh}: FMD differs from the index build")
    api_s = time.perf_counter() - t0
    del bwt, b2
    s1, s2 = host_batches(many_fa, cli.parse_num(MANY_M))[:2]
    b1 = sa.gsa_bwt(s1, dev)[0]
    _, r64 = mesh_merge(merge, OccIndex.from_bwt(b1, int64=True, mega_shift=DENSE64_SHIFT), sa.gsa_bwt(s2, dev)[0],
                        mesh, 5, ns[LAT_L2])
    occupancy = {}
    for tag, lay in (("mapped_dense32", merges[0]["layout"]), ("dense32", "dense32"), ("mapped_dense64", r64["layout"]),
                     ("dense64", "dense64")):  # the kernels the mesh launched, then the unsharded index's
        for hand_over in (0, 1):
            b, loc, regs = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            if getattr(kernels.lib(), f"rb3c_occupancy_merge_rank_{lay}")(hand_over, ctypes.byref(b), ctypes.byref(loc),
                                                                           ctypes.byref(regs)):
                fail(f"rb3c_occupancy_merge_rank_{lay} failed")
            occupancy[f"{tag}_{'hand_over' if hand_over else 'walk'}"] = dict(regs=regs.value, blocks_per_sm=b.value,
                                                                              local_bytes=loc.value)
    port = os.path.join(WORK, "construct_port_mesh.fmd")
    merge.merge_rank_cuda.launches.clear()
    path_s, _ = cli_run(cli, ["build", "-m", CONSTRUCT_M, "--mesh=1x1", "-do", port, fa])
    launches = dict(merge.merge_rank_cuda.launches)
    same_file(port, fmd, f"`build -m {CONSTRUCT_M} --mesh=1x1 -do` vs the index build")
    if launches != {"dense32": 2 * len(merges)}:
        fail(f"[mesh] `build -m {CONSTRUCT_M} --mesh=1x1` launched {launches} (dense32 over the mapped rows, one a "
             f"pass a merge: {2 * len(merges)} expected)")
    for k in occupancy:
        if k.startswith("mapped_") and occupancy[k] != occupancy[k[7:]]:
            fail(f"[mesh] the mesh's merge rank ({k}) differs in registers or blocks from the unsharded one")
    for r in merges + [r64]:
        a = r["merge_rank_abba_ms"]
        say(f"[mesh] merge_rank_{r['layout']} over the mapped rows (n1={r['n1']}, n2={r['n2']}, m2={r['m2']}, S "
            f"{r['S']}, {r['lanes']} segments, one range a card) over a {mesh.dp}x{mesh.idx} mesh of {dev} (granularity "
            f"{r['granularity']} B, {r['unit']} rows a unit, {r['nb_local']} a slab, {r['mapped_bytes']} B mapped): ins "
            f"and records exact vs " + (f"merge_rank_chunked_plain over rank6_sharded_plain on the card ({r['plain_ms']:.1f} "
                                        "ms) and vs " if r["plain_ms"] is not None else "")
            + f"the unsharded K6; the card's 2 launches {r['ms']:.4f} ms, the {2 * r['ranges']} launches of "
            f"the slots' ranges {r['slot_ranges_ms']:.4f} ms; the mesh's merge rank A B B A unsharded {a[0]:.4f}, "
            f"mesh {a[1]:.4f} / {a[2]:.4f}, unsharded {a[3]:.4f} ms; longest segment {r['longest_segment']}, "
            f"hand-over {r['longest_hand_over']} (chain floor {r['chain_floor_ms']:.4f} ms); bound {r['bound_ms']:.4f} "
            "ms" + (f"; `build`'s merge over the mesh: peak {r['peak_bytes']} B + mapped {r['mapped_peak_bytes']} B <= "
                    f"merge_mesh_bytes {r['merge_mesh_bytes']} B" if "peak_bytes" in r else "") + f" ({card})")
    say(f"[mesh] `build -m {CONSTRUCT_M}` of bench.py's genomes with the merge rank over a {mesh.dp}x{mesh.idx} mesh "
        f"of {dev} (the API): FMD byte-equal to the index build, {api_s:.3f} s; K6 registers / blocks an SM (walk, "
        "hand-over): "
        + ", ".join(f"{k} {v['regs']} / {v['blocks_per_sm']}" for k, v in occupancy.items())
        + f"; path `build -m {CONSTRUCT_M} --mesh=1x1 -do` through cli.main: FMD byte-equal, launches {launches}, "
        f"{path_s:.3f} s ({card})")
    return dict(merges=merges, dense64=r64, occupancy=occupancy, api_s=api_s, path_s=path_s, launches=launches)


HOST_MESH = re.compile(r"merge in host memory over B1's (\S+) rows sharded over a (\S+) mesh .*?; slabs built here: "
                       r"(.*?); .*?seconds by piece: (.*)")


def mesh_host_build(cli, dev, card: str, fa: str) -> dict:
    """[mesh] (k): `build -m 16M -do --mesh=2x4` through cli.main with every
    merge on the host placement over a 2x4 mesh of this card (F12:
    launch.local_mesh patched to give it, as the CLI maps 2x4 to eight
    cards; construct/merge.py budget cut in-process between the host
    placement's largest need and the card path's smallest): B1 and the
    merged BWT in host memory, B1's dense rows built slab by slab on the
    card (OccIndex.from_bwt never called), K6 over the mapped slabs.  Its
    FMD byte-equal to [construct]'s `python -m ropebwt3_tpu build -m 16M
    -do`, each merge's slabs and pieces logged, merge_rank_dense32
    launched twice a merge (one range, a launch a pass; counts reset
    before, read after)."""
    import torch

    from ropebwt3_tpu_torch.construct import merge
    from ropebwt3_tpu_torch.ops import rank
    from ropebwt3_tpu_torch.parallel import launch
    from ropebwt3_tpu_torch.parallel.mesh import make_mesh, mapped_bytes, reset_mapped_peak

    mesh = make_mesh(MESH_DP, MESH_IDX, [dev] * (MESH_DP * MESH_IDX))
    card0 = str(mesh.devices[0])
    sizes = [(len(b), int(np.count_nonzero(b == 0))) for b in host_batches(fa, cli.parse_num(CONSTRUCT_M))]
    steps = [(sum(n for n, _ in sizes[: k + 1]), *sizes[k + 1]) for k in range(len(sizes) - 1)]
    host = [merge.merge_mesh_host_bytes(n1, n2, m2, mesh)[card0] for n1, n2, m2 in steps]
    card_path = [merge.merge_mesh_bytes(n1, n2, m2, mesh)[card0] for n1, n2, m2 in steps]
    budget = max(host)
    if budget >= min(card_path):
        fail(f"[mesh] no budget puts every merge on the host placement: host needs {host}, card path {card_path}")
    port = os.path.join(WORK, "construct_port_mesh_host.fmd")
    saved = merge.budget, launch.local_mesh, rank.OccIndex.__dict__["from_bwt"]  # the classmethod itself
    whole = []

    def from_bwt(cls, *a, **kw):
        whole.append(1)
        return saved[2].__func__(cls, *a, **kw)

    merge.budget, launch.local_mesh = (lambda d: budget), (lambda spec, device: mesh)
    rank.OccIndex.from_bwt = classmethod(from_bwt)
    merge.merge_rank_cuda.launches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_mapped_peak(dev)
    base = torch.cuda.memory_allocated(dev)
    try:
        s, err = cli_run(cli, ["build", "-m", CONSTRUCT_M, f"--mesh={MESH_DP}x{MESH_IDX}", "-do", port, fa])
    finally:
        merge.budget, launch.local_mesh, rank.OccIndex.from_bwt = saved
    peak = torch.cuda.max_memory_allocated(dev) - base, mapped_bytes(dev)[1]
    launches = dict(merge.merge_rank_cuda.launches)
    same_file(port, os.path.join(WORK, CONSTRUCT_REFS["construct_ref16"][0]),
              f"`build -m {CONSTRUCT_M} --mesh={MESH_DP}x{MESH_IDX}` on the host placement vs `python -m ropebwt3_tpu "
              f"build -m {CONSTRUCT_M} -do`")
    logged = HOST_MESH.findall(err)
    placed = re.findall(r"merging \d+ symbols into \d+ on the host: the card path over the", err)
    if len(logged) != len(steps) or len(placed) != len(steps) or whole or \
            launches != {"dense32": 2 * len(steps)} or any(lay != "dense32" or sl.count(f" on {card0} ") != MESH_IDX
                                                          for lay, _, sl, _ in logged):
        fail(f"[mesh] host-placed `build --mesh`: {len(placed)} placements and {len(logged)} host merges logged for "
             f"{len(steps)} merges, OccIndex.from_bwt called {len(whole)} times, launches {launches} (dense32, 2 a "
             f"merge, expected): {err[-2000:]}")
    pieces = [dict((k, float(v)) for k, v in (x.rsplit(" ", 1) for x in p.split(", "))) for _, _, _, p in logged]
    slabs = [[float(x.rsplit(" ", 2)[1]) for x in sl.split(", ")] for _, _, sl, _ in logged]
    r = dict(merges=[dict(n1=n1, n2=n2, m2=m2, host_bytes=h, card_path_bytes=c, pieces=p, slab_s=sl)
                     for (n1, n2, m2), h, c, p, sl in zip(steps, host, card_path, pieces, slabs)],
             budget=budget, launches=launches, s=s, torch_peak_bytes=peak[0], mapped_peak_bytes=peak[1])
    say(f"[mesh] `build -m {CONSTRUCT_M} -do --mesh={MESH_DP}x{MESH_IDX}` through cli.main on the host placement over "
        f"a {MESH_DP}x{MESH_IDX} mesh of {dev} (merge budget cut in-process to {budget} B: the host placement needs "
        f"{host} B, the card path {card_path} B): FMD byte-equal to `python -m ropebwt3_tpu build -m {CONSTRUCT_M} -do`; "
        f"B1's rows built slab by slab ({MESH_IDX} slabs a merge, s each {slabs}), OccIndex.from_bwt not called; "
        f"launches {launches}; seconds by piece a merge {pieces}; {s:.3f} s in all; card peak {peak[0]} B (PyTorch, "
        f"K7's batches included) + {peak[1]} B mapped ({card})")
    return r


def check_mesh(cli, smem, kernels, probe, dev, card: str, fmd: str, reads_fa: str, reads, idxs: dict, ns: dict,
               smem_res: dict, want_bed: bytes, f, genomes_fa: str, many_fa: str, bg: Background) -> dict:
    """[mesh]: the SMEM kernels over rows sharded on a 2x4 mesh of this card
    and mapped into one range (parallel/mesh.py, csrc/vmm.cu), per layout:
    smem_tg and smem_tgc over the mapped rows against their plain version
    (smem_tg_plain over rank6_sharded_plain, on the card) on a subset of the
    reads, exact, the other seven views' kernels equal; on the main path's
    batch smem_tgc over the mapped rows beside the unsharded rows, A B B A,
    their lane trips, registers and blocks an SM equal; dense32 and rb32
    through the mesh engine (one share a card) equal to the unsharded
    engine.  Then `mem --mesh=1x1` (and --occ=rb)
    through cli.main and as a subprocess, and `mem --mesh=2x1` under
    torchrun, two processes on this card: BED byte-equal to native;
    `hapdiv` of the 17th haplotype and `sw` of the 10,000 reads over
    [this card] x 2, byte-equal to the unsharded runs; `ssa` (`mesh_ssa`) and
    `build -m 16M` (`mesh_build`) over a 2x4 mesh of this card, and `ssa
    --mesh=2x1` under torchrun, each process's file byte-equal; `mem`,
    `build` and `ssa` with --mesh=1x2 under torchrun, an idx axis across
    the two processes (`mesh_across`); with two cards or more, `mem`,
    `ssa` and `build --mesh=2x1` and `1x2` on real cards."""
    import torch

    from ropebwt3_tpu_torch.parallel.mesh import ShardedRows, make_mesh
    from ropebwt3_tpu_torch.parallel.smem_sharded import smem_mesh

    mesh = make_mesh(MESH_DP, MESH_IDX, [dev] * (MESH_DP * MESH_IDX))
    args = dict(min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS)

    def on_card(rs):
        return tuple(torch.from_numpy(a).to(dev) for a in smem.pack_reads(rs))

    sflat, soff = on_card(reads[:MESH_TG])
    cflat, coff = on_card(reads[:MESH_TGC_SHORT] + reads[N_READS : N_READS + MESH_TGC_LONG])
    clanes = smem.chunk_lanes(coff)
    corder = smem.lane_order(clanes, coff)
    flat_np, off_np = smem.pack_reads(reads)
    aflat, aoff = torch.from_numpy(flat_np).to(dev), torch.from_numpy(off_np).to(dev)
    alanes = smem.chunk_lanes(aoff)
    aorder = smem.lane_order(alanes, aoff)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res, plain_ref = {}, None
    for name, x in idxs.items():
        t0 = time.perf_counter()
        sh = ShardedRows(x, mesh)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        v = sh.views[-1]  # dp row 1, shard column 3
        if v.layout != name:
            fail(f"[mesh] {name}: the view over the mapped rows passes for {v.layout}")
        is_rb = name.startswith("rb")
        step = RB_ROUNDS * ns[name] if is_rb else ns[LAT_48MB]
        sc1, scc = (SectorCount(v, [x]), SectorCount(v, [x])) if is_rb else (v, v)
        k1 = smem.smem_tg_cuda(v, sflat, soff, trips=True, **args)
        kc = smem.smem_tgc_cuda(v, cflat, coff, clanes, trips=True, **args)
        if name in PLAIN_ROWS:  # the chains are the BWT's function: dense32's plain runs over its mapped rows
            want1, plain, wantc, cplain = plain_ref
        else:
            want1, plain = wall_ms_of(lambda: smem.smem_tg_plain(sc1, sflat, soff, **args))
            wantc, cplain = wall_ms_of(
                lambda: smem.smem_tg_plain(scc, cflat, coff, lanes=clanes, log_len=smem.LOG_LEN, **args))
        if name == "dense32":
            plain_ref = (want1, plain, wantc, cplain)
        err1 = chains_err(k1, want1, MAX_MEMS, f"[mesh] smem_tg_{v.layout}")
        errc = chains_err(kc, wantc, MAX_MEMS, f"[mesh] smem_tgc_{v.layout}")
        if err1 or errc:
            fail(f"[mesh] {v.layout}: smem_tg off by {err1}, smem_tgc off by {errc} against the plain version")
        for w in sh.views[:-1]:  # every dp row and shard column: the same chains
            e = chains_err(smem.smem_tgc_cuda(w, cflat, coff, clanes, trips=True, **args), kc, MAX_MEMS,
                           f"[mesh] smem_tgc_{v.layout} on view {w.dp_row}/{w.device}")
            if e:
                fail(f"[mesh] {v.layout}: the views' kernels differ by {e}")
        tables = (sc1.bytes()[0] if is_rb else v.nbytes)
        ctables = (scc.bytes()[0] if is_rb else v.nbytes)
        del sc1, scc, want1, wantc
        r = dict(err=err1, cerr=errc, shard_s=shard_s, nb_local=sh.nb_local, nbytes=sh.nbytes, granularity=sh.gran,
                 unit=sh.unit, mapped_bytes=sh.phys_bytes, plain=plain, cplain=cplain, plain_rows=PLAIN_ROWS.get(name, name),
                 ms=probe.queued_ms([lambda: smem.launch_tg(v, sflat, soff, **args)] * 10),
                 bound=bound_ms(tables + nbytes(sflat, soff, k1.n_mem)
                                + int(k1.n_mem.clamp(max=MAX_MEMS).sum()) * 5 * k1.mems.element_size()),
                 floor=int(k1.trips.max()) * step / 1e6,
                 cms=probe.queued_ms([lambda: smem.launch_tgc(v, cflat, coff, clanes, corder, **args)] * 10),
                 cbound=bound_ms(ctables + nbytes(cflat, coff, clanes, kc.n_mem, kc.n_log)
                                 + int(kc.n_mem.clamp(max=MAX_MEMS).sum()) * 5 * kc.mems.element_size()
                                 + int(kc.n_log.clamp(max=smem.LOG_LEN).sum()) * 4),
                 cfloor=int(kc.trips.max()) * step / 1e6,
                 occupancy=smem_occupancy(kernels, v.layout, sms),
                 tg_occupancy=smem_occupancy(kernels, v.layout, sms, chunked=0),
                 unsharded_occupancy=smem_occupancy(kernels, name, sms))
        if r["occupancy"] != r["unsharded_occupancy"]:
            fail(f"[mesh] {name}: smem_tgc over the mapped rows takes {r['occupancy']}, the unsharded rows' "
                 f"{r['unsharded_occupancy']}")
        # the main path's batch: sharded beside unsharded smem_tgc, A B B A
        tu = smem.launch_tgc(x, aflat, aoff, alanes, aorder, trips=True, **args).trips
        ts = smem.launch_tgc(v, aflat, aoff, alanes, aorder, trips=True, **args).trips
        if not torch.equal(tu, ts):
            fail(f"[mesh] {v.layout}: lane trips on the main path's batch differ from {name}'s")
        abba = []
        for idx in (x, v, v, x):
            abba.append(probe.queued_ms([lambda idx=idx: smem.launch_tgc(idx, aflat, aoff, alanes, aorder, **args)]
                                        * MESH_REPS))
        r.update(batch_ms=(abba[1], abba[2]), batch_unsharded_ms=(abba[0], abba[3]), lane_trips=int(ts.max()),
                 batch_floor=int(ts.max()) * step / 1e6,
                 batch_bound=smem_res[name].get("batch_sector_bound", smem_res[name]["batch_bound"]))
        if name in ("dense32", "rb32"):  # the mesh engine: the batch over all eight views
            before = smem.smem_tgc_cuda.launches[v.layout]
            t0 = time.perf_counter()
            out = smem_mesh(sh.views, flat_np, off_np, **args)
            r["engine_ms"] = (time.perf_counter() - t0) * 1e3
            r["engine_launches"] = smem.smem_tgc_cuda.launches[v.layout] - before
            t0 = time.perf_counter()
            want = smem.smem_tg(x, aflat, aoff, **args)
            torch.cuda.synchronize()
            r["engine_unsharded_ms"] = (time.perf_counter() - t0) * 1e3
            if not (np.array_equal(out.counts, want.counts.cpu().numpy())
                    and np.array_equal(out.rows, want.rows.cpu().numpy())):
                fail(f"[mesh] {v.layout}: the mesh engine's rows on the main path's batch differ from {name}'s")
            if r["engine_launches"] < len(mesh.distinct):
                fail(f"[mesh] {v.layout}: the mesh engine launched smem_tgc {r['engine_launches']} times (one a card "
                     "at least)")
            r["n_mems"] = int(out.counts.sum())
        res[name] = r
        o = r["occupancy"]
        say(f"[mesh] {v.layout} over a {mesh.dp}x{mesh.idx} mesh of {dev}, mapped ({sh.nb} rows, {sh.nb_local} a slab, "
            f"granularity {sh.gran} B, {sh.unit} rows a unit, {sh.phys_bytes} B mapped, {sh.nbytes} B in all; "
            f"sharded in {shard_s:.3f} s; plain: {plain_note(name)}): smem_tg exact vs plain on {MESH_TG} reads {r['ms']:.4f} ms (plain {plain:.1f} ms, "
            f"bound {r['bound']:.4f}, chain floor {r['floor']:.4f}); smem_tgc exact vs plain on the lanes of "
            f"{MESH_TGC_SHORT} short + {MESH_TGC_LONG} long reads ({clanes.shape[0]} lanes; rows, counts, START logs, "
            f"trips; the other 7 views equal) {r['cms']:.4f} ms (plain {cplain:.1f} ms, bound {r['cbound']:.4f}, chain "
            f"floor {r['cfloor']:.4f}); main path's batch smem_tgc A B B A {name} {abba[0]:.4f}, {v.layout} "
            f"{abba[1]:.4f} / {abba[2]:.4f}, {name} {abba[3]:.4f} ms (lane trips equal, longest {r['lane_trips']}, "
            f"chain floor {r['batch_floor']:.4f} ms); smem_tgc {o['regs']} registers, {o['blocks_per_sm']} blocks an "
            f"SM, smem_tg {r['tg_occupancy']['regs']} / {r['tg_occupancy']['blocks_per_sm']}"
            + (f"; the mesh engine on the batch ({r['engine_launches']} smem_tgc launches, {r['n_mems']} MEMs) equal "
               f"to {name}'s: {r['engine_ms']:.1f} ms wall vs {r['engine_unsharded_ms']:.1f}" if "engine_ms" in r else "")
            + f" ({card})")
        del sh, v, k1, kc
    del sflat, soff, cflat, coff, aflat, aoff, alanes, aorder, plain_ref

    # (c) mem --mesh=1x1 through cli.main (the path: counts reset and read) and as a subprocess
    counters = (smem.smem_tg_cuda, smem.smem_tgc_cuda)
    paths = {}
    for extra, lay in (([], "dense32"), (["--occ=rb"], "rb32")):
        argv = ["mem", "--mesh=1x1", f"-l{MIN_LEN}", *extra, fmd, reads_fa]
        paths[lay] = mesh_cli(cli, counters, argv, want_bed, lay)
        say(f"[mesh] path `{' '.join(argv[:-2])}` through cli.main: BED byte-equal to --engine=native; launches "
            f"{paths[lay]['launches']}; in-process {paths[lay]['port_s']:.3f} s ({card})")
    sub_s, sub_err = bg.result("mesh_sub")
    if open(os.path.join(WORK, MESH_JOBS["mesh_sub"][0]), "rb").read() != want_bed:
        fail("[mesh] `python -m ropebwt3_tpu_torch mem --mesh=1x1` BED differs from --engine=native")
    say(f"[mesh] `python -m ropebwt3_tpu_torch mem --mesh=1x1 -l{MIN_LEN}` (in the background): BED byte-equal, "
        f"{sub_s:.3f} s; stderr: "
        + " | ".join(ln for ln in sub_err.strip().splitlines() if "smem_tg launches" in ln or "occ layout" in ln))

    # (d) two processes under torchrun on this card, dp 2
    tr_bed = os.path.join(WORK, MESH_JOBS["mesh_tr_mem"][0])
    tr_s, tr_err = bg.result("mesh_tr_mem")
    if open(tr_bed, "rb").read() != want_bed:
        fail(f"[mesh] torchrun mem --mesh=2x1 BED differs from --engine=native: "
             f"{first_diff(open(tr_bed, 'rb').read(), want_bed)}; stderr {tr_err[-1500:]}")
    n_launch = len(re.findall(r"smem_tg launches \(dense32\): [1-9]", tr_err))
    n_mapped = tr_err.count("occ layout dense32 (dense32 rows sharded over a 1x1 mesh")
    if n_launch != 2 or n_mapped != 2:
        fail(f"[mesh] torchrun mem --mesh=2x1: {n_launch} processes report dense32 launches, {n_mapped} over the "
             f"mapped rows: {tr_err[-1500:]}")
    say(f"[mesh] `torchrun --standalone --nproc_per_node=2 -m ropebwt3_tpu_torch mem --mesh=2x1 -l{MIN_LEN}` on this "
        f"card (gloo, in the background): BED of process 0 byte-equal to --engine=native, both processes launched "
        f"dense32 over their mapped rows; "
        f"{tr_s:.3f} s (one process: {sub_s:.3f} s) ({card})")

    # (e) hapdiv and sw over [this card] x 2
    dps = {}
    for cmd, fa, want_fn in (("hapdiv", os.path.join(WORK, "hap17.fa"), os.path.join(WORK, "hapdiv_port.txt")),
                             ("sw", os.path.join(WORK, "sw", "reads.fa"), os.path.join(WORK, "sw", "sw_port.txt"))):
        dps[cmd] = dp_mesh_path(cli, cmd, fa, fmd, [dev, dev], want_fn)
        say(f"[mesh] `{cmd}` with the work split over [{dev}] x 2 (rows uploaded once): stdout byte-equal to the "
            f"unsharded run ({dps[cmd]['lines']} lines); launches {dps[cmd]['launches']}; {dps[cmd]['port_s']:.3f} s "
            f"({card})")

    # (g) ssa and (h) build over a 2x4 mesh of this card
    ssa_r = mesh_ssa(cli, probe, dev, card, f, fmd, idxs["dense32"], mesh, ns[LAT_48MB])
    build_r = mesh_build(cli, kernels, dev, card, genomes_fa, fmd, many_fa, mesh, ns)
    # (k) build over a 2x4 mesh of this card on the host placement (F12)
    build_r["host_placed"] = mesh_host_build(cli, dev, card, genomes_fa)

    # (i) ssa under torchrun: two processes on this card, dp 2, each writes its own file
    outs = [os.path.join(WORK, f"ssa_torchrun_p{r}") for r in range(2)]
    trs_s, trs_err = bg.result("mesh_tr_ssa")
    for r, o in enumerate(outs):
        same_file(o + ".ssa", os.path.join(WORK, "ssa_bench_ref.ssa"), f"torchrun `ssa --mesh=2x1`, process {r}")
    if open(outs[1] + ".out", "rb").read() or len(re.findall(r"[1-9]\d* ssa_gen range launches \(dense32\)", trs_err)) != 2:
        fail(f"[mesh] torchrun ssa --mesh=2x1: process 1 wrote stdout, or not both processes launched: {trs_err[-1500:]}")
    say(f"[mesh] `torchrun --standalone --nproc_per_node=2 -m ropebwt3_tpu_torch ssa --mesh=2x1 -o pRANK.ssa` on this "
        f"card (gloo, in the background): both files byte-equal to `python -m ropebwt3_tpu ssa`'s, process 1's stdout "
        f"empty, both "
        f"processes launched their range; {trs_s:.3f} s ({card})")

    # (j) an idx axis across processes: torchrun, two processes on this card, --mesh=1x2 (one dp row, a slot each):
    # each process creates and fills its slab, exports it (a POSIX fd of the VMM allocation) and maps the other's
    across = mesh_across(bg, fmd, want_bed)
    say(f"[mesh] idx across processes (`torchrun --standalone --nproc_per_node=2`, --mesh=1x2, one slab a process, "
        f"each mapping the other's; in the background): `mem -l{MIN_LEN}` BED byte-equal to --engine=native, {across['mem']['s']:.3f} s "
        f"(one process, `mem --mesh=1x1`: {sub_s:.3f} s; two, `--mesh=2x1`: {tr_s:.3f} s); `build -m {CONSTRUCT_M}` "
        f"both FMDs byte-equal to the index build, {across['build']['s']:.3f} s (one process, `build -m {CONSTRUCT_M} "
        f"--mesh=1x1` in-process: {build_r['path_s']:.3f} s); `ssa` both files byte-equal, {across['ssa']['s']:.3f} s "
        f"(two processes, `--mesh=2x1`: {trs_s:.3f} s); imports "
        + "; ".join(f"{c}: " + ", ".join(f"process {r} {v}" for r, v in enumerate(across[c]["imported"]))
                    for c in ("mem", "build", "ssa"))
        + f"; launches a process: smem_tgc {across['mem']['launches']}, merge_rank {across['build']['launches']}, "
        f"ssa_gen range {across['ssa']['launches']}; slabs shared in (s, each process): mem "
        f"{across['mem']['share_s']}, build's merges {across['build']['share_s']} ({card})")

    # (f) real cards, where the machine has them
    real = {}
    if torch.cuda.device_count() >= 2:
        for spec in ("2x1", "1x2"):
            bed = os.path.join(WORK, f"port_mesh_{spec}.bed")
            with open(bed, "wb") as out:
                s_, e_ = run([sys.executable, "-m", "ropebwt3_tpu_torch", "mem", f"--mesh={spec}", f"-l{MIN_LEN}", fmd,
                              reads_fa], stdout=out)
            if open(bed, "rb").read() != want_bed:
                fail(f"[mesh] mem --mesh={spec} on {torch.cuda.device_count()} cards: BED differs from native")
            peer = re.search(r"\d+ mapping\(s\) of [^;]*", e_)
            out_ssa, out_fmd = os.path.join(WORK, f"ssa_mesh_{spec}.ssa"), os.path.join(WORK, f"build_mesh_{spec}.fmd")
            ssa_s, _ = run([sys.executable, "-m", "ropebwt3_tpu_torch", "ssa", f"--mesh={spec}", "-o", out_ssa, fmd])
            same_file(out_ssa, os.path.join(WORK, "ssa_bench_ref.ssa"), f"`ssa --mesh={spec}` on real cards")
            build_s, _ = run([sys.executable, "-m", "ropebwt3_tpu_torch", "build", "-m", CONSTRUCT_M, f"--mesh={spec}",
                              "-do", out_fmd, genomes_fa])
            same_file(out_fmd, fmd, f"`build -m {CONSTRUCT_M} --mesh={spec}` on real cards")
            real[spec] = dict(s=s_, peer=peer.group(0) if peer else None, ssa_s=ssa_s, build_s=build_s)
            say(f"[mesh] `mem`, `ssa`, `build -m {CONSTRUCT_M}` with --mesh={spec} on real cards: byte-equal, {s_:.3f} / "
                f"{ssa_s:.3f} / {build_s:.3f} s; {real[spec]['peer']} ({card})")
    else:
        say(f"[mesh] real --mesh=2x1 and 1x2 (mem, ssa, build) skipped: this machine has {torch.cuda.device_count()} "
            "card (a mapping across cards and scaling across them unmeasured)")
    return dict(res=res, paths=paths, sub_s=sub_s, torchrun_s=tr_s, dp=dps, real=real, ssa=ssa_r, build=build_r,
                torchrun_ssa_s=trs_s, across=across)


def shared_s(stderr: str) -> list[float]:
    """The seconds each ShardedRows across processes took to share its slabs
    (create, export, send, import, map, fill and the barrier), as logged."""
    return [float(x) for x in re.findall(r"slabs shared across \d+ processes in ([\d.]+) s", stderr)]


def submit_mesh_jobs(bg: Background, fmd: str, reads_fa: str, genomes_fa: str) -> None:
    """Starts [mesh]'s subprocesses in the background once their references
    exist (the native BED of [mem], the SSA of [ssa]): `mem --mesh=1x1` as
    a one-shot process, `mem` and `ssa` with --mesh=2x1 under torchrun, and
    `mesh_across`'s three --mesh=1x2 runs."""
    tr = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2"]
    port = [sys.executable, "-m", "ropebwt3_tpu_torch"]
    cmds = {
        "mesh_sub": port + ["mem", "--mesh=1x1", f"-l{MIN_LEN}", fmd, reads_fa],
        "mesh_tr_mem": tr + ["-m", "ropebwt3_tpu_torch", "mem", "--mesh=2x1", f"-l{MIN_LEN}", fmd, reads_fa],
        "mesh_tr_ssa": tr + ["--no-python", "bash", "-c", f"exec {sys.executable} -m ropebwt3_tpu_torch ssa --mesh=2x1 "
                             f"-o {WORK}/ssa_torchrun_p$RANK.ssa {fmd} > {WORK}/ssa_torchrun_p$RANK.out"],
        "across_mem": tr + ["-m", "ropebwt3_tpu_torch", "mem", "--mesh=1x2", f"-l{MIN_LEN}", fmd, reads_fa],
        "across_build": tr + ["--no-python", "bash", "-c", f"exec {sys.executable} -m ropebwt3_tpu_torch build -m "
                              f"{CONSTRUCT_M} --mesh=1x2 -do {WORK}/build_across_p$RANK.fmd {genomes_fa}"],
        "across_ssa": tr + ["--no-python", "bash", "-c", f"exec {sys.executable} -m ropebwt3_tpu_torch ssa --mesh=1x2 "
                            f"-o {WORK}/ssa_across_p$RANK.ssa {fmd} > {WORK}/ssa_across_p$RANK.out"],
    }
    for key, cmd in cmds.items():
        out = MESH_JOBS.get(key, (None,))[0]
        bg.submit(key, cmd, os.path.join(WORK, out) if out else None)


MESH_JOBS = {"mesh_sub": ("port_mesh_subprocess.bed",), "mesh_tr_mem": ("port_mesh_torchrun.bed",),
             "across_mem": ("port_mesh_across.bed",)}  # the jobs' stdout files under WORK


def mesh_across(bg: Background, fmd: str, want_bed: bytes) -> dict:
    """[mesh] (j): `mem`, `build -m 16M` and `ssa` with --mesh=1x2 under
    torchrun, two processes on this card: one dp row whose idx axis spans
    the processes, each slab created and filled by its owner, exported as
    a POSIX file descriptor and mapped by the other (parallel/mesh.py
    ShardedRows, parallel/ipc.py, csrc/vmm.cu rb3c_vmm_export / _import).
    Process 0's BED byte-equal to --engine=native, both FMDs to the index
    build, both SSA files to `python -m ropebwt3_tpu ssa`'s; each process's
    log names the slab it imported and its launches over the range (mem:
    smem_tgc dense32 over a mapping with one imported slab; build:
    merge_rank; ssa: replicated rows, so no slab, and its range launch).
    The runs are `submit_mesh_jobs`'.  Returns per command the wall, each
    process's imports (mem: its slab; build: one a merge whose slab has
    rows) and launches."""
    out = {}
    bed = os.path.join(WORK, MESH_JOBS["across_mem"][0])
    s_, err = bg.result("across_mem")
    if open(bed, "rb").read() != want_bed:
        fail(f"[mesh] torchrun mem --mesh=1x2 BED differs from --engine=native: "
             f"{first_diff(open(bed, 'rb').read(), want_bed)}; stderr {err[-1500:]}")
    imported = re.findall(r"imported slab (\d) of dp row 0 \(rows, (\d+) B\) from process (\d)", err)
    launches = re.findall(r"([1-9]\d*) smem_tg launches \(dense32\): ([1-9]\d*) chunked", err)
    mapped = err.count("dense32 rows sharded over a 1x2 mesh of ")
    one_imported = len(re.findall(r"1 mapping\(s\) of 1 physical slab\(s\) and 1 imported \(slab \d of dp row 0 "
                                  r"from process \d\)", err))
    if sorted((sl, o) for sl, _, o in imported) != [("0", "0"), ("1", "1")] or len(launches) != 2 or mapped != 2 \
            or one_imported != 2:
        fail(f"[mesh] torchrun mem --mesh=1x2: imports {imported}, launches {launches}, {mapped} mapped rows, "
             f"{one_imported} mappings with one imported slab (two of each expected): {err[-2500:]}")
    out["mem"] = dict(s=s_, launches=[int(c) for _, c in launches], share_s=shared_s(err),
                      imported=[f"slab {sl} ({b} B) from process {o}" for sl, b, o in sorted(imported, reverse=True)])
    s_, err = bg.result("across_build")
    for r in range(2):
        same_file(f"{WORK}/build_across_p{r}.fmd", fmd, f"torchrun `build -m {CONSTRUCT_M} --mesh=1x2`, process {r}")
    n_merge = err.count("merge rank over dense32 rows sharded over a 1x2 mesh")
    imp = [len(re.findall(rf"imported slab {1 - r} of dp row 0 \(rows, \d+ B\) from process {1 - r}", err))
           for r in range(2)]
    launches = [int(c) for c in re.findall(r"merge_rank launches: (\d+) dense32", err)]
    if n_merge < 2 or min(imp) < 1 or len(launches) != 2 or min(launches) < 2:
        fail(f"[mesh] torchrun build --mesh=1x2: {n_merge} merges logged, imports {imp}, merge_rank launches "
             f"{launches}: {err[-2500:]}")
    out["build"] = dict(s=s_, imported=[f"{imp[r]} slab(s) over {n_merge // 2} merges" for r in range(2)],
                        launches=launches, share_s=shared_s(err))
    s_, err = bg.result("across_ssa")
    for r in range(2):
        same_file(f"{WORK}/ssa_across_p{r}.ssa", os.path.join(WORK, "ssa_bench_ref.ssa"),
                  f"torchrun `ssa --mesh=1x2`, process {r}")
    launches = [int(c) for c in re.findall(r"([1-9]\d*) ssa_gen range launches \(dense32\) over a 1x2 mesh", err)]
    if open(f"{WORK}/ssa_across_p1.out", "rb").read() or len(launches) != 2:
        fail(f"[mesh] torchrun ssa --mesh=1x2: process 1 wrote stdout, or not both processes launched: {err[-1500:]}")
    out["ssa"] = dict(s=s_, imported=["none (the rows are replicated)"] * 2, launches=launches)
    return out


def main(argv: list[str]) -> None:
    if argv and (len(argv) != 2 or argv[0] != "--parent"):
        fail("usage: python3 chip_smoke.py [--parent TREE]")
    parent = os.path.abspath(argv[1]) if argv else None
    clock = [time.perf_counter()] * 2  # the start, the last phase's end
    phase_s = {}

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = now - clock[1]
        clock[1] = now
        say(f"[{name}] phase in {phase_s[name]:.3f} s ({now - clock[0]:.3f} s since the start)")

    if not os.path.isdir(os.path.join(ROOT, "ropebwt3_tpu_torch")) or not os.path.isdir(os.path.join(ROOT, "ropebwt3_tpu")):
        fail("run chip_smoke.py from a checkout of the repository")
    # every command, in this process and in subprocesses, returns its own
    # exit code: an ERROR line fails the rc checks (both CLIs give 0 otherwise)
    os.environ["RB3TPU_STRICT_EXIT"] = "1"
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    import ropebwt3_tpu_torch
    from ropebwt3_tpu_torch import cli, corpus, kernels, probe, sa_time, ssa_ops
    from ropebwt3_tpu_torch.ops import kount, rank, runblock, smem

    if os.path.dirname(os.path.abspath(ropebwt3_tpu_torch.__file__)) != os.path.join(ROOT, "ropebwt3_tpu_torch"):
        fail(f"imported ropebwt3_tpu_torch from {ropebwt3_tpu_torch.__file__}, not from this checkout")
    if (N_GENOMES, GENOME_LEN, DIVERGENCE, N_READS, READ_LEN, READ_ERR, SEED, N_LONG, LONG_LEN) != (
            corpus.N_GENOMES, corpus.GENOME_LEN, corpus.DIVERGENCE, corpus.N_READS, corpus.READ_LEN, corpus.READ_ERR,
            corpus.SEED, corpus.N_LONG, corpus.LONG_LEN):
        fail("the corpus constants differ from ropebwt3_tpu_torch/corpus.py's, which sa_time, dp_time and smem_time use")
    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    counters = (rank.rank1a_cuda, rank.extend_c_cuda, smem.smem_tg_cuda, smem.smem_tgc_cuda)
    bg, side = Background(), Background()  # the references' lane; the port's one-shot and torchrun runs'
    atexit.register(bg.stop)
    atexit.register(side.stop)

    # ---- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.lib()
    say(f"[build] kernels built and loaded in {time.perf_counter() - t0:.3f} s ({kernels.build()})")
    phase_done("build")

    # ---- corpus --------------------------------------------------------------
    t0 = time.perf_counter()
    fa, reads_fa, reads = make_corpus(WORK, N_GENOMES, GENOME_LEN, N_READS, N_LONG, SEED)
    t1 = time.perf_counter()
    fmd = build_index(fa)
    t2 = time.perf_counter()
    f = cli.load_index(fmd)
    idx = rank.OccIndex.from_dense(f, dev)
    say(
        f"[corpus] {N_GENOMES} x {GENOME_LEN} bp genomes, {N_READS} x {READ_LEN} bp + {N_LONG} long reads in "
        f"{t1 - t0:.3f} s; index n={f.n} built in {t2 - t1:.3f} s; occf {tuple(idx.occf.shape)} "
        f"({idx.occf.numel() * 4 / 1e6:.3f} MB) on the card in {time.perf_counter() - t2:.3f} s"
    )
    t0 = time.perf_counter()
    S_bench, s_stats = runblock.choose_S(runblock.runs_from_dense(f)[1], f.n)
    rb_np = {"rb32": runblock.from_dense_np(f, cache=None),
             "rb64": runblock.from_dense_np(f, S=RB64_S, int64=True, mega_shift=RB64_SHIFT, cache=None)}
    idxs = {
        "dense32": idx,
        "dense64": rank.OccIndex.from_dense(f, dev, int64=True, mega_shift=DENSE64_SHIFT),
        "rb32": runblock.RunBlockIndex.from_np(rb_np["rb32"], dev),
        "rb64": runblock.RunBlockIndex.from_np(rb_np["rb64"], dev),
    }
    say(
        f"[corpus] the other layouts in {time.perf_counter() - t0:.3f} s: "
        + "; ".join(
            f"{name} {x.nbytes} B ({x.nbytes / f.n:.4f} B/sym"
            + (f", S {x.S}, {x.n_esc} escape blocks" if name.startswith("rb") else "")
            + (f", {x.mega.shape[0]} megablocks" if x.int64 else "") + ")"
            for name, x in idxs.items()
        )
        + "; choose_S (cache bytes, escape share, card bytes): "
        + ", ".join(f"{S}: {v[0]} {v[1]:.4f} {v[2]}" for S, v in s_stats.items())
    )
    # the escape pack alone (planes to sub-rows on the card), warm
    rb_pack = {name: dict(ms=wall_ms(lambda d=d: runblock.pack_escapes(d["esc"], d["S"], dev)), esc_rows=len(d["esc"]),
                          cache_bytes=d["esc"].nbytes, card_bytes=nbytes(idxs[name].esc),
                          b_per_sym=idxs[name].nbytes / f.n) for name, d in rb_np.items()}
    del rb_np
    say("[corpus] escape pack (pack_escapes: cache planes to 64-B sub-rows, on the card): " + "; ".join(
        f"{name} {p['ms']:.3f} ms for {p['esc_rows']} escape rows ({p['cache_bytes']} B of planes -> {p['card_bytes']} B "
        f"of sub-rows), {p['b_per_sym']:.4f} B/sym on the card" for name, p in rb_pack.items()) + f" ({card})")
    phase_done("corpus")

    # ---- construct -----------------------------------------------------------
    many_fa = write_fasta(os.path.join(WORK, "many", "reads.fa"), reads[:N_READS])
    submit_construct_refs(bg, fa, many_fa)
    submit_utils_refs(bg, f, fmd, reads_fa)
    con = check_construct(cli, sa_time, dev, card, fa, fmd, many_fa, build_index(many_fa), bg, side)
    phase_done("construct")

    # ---- rank ----------------------------------------------------------------
    rng = np.random.default_rng(SEED + 1)
    special = np.concatenate([[0, f.n], boundaries(f.n, 1 << 20, 64), boundaries(f.n, RB64_S, N_CHECK // 256),
                              boundaries(f.n, S_bench, N_CHECK // 256)])
    k = torch.from_numpy(np.concatenate([special, rng.integers(0, f.n + 1, N_CHECK - len(special))]).astype(np.int64)).to(dev)
    ik = torch.from_numpy(intervals(rng, f.n, N_CHECK, 100_000)).to(dev)
    c = torch.from_numpy(rng.integers(0, 6, N_CHECK).astype(np.int32)).to(dev)
    back = torch.from_numpy(rng.random(N_CHECK) < 0.5).to(dev)
    occ_res = {}
    for name, x in idxs.items():
        r = occ_res[name] = check_occ_kernels(rank, x, k, ik, c, back, 3)
        if r["got"][1].tolist() != (f.acc[1:] - f.acc[:-1]).tolist():
            fail(f"{name}: rank1a(n) is not the symbol totals")
        say(
            f"[rank] {name}: exact on {N_CHECK} positions and {N_CHECK} intervals; occ_rank1a {r['rank_ms']:.4f} ms "
            f"vs plain {r['rank_plain']:.4f} ms; occ_extend_c {r['ext_ms']:.4f} ms vs plain {r['ext_plain']:.4f} ms; "
            f"occ_lf on the {r['lf_positions']} below n {r['lf_ms']:.4f} ms vs plain {r['lf_plain']:.4f} ms, bound "
            f"{r['lf_bound']:.4f} ms ({card})"
        )
        del r["got"], r["lf_got"]
    phase_done("rank")

    # ---- rank64 --------------------------------------------------------------
    t0 = time.perf_counter()
    syms, lens, (e0, e1) = synthetic_runs(SEED + 2)
    S64, stats = runblock.choose_S(lens, N64)
    d64 = runblock.build_runblock_np(syms, lens, n=N64)
    t1 = time.perf_counter()
    x64 = runblock.RunBlockIndex.from_np(d64, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del d64
    if not (S64 == x64.S == 8192 and x64.int64 and x64.n_esc >= 1 and x64.n % x64.S == 0):
        fail(f"rank64 rows: S {x64.S} (choose_S {S64}), int64 {x64.int64}, {x64.n_esc} escape blocks")
    say(
        f"[rank64] {len(lens)} runs, n={N64}; rb64 rows built in {t1 - t0:.3f} s, uploaded (escapes packed) in "
        f"{t2 - t1:.3f} s: S {x64.S}, {x64.rows.shape[0]} rows, "
        f"{x64.n_esc} escape blocks, {x64.mega.shape[0]} megablocks, {x64.nbytes} B on the card "
        f"({x64.nbytes / N64:.5f} B/sym; choose_S bytes {[stats[s][0] for s in runblock.S_CHOICES]})"
    )
    special = np.concatenate([
        [0, 1, N64 - 1, N64, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1],
        boundaries(N64, 8192, N_CHECK // 16), np.arange(e0 - 8192, e1 + 8192, 7)[: N_CHECK // 8],
    ])
    k64 = np.concatenate([special, rng.integers(0, N64 + 1, N_CHECK - len(special))]).astype(np.int64)
    ik64 = torch.from_numpy(intervals(rng, N64, N_CHECK, 1 << 34)).to(dev)
    r64 = check_occ_kernels(rank, x64, torch.from_numpy(k64).to(dev), ik64, c, back, 2)
    indep = run_length_rank(syms, lens, k64)
    ind_err = int(np.abs(r64.pop("got").cpu().numpy() - indep).max())
    # occ_lf at the positions below n: the symbol of the run that holds k,
    # LF(k) = acc[c] + its run-length rank
    below = k64 < N64
    lf_c, lf_nk = (t.cpu().numpy() for t in r64.pop("lf_got"))
    want_c = syms[np.searchsorted(np.cumsum(lens) - lens, k64[below], side="right") - 1].astype(np.int64)
    acc64 = np.concatenate([[0], np.cumsum(np.bincount(syms, weights=lens, minlength=6).astype(np.int64))])
    want_nk = acc64[want_c] + np.take_along_axis(indep[below], want_c[:, None], 1)[:, 0]
    lf_ind_err = max(int(np.abs(lf_c - want_c).max()), int(np.abs(lf_nk - want_nk).max()))
    if ind_err or lf_ind_err:
        fail(f"rank64: occ_rank1a differs from the run-length rank by up to {ind_err}, occ_lf by {lf_ind_err}")
    # kount_rank on random intervals, and intervals from the special
    # positions, against the plain version and the run-length rank at both ends
    ka = np.concatenate([special[special < N64], rng.integers(0, N64 + 1, N_CHECK // 4)])
    kb = np.minimum(N64, ka + np.concatenate([rng.integers(0, 1 << 14, len(ka) - N_CHECK // 4),
                                              rng.integers(0, 1 << 34, N_CHECK // 4)]))
    kt, lt = (torch.from_numpy(v.astype(np.int64)).to(dev) for v in (ka, kb))
    kr_got = kount.kount_rank_cuda(x64, kt, lt)
    kr_err = max(max_abs(a, b) for a, b in zip(kr_got, kount.kount_rank_plain(x64, kt, lt)))
    rk, rl = run_length_rank(syms, lens, ka), run_length_rank(syms, lens, kb)
    kr_ind_err = max(int(np.abs(kr_got[0].cpu().numpy() - rk[:, 1:5].T).max()),
                     int(np.abs(kr_got[1].cpu().numpy() - (rl - rk)[:, 1:5].T).max()))
    if kr_err or kr_ind_err:
        fail(f"rank64: kount_rank_rb64 off by {kr_err} against kount_rank_plain, by {kr_ind_err} against the "
             "run-length rank")
    rank64_kount = dict(err=kr_err, run_length_err=kr_ind_err, intervals=len(ka),
                        ms=cuda_ms(lambda: kount.kount_rank_cuda(x64, kt, lt), 10),
                        plain_ms=cuda_ms(lambda: kount.kount_rank_plain(x64, kt, lt), 2),
                        bound_ms=bound_ms(table_bytes(rank, x64, torch.cat([kt, lt])) + nbytes(kt, lt, *kr_got)))
    r64["lf_run_length_err"] = lf_ind_err
    del syms, lens, indep, rk, rl, kr_got
    say(
        f"[rank64] exact on {N_CHECK} positions (vs plain and vs the run-length rank) and {N_CHECK} intervals; "
        f"occ_rank1a {r64['rank_ms']:.4f} ms vs plain {r64['rank_plain']:.4f} ms; occ_extend_c {r64['ext_ms']:.4f} ms "
        f"vs plain {r64['ext_plain']:.4f} ms; occ_lf_rb64 on the {r64['lf_positions']} positions below n (2^31, 2^32 "
        f"and their neighbours among them) exact vs plain and vs the runs, {r64['lf_ms']:.4f} ms vs plain "
        f"{r64['lf_plain']:.4f} ms, bound {r64['lf_bound']:.4f} ms; kount_rank_rb64 on {len(ka)} intervals (from the "
        f"special positions, and random) exact vs plain and vs the run-length rank at both ends, "
        f"{rank64_kount['ms']:.4f} ms vs plain {rank64_kount['plain_ms']:.4f} ms, bound {rank64_kount['bound_ms']:.4f} "
        f"ms ({card})"
    )
    del x64, ik64, kt, lt
    phase_done("rank64")

    # ---- probe ---------------------------------------------------------------
    probe_res = check_probes(probe, dev)
    counted = (probe.smem_capacity_cuda, probe.smem_gather_cuda, probe.hbm_gather_cuda)
    for fn in counted:
        fn.launches.clear()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = probe.main([])
    sys.stdout.write(buf.getvalue())
    if rc != 0:
        fail("python -m ropebwt3_tpu_torch.probe failed")
    for fn, name in zip(counted, ("probe_smem_capacity", "probe_smem_gather", "probe_hbm_gather")):
        probe_res[name]["launches"] = sum(fn.launches.values())
        if probe_res[name]["launches"] < 1:
            fail(f"the probe path launched no {name}")
    # this run's ns per dependent row step, from the probe path's latency sweep
    ns = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[probe\] probe_hbm_gather (.+?) q=32 dep, new starts: \d+ steps in [0-9.]+ ms, ([0-9.]+) ns/step", buf.getvalue())}
    if LAT_L2 not in ns or LAT_48MB not in ns:
        fail(f"the probe path's latency sweep gave no ns per step for {LAT_L2} and {LAT_48MB}: {ns}")
    say(f"[probe] path `python -m ropebwt3_tpu_torch.probe` in {time.perf_counter() - t0:.3f} s; launches "
        + ", ".join(f"{k} {v['launches']}" for k, v in probe_res.items())
        + f"; ns per dependent step: {ns[LAT_L2]} ({LAT_L2}), {ns[LAT_48MB]} ({LAT_48MB})")
    # the rb chain floors' step: the latency sweep on a table of the rb tables' size
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name in ("rb32", "rb64"):
        nb = idxs[name].nbytes
        lat = probe.latency_sweep(dev, gen, tables=[(f"48 B x {nb // 48} ({nb / 1e6:.1f} MB)", nb // 48, 12)])[0]
        ns[name] = lat["ns_per_step"]
        say(f"[probe] ns per dependent step at the {name} tables' size, {lat['table']}: {ns[name]} ({card})")

    # K6's chain floors: pass 1's longest segment, then pass 2's longest
    # hand-over, a dependent row step each.  The short reads' B1 rows (9 MB)
    # stay in the L2; the genomes' (12-36 MB) are taken at the 48 MB
    # table's ns per step
    for m, step in [(con[f"merge_rank_{lay}"], ns[LAT_L2]) for lay in ("dense32", "dense64")] + \
            [(m, ns[LAT_48MB]) for m in con["merges16"]]:
        m["chain_floor_ms"] = (m["longest_segment"] + m["longest_hand_over"]) * step / 1e6
    say("[construct] K6 chain floors (longest segment + longest hand-over): short reads' merge " + ", ".join(
            f"{lay} {con[f'merge_rank_{lay}']['chain_floor_ms']:.4f} ms (K6 {con[f'merge_rank_{lay}']['ms']:.4f} ms)"
            for lay in ("dense32", "dense64"))
        + f" ({ns[LAT_L2]} ns a step); -m {CONSTRUCT_M} merges "
        + ", ".join(f"{m['chain_floor_ms']:.3f} ms (K6 {m['ms']:.3f} ms)" for m in con["merges16"])
        + f" ({ns[LAT_48MB]} ns a step) ({card})")
    # K6 over rb rows: two rounds a step (header, then records or sub-row)
    # at the ns of a table of that merge's B1 rb tables' size
    for k6 in [r["k6_rb32"] for r in con["host"]["merges"]] + [con["merge_rank_rb64"]]:
        nb = k6["table_bytes"]
        lat = probe.latency_sweep(dev, gen, tables=[(f"48 B x {nb // 48} ({nb / 1e6:.1f} MB)", nb // 48, 12)])[0]
        k6["chain_floor_ns_per_step"] = lat["ns_per_step"]
        k6["chain_floor_ms"] = (k6["longest_segment"] + k6["longest_hand_over"]) * RB_ROUNDS * lat["ns_per_step"] / 1e6
    say("[construct] K6 chain floors on rb rows ((longest segment + longest hand-over) x 2 rounds at the ns of a table "
        "of B1's rb tables' size): -m " + CONSTRUCT_M + " merges (rb32) " + ", ".join(
            f"{r['k6_rb32']['chain_floor_ms']:.3f} ms (K6 {r['k6_rb32']['ms']:.3f} ms, "
            f"{r['k6_rb32']['chain_floor_ns_per_step']} ns)" for r in con["host"]["merges"])
        + f"; short reads' merge (rb64) {con['merge_rank_rb64']['chain_floor_ms']:.4f} ms (K6 "
        f"{con['merge_rank_rb64']['ms']:.4f} ms, {con['merge_rank_rb64']['chain_floor_ns_per_step']} ns) ({card})")
    phase_done("probe")

    # ---- smem ----------------------------------------------------------------
    args = dict(min_occ=1, min_len=MIN_LEN, max_mems=MAX_MEMS)

    def on_card(rs):
        return tuple(torch.from_numpy(a).to(dev) for a in smem.pack_reads(rs))

    sflat, soff = on_card(reads[:N_SMEM])
    cflat, coff = on_card(reads[:N_TGC_SHORT] + reads[N_READS : N_READS + N_TGC_LONG])
    clanes = smem.chunk_lanes(coff)
    corder = smem.lane_order(clanes, coff)
    aflat, aoff = on_card(reads)
    alanes = smem.chunk_lanes(aoff)
    aorder = smem.lane_order(alanes, aoff)
    lflat, loff = on_card(reads[N_READS:])  # the long reads' lanes alone
    llanes = smem.chunk_lanes(loff)
    lorder = smem.lane_order(llanes, loff)
    n_short = N_READS * READ_LEN
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem_res, ref, sweep, plain_ref = {}, None, [], {}
    for name, x in idxs.items():
        # rb: the tables' bytes are the sectors the plain twin's ranks read;
        # a trip's chain step is RB_ROUNDS loads at the rb tables' size
        is_rb = name.startswith("rb")
        sc1, scc = (SectorCount(x, [x]), SectorCount(x, [x])) if is_rb else (x, x)
        step = RB_ROUNDS * ns[name] if is_rb else ns[LAT_48MB]
        # the plain checks' runs are their timed runs (rb: with the sectors
        # counted as they go).  The chains are the BWT's function, whatever
        # the rows, so dense64 is held against dense32's plain run
        k1 = smem.smem_tg_cuda(x, sflat, soff, trips=True, **args)
        p1, plain_ms = plain_ref["tg"] if name == "dense64" else wall_ms_of(
            lambda: smem.smem_tg_plain(sc1, sflat, soff, **args))
        err1 = chains_err(k1, p1, MAX_MEMS, f"smem_tg {name}")
        kc = smem.smem_tgc_cuda(x, cflat, coff, clanes, trips=True, **args)
        pc, cplain_ms = plain_ref["tgc"] if name == "dense64" else wall_ms_of(
            lambda: smem.smem_tg_plain(scc, cflat, coff, lanes=clanes, log_len=smem.LOG_LEN, **args))
        errc = chains_err(kc, pc, MAX_MEMS, f"smem_tgc {name}")
        if name == "dense32":
            plain_ref = {"tg": (p1, plain_ms), "tgc": (pc, cplain_ms)}
        del p1, pc
        if err1 or errc:
            fail(f"smem {name}: smem_tg off by {err1}, smem_tgc off by {errc} against smem_tg_plain")
        r = dict(err=err1, cerr=errc,
                 ms=probe.queued_ms([lambda: smem.launch_tg(x, sflat, soff, **args)] * 10),
                 plain=plain_ms, plain_rows=PLAIN_ROWS.get(name, name),
                 bound=bound_ms((sc1.bytes()[0] if is_rb else x.nbytes) + nbytes(sflat, soff) + nbytes(k1.n_mem)
                                + int(k1.n_mem.clamp(max=MAX_MEMS).sum()) * 5 * k1.mems.element_size()),
                 floor=int(k1.trips.max()) * step / 1e6,
                 cms=probe.queued_ms([lambda: smem.launch_tgc(x, cflat, coff, clanes, corder, **args)] * 10),
                 cplain=cplain_ms,
                 cbound=bound_ms((scc.bytes()[0] if is_rb else x.nbytes) + nbytes(cflat, coff, clanes, kc.n_mem, kc.n_log)
                                 + int(kc.n_mem.clamp(max=MAX_MEMS).sum()) * 5 * kc.mems.element_size()
                                 + int(kc.n_log.clamp(max=smem.LOG_LEN).sum()) * 4),
                 cfloor=int(kc.trips.max()) * step / 1e6)
        del sc1, scc
        # the main path's batch: the chunked engine against the one-thread kernel
        out = smem.smem_tg(x, aflat, aoff, **args)
        counts, rows, read_trips = serial_answer(smem, x, aflat, aoff)
        if not (torch.equal(out.counts, counts) and torch.equal(out.rows, rows)):
            fail(f"smem {name}: the chunked engine's rows on the main path's batch differ from the one-thread kernel's")
        if ref is None:
            ref = (counts, rows.long())
        elif not (torch.equal(counts, ref[0]) and torch.equal(rows.long(), ref[1])):
            fail(f"smem {name}: rows on the main path's batch differ from the dense32 kernels'")
        lane_trips = smem.launch_tgc(x, aflat, aoff, alanes, aorder, trips=True, **args).trips
        r.update(
            n_unmerged=out.n_unmerged, n_whole=out.n_whole, n_rerun=out.n_rerun, n_mems=int(counts.sum()),
            lanes=alanes.shape[0],
            tgc_ms=probe.queued_ms([lambda: smem.launch_tgc(x, aflat, aoff, alanes, aorder, **args)] * 3),
            long_ms=probe.queued_ms([lambda: smem.launch_tgc(x, lflat, loff, llanes, lorder, **args)] * 3),
            occupancy=smem_occupancy(kernels, name, sms),
            tg_ms=probe.queued_ms([lambda: smem.launch_tg(x, aflat, aoff, **args)] * 3),
            short_ms=probe.queued_ms([lambda: smem.launch_tg(x, aflat[:n_short], aoff[: N_READS + 1], **args)] * 3),
            engine_ms=wall_ms(lambda: smem.smem_tg(x, aflat, aoff, **args)),
            lane_trips=int(lane_trips.max()), lane_trips_sum=int(lane_trips.sum()), read_trips=int(read_trips.max()),
            read_trips_sum=int(read_trips.sum()),
            batch_io=nbytes(aflat, aoff, counts, rows), batch_bound=bound_ms(x.nbytes + nbytes(aflat, aoff, counts, rows)),
        )
        for key, trips in (("tgc", r["lane_trips"]), ("tg", r["read_trips"])):
            r[f"{key}_floor"] = (trips * step / 1e6,) if is_rb else (trips * ns[LAT_L2] / 1e6, trips * ns[LAT_48MB] / 1e6)
        r["ns_per_trip"], r["long_ns_per_trip"] = (r[k] * 1e6 / r["lane_trips"] for k in ("tgc_ms", "long_ms"))
        smem_res[name] = r
        say(
            f"[smem] {name}: smem_tg exact on {N_SMEM} reads ({int(k1.n_mem.sum())} MEMs) {r['ms']:.4f} ms vs plain "
            f"{r['plain']:.4f} ms; smem_tgc exact on the lanes of {N_TGC_SHORT} short + {N_TGC_LONG} long reads "
            f"({clanes.shape[0]} lanes; rows, counts, START logs, trips) {r['cms']:.4f} ms vs plain {r['cplain']:.4f} ms "
            f"(plain: {plain_note(name)}) ({card})")
        say(
            f"[smem] {name} main path's batch ({len(reads)} reads, {r['lanes']} lanes of {smem.CHUNK} + {smem.MARGIN}): "
            f"chunked engine rows equal to the one-thread kernel's ({r['n_mems']} MEMs) and dense32's; smem_tgc "
            f"{r['tgc_ms']:.4f} ms, engine (launch, stitch, reruns) {r['engine_ms']:.4f} ms, n_unmerged {out.n_unmerged} "
            f"(whole {out.n_whole}), "
            f"n_rerun {out.n_rerun}; one-thread smem_tg {r['tg_ms']:.4f} ms, its {N_READS} short reads alone "
            f"{r['short_ms']:.4f} ms; trips: longest lane {r['lane_trips']} (all lanes {r['lane_trips_sum']}), longest "
            f"read {r['read_trips']} (all reads {r['read_trips_sum']}); roofline bound (the whole tables) "
            f"{r['batch_bound']:.4f} ms; the long reads' {llanes.shape[0]} lanes alone {r['long_ms']:.4f} ms; ns a "
            f"trip of the longest lane {r['ns_per_trip']:.1f} (alone {r['long_ns_per_trip']:.1f}); smem_tgc "
            f"{r['occupancy']['regs']} registers, "
            f"{r['occupancy']['blocks_per_sm']} blocks an SM ({r['occupancy']['resident_threads']} threads resident); "
            f"chain floor smem_tgc "
            + " / ".join(f"{v:.4f}" for v in r["tgc_floor"]) + " ms, smem_tg " + " / ".join(f"{v:.4f}" for v in r["tg_floor"])
            + (f" ms ({RB_ROUNDS} rounds a trip at {ns[name]} ns)" if is_rb else f" ms (at {ns[LAT_L2]} / {ns[LAT_48MB]} ns a step)")
            + f"; lanes' check: smem_tgc {r['cms']:.4f} ms, bound {r['cbound']:.4f} ms, chain floor {r['cfloor']:.4f} ms ({card})"
        )
        if name == "dense32":
            for C in CHUNK_SWEEP:
                lanes = smem.chunk_lanes(aoff, C, C // 2)
                order = smem.lane_order(lanes, aoff)
                o = smem.smem_tg(x, aflat, aoff, chunk=C, margin=C // 2, **args)
                if not (torch.equal(o.counts, counts) and torch.equal(o.rows, rows)):
                    fail(f"smem dense32: chunk {C} gives other rows than the one-thread kernel")
                t = smem.launch_tgc(x, aflat, aoff, lanes, order, trips=True, **args).trips
                sweep.append(dict(chunk=C, margin=C // 2, lanes=lanes.shape[0], n_unmerged=o.n_unmerged, n_whole=o.n_whole,
                                  max_trips=int(t.max()), sum_trips=int(t.sum()),
                                  ms=probe.queued_ms([lambda lanes=lanes, order=order:
                                                      smem.launch_tgc(x, aflat, aoff, lanes, order, **args)] * 3),
                                  engine_ms=wall_ms(lambda C=C: smem.smem_tg(x, aflat, aoff, chunk=C, margin=C // 2, **args))))
            say("[smem] dense32 chunk sweep (exact at each): " + "; ".join(
                f"C {w['chunk']} W {w['margin']}: {w['lanes']} lanes, smem_tgc {w['ms']:.4f} ms, engine "
                f"{w['engine_ms']:.4f} ms, longest lane {w['max_trips']} trips (all {w['sum_trips']}), n_unmerged "
                f"{w['n_unmerged']} (rerun at twice the margin; whole {w['n_whole']})" for w in sweep) + f" ({card})")
        del k1, kc, out, rows
    # the main path's batch: the sectors its ranks read in the rb tables,
    # from the plain twin's lanes on the dense32 rows (the same positions)
    t0 = time.perf_counter()
    sc = SectorCount(idxs["dense32"], [idxs["rb32"], idxs["rb64"]])
    chains = smem.smem_tg_plain(sc, aflat, aoff, lanes=alanes, log_len=smem.LOG_LEN, **args)
    if int(chains.trips.max()) != smem_res["dense32"]["lane_trips"]:
        fail("smem: the plain twin's lanes on the main path's batch take other trips than smem_tgc")
    # the trips whose two ranks fall in one 64-symbol dense row (both loads
    # then read one row: the second from L1 or the first's miss in flight)
    smem_res["dense32"]["one_row_share"] = int(chains.one_row.sum()) / int(chains.trips.sum())
    for name, b in zip(("rb32", "rb64"), sc.bytes()):
        r = smem_res[name]
        r["batch_sector_bytes"] = b
        r["batch_sector_bound"] = bound_ms(b + r["batch_io"])
    say(f"[smem] main path's batch, the sectors its ranks read (plain twin's lanes, {time.perf_counter() - t0:.1f} s): "
        + "; ".join(f"{name} {smem_res[name]['batch_sector_bytes']} B of {idxs[name].nbytes} B, bound "
                    f"{smem_res[name]['batch_sector_bound']:.4f} ms, chain floor {smem_res[name]['tgc_floor'][0]:.4f} ms, "
                    f"smem_tgc {smem_res[name]['tgc_ms']:.4f} ms" for name in ("rb32", "rb64"))
        + f"; dense32 smem_tgc {smem_res['dense32']['tgc_ms']:.4f} ms; trips whose two ranks fall in one dense row "
        f"{smem_res['dense32']['one_row_share']:.4f} ({card})")
    del sc, chains, aflat, aoff, alanes, aorder, lflat, loff, llanes, lorder, ref, plain_ref
    if parent:  # K1 of a parent tree beside this one's, A B B A, on the main path's batch
        smem_ab = parent_ab(parent, card)
    phase_done("smem")

    # ---- ssa -----------------------------------------------------------------
    ssa_res, ssa_path = check_ssa(cli, ssa_ops, probe, rank, dev, card, f, fmd, idxs, reads, ns, side)
    phase_done("ssa")

    # ---- mem: the main path, then --occ=rb --------------------------------------
    # the reference output first, untimed: that run also builds the JAX
    # package's native library and its sidecars, one-time costs
    native_bed = os.path.join(WORK, "native.bed")
    native_cmd = [sys.executable, "-m", "ropebwt3_tpu", "mem", "--engine=native", f"-l{MIN_LEN}", fmd, reads_fa]
    with open(native_bed, "wb") as out:
        run(native_cmd, stdout=out)
    want = open(native_bed, "rb").read()
    n_all = len(reads)
    paths = {}
    names = ("occ_rank1a", "occ_extend_c", "smem_tg", "smem_tgc")
    for path, extra, layout in (("mem", [], "dense32"), ("mem-rb", ["--occ=rb"], "rb32")):
        argv = ["mem", f"-l{MIN_LEN}", *extra, fmd, reads_fa]
        port_bed = os.path.join(WORK, f"port_{path}.bed")
        for counted in counters:
            counted.launches.clear()
        err = io.StringIO()
        t0 = time.perf_counter()
        with open(port_bed, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        port_s = time.perf_counter() - t0
        launches = {name: dict(counted.launches) for name, counted in zip(names, counters)}
        sys.stderr.write(err.getvalue())
        if rc != 0:
            fail(f"ropebwt3_tpu_torch {' '.join(argv)} exited {rc}")
        if launches["smem_tgc"].get(layout, 0) < 1:
            fail(f"{path}: no {layout} smem_tgc launch ({launches})")
        m = re.search(rf"(\d+) smem_tg launches \({layout}\): (\d+) chunked, (\d+) one-thread; (\d+) reads rerun on "
                      rf"the card, (\d+) unmerged, (\d+) whole", err.getvalue())
        if m is None or int(m.group(2)) != launches["smem_tgc"][layout]:
            fail(f"{path}: the port's mem did not report its engine counts for {layout}")
        got_bed = open(port_bed, "rb").read()
        if got_bed != want:
            fail(f"port {path} BED differs from --engine=native: {first_diff(got_bed, want)}")
        n_lines = want.count(b"\n")
        if n_lines < N_READS:
            fail(f"only {n_lines} BED lines for {N_READS + N_LONG} reads")
        paths[path] = dict(launches=launches, layout=layout, port_s=port_s, n_rerun=int(m.group(4)),
                           n_unmerged=int(m.group(5)), n_whole=int(m.group(6)))
        say(
            f"[{path}] `{' '.join(argv[:-2])}`: BED byte-equal to --engine=native ({n_lines} lines); launches {launches}; "
            f"n_rerun {m.group(4)}, n_unmerged {m.group(5)}, rerun whole {m.group(6)} (of {N_LONG} long reads); port "
            f"in-process {port_s:.3f} s "
            f"({n_all / port_s:.1f} reads/s)"
        )

    # mem's other engines on the full batch, through cli.main with the counts
    # reset before and read after: the native host engine alone (no occ
    # rows, no launch of any kind) and the hybrid (K1 beside it)
    engines = {"auto": dict(port_s=paths["mem"]["port_s"])}
    for engine in ("native", "hybrid"):
        argv = ["mem", f"--engine={engine}", f"-l{MIN_LEN}", fmd, reads_fa]
        out_fn = os.path.join(WORK, f"port_mem_{engine}.bed")
        for counted in counters:
            counted.launches.clear()
        err = io.StringIO()
        t0 = time.perf_counter()
        with open(out_fn, "w") as out, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        rec = dict(port_s=time.perf_counter() - t0,
                   launches={name: dict(counted.launches) for name, counted in zip(names, counters)})
        sys.stderr.write(err.getvalue())
        if rc != 0:
            fail(f"ropebwt3_tpu_torch {' '.join(argv)} exited {rc}")
        got_bed = open(out_fn, "rb").read()
        if got_bed != want:
            fail(f"port mem --engine={engine} BED differs from --engine=native: {first_diff(got_bed, want)}")
        if engine == "native":
            if any(rec["launches"].values()) or "native SMEM engine" not in err.getvalue():
                fail(f"mem --engine=native launched {rec['launches']} or did not log its engine")
        else:
            m = HYBRID_LOG.search(err.getvalue())
            if rec["launches"]["smem_tgc"].get("dense32", 0) < 1 or m is None or int(m.group(1)) < 1:
                fail(f"mem --engine=hybrid: launches {rec['launches']}, log {m and m.group(0)}")
            rec.update(n_dev=int(m.group(1)), n_items=int(m.group(2)), share=float(m.group(3)))
        engines[engine] = rec
    say(f"[mem] in-process walls by engine, `mem -l{MIN_LEN}` of the full batch ({n_all} reads), each BED byte-equal "
        f"to --engine=native: auto (K1) {engines['auto']['port_s']:.3f} s, native {engines['native']['port_s']:.3f} s "
        f"(no launch), hybrid {engines['hybrid']['port_s']:.3f} s ({engines['hybrid']['n_dev']} of "
        f"{engines['hybrid']['n_items']} reads on the card, the card's share at the end {engines['hybrid']['share']:.4f}; "
        f"launches {engines['hybrid']['launches']}) ({card})")

    # the main path's host work, piece by piece (warm: the sidecar and the
    # kernels exist), through the functions `mem` runs; its BED must match too
    from ropebwt3_tpu_torch import seqio

    t = {}
    t0 = time.perf_counter()
    f2 = cli.load_index(fmd)
    t["load_index"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = smem.BatchedSmemTG(f2, 1, MIN_LEN, device=dev)
    torch.cuda.synchronize()
    t["occ rows build and upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = list(seqio.iter_flat_batches(reads_fa, False, 100_000_000))
    t["FASTA read (iter_flat_batches)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    found = [eng.run_flat(fl, of) for _, fl, of in batches]
    t["engine (run_flat: upload, smem_tgc, stitch, reruns, download)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sink, sid = io.StringIO(), 0
    for (bnames, _, of), (bc, br) in zip(batches, found):
        sid = cli.write_bed(sink, f2, bnames, of, bc, br, sid, 0, False, 0)
    t["BED write (write_bed)"] = time.perf_counter() - t0
    if sink.getvalue().encode() != want:
        fail("the main path's pieces, run one by one, give another BED")
    say("[mem] host work of the main path, warm, in-process: " + "; ".join(f"{k} {v:.3f} s" for k, v in t.items())
        + f" ({len(batches)} batch, {card})")

    sub_bed = os.path.join(WORK, "port_subprocess.bed")
    argv = ["mem", f"-l{MIN_LEN}", fmd, reads_fa]
    with open(sub_bed, "wb") as out:
        sub_s, sub_err = run([sys.executable, "-m", "ropebwt3_tpu_torch"] + argv, stdout=out)
    say("[mem] `python -m ropebwt3_tpu_torch` stderr: " + " | ".join(sub_err.strip().splitlines()))
    if open(sub_bed, "rb").read() != want:
        fail(f"port mem (subprocess) BED differs from --engine=native: {first_diff(open(sub_bed, 'rb').read(), want)}")
    native_s, _ = run(native_cmd)
    say(
        f"[mem] end to end: port in-process {paths['mem']['port_s']:.3f} s (dense32), {paths['mem-rb']['port_s']:.3f} s "
        f"(--occ=rb), port `python -m ropebwt3_tpu_torch` {sub_s:.3f} s ({n_all / sub_s:.1f} reads/s), "
        f"native `python -m ropebwt3_tpu --engine=native` {native_s:.3f} s ({n_all / native_s:.1f} reads/s, "
        f"{os.cpu_count()} host cores) ({card})"
    )
    say(
        "[mem-rb] rows on the card and the chunked engine on the main path's batch: "
        + "; ".join(f"{name} {x.nbytes} B, smem_tgc {smem_res[name]['tgc_ms']:.4f} ms, one-thread smem_tg "
                    f"{smem_res[name]['tg_ms']:.4f} ms" for name, x in idxs.items())
        + f" ({card})"
    )
    submit_mesh_jobs(side, fmd, reads_fa, fa)
    phase_done("mem")

    # ---- hapdiv ----------------------------------------------------------------
    hd = check_hapdiv(cli, dev, card, fa, fmd, idxs, ns, bg)
    phase_done("hapdiv")

    # ---- sw --------------------------------------------------------------------
    swr = check_sw(cli, dev, card, fmd, reads, idxs, ns, bg)
    phase_done("sw")

    # ---- utils -------------------------------------------------------------------
    ut = check_utils(cli, probe, dev, card, fa, fmd, reads_fa, reads, idxs, ns, bg)
    phase_done("utils")

    # ---- serve -------------------------------------------------------------------
    sv = check_serve(card, fmd, reads_fa, sub_s, native_s, engines["hybrid"]["port_s"], hd, swr)
    phase_done("serve")

    # ---- mesh --------------------------------------------------------------------
    ms_ = check_mesh(cli, smem, kernels, probe, dev, card, fmd, reads_fa, reads, idxs, ns, smem_res, want, f, fa,
                     many_fa, side)
    phase_done("mesh")

    def path_launches(kernel: str, layout: str) -> tuple[int, str | None]:
        for path, p in paths.items():
            if p["layout"] == layout and kernel in ("smem_tg", "smem_tgc"):
                return p["launches"][kernel].get(layout, 0), path
        return sum(p["launches"][kernel].get(layout, 0) for p in paths.values()), None

    entries = []
    smem_src, smem_rep = "ropebwt3_tpu_torch/csrc/smem_tg.cu", "ropebwt3_tpu/ops/smem_pallas.py:91"
    for name in LAYOUTS:
        s = smem_res[name]
        rb = {} if not name.startswith("rb") else {
            "bound_counts": "the 32-B sectors of the rb tables that the plain twin's ranks read",
            "chain_floor_rounds_per_trip": RB_ROUNDS, "chain_floor_ns_per_step": ns[name],
            "chain_floor_table_bytes": idxs[name].nbytes, "dense32_main_path_batch_ms": smem_res["dense32"]["tgc_ms"],
        }
        n, path = path_launches("smem_tg", name)
        entries.append({
            "name": f"smem_tg_{name}", "route": "cuda", "source": smem_src, "replaces": smem_rep, "launches": n,
            "path": path if n else None, "max_abs_err": s["err"], "ms": s["ms"], "plain_ms": s["plain"],
            "plain_rows": s["plain_rows"],
            "bound_ms": s["bound"], "bound_by": "bytes", "library_ms": None, "chain_floor_ms": s["floor"],
            "input": f"{N_SMEM} x {READ_LEN} bp reads, one thread each",
            "main_path_batch_ms": s["tg_ms"], "main_path_batch_short_reads_ms": s["short_ms"],
            "main_path_batch_bound_ms": s["batch_bound"], "main_path_batch_chain_floor_ms": s["tg_floor"],
            "main_path_batch_longest_read_trips": s["read_trips"], **rb,
        })
        n, path = path_launches("smem_tgc", name)
        entries.append({
            "name": f"smem_tgc_{name}", "route": "cuda", "source": smem_src, "replaces": smem_rep, "launches": n,
            "path": path, "max_abs_err": s["cerr"], "ms": s["cms"], "plain_ms": s["cplain"], "bound_ms": s["cbound"],
            "plain_rows": s["plain_rows"],
            "bound_by": "bytes", "library_ms": None, "chain_floor_ms": s["cfloor"],
            "input": f"the lanes ({smem.CHUNK} + {smem.MARGIN}) of {N_TGC_SHORT} short and {N_TGC_LONG} long reads",
            "main_path_batch_ms": s["tgc_ms"], "main_path_batch_engine_ms": s["engine_ms"],
            "main_path_batch_long_lanes_ms": s["long_ms"], "main_path_batch_ns_per_trip": s["ns_per_trip"],
            "main_path_batch_long_lanes_ns_per_trip": s["long_ns_per_trip"],
            **({"one_row_share": s["one_row_share"]} if "one_row_share" in s else {}),
            "occupancy": s["occupancy"],
            **({"parent_ab": [{"tag": d["tag"], **{lay: {k: d[lay][k]["ms"] for k in ("all", "long", "short")}
                                                   for lay in ("dense32", "rb32")}} for d in smem_ab]}
               if parent and name in ("dense32", "rb32") else {}),
            "main_path_batch_bound_ms": s["batch_bound"], "main_path_batch_chain_floor_ms": s["tgc_floor"],
            "main_path_batch_longest_lane_trips": s["lane_trips"], "n_unmerged": s["n_unmerged"], "n_whole": s["n_whole"],
            "n_rerun": s["n_rerun"],
            **({"chunk_sweep": sweep} if name == "dense32" else {}), **rb,
            **({"main_path_batch_sector_bytes": s["batch_sector_bytes"], "main_path_batch_sector_bound_ms":
                s["batch_sector_bound"]} if rb else {}),
        })
    for name in LAYOUTS:
        o = occ_res[name]
        src = "ropebwt3_tpu_torch/csrc/occ_rank.cu + " + ("rb.cuh" if name.startswith("rb") else "occ.cuh")
        rep = "ropebwt3_tpu/ops/runblock.py:154" if name.startswith("rb") else "ropebwt3_tpu/ops/rank.py:233"
        for kern, err, ms, plain, bound in (("occ_rank1a", o["rank_err"], o["rank_ms"], o["rank_plain"], o["rank_bound"]),
                                            ("occ_extend_c", o["ext_err"], o["ext_ms"], o["ext_plain"], o["ext_bound"])):
            n, path = path_launches(kern, name)
            e = {"name": f"{kern}_{name}", "route": "cuda", "source": src, "replaces": rep, "launches": n, "path": path,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                 "library_ms": None, "input": f"{N_CHECK} on the bench index",
                 **({"kount_launches": ut["kount"]["occ_rank1a_launches"].get(name, 0)} if kern == "occ_rank1a" else {})}
            if name == "rb64":
                key = "rank" if kern == "occ_rank1a" else "ext"
                e.update({"rank64_ms": r64[f"{key}_ms"], "rank64_plain_ms": r64[f"{key}_plain"],
                          "rank64_max_abs_err": r64[f"{key}_err"], "rank64_vs_run_length_rank_err": ind_err})
            entries.append(e)
    for name in LAYOUTS:
        o = occ_res[name]
        entries.append({
            "name": f"occ_lf_{name}", "route": "cuda",
            "source": "ropebwt3_tpu_torch/csrc/occ_rank.cu + " + ("rb.cuh" if name.startswith("rb") else "occ.cuh"),
            "replaces": "ropebwt3_tpu/index/dense.py:237 (DenseFMIndex.lf: host numpy, no TPU kernel)", "launches": 0,
            "path": None, "max_abs_err": o["lf_err"], "ms": o["lf_ms"], "plain_ms": o["lf_plain"],
            "bound_ms": o["lf_bound"], "bound_by": "bytes", "library_ms": None,
            "input": f"the {o['lf_positions']} of {N_CHECK} positions below n on the bench index",
            **({"rank64_ms": r64["lf_ms"], "rank64_plain_ms": r64["lf_plain"], "rank64_bound_ms": r64["lf_bound"],
                "rank64_max_abs_err": r64["lf_err"], "rank64_vs_runs_err": r64["lf_run_length_err"],
                "rank64_positions": r64["lf_positions"]} if name == "rb64" else {}),
        })
    for name in ("probe_smem_capacity", "probe_smem_gather", "probe_hbm_gather"):
        r = probe_res[name]
        entries.append({"name": name, "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/probe.cu", "replaces": r["replaces"],
                        "launches": r["launches"], "path": "probe", "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain"], "bound_ms": r["bound"], "bound_by": "bytes", "library_ms": r["library"],
                        "input": r["input"], **({"indep_ms": r["indep_ms"]} if "indep_ms" in r else {})})
    for name in LAYOUTS:
        r = ssa_res[name]
        b = r["bench"]
        is_rb = name.startswith("rb")
        n = ssa_path["rb32" if is_rb else "dense32"]["launches"].get(name, 0)
        entries.append({
            "name": f"ssa_gen_{name}", "route": "cuda",
            "source": "ropebwt3_tpu_torch/csrc/ssa_gen.cu + " + ("rb.cuh" if is_rb else "occ.cuh"),
            "replaces": "ropebwt3_tpu/ssa_ops.py:127-147 (ssa_gen_device body)", "launches": n,
            "path": ("ssa (RB3TPU_DEVICE_OCC=rb)" if is_rb else "ssa") if n else None, "max_abs_err": r["err"],
            "ms": b["ms"], "plain_ms": b["seg_plain_ms"], "bound_ms": b["bound_ms"], "bound_by": "bytes",
            "library_ms": None, **b, "many_index": r["many"], "corpus_index": r["corpus"],
            **({"path_port_s": ssa_path["rb32"]["port_s"]} if is_rb else {}),
        })
    k7, path = con["sa_round"], con["path"]
    entries.append({
        "name": "sa_round", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/sa_round.cu",
        "replaces": "ropebwt3_tpu/construct/sa_jax.py:23-48 (_round, _initial)",
        "launches": sum(v for p, v in path["sa"].items() if p != "sa_sort"), "path": f"build -m {CONSTRUCT_M}",
        "launches_by_pass": path["sa"], "max_abs_err": k7["rank_err"], "ms": k7["ms"], "plain_ms": k7["plain"],
        "bound_ms": k7["bound"], "bound_by": "bytes", "library_ms": None, "input": k7["input"], "rounds": k7["rounds"],
        "per_round_ms": k7["per_round"], "cumsum_ms": k7["scan_ms"], "k7_total_ms": k7["total_ms"],
        "k7_bound_ms": k7["k7_bound"], "int64_passes_bound_ms": k7["int64_bound"],
        "peak_card_bytes_per_symbol": k7["peak_b_per_sym"], "sa_bytes_per_symbol": con["sa_bytes_per_symbol"],
    })
    entries.append({
        "name": "sa_sort", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/sa_sort.cu",
        "replaces": "ropebwt3_tpu/construct/sa_jax.py:23-48 (_round's lax.sort)",
        "launches": path["sa"].get("sa_sort", 0), "path": f"build -m {CONSTRUCT_M}", "max_abs_err": k7["sort_err"],
        "ms": k7["sort_ms"], "plain_ms": k7["sort_plain_ms"], "bound_ms": k7["sort_bound"], "bound_by": "bytes",
        "library_ms": k7["library_sort_ms"], "library": "torch.sort of the same keys, every round",
        "input": k7["input"], "live_bits_per_round": k7["bits"], "digit_passes": k7["digit_passes"],
    })
    k6_keys = ("S", "lanes", "meet_median", "meet_p99", "meet_max", "never_met", "longest_segment",
               "longest_hand_over", "chunked_plain_ms", "native_walk_s")
    for layout in ("dense32", "dense64"):
        r = con[f"merge_rank_{layout}"]
        n = path["merge"].get(layout, 0)
        entries.append({
            "name": f"merge_rank_{layout}", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/merge_rank.cu + occ.cuh",
            "replaces": "ropebwt3_tpu/construct/merge.py:112-123 (window.step)", "launches": n,
            "path": f"build -m {CONSTRUCT_M}" if n else None, "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain"],
            "bound_ms": r["bound"], "bound_by": "bytes", "library_ms": None, "chain_floor_ms": r["chain_floor_ms"],
            "input": r["input"], "longest_walk": r["longest"], "native_merges_s": r["many_native_merges_s"],
            **{k: r[k] for k in k6_keys},
            **({"build_path_merges": con["merges16"]} if layout == "dense32" else {}),
        })
    host = con["host"]
    for layout in ("rb32", "rb64"):
        r = host["merges"][0]["k6_rb32"] if layout == "rb32" else con["merge_rank_rb64"]
        n = host["launches"].get(layout, 0)
        entries.append({
            "name": f"merge_rank_{layout}", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/merge_rank.cu + rb.cuh",
            "replaces": "ropebwt3_tpu/construct/merge.py:112-123 (window.step)", "launches": n,
            "path": f"build -m {CONSTRUCT_M} on the host placement (RB3TPU_DEVICE_OCC=rb)" if n else None,
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["chunked_plain_ms"], "bound_ms": r["bound"],
            "bound_by": "bytes", "library_ms": None, "chain_floor_ms": r["chain_floor_ms"],
            "input": r["input"] + "; plain_ms: merge_rank_chunked_plain over the same rb rows on the card; bound: the "
                     "rb sectors its ranks read, records in and ins out",
            "dense32_ms": r["dense32_ms"] if layout == "rb32" else con["merge_rank_dense32"]["ms"],
            "S_block": r["S_block"], "escape_blocks": r["escape_blocks"], "table_bytes": r["table_bytes"],
            "chain_floor_ns_per_step": r["chain_floor_ns_per_step"], **{k: r[k] for k in k6_keys},
            **({"host_merges": host["merges"], "host_path_s": host["path_s"], "host_path_pieces": host["path_pieces"]}
               if layout == "rb32" else {}),
        })
    for layout in ("dense32", "dense64"):
        r, n = hd["res"][layout], hd["path"]["launches"].get(layout, 0)
        entries.append({
            "name": f"hapdiv_{layout}", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/hapdiv.cu + occ.cuh",
            "replaces": "ropebwt3_tpu/align/hapdiv_jax.py:401 (hapdiv_device)", "launches": n,
            "path": "hapdiv" if n else None, "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None, "chain_floor_ms": r["chain_floor_ms"],
            "input": f"{r['n_win']} windows of {HAPDIV_K} (haplotype and insertion windows)", "n_bad": r["n_bad"],
            "max_trips": r["max_trips"], "mean_trips": r["mean_trips"], "rows_bytes": r["rows_bytes"], "plain_rows": r["plain_rows"],
            "full_batch_ms": r["full_ms"], "full_batch_windows": r["full_windows"], "occupancy": r["occupancy"],
            "phase_split": r["split"],
            **({"path_windows": hd["path"]["n_win"], "path_bad": hd["path"]["n_bad"], "path_port_s": hd["path"]["port_s"],
                "path_reference_s": hd["path"]["ref_s"], "past_card": hd["past_card"]} if n else {}),
        })
    for layout in ("dense32", "dense64"):
        r, e = swr["res"][f"general_{layout}"], swr["res"][f"e2e_{layout}"]
        n = swr["path"]["launches"].get(layout, 0) + swr["e2e"]["launches"].get(layout, 0)
        entries.append({
            "name": f"sw_{layout}", "route": "cuda", "source": "ropebwt3_tpu_torch/csrc/sw.cu + dp.cuh + occ.cuh",
            "replaces": "ropebwt3_tpu/align/sw_jax.py:122 (sw_device)", "launches": n,
            "path": "sw, sw --all-e2e -b" if n else None, "max_abs_err": max(r["err"], e["err"]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "chain_floor_ms": r["chain_floor_ms"], "input": f"{r['n_reads']} short reads' general DAWGs (NC {r['NC']}, P {r['P']})",
            "n_bad": r["n_bad"], "max_trips": r["max_trips"], "mean_trips": r["mean_trips"], "rows_bytes": r["rows_bytes"], "plain_rows": r["plain_rows"],
            "full_batch_ms": r["full_ms"], "full_batch_reads": r["full_reads"], "occupancy": r["occupancy"],
            "phase_split": r["split"], "e2e": e,
            **({"path_sw": swr["path"], "path_all_e2e": swr["e2e"], "past_card": swr["past_card"]} if n else {}),
        })
    kt = ut["kount"]
    for layout in LAYOUTS:
        r = kt[layout]
        n = r["launches"]
        is_rb = layout.startswith("rb")
        entries.append({
            "name": f"kount_rank_{layout}", "route": "cuda",
            "source": "ropebwt3_tpu_torch/csrc/kount.cu + " + ("rb.cuh" if is_rb else "occ.cuh"),
            "replaces": "ropebwt3_tpu/cli.py:886 (main_kount's rank1a_fast of each level: host numpy, no TPU kernel)",
            "launches": n, "path": ("kount (RB3TPU_DEVICE_OCC=rb)" if is_rb else "kount") if n else None,
            "max_abs_err": max(r["err"], r["random_err"]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "input": f"kount -k {KOUNT_K} -m {KOUNT_M}'s widest level ({kt['widest_nodes']} nodes, level "
                     f"{kt['widest_level']}) and as many random (k, l)",
            **({"table_bytes": r["table_bytes"]} if is_rb else {"rows": r["rows"], "row_fetches": r["row_fetches"]}),
            **({"rank64": rank64_kount} if layout == "rb64" else {}),
            **({"occ_rank1a_widest_node_major_ms": kt["widest_ms"]["A"],
                "occ_rank1a_widest_symbol_major_ms": kt["widest_ms"]["B"],
                "occ_rank1a_widest_bound_ms": kt["widest_bound_ms"]["A"],
                "levels": [{"level": lv["level"], "nodes": lv["nodes"], "rows": lv["rows"], "ms": lv["ms"],
                            "bound_ms": lv["bound_ms"], "row_fetches": lv["warp_rows"]} for lv in kt["levels"]]}
               if layout == "dense32" else {}),
        })
    walk_src = "ropebwt3_tpu_torch/csrc/walk.cu + "
    for layout in LAYOUTS:
        r = ut[f"retrieve_seg_{layout}"]
        entries.append({
            "name": f"retrieve_seg_{layout}", "route": "cuda",
            "source": walk_src + "ssa_gen.cu (rb3c_ssa_jump) + " + ("rb.cuh" if layout.startswith("rb") else "occ.cuh"),
            "replaces": "ropebwt3_tpu/index/dense.py:244 (DenseFMIndex.retrieve: a host walk, no TPU kernel)",
            "launches": r["launches"], "path": r["path"] if r["launches"] else None, "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "chain_floor_ms": r["chain_floor_ms"],
            "input": f"the whole get walk: {r['lanes']} heads, {r['walk_steps']} symbols, segment stride {r['S']}",
            **{k: v for k, v in r.items() if k not in ("err", "ms", "plain_ms", "bound_ms", "chain_floor_ms", "launches",
                                                      "lanes", "walk_steps", "path")},
        })
    for layout in LAYOUTS:
        r = ut[f"suffix_walk_{layout}"]
        entries.append({
            "name": f"suffix_walk_{layout}", "route": "cuda",
            "source": walk_src + ("rb.cuh" if layout.startswith("rb") else "occ.cuh"),
            "replaces": "ropebwt3_tpu/cli.py:799-829 (main_suffix's flush: host numpy over rank1a_fast, no TPU kernel)",
            "launches": r["launches"], "path": r["path"] if r["launches"] else None, "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "chain_floor_ms": r["chain_floor_ms"], "input": f"{len(reads)} reads (the main path's)",
            **{k: r[k] for k in ("longest_steps", "table_bytes", "regs", "blocks_per_sm")},
            **({k: r[k] for k in ("suffix_port_s", "suffix_reference_s", "suffix_pieces")} if r["launches"] else {}),
        })
    mapped_src = " over csrc/vmm.cu's mapping of the slabs (parallel/mesh.py ShardedRows)"
    for name in LAYOUTS:
        r = ms_["res"][name]
        path = ms_["paths"].get(name)
        mesh_in = f"a {MESH_DP}x{MESH_IDX} mesh of one card, its slabs mapped into one range"
        for kern in ("smem_tg", "smem_tgc"):
            n = path["launches"][f"{kern}_cuda"].get(name, 0) if path else 0
            tgc = kern == "smem_tgc"
            e = {"name": f"{kern}_{name}_mapped", "route": "cuda", "source": smem_src + mapped_src,
                 "replaces": MESH_REPLACES, "launches": n, "path": f"mem --mesh=1x1{' --occ=rb' if name == 'rb32' else ''}"
                 if n else None, "max_abs_err": r["cerr" if tgc else "err"], "ms": r["cms" if tgc else "ms"],
                 "plain_ms": r["cplain" if tgc else "plain"], "bound_ms": r["cbound" if tgc else "bound"],
                 "bound_by": "bytes", "library_ms": None, "chain_floor_ms": r["cfloor" if tgc else "floor"],
                 "plain_rows": r["plain_rows"],
                 "input": (f"the lanes ({smem.CHUNK} + {smem.MARGIN}) of {MESH_TGC_SHORT} short and {MESH_TGC_LONG} long "
                           f"reads, {mesh_in}" if tgc else f"{MESH_TG} x {READ_LEN} bp reads, one thread each, {mesh_in}"),
                 "occupancy": r["occupancy" if tgc else "tg_occupancy"], "nb_local": r["nb_local"],
                 "granularity": r["granularity"], "unit": r["unit"], "mapped_bytes": r["mapped_bytes"]}
            if tgc:
                e.update(main_path_batch_ms=r["batch_ms"], main_path_batch_unsharded_ms=r["batch_unsharded_ms"],
                         main_path_batch_bound_ms=r["batch_bound"], main_path_batch_chain_floor_ms=r["batch_floor"],
                         main_path_batch_longest_lane_trips=r["lane_trips"],
                         **({"mesh_engine_ms": r["engine_ms"], "unsharded_engine_ms": r["engine_unsharded_ms"],
                             "mesh_engine_launches": r["engine_launches"]} if "engine_ms" in r else {}))
                if name == "dense32":  # mem --mesh=1x2 under torchrun: launches a process, each over one imported slab
                    e["idx_across_processes"] = ms_["across"]["mem"]
            entries.append(e)
    mb, g = ms_["build"], ms_["ssa"]
    for lay in ("dense32", "dense64"):
        rs = mb["merges"] if lay == "dense32" else [mb["dense64"]]
        n = mb["launches"].get(lay, 0)
        entries.append({
            "name": f"merge_rank_{lay}_mapped", "route": "cuda",
            "source": "ropebwt3_tpu_torch/csrc/merge_rank.cu + occ.cuh" + mapped_src + ", construct/merge.py merge_rank_mesh",
            "replaces": MERGE_MESH_REPLACES, "launches": n,
            "path": f"build -m {CONSTRUCT_M} --mesh=1x1" if n else None, "max_abs_err": max(r["err"] for r in rs),
            "ms": rs[0]["ms"], "plain_ms": rs[0]["plain_ms"], "bound_ms": rs[0]["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "chain_floor_ms": rs[0]["chain_floor_ms"],
            "input": (f"the {len(rs)} merges of `build -m {CONSTRUCT_M}` (ms, bounds: the first)" if lay == "dense32"
                      else f"the short reads' first merge (-m {MANY_M})") + f", {MESH_DP}x{MESH_IDX} mesh of one card; "
                     "ms: the card's two launches, one a pass",
            "merges": rs, "occupancy": {k: v for k, v in mb["occupancy"].items() if lay in k},
            **({"idx_across_processes": ms_["across"]["build"], "host_placed_build": mb["host_placed"]}
               if lay == "dense32" else {}),
        })
    entries.append({
        "name": "ssa_gen_mesh_dense32", "route": "cuda",
        "source": "ropebwt3_tpu_torch/csrc/ssa_gen.cu (pass 1 over a range) + ssa_ops.py walk_mesh",
        "replaces": "ropebwt3_tpu/ssa_ops.py:163-199 (the mesh branch of ssa_gen_device)",
        "launches": g["launches"].get("dense32", 0), "path": "ssa --mesh=1x1" if g["launches"] else None,
        "max_abs_err": g["err"], "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "chain_floor_ms": g["chain_floor_ms"],
        "input": f"bench.py's index, {g['n_seg']} segments (S {g['S']}), {MESH_DP}x{MESH_IDX} mesh of one card; ms: "
                 "pass 1's one range launch a card",
        **{k: g[k] for k in ("slot_ranges_ms", "walk_abba_ms", "longest_segment_by_range", "api_s", "path_s")},
        "idx_across_processes": ms_["across"]["ssa"],
    })
    say(json.dumps({"kernels": entries, "mesh": {k: ms_[k] for k in ("sub_s", "torchrun_s", "dp", "real",
                                                                     "torchrun_ssa_s", "across")},
                    "utils": {k: ut[k] for k in ("kount", "fa2line", "fa2kmer", "tools_call")},
                    "serve": sv, "phase_s": phase_s}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
