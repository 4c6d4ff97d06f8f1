"""bench.py's corpus (bench.py:78-85), made from its seed: N_GENOMES
haplotypes of one random GENOME_LEN-bp genome at DIVERGENCE substitutions,
then N_READS short reads of READ_LEN bp from the base genome at READ_ERR,
then chip_smoke.py's N_LONG long reads of LONG_LEN bp.  chip_smoke.py and
the card timers (dp_time, sa_time, smem_time) draw it from here, in this
order from one generator.
"""

from __future__ import annotations

import numpy as np

from .nt6 import revcomp

N_GENOMES, GENOME_LEN, DIVERGENCE = 16, 2_000_000, 0.01
N_READS, READ_LEN, READ_ERR = 100_000, 150, 0.01
N_LONG, LONG_LEN = 200, (5_000, 20_000)
SEED = 20260817


def genomes(rng: np.random.Generator, n_genomes: int = N_GENOMES,
            genome_len: int = GENOME_LEN) -> tuple[np.ndarray, list[np.ndarray]]:
    """(base genome, its n_genomes haplotypes), nt6 uint8, drawn from rng."""
    base = rng.integers(1, 5, genome_len).astype(np.uint8)
    gens = []
    for _ in range(n_genomes):
        s = base.copy()
        mut = rng.random(genome_len) < DIVERGENCE
        s[mut] = rng.integers(1, 5, int(mut.sum()))
        gens.append(s)
    return base, gens


def short_reads(rng: np.random.Generator, base: np.ndarray, n_reads: int = N_READS) -> np.ndarray:
    """(n_reads, READ_LEN) nt6 reads of base at READ_ERR substitutions, drawn
    from rng after `genomes`."""
    starts = rng.integers(0, len(base) - READ_LEN, n_reads)
    short = base[starts[:, None] + np.arange(READ_LEN)]
    return np.where(rng.random(short.shape) < READ_ERR, rng.integers(1, 5, short.shape), short).astype(np.uint8)


def construction_batch(gens: list[np.ndarray]) -> np.ndarray:
    """The double-strand construction batch of the genomes: each, then its
    reverse complement, 0-terminated (n = 16 x 4,000,002 = 64,000,032 for
    bench.py's)."""
    z = np.zeros(1, np.uint8)
    return np.concatenate([p for s in gens for p in (s, z, revcomp(s), z)])


def long_reads(rng: np.random.Generator, base: np.ndarray, n_long: int = N_LONG) -> list[np.ndarray]:
    """n_long nt6 reads of LONG_LEN[0]..LONG_LEN[1] bp of base at READ_ERR
    substitutions, drawn from rng after `short_reads`."""
    out = []
    for _ in range(n_long):
        ln = int(rng.integers(*LONG_LEN))
        st = int(rng.integers(0, len(base) - ln))
        r = base[st : st + ln].copy()
        err = rng.random(ln) < READ_ERR
        r[err] = rng.integers(1, 5, int(err.sum()))
        out.append(r)
    return out
