"""Dataset paths and read sets (copied from ``sequence_aligner_tpu/pipeline``).

``simulated_reads`` draws a random genome sized for the requested coverage
and shreds it into an even tiling of reads; with the same seed it gives the
same reads as the JAX package (both draw from ``np.random.RandomState``).
``planted_repeat_reads`` (the port's own) does the same on a genome with
many copies of short planted k-mers, where the prescreen has work to do.
``c_ruddii_reads`` shreds the reference's single-contig c_ruddii genome
(159,659 bp) into the c_ruddii benchmark's 32,000 x 100 bp reads.

The paths name the reference implementation's data: the crp177 golden
fixtures, the c_ruddii genome and the AMOS binaries.  They lie under
``REFERENCE``: ``$SEQALIGN_REFERENCE`` if set, else ``reference/`` at the
root of the checkout, which does not hold them yet.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.io.fasta import read_fasta

REFERENCE = os.environ.get("SEQALIGN_REFERENCE",
                           str(Path(__file__).resolve().parents[2] / "reference"))
CRP_SEQ = f"{REFERENCE}/amos/small/crp177.seq"
CRP_OVL = f"{REFERENCE}/amos/small/crp177.ovl"
CRP_FASTA = f"{REFERENCE}/amos/small/crp177.fasta"
C_RUDDII_FASTA = f"{REFERENCE}/amos/c_ruddii.fasta"
AMOS_BIN = f"{REFERENCE}/bin"

_BASES = "ACTG"


def shred_genome(
    genome: str,
    n_reads: int,
    read_len: int,
    *,
    error_rate: float = 0.0,
    seed: int = 0,
) -> list[Sequence]:
    """Even tiling of ``genome`` into n_reads reads of read_len bp, with
    optional per-base substitution errors."""
    g = len(genome)
    if g < read_len:
        raise ValueError("genome shorter than read length")
    starts = np.floor(
        np.arange(n_reads, dtype=np.float64) * (g - read_len) / max(n_reads - 1, 1)
    ).astype(np.int64)
    rng = np.random.RandomState(seed)
    seqs = []
    for i, st in enumerate(starts):
        body = genome[st : st + read_len]
        if error_rate > 0:
            arr = list(body)
            n_err = rng.binomial(read_len, error_rate)
            for p in rng.randint(0, read_len, n_err):
                arr[p] = _BASES[rng.randint(0, 4)]
            body = "".join(arr)
        seqs.append(Sequence(i + 1, body))
    return seqs


def load_genome(path: str | None = None) -> str:
    """The bases of every record of a FASTA file, joined (default
    ``C_RUDDII_FASTA``)."""
    return "".join(r.seq for r in read_fasta(path or C_RUDDII_FASTA))


def c_ruddii_reads(n_reads: int = 32000, read_len: int = 100, *,
                   genome: str | None = None, **kw) -> list[Sequence]:
    """The c_ruddii-scale dataset: the genome at ``genome`` (default
    ``C_RUDDII_FASTA``) shredded into n_reads reads of read_len bp (the
    golden bank's RED object count); ``kw`` goes to ``shred_genome``."""
    return shred_genome(load_genome(genome), n_reads, read_len, **kw)


def simulated_reads(
    n_reads: int,
    read_len: int = 100,
    *,
    coverage: float = 8.0,
    error_rate: float = 0.0,
    seed: int = 0,
) -> list[Sequence]:
    """A random (repeat-free) genome of n_reads * read_len / coverage bp,
    shredded into n_reads reads."""
    rng = np.random.RandomState(seed)
    genome_len = max(int(n_reads * read_len / coverage), read_len + 1)
    genome = "".join(_BASES[i] for i in rng.randint(0, 4, genome_len))
    return shred_genome(
        genome, n_reads, read_len, error_rate=error_rate, seed=seed + 1
    )


def planted_repeat_reads(
    n_reads: int,
    read_len: int = 100,
    *,
    coverage: float = 5.0,
    error_rate: float = 0.01,
    seed: int = 0,
) -> list[Sequence]:
    """Reads of a random genome carrying one planted 12-mer per 375 bp,
    each in 20 copies at random places: read pairs that share two planted
    k-mers at unrelated offsets collide on scattered diagonals, which the
    diagonal-coherence prescreen drops."""
    rng = np.random.RandomState(seed)
    genome_len = max(int(n_reads * read_len / coverage), read_len + 1)
    g = rng.randint(0, 4, genome_len)
    for _ in range(genome_len // 375):
        motif = rng.randint(0, 4, 12)
        for p in rng.randint(0, genome_len - 12, 20):
            g[p : p + 12] = motif
    genome = "".join(_BASES[i] for i in g)
    return shred_genome(
        genome, n_reads, read_len, error_rate=error_rate, seed=seed + 1
    )


def write_seq(seqs: list[Sequence], path: str) -> None:
    """Write reads as a .seq/FASTA file."""
    with open(path, "w") as f:
        for q in seqs:
            f.write(f">r{q.id}\n{q.seq}\n")
