"""The AMOS assembly pipeline (port of ``sequence_aligner_tpu/pipeline/driver.py``).

The reference's Rake orchestration (``Rakefile.rb:164-209``): bank creation
-> overlap -> bank-transact -> tigger -> make-consensus -> bank2fasta, each
stage timed on the wall clock (:197-208).  The assembly stages are the AMOS
toolchain's own binaries, run from ``amos_bin``; the overlap stage is one
of this package's engines, or AMOS ``hash-overlap`` itself.  The stages run
the same commands with the same arguments as the JAX package's driver.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import shutil
import subprocess
import time

import torch

from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import AlignSettings
from sequence_aligner_tpu_torch.device import resolve_device
from sequence_aligner_tpu_torch.io.fasta import read_fasta
from sequence_aligner_tpu_torch.io.ovl import write_ovl
from sequence_aligner_tpu_torch.pipeline.datasets import AMOS_BIN, write_seq

# the overlap stage: the single-device engine, the CPU oracle, the sharded
# engine (one rank), or AMOS hash-overlap (the reference's pipeline:amos,
# Rakefile.rb:98-150)
OVERLAPPERS = ("device", "oracle", "sharded", "amos")


@dataclasses.dataclass
class PipelineResult:
    contigs: list[Sequence]
    timings: dict[str, float]
    workdir: str
    n_overlaps: int

    @property
    def n_contigs(self) -> int:
        return len(self.contigs)


def unlock_bank(bank_dir: str) -> int:
    """Clears stale AMOS bank locks (the reference's Perl ``bank-unlock``,
    amos/bank-unlock:36-60): removes ``*.lck`` files and empties the
    ``locks = ...`` lines of ``*.ifo`` headers.  Returns the number of
    locks cleared."""
    n = 0
    for lck in glob.glob(os.path.join(bank_dir, "*.lck")):
        os.remove(lck)
        n += 1
    for ifo in glob.glob(os.path.join(bank_dir, "*.ifo")):
        with open(ifo) as f:
            text = f.read()
        new = re.sub(r"(?m)^(locks = ).+$", r"\1", text)
        if new != text:
            with open(ifo, "w") as f:
                f.write(new)
            n += 1
    return n


def _run(cmd: list[str], **kw) -> None:
    """Runs one stage; raises RuntimeError with the end of its output if it
    exits non-zero (a missing binary raises FileNotFoundError)."""
    r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **kw)
    if r.returncode != 0:
        raise RuntimeError(f"pipeline stage failed ({' '.join(cmd)}):\n{r.stdout[-2000:]}")


def _overlaps(seqs: list[Sequence], settings: AlignSettings, overlapper: str,
              device: torch.device | None):
    if overlapper == "oracle":
        from sequence_aligner_tpu_torch.oracle.overlap import oracle_overlaps

        return oracle_overlaps(seqs, settings)
    if overlapper == "sharded":
        from sequence_aligner_tpu_torch.parallel.shard import sharded_overlap

        return sharded_overlap(seqs, settings, device=device)
    from sequence_aligner_tpu_torch.models.overlapper import Overlapper

    return Overlapper(settings, device=device).run(seqs)


def run_amos_pipeline(
    seqs: list[Sequence] | str,
    settings: AlignSettings,
    workdir: str,
    *,
    overlapper: str = "device",
    amos_bin: str = AMOS_BIN,
    keep_workdir: bool = True,
    device: str | torch.device = "cuda",
) -> PipelineResult:
    """Assembles ``seqs`` (reads, or a FASTA path) in ``workdir``, with the
    overlap stage's ``overlapper`` one of ``OVERLAPPERS``.  ``device`` is
    the device of the ``device`` and ``sharded`` engines (checked before
    any stage runs); the other two do not use it."""
    if overlapper not in OVERLAPPERS:
        raise ValueError(f"overlapper must be one of {OVERLAPPERS}, got {overlapper!r}")
    dev = resolve_device(device) if overlapper in ("device", "sharded") else None
    os.makedirs(workdir, exist_ok=True)
    seq_path = os.path.join(workdir, "input.seq")
    bnk = os.path.join(workdir, "input.bnk")
    ovl = os.path.join(workdir, "input.ovl")
    fst = os.path.join(workdir, "input.fasta")
    if isinstance(seqs, str):
        shutil.copy(seqs, seq_path)
        seqs = read_fasta(seq_path)
    else:
        write_seq(seqs, seq_path)
    if os.path.exists(bnk):
        shutil.rmtree(bnk)

    timings: dict[str, float] = {}
    t0 = time.time()
    _run([f"{amos_bin}/toAmos_new", "-s", seq_path, "-b", bnk])
    timings["bank"] = time.time() - t0

    n_overlaps = 0
    t0 = time.time()
    if overlapper == "amos":
        _run([f"{amos_bin}/hash-overlap", bnk, "-B", "-x", "0.04", "-o", "40"])
        timings["overlap"] = time.time() - t0
    else:
        n_overlaps = write_ovl(_overlaps(seqs, settings, overlapper, dev), ovl)
        timings["overlap"] = time.time() - t0
        t0 = time.time()
        _run([f"{amos_bin}/bank-transact", "-b", bnk, "-m", ovl])
        timings["transact"] = time.time() - t0

    t0 = time.time()
    _run([f"{amos_bin}/tigger", "-b", bnk])
    timings["tigger"] = time.time() - t0

    t0 = time.time()
    _run([f"{amos_bin}/make-consensus", "-e", "0.04", "-o", "40", "-B", "-b", bnk])
    timings["consensus"] = time.time() - t0

    t0 = time.time()
    with open(fst, "w") as f:
        r = subprocess.run([f"{amos_bin}/bank2fasta", "-b", bnk], stdout=f,
                           stderr=subprocess.PIPE, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"bank2fasta failed:\n{r.stderr[-2000:]}")
    timings["fasta"] = time.time() - t0

    res = PipelineResult(contigs=read_fasta(fst), timings=timings, workdir=workdir,
                         n_overlaps=n_overlaps)
    if not keep_workdir:
        shutil.rmtree(workdir)
    return res
