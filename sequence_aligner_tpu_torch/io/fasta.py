"""FASTA / AMOS .seq ingestion (copied from ``sequence_aligner_tpu/io``).

The reference's streaming reader semantics (``src/BioLibs.scala:26-50``):
the file must start with ``>``, header text is discarded, record bodies are
concatenated across lines and upper-cased, and ids are 1-based ordinals in
file order.
"""

from __future__ import annotations

from collections.abc import Iterator

from sequence_aligner_tpu_torch.core.records import Sequence


def iter_fasta(path: str) -> Iterator[Sequence]:
    """Stream Sequence records from a FASTA/.seq file."""
    with open(path, "r") as f:
        first = f.readline()
        if not first.startswith(">"):
            raise ValueError(f"Invalid Sequence File: {path}")
        i = 1
        parts: list[str] = []
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                yield Sequence(i, "".join(parts).upper())
                i += 1
                parts = []
            else:
                parts.append(line)
        yield Sequence(i, "".join(parts).upper())


def read_fasta(path: str) -> list[Sequence]:
    return list(iter_fasta(path))
