"""FASTA reading, OVL writing and parsing, and AMOS messages (host)."""

from sequence_aligner_tpu_torch.io.fasta import read_fasta, iter_fasta
from sequence_aligner_tpu_torch.io.ovl import (
    write_ovl, parse_ovl, canonical_sort, records_equal,
)
from sequence_aligner_tpu_torch.io.hoxd import read_hoxd

__all__ = [
    "read_fasta", "iter_fasta", "write_ovl", "parse_ovl",
    "canonical_sort", "records_equal", "read_hoxd",
]
