"""The CPU oracle engine in numpy (copied from ``sequence_aligner_tpu/oracle``):
the reference's aligners, k-mer table and end-to-end overlap path, one pair
at a time.  It backs the CLI's ``--engine oracle`` / ``--st-align`` and its
``--test-*`` modes."""

from sequence_aligner_tpu_torch.oracle.align import (
    local_alignment, fast_dovetail_alignment, DUD,
)
from sequence_aligner_tpu_torch.oracle.kmers import (
    seq_hash, generate_kmers, KmerTableOracle,
)
from sequence_aligner_tpu_torch.oracle.overlap import oracle_overlaps

__all__ = [
    "local_alignment", "fast_dovetail_alignment", "DUD",
    "seq_hash", "generate_kmers", "KmerTableOracle", "oracle_overlaps",
]
