"""Tensor ops: encode (host), k-mer scan, pair generation, dovetail alignment.

The JAX package's ``plan_totals_device`` has no namesake: ``plan_totals``
sums on the device in int64 and returns the totals as Python ints."""

from sequence_aligner_tpu_torch.ops.encode import encode_reads, pack_2bit
from sequence_aligner_tpu_torch.ops.kmer import kmer_scan
from sequence_aligner_tpu_torch.ops.pairgen import candidate_pairs_stream, plan_totals

__all__ = [
    "encode_reads", "pack_2bit", "kmer_scan", "candidate_pairs_stream", "plan_totals",
]
