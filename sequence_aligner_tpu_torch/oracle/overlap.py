"""End-to-end CPU oracle: FASTA -> k-mer table -> candidates -> DP -> OVL.

Copied from ``sequence_aligner_tpu/oracle/overlap.py``.

This is the semantic anchor for the whole framework: it mirrors the
reference's production call stack (``--calc-overlaps``,
src/Project4.scala:56-59 -> 508-563 -> 725-790 -> 795-825) with output in
canonical (id_a, id_b) order.
"""

from __future__ import annotations

from sequence_aligner_tpu_torch.core.records import AlignmentResult, OverlapRecord, Sequence
from sequence_aligner_tpu_torch.core.settings import AlignSettings
from sequence_aligner_tpu_torch.io.fasta import read_fasta
from sequence_aligner_tpu_torch.oracle.align import fast_dovetail_alignment, local_alignment
from sequence_aligner_tpu_torch.oracle.kmers import KmerTableOracle
from sequence_aligner_tpu_torch.utils.debug import heartbeat


def build_table(seqs: list[Sequence], s: AlignSettings) -> KmerTableOracle:
    table = KmerTableOracle()
    for seq in seqs:
        table.add_sequence(seq, s.kmer_size)
    return table


def oracle_alignments(
    seqs: list[Sequence],
    s: AlignSettings,
    *,
    fast_dovetail: bool = True,
    filter_valid: bool = True,
    max_pairs: int | None = None,
) -> list[AlignmentResult]:
    """Candidate generation + per-pair DP, canonically ordered.

    ``max_pairs`` samples only the first N candidate pairs — the intent of
    the reference's ``debugStop = 500`` quick-bench mode
    (src/Project4.scala:462-465; its gate ``aligns.size > debugStop`` at
    :611 is inverted and never fires, so we implement the documented
    sampling intent rather than the no-op)."""
    table = build_table(seqs, s)
    by_id = {q.id: q for q in seqs}
    align = fast_dovetail_alignment if fast_dovetail else local_alignment
    out = []
    for i, (a, b) in enumerate(table.candidate_pairs(s)):
        if max_pairs is not None and i >= max_pairs:
            break
        # --debug progress prints, like the reference's per-N heartbeats
        # in its alignment loops (src/Project4.scala:654-664)
        heartbeat(i, 1000, f" Aligned {i} pairs...")
        r = align(by_id[a], by_id[b], s)
        if (not filter_valid) or r.valid(s):
            out.append(r)
    return out


def oracle_overlaps(
    path_or_seqs: str | list[Sequence],
    s: AlignSettings,
    *,
    fast_dovetail: bool = True,
) -> list[OverlapRecord]:
    """Valid OVL records for a FASTA file or sequence list, sorted."""
    seqs = (
        read_fasta(path_or_seqs) if isinstance(path_or_seqs, str) else path_or_seqs
    )
    records = []
    for r in oracle_alignments(seqs, s, fast_dovetail=fast_dovetail):
        o = OverlapRecord.from_alignment(r)
        if o.hang_valid(s):
            records.append(o)
    records.sort(key=OverlapRecord.sort_key)
    return records
