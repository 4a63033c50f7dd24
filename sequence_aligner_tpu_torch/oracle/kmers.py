"""NumPy/dict k-mer index oracle.

Copied from ``sequence_aligner_tpu/oracle/kmers.py``.

Replicates the reference's k-mer machinery:
  seq_hash        src/ObjectStore.scala:48-67 (2 bits/base, A=00 C=01 T=10
                  G=11, first min(16, len) bases, 32-bit wraparound)
  generate_kmers  src/BioLibs.scala:54-61 (normalized loc = i / (len - k),
                  float32)
  KmerTableOracle src/KmerTable.scala — inverted k-mer index, positional
                  edge/middle pair counting (:85-149), collision-band
                  dispatch grouping (:155-187), collision histogram
                  (:200-221)

The device path (ops/kmer.py, ops/pairgen.py) re-expresses the hash maps as
sorted arrays + segment ops and is validated against this oracle.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import BASE_CODE, AlignSettings


def seq_hash(kmer: str) -> int:
    """Pack the first min(16, len) bases into a signed 32-bit int.

    Unknown characters behave like 'A' (code 0), as in the reference (which
    prints a warning and XORs nothing, src/ObjectStore.scala:60-62).
    """
    h = 0
    for c in kmer[:16].upper():
        h = ((h << 2) & 0xFFFFFFFF) ^ BASE_CODE.get(c, 0)
    if h >= 0x80000000:
        h -= 0x100000000
    return h


def generate_kmers(k: int, seq: Sequence) -> list[tuple[int, np.float32]]:
    """All (hash, loc) k-mer occurrences of one read, position order.

    loc = i / (len - k) computed in float32 (src/BioLibs.scala:57-58).
    """
    n = len(seq.seq)
    d = np.float32(n - k)
    out = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(n - k + 1):
            out.append((seq_hash(seq.seq[i : i + k]), np.float32(np.float32(i) / d)))
    return out


class KmerTableOracle:
    """Dict-based replica of the reference KmerTable."""

    def __init__(self):
        # khash -> list of (read_id, loc) in insertion order
        self.kmer_data: dict[int, list[tuple[int, np.float32]]] = defaultdict(list)
        self.sequence_data: dict[int, Sequence] = {}

    def add_sequence(self, seq: Sequence, k: int) -> None:
        self.sequence_data[seq.id] = seq
        for h, loc in generate_kmers(k, seq):
            self.kmer_data[h].append((seq.id, loc))

    def unique_kmers(self) -> int:
        return len(self.kmer_data)

    def unique_seqs(self) -> int:
        return len(self.sequence_data)

    def collision_histogram(self) -> dict[int, int]:
        """occurrences-per-unique-kmer -> count (src/KmerTable.scala:200-221)."""
        hist: dict[int, int] = defaultdict(int)
        for occs in self.kmer_data.values():
            hist[len(occs)] += 1
        return dict(hist)

    def calc_pair_data(self, s: AlignSettings) -> dict[tuple[int, int], int]:
        """Ordered-pair collision counts (src/KmerTable.scala:85-149).

        Per unique k-mer, occurrences are bucketed into head-edge / middle /
        tail-edge by loc, then every head x middle and tail x middle pair is
        counted via the ordering rule of addKmerPair (:57-80): self-pairs
        skipped; the occurrence with the strictly greater loc is the lead
        (probable upstream read); ties make the middle occurrence lead.
        """
        h_edge = s.kmer_head_edge
        t_edge = s.kmer_tail_edge
        m_lead = s.kmer_mid_lead_edge
        m_tail = s.kmer_mid_tail_edge
        counts: dict[tuple[int, int], int] = defaultdict(int)

        def add_pair(a, b):
            if a[0] == b[0]:
                return
            if a[1] > b[1]:
                fst, snd = a, b
            else:
                fst, snd = b, a
            counts[(fst[0], snd[0])] += 1

        for occs in self.kmer_data.values():
            st = [o for o in occs if o[1] <= h_edge]
            md = [o for o in occs if m_lead <= o[1] <= m_tail]
            en = [o for o in occs if t_edge <= o[1]]
            for a in st:
                for b in md:
                    add_pair(a, b)
            for a in en:
                for b in md:
                    add_pair(a, b)
        return dict(counts)

    def calc_dispatch(self, s: AlignSettings) -> dict[int, list[int]]:
        """lead -> trailing ids for pairs whose collision count lies in
        [min_collisions, max_collisions] (src/KmerTable.scala:155-187)."""
        dispatch: dict[int, list[int]] = defaultdict(list)
        for (a, b), cnt in self.calc_pair_data(s).items():
            if s.min_collisions <= cnt <= s.max_collisions:
                dispatch[a].append(b)
        return dict(dispatch)

    def candidate_pairs(self, s: AlignSettings) -> list[tuple[int, int]]:
        """Canonically-sorted (lead, trail) candidate list."""
        pairs = []
        for a, bs in self.calc_dispatch(s).items():
            for b in bs:
                pairs.append((a, b))
        pairs.sort()
        return pairs
