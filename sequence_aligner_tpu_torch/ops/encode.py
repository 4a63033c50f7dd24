"""Host-side read encoding: strings -> dense 2-bit-code arrays.

Copied from ``sequence_aligner_tpu/ops/encode.py``.  Bases map to the
reference's ``seqHash`` 2-bit codes (A=0 C=1 T=2 G=3,
src/ObjectStore.scala:56-59) in a zero-padded [N, L_max] int8 matrix plus a
length vector; unknown characters map to code 0 ('A'), the reference's
warn-and-continue behaviour.  ``pack_2bit`` packs 16 codes an int32 word,
base 0 in the word's top bits (the ``seqHash`` shift order), and
``unpack_2bit`` reverses it.
"""

from __future__ import annotations

import numpy as np

from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import CODE_BASE

# char -> 2-bit code lookup over raw bytes; unknown chars -> 0
_LUT = np.zeros(256, dtype=np.int8)
for c, v in (("A", 0), ("C", 1), ("T", 2), ("G", 3)):
    _LUT[ord(c)] = v
    _LUT[ord(c.lower())] = v


def encode_reads(
    seqs: list[Sequence], l_max: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """-> (bases int8 [N, l_max] zero-padded, lengths int32 [N])."""
    n = len(seqs)
    lengths = np.asarray([len(q.seq) for q in seqs], dtype=np.int32)
    if l_max is None:
        l_max = int(lengths.max()) if n else 0
    if n and l_max and (lengths == l_max).all():
        # uniform-length fast path: one joined buffer + one LUT pass
        blob = np.frombuffer(
            "".join(q.seq for q in seqs).encode("ascii"), dtype=np.uint8
        )
        return _LUT[blob].reshape(n, l_max), lengths
    bases = np.zeros((n, l_max), dtype=np.int8)
    for i, q in enumerate(seqs):
        b = np.frombuffer(q.seq.encode("ascii"), dtype=np.uint8)[:l_max]
        bases[i, : len(b)] = _LUT[b]
    return bases, lengths


def pack_2bit(bases: np.ndarray) -> np.ndarray:
    """[N, L] int8 codes -> [N, ceil(L/16)] int32, 16 bases a word, base 0
    in the word's top bits."""
    n, l = bases.shape
    b = np.pad(bases, ((0, 0), (0, (-l) % 16))).astype(np.uint64).reshape(n, -1, 16)
    shifts = np.arange(15, -1, -1, dtype=np.uint64) * 2
    return (b << shifts).sum(axis=2).astype(np.uint32).view(np.int32)


def unpack_2bit(words: np.ndarray, l: int) -> np.ndarray:
    """Inverse of ``pack_2bit``: [N, W] int32 words -> [N, l] int8 codes."""
    w = words.view(np.uint32).astype(np.uint64)
    shifts = np.arange(15, -1, -1, dtype=np.uint64) * 2
    return ((w[:, :, None] >> shifts) & 3).reshape(w.shape[0], -1)[:, :l].astype(np.int8)


def decode_read(bases_row: np.ndarray, length: int) -> str:
    """The first ``length`` codes of a row as bases."""
    return "".join(CODE_BASE[int(c)] for c in bases_row[:length])
