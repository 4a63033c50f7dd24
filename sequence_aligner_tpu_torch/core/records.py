"""Result records: sequences, alignments, overlaps.

Copied from ``sequence_aligner_tpu/core/records.py`` (the port imports
nothing of the JAX package); semantics of the reference's data objects:
  Sequence         src/ObjectStore.scala:72-85 (1-based ordinal ids)
  AlignmentResult  src/ObjectStore.scala:89-115 (validity predicate :102-107)
  OverlapRecord    src/ObjectStore.scala:119-142 (AMOS {OVL} block :127-135,
                   hang-limit validity :137-141)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sequence_aligner_tpu_torch.core.settings import AlignSettings


@dataclasses.dataclass(frozen=True)
class Sequence:
    id: int  # 1-based ordinal in file order
    seq: str  # upper-cased bases


@dataclasses.dataclass
class AlignmentResult:
    """Result of one pairwise DP.

    ``start``/``end`` are (i, j) coordinates in the (A-row, B-column) DP
    space; ``correct``/``error`` are matched/unmatched column counts along
    the traceback; ``align_len`` is the traceback length (== len(alignA) in
    the reference).  Gapped strings are optional — the device path returns
    only coordinates and counts.
    """

    id_a: int
    id_b: int
    len_a: int
    len_b: int
    start: tuple[int, int]
    end: tuple[int, int]
    correct: int
    error: int
    align_len: int
    align_a: str | None = None
    align_b: str | None = None
    dud: bool = False

    @property
    def err_ratio(self) -> np.float32:
        # identity fraction, float32 like the reference's errRatio
        # (src/ObjectStore.scala:99)
        c = np.float32(self.correct)
        return np.float32(c / (c + np.float32(self.error)))

    def valid(self, s: AlignSettings) -> bool:
        """src/ObjectStore.scala:102-107: identity, length and the dovetail
        boundary condition ((A starts at 0 and B ends at its last base) or
        (B starts at 0 and A ends at its last base))."""
        if self.dud:
            return False
        return (
            self.err_ratio >= np.float32(s.min_identity)
            and self.align_len >= s.min_overlap
            and (
                (self.start[0] == 0 and self.len_b == self.end[1])
                or (self.start[1] == 0 and self.len_a == self.end[0])
            )
        )


@dataclasses.dataclass(frozen=True)
class OverlapRecord:
    """AMOS OVL record (src/ObjectStore.scala:119-142).

    adj is always 'N' and scr always 0 in the reference; ahg/bhg derive from
    the alignment start coordinates and sequence lengths.
    """

    id_a: int
    id_b: int
    ahg: int
    bhg: int
    adj: str = "N"
    scr: int = 0

    @classmethod
    def from_alignment(cls, a: AlignmentResult) -> "OverlapRecord":
        ahg = a.start[0] - a.start[1]
        bhg = a.len_b - a.len_a + ahg
        return cls(id_a=a.id_a, id_b=a.id_b, ahg=ahg, bhg=bhg)

    @classmethod
    def bulk_build(cls, id_a, id_b, ahg, bhg) -> list["OverlapRecord"]:
        """Construct many records from parallel int sequences, bypassing
        the frozen-dataclass __init__ (six object.__setattr__ calls per
        record made emission the third-largest stage at 383k records).

        The bypass assumes a plain frozen dataclass: no __slots__ (records
        need a __dict__) and no __post_init__/validation to skip."""
        assert "__slots__" not in cls.__dict__ and not hasattr(
            cls, "__post_init__"
        ), "bulk_build bypasses __init__; it cannot honor slots/__post_init__"
        new = object.__new__
        out = []
        append = out.append
        for a, b, h, g in zip(id_a, id_b, ahg, bhg):
            r = new(cls)
            # in-place dict update: frozen __setattr__ blocks even
            # __dict__ replacement, but mutating the dict is fine
            r.__dict__.update(
                id_a=a, id_b=b, ahg=h, bhg=g, adj="N", scr=0
            )
            append(r)
        return out

    def render(self) -> str:
        """The 6-line {OVL ...} text block (src/ObjectStore.scala:127-135)."""
        return (
            "{OVL"
            f"\nadj:{self.adj}"
            f"\nrds:{self.id_a},{self.id_b}"
            f"\nscr:{self.scr}"
            f"\nahg:{self.ahg}"
            f"\nbhg:{self.bhg}"
            "\n}"
        )

    def hang_valid(self, s: AlignSettings) -> bool:
        """The extra |ahg|,|bhg| < max_ignore condition
        (src/ObjectStore.scala:137-141)."""
        return abs(self.ahg) < s.max_ignore and abs(self.bhg) < s.max_ignore

    def sort_key(self) -> tuple[int, int]:
        return (self.id_a, self.id_b)
