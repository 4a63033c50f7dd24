"""Result records: sequences and AMOS overlap records.

Copied from ``sequence_aligner_tpu/core/records.py`` (the parts the
calc-overlaps path needs):

  Sequence       src/ObjectStore.scala:72-85 (1-based ordinal ids)
  OverlapRecord  src/ObjectStore.scala:119-142 (AMOS {OVL} block :127-135)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Sequence:
    id: int  # 1-based ordinal in file order
    seq: str  # upper-cased bases


@dataclasses.dataclass(frozen=True)
class OverlapRecord:
    """AMOS OVL record; adj is always 'N' and scr always 0 in the
    reference."""

    id_a: int
    id_b: int
    ahg: int
    bhg: int
    adj: str = "N"
    scr: int = 0

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
