"""AMOS {OVL} message writing (copied from ``sequence_aligner_tpu/io``).

Each record is the 6-line block of ``src/ObjectStore.scala:127-135``
followed by a newline (``src/Project4.scala:814-819``), in canonical
(id_a, id_b) order — byte-identical to the JAX package's writer.  A file
is written by the native formatter (``native.ovl_write_native``), as the
JAX package writes it; stdout stays Python.
"""

from __future__ import annotations

import sys
from collections.abc import Iterable

from sequence_aligner_tpu_torch.core.records import OverlapRecord
from sequence_aligner_tpu_torch.native import ovl_write_native


def write_ovl(records: Iterable[OverlapRecord], path: str | None = None) -> int:
    """Write records to a file, or to stdout when ``path`` is None (the
    reference's no-output mode, src/Project4.scala:815-819).  Returns the
    record count."""
    if path is None:
        n = 0
        for r in records:
            print(r.render())
            n += 1
        return n
    recs = records if isinstance(records, list) else list(records)
    if recs and all(r.adj == "N" and r.scr == 0 for r in recs):
        ovl_write_native(path, [r.id_a for r in recs], [r.id_b for r in recs],
                         [r.ahg for r in recs], [r.bhg for r in recs])
        return len(recs)
    with open(path, "w") as f:
        for r in recs:
            f.write(r.render() + "\n")
    return len(recs)


def write_ovl_arrays(arrs, path: str | None = None) -> int:
    """(lead, trail, ahg, bhg) int sequences -> {OVL} text in a file, or on
    stdout when ``path`` is None.  Returns the record count."""
    lead, trail, ahg, bhg = arrs
    n = len(lead)
    if path is not None and n:
        ovl_write_native(path, lead, trail, ahg, bhg)
        return n
    lead, trail, ahg, bhg = (list(map(int, a)) for a in arrs)
    out = sys.stdout if path is None else open(path, "w")
    try:
        chunk = 1 << 16  # bounded transient text at millions of records
        for lo in range(0, n, chunk):
            out.writelines(
                f"{{OVL\nadj:N\nrds:{a},{b}\nscr:0\nahg:{h}\nbhg:{g}\n}}\n"
                for a, b, h, g in zip(
                    lead[lo : lo + chunk], trail[lo : lo + chunk],
                    ahg[lo : lo + chunk], bhg[lo : lo + chunk],
                )
            )
    finally:
        if path is not None:
            out.close()
    return n
