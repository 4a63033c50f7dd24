"""AMOS {OVL} message writing (copied from ``sequence_aligner_tpu/io``).

Each record is the 6-line block of ``src/ObjectStore.scala:127-135``
followed by a newline (``src/Project4.scala:814-819``), in canonical
(id_a, id_b) order — byte-identical to the JAX package's writer.
"""

from __future__ import annotations

import sys


def write_ovl_arrays(arrs, path: str | None = None) -> int:
    """(lead, trail, ahg, bhg) int sequences -> {OVL} text in a file, or on
    stdout when ``path`` is None.  Returns the record count."""
    lead, trail, ahg, bhg = (list(map(int, a)) for a in arrs)
    n = len(lead)
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
