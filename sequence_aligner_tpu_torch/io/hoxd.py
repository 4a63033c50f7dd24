"""HOXD substitution-matrix readers (copied from ``sequence_aligner_tpu/io``).

The reference parses the "wide" CSV format (title line + header + 4 rows,
``amos/HOXD1.txt``) in ``src/BioLibs.scala:66-114``.  The repo also ships a
pair-format file (``amos/HOXD2.txt``: lines like ``A,C=-114``); we
auto-detect and support both.  Missing symmetric entries in the pair format
are mirrored.

Returns a 4x4 int32 matrix in base-code (A=0,C=1,T=2,G=3) order.
"""

from __future__ import annotations

import numpy as np

from sequence_aligner_tpu_torch.core.settings import BASE_CODE


def read_hoxd(path: str) -> np.ndarray:
    with open(path) as f:
        lines = [ln.strip() for ln in f.read().splitlines()]
    lines = [ln for ln in lines if ln]
    if len(lines) < 2:
        raise ValueError(f"Empty HOXD file: {path}")
    body = lines[1:]  # drop the title line
    m = np.zeros((4, 4), dtype=np.int32)
    if "=" in body[0]:
        # pair format: "A,C=-114"
        seen = set()
        for ln in body:
            left, val = ln.split("=")
            a, b = [c.strip().upper() for c in left.split(",")]
            ia, ib = BASE_CODE[a], BASE_CODE[b]
            m[ia, ib] = int(val)
            seen.add((ia, ib))
        for (ia, ib) in list(seen):
            if (ib, ia) not in seen:
                m[ib, ia] = m[ia, ib]
    else:
        # wide format: header "-,A,C,G,T" then rows "A,91,-114,-31,-123"
        header = [c.strip().upper() for c in body[0].split(",")]
        for ln in body[1:]:
            row = [c.strip() for c in ln.split(",")]
            ia = BASE_CODE[row[0].upper()]
            for i in range(1, len(row)):
                ib = BASE_CODE[header[i]]
                m[ia, ib] = int(row[i])
    return m
