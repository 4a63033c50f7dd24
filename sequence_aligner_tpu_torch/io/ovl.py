"""AMOS {OVL} message writing, parsing and comparison (copied from
``sequence_aligner_tpu/io``).

Each record is the 6-line block of ``src/ObjectStore.scala:127-135``
followed by a newline (``src/Project4.scala:814-819``), in canonical
(id_a, id_b) order — byte-identical to the JAX package's writer.  A file
is written by the native formatter (``native.ovl_write_native``), as the
JAX package writes it; stdout stays Python.  ``parse_ovl`` reads such
files back; ``records_equal`` compares two record lists as canonically
sorted lists.
"""

from __future__ import annotations

import sys
from collections.abc import Iterable, Sequence as Seq

from sequence_aligner_tpu_torch.core.records import OverlapRecord
from sequence_aligner_tpu_torch.native import ovl_write_native


def canonical_sort(records: Iterable[OverlapRecord]) -> list[OverlapRecord]:
    return sorted(records, key=OverlapRecord.sort_key)


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


def parse_ovl(path_or_text: str, *, is_text: bool = False) -> list[OverlapRecord]:
    """The records of an AMOS {OVL} message file (or of its text)."""
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    records: list[OverlapRecord] = []
    cur: dict[str, str] = {}
    in_rec = False
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{OVL"):
            in_rec = True
            cur = {}
        elif line == "}":
            if in_rec:
                a, b = cur["rds"].split(",")
                records.append(OverlapRecord(
                    id_a=int(a), id_b=int(b), ahg=int(cur["ahg"]), bhg=int(cur["bhg"]),
                    adj=cur.get("adj", "N"), scr=int(cur.get("scr", "0"))))
            in_rec = False
        elif in_rec and ":" in line:
            k, v = line.split(":", 1)
            cur[k] = v
    return records


def records_equal(got: Seq[OverlapRecord], want: Seq[OverlapRecord], *,
                  verbose: bool = False) -> bool:
    """Equality of two record lists in canonical order; ``verbose`` prints
    up to 20 missing and 20 extra records to stderr."""
    g, w = canonical_sort(got), canonical_sort(want)
    if g == w:
        return True
    if verbose:
        gs, ws = set(g), set(w)
        print(f"records_equal: got {len(g)} want {len(w)}", file=sys.stderr)
        for r in sorted(ws - gs, key=OverlapRecord.sort_key)[:20]:
            print(f"  missing: {r}", file=sys.stderr)
        for r in sorted(gs - ws, key=OverlapRecord.sort_key)[:20]:
            print(f"  extra:   {r}", file=sys.stderr)
    return False
