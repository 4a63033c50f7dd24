"""Instruction mix of the compiled kernels' row loops.

    python -m sequence_aligner_tpu_torch.sass_mix [--source dovetail|probes] [--sass FILE]

Builds ``csrc/<source>.cu`` (see ``_build.py``), disassembles it with
``cuobjdump -sass`` (or reads a saved dump with ``--sass``) and prints, for
each kernel instance, the instructions of its outermost loop (the span of its
longest backward branch: the DP row loop of the dovetail kernels, the chain
loop of the probes) by opcode
family, with the share of register moves (``MOV``, ``IMAD.MOV``), control flow
and the rest.  Register moves cost an issue slot but do no work of the DP.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

_FUNC = re.compile(r"\s*Function : (\S+)")
_INS = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"(?:@!?U?P\w+\s+)?BRA\s+(?:\S+\s+)?0x([0-9a-f]+)")
MOVES = ("MOV", "IMAD.MOV")
CONTROL = ("BRA", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC", "BAR")


def parse(text: str) -> dict[str, list[tuple[int, str]]]:
    """Kernel name -> [(address, instruction text)]."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INS.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(ins: str) -> str:
    parts = ins.split()
    return parts[1] if parts[0].startswith("@") else parts[0]


def row_loop(body: list[tuple[int, str]]) -> list[tuple[int, str]]:
    """Instructions of the longest backward branch's span."""
    best = (0, 0)
    for addr, ins in body:
        m = _BRA.match(ins)
        if m and int(m.group(1), 16) < addr:
            tgt = int(m.group(1), 16)
            if addr - tgt > best[1] - best[0]:
                best = (tgt, addr)
    return [(a, i) for a, i in body if best[0] <= a <= best[1]]


def mix(loop: list[tuple[int, str]]) -> dict:
    fam = collections.Counter()
    moves = control = 0
    for _, ins in loop:
        op = opcode(ins)
        if op.startswith(MOVES):
            moves += 1
            fam["IMAD.MOV" if op.startswith("IMAD.MOV") else "MOV"] += 1
            continue
        if op.startswith(CONTROL):
            control += 1
        fam[op.split(".")[0]] += 1
    n = len(loop)
    return dict(instructions=n, moves=moves, control=control,
                other=n - moves - control,
                move_share=moves / n if n else 0.0,
                families=dict(fam.most_common()))


_TYPES = {"a": "int8_t", "s": "int16_t", "i": "int32_t",
          "h": "uint8_t", "t": "uint16_t", "j": "uint32_t"}


def _demangle_short(name: str) -> str:
    """``kernel<args>`` for a templated kernel's mangled name, with integer,
    bool and integer-type template arguments; the anonymous namespace
    (``_ZN41_GLOBAL__N__..._9_probes_cu_...17pack_probe_kernelILi1EEE...``)
    is dropped."""
    m = re.match(r"_ZN?", name)
    if not m:
        return name
    i, base = m.end(), None
    while (d := re.match(r"\d+", name[i:])):  # length-prefixed identifiers
        n = int(d.group())
        ident = name[i + d.end() : i + d.end() + n]
        i += d.end() + n
        if not ident.startswith("_GLOBAL__N"):
            base = ident
            break
    if base is None:
        return name
    rest = name[i:]
    if not rest.startswith("I"):
        return base
    args = [lit or ("true" if flag == "1" else "false") if lit or flag else _TYPES[typ]
            for lit, flag, typ in
            re.findall(r"Li(-?\d+)E|Lb([01])E|([ashtij])", rest[1 : rest.find("EE") + 1])]
    return f"{base}<{', '.join(args)}>"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="dovetail")
    ap.add_argument("--sass", default="", help="analyse a saved cuobjdump -sass dump")
    a = ap.parse_args(argv)
    if a.sass:
        text = Path(a.sass).read_text()
    else:
        from sequence_aligner_tpu_torch import _build

        lib = _build.library_path(a.source)
        _build.finish_build(*_build.start_build(a.source))
        cuobjdump = shutil.which("cuobjdump") or str(Path(_build.find_nvcc()).parent / "cuobjdump")
        text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
    for name, body in sorted(parse(text).items()):
        m = mix(row_loop(body))
        fams = ", ".join(f"{k} {v}" for k, v in list(m["families"].items())[:8])
        print(f"{_demangle_short(name)}: row loop {m['instructions']} instructions, "
              f"{m['moves']} register moves ({100 * m['move_share']:.1f} %), "
              f"{m['control']} control, {m['other']} other; {fams}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
