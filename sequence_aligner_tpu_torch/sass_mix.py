"""Instruction mix of the compiled kernels' row loops.

    python -m sequence_aligner_tpu_torch.sass_mix [--source dovetail|probes] [--sass FILE]

Builds ``csrc/<source>.cu`` (see ``_build.py``), disassembles it with
``cuobjdump -sass`` (or reads a saved dump with ``--sass``) and prints, for
each kernel instance, the instructions of its outermost loop (the span of its
longest backward branch: the DP row loop of the dovetail kernels, the chain
loop of the probes) by opcode
family, with the share of register moves (``MOV``, ``IMAD.MOV``), control flow
and the rest.  Register moves cost an issue slot but do no work of the DP.
Then, for every loop (every backward branch's span), its min / max
instructions by full opcode: Hopper's DPX forms (``VIMNMX3``, ``VIADDMNMX``,
``VIMNMX`` with its 16x2 modifiers) beside the plain ``IMNMX``.
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


def loops(body: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(start, end) address of every backward branch's span, in order."""
    spans = set()
    for addr, ins in body:
        m = _BRA.match(ins)
        if m and int(m.group(1), 16) < addr:
            spans.add((int(m.group(1), 16), addr))
    return sorted(spans)


def minmax(loop: list[tuple[int, str]]) -> dict[str, int]:
    """Min / max instructions by full opcode (``VIMNMX3.S16x2``, ``IMNMX``,
    ...): the DPX forms and the plain two-input one."""
    return dict(collections.Counter(
        op for op in (opcode(i) for _, i in loop) if "MNMX" in op.split(".")[0]
    ).most_common())


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
_IDENT = re.compile(r"\d+")


def _ident(name: str, i: int) -> tuple[str, int]:
    d = _IDENT.match(name, i)
    n = int(d.group())
    return name[d.end() : d.end() + n], d.end() + n


def _args(name: str, i: int) -> tuple[list[str], int]:
    """Template arguments from ``name[i] == "I"`` to their ``E``: integer and
    bool literals, integer types, and (nested) class names with arguments."""
    i += 1
    args = []
    while name[i] != "E":
        if name.startswith(("Li", "Lb"), i):
            end = name.index("E", i)
            lit = name[i + 2 : end]
            args.append(lit if name[i + 1] == "i" else ("true" if lit == "1" else "false"))
            i = end + 1
        elif name[i] in _TYPES:
            args.append(_TYPES[name[i]])
            i += 1
        else:  # a class: N <prefixes> <name> [I ... E] E, or <name> [I ... E]
            nested = name[i] == "N"
            i += nested
            base = ""
            while name[i] == "S" or name[i].isdigit():
                if name[i] == "S":  # a substitution (the enclosing namespace)
                    i = name.index("_", i) + 1
                else:
                    base, i = _ident(name, i)
            if not base:
                raise ValueError(f"no template argument at {name[i:]!r}")
            sub = []
            if name[i] == "I":
                sub, i = _args(name, i)
            if nested:
                i += 1  # the nested name's E
            args.append(f"{base}<{', '.join(sub)}>" if sub else base)
    return args, i + 1


def _demangle_short(name: str) -> str:
    """``kernel<args>`` for a templated kernel's mangled name, with integer,
    bool, integer-type and class template arguments; the anonymous namespace
    (``_ZN41_GLOBAL__N__..._9_probes_cu_...17pack_probe_kernelILi1EEE...``)
    is dropped."""
    m = re.match(r"_ZN?", name)
    if not m:
        return name
    i, base = m.end(), None
    while _IDENT.match(name, i):  # length-prefixed identifiers
        ident, i = _ident(name, i)
        if not ident.startswith("_GLOBAL__N"):
            base = ident
            break
    if base is None:
        return name
    if not name.startswith("I", i):
        return base
    try:
        args, _ = _args(name, i)
    except (ValueError, IndexError, AttributeError):
        return base
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
        for lo, hi in loops(body):
            span = [(a, i) for a, i in body if lo <= a <= hi]
            mm = ", ".join(f"{k} {v}" for k, v in minmax(span).items()) or "none"
            print(f"    loop {lo:#06x}-{hi:#06x}: {len(span)} instructions; min/max: {mm}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
