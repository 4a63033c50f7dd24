"""Stand-in AMOS binaries, to drive the pipeline without the AMOS toolchain.

``write_standins(bin_dir)`` writes an executable Python script under the
name of each binary the driver runs (``AMOS_BINARIES``).  Each appends its
argv, its own name first, as one JSON list a line to ``bin_dir/argv.log``,
and copies what the bank is handed into the bank directory: ``toAmos_new``
the reads (``reads.seq``), ``bank-transact`` the OVL file
(``overlaps.ovl``).  ``bank2fasta`` prints one contig, the bank's first
read.  A name in ``fail`` prints one line and exits 1 after logging.  They
assemble nothing: they show which commands the driver runs and what it
hands each stage.
"""

from __future__ import annotations

import os
import sys

AMOS_BINARIES = ("toAmos_new", "hash-overlap", "bank-transact", "tigger", "make-consensus",
                 "bank2fasta")

_SCRIPT = '''#!{python}
import json, os, shutil, sys

name = os.path.basename(sys.argv[0])
args = sys.argv[1:]
with open(os.path.join(os.path.dirname(os.path.abspath(sys.argv[0])), "argv.log"), "a") as f:
    f.write(json.dumps([name, *args]) + "\\n")
if name in {fail!r}:
    print(name + ": stand-in exits 1 as asked")
    sys.exit(1)


def opt(flag):
    return args[args.index(flag) + 1]


if name == "toAmos_new":
    os.makedirs(opt("-b"))
    shutil.copy(opt("-s"), os.path.join(opt("-b"), "reads.seq"))
elif name == "bank-transact":
    shutil.copy(opt("-m"), os.path.join(opt("-b"), "overlaps.ovl"))
elif name == "bank2fasta":
    with open(os.path.join(opt("-b"), "reads.seq")) as f:
        first = f.read().split(">")[1].splitlines()
    print(">1")
    print("".join(first[1:]))
'''


def write_standins(bin_dir: str, *, fail: tuple[str, ...] = ()) -> str:
    """Writes the stand-ins into ``bin_dir`` (made if absent), run by this
    Python interpreter; returns ``bin_dir``."""
    os.makedirs(bin_dir, exist_ok=True)
    body = _SCRIPT.format(python=sys.executable, fail=tuple(fail))
    for name in AMOS_BINARIES:
        path = os.path.join(bin_dir, name)
        with open(path, "w") as f:
            f.write(body)
        os.chmod(path, 0o755)
    return bin_dir
