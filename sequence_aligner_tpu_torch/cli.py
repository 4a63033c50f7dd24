"""Command line: ``python -m sequence_aligner_tpu_torch.cli``.

The calc-overlaps mode of the JAX package's CLI (``sequence_aligner_tpu/cli.py``)
with its flag names and sign conventions for the settings it takes:

    python -m sequence_aligner_tpu_torch.cli -i reads.fasta -o out.ovl [--device cpu]

Runs on the card unless ``--device cpu`` is given.  The other modes of the
JAX CLI (tests, benches, pipeline, other engines, HOXD matrix files) are not
ported yet and are refused.
"""

from __future__ import annotations

import sys

from sequence_aligner_tpu_torch.core.settings import AlignSettings, simple_match_matrix

HELP = """sequence_aligner_tpu_torch — overlap engine on one NVIDIA GPU (PyTorch + CUDA)

Usage: python -m sequence_aligner_tpu_torch.cli -i <input.seq> [-o out.ovl] [options]

  --calc-overlaps (the only mode)
  -k|--kmer-size N     (12)    --match N / --mismatch N   (95/-70)
  --min-overlap N      (40)    --min-identity F           (0.98)
  --min-collisions N   (7)     --max-collisions N         (222)
  --kmer-center F      (0.4)   --kmer-edge F              (0.4)
  -gO|--gap-open N     (-200)  -gE|--gap-extend N         (-20)
  --max-ignore N       (90)    --amos-parity
  --batch-size N       (1048576)
  --prescreen / --no-prescreen  diagonal-coherence candidate prescreen
                       (empirically lossless, off by default)
  --device cuda|cpu    (cuda)
  -i|--input FILE   -o|--output FILE (stdout if absent)
"""


class Options:
    def __init__(self):
        self.input = ""
        self.output = ""
        self.k = 12
        self.match = 95
        self.mismatch = -70
        self.use_simple = False
        self.min_overlap = 40
        self.min_identity = 0.98
        self.max_ignore = 90
        self.gap_open = -200
        self.gap_extend = -20
        self.min_collisions = 7
        self.max_collisions = 222
        self.kmer_center = 0.4
        self.kmer_edge = 0.4
        self.amos_parity = False
        self.batch_size = 1 << 20
        self.device = "cuda"
        self.prescreen = False

    def settings(self) -> AlignSettings:
        cm = (simple_match_matrix(self.match, self.mismatch) if self.use_simple
              else AlignSettings().cost_matrix)
        mi = self.min_identity
        if mi >= 1:  # percent-style auto-scaling (src/Project4.scala:144-146)
            mi *= 0.01
        return AlignSettings(
            cost_matrix=cm, gap_open=self.gap_open, gap_extend=self.gap_extend,
            min_overlap=self.min_overlap, min_identity=mi,
            max_ignore=self.max_ignore, kmer_size=self.k,
            min_collisions=2 if self.amos_parity else self.min_collisions,
            max_collisions=self.max_collisions,
            kmer_edge=self.kmer_edge, kmer_center=self.kmer_center,
        )


def _fail(msg: str):
    print(msg, file=sys.stderr)
    sys.exit(1)


def parse_args(argv: list[str]) -> Options:
    o = Options()
    # flag -> (attribute, parse); the sign conventions of the JAX CLI
    takes = {
        "-k": ("k", int), "--kmer-size": ("k", int),
        "-i": ("input", str), "--input": ("input", str),
        "-o": ("output", str), "--output": ("output", str),
        "--min-overlap": ("min_overlap", lambda v: abs(int(v))),
        "--min-identity": ("min_identity", float),
        "--min-collisions": ("min_collisions", lambda v: abs(int(v))),
        "--max-collisions": ("max_collisions", lambda v: abs(int(v))),
        "--kmer-center": ("kmer_center", lambda v: abs(float(v))),
        "--kmer-edge": ("kmer_edge", lambda v: abs(float(v))),
        "-gO": ("gap_open", lambda v: -abs(int(v))),
        "--gap-open": ("gap_open", lambda v: -abs(int(v))),
        "-gE": ("gap_extend", lambda v: -abs(int(v))),
        "--gap-extend": ("gap_extend", lambda v: -abs(int(v))),
        "--max-ignore": ("max_ignore", lambda v: abs(int(v))),
        "--batch-size": ("batch_size", int),
        "--device": ("device", str),
        "--match": ("match", lambda v: abs(int(v))),
        "--mismatch": ("mismatch", lambda v: -abs(int(v))),
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(HELP)
            sys.exit(0)
        elif a in takes:
            if i + 1 >= len(argv):
                _fail(f"Missing value for {a}")
            attr, conv = takes[a]
            try:
                setattr(o, attr, conv(argv[i + 1]))
            except ValueError:
                _fail(f"Invalid value for {a}: {argv[i + 1]}")
            if a in ("--match", "--mismatch"):
                o.use_simple = True
            i += 2
        elif a == "--amos-parity":
            o.amos_parity = True
            i += 1
        elif a in ("--prescreen", "--no-prescreen"):
            o.prescreen = a == "--prescreen"
            i += 1
        elif a in ("--calc-overlaps", "--linear-align", "--block-align", "--mt-align",
                   "--mt-hash", "--st-hash"):
            i += 1  # the defaults this port implements
        else:
            _fail(f"Invalid or not yet ported argument : {a}")
    if o.input == "":
        _fail("No input file specified")
    return o


def main(argv: list[str] | None = None) -> int:
    o = parse_args(sys.argv[1:] if argv is None else argv)
    from sequence_aligner_tpu_torch.io.ovl import write_ovl_arrays
    from sequence_aligner_tpu_torch.models.overlapper import Overlapper

    arrs = Overlapper(o.settings(), batch_size=o.batch_size, prescreen=o.prescreen,
                      device=o.device).run_arrays(o.input)
    write_ovl_arrays(arrs, o.output or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
