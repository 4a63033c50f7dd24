"""Command line: ``python -m sequence_aligner_tpu_torch.cli``.

The JAX package's CLI (``sequence_aligner_tpu/cli.py``, which mirrors the
reference's, src/Project4.scala:101-259) with its flags, sign conventions,
modes and output bytes:

    python -m sequence_aligner_tpu_torch.cli -i reads.fasta -o out.ovl [--device cpu]

The engine runs on the card unless ``--device cpu`` is given.  The
reference's threading toggles map onto engines as in the JAX CLI:
``--st-align`` is the CPU oracle engine (``--engine oracle``), ``--mt-align``
the device engine; ``--single-align`` aligns batches of one pair (the engine
clamps them to 128), ``--block-align`` full batches; ``--quadratic-align``
the full Smith-Waterman, ``--linear-align`` the two-phase banded dovetail.
``--engine sharded`` runs the sharded engine (``parallel.shard``) as one
rank on ``--device``, as the JAX CLI runs it over the local devices; its
multi-process form is ``python -m sequence_aligner_tpu_torch.dist.worker``.
``--pipeline`` runs the AMOS assembly (``pipeline.driver``) in
``--workdir`` with the ``--engine`` as its overlap stage (``--engine amos``:
AMOS ``hash-overlap``); its binaries are read from ``pipeline.datasets.AMOS_BIN``,
and where they are missing it fails as the JAX CLI does.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from sequence_aligner_tpu_torch.core.settings import AlignSettings, simple_match_matrix
from sequence_aligner_tpu_torch.io.hoxd import read_hoxd
from sequence_aligner_tpu_torch.ops.encode import encode_reads

HELP = """sequence_aligner_tpu_torch — overlap engine on NVIDIA GPUs (PyTorch + CUDA)

Usage: python -m sequence_aligner_tpu_torch.cli -i <input.seq> [options]

Modes (default --calc-overlaps):
  --calc-overlaps --test-overlaps --test-alignment
  --test-dispatch-collisions --test-block-dispatch --test-kmer-cover
  --test-fasta-read --bench-fasta-read --bench-kmer-gen
  --bench-kmer-analysis --bench-align-quick --bench-align
  --pipeline (full AMOS assembly: bank->overlap->transact->tigger->
              consensus->fasta, like rake pipeline:project)

Alignment options:
  -m|--matrix|-H|--HOXD-matrix FILE   HOXD matrix file
  -k|--kmer-size N     (12)    --match N / --mismatch N   (95/-70)
  --min-overlap N      (40)    --min-identity F           (0.98)
  --min-collisions N   (7)     --max-collisions N         (222)
  --kmer-center F      (0.4)   --kmer-edge F              (0.4)
  -gO|--gap-open N     (-200)  -gE|--gap-extend N         (-20)
  --max-ignore N       (90)
  --amos-parity               collision band matching AMOS hash-overlap

Engine options:
  --st-hash/--mt-hash --st-align/--mt-align --block-align/--single-align
  --quadratic-align/--linear-align
  --engine device|oracle|sharded (--pipeline: also amos)
  --batch-size N (1048576)   --workdir DIR (/tmp/seqalign_pipe)
  --prescreen / --no-prescreen  diagonal-coherence candidate prescreen
                       (device engine; empirically lossless, off by default)
  --device cuda|cpu    (cuda)
  -i|--input FILE   -o|--output FILE (stdout if absent)
  --debug   --profile DIR   --sleep-for-debug
"""

MODES = {
    "--calc-overlaps", "--test-overlaps", "--test-alignment",
    "--test-dispatch-collisions", "--test-block-dispatch", "--test-kmer-cover",
    "--test-fasta-read", "--bench-fasta-read", "--bench-kmer-gen",
    "--bench-kmer-analysis", "--bench-align-quick", "--bench-align", "--pipeline",
}


class Options:
    def __init__(self):
        self.action = "calc-overlaps"
        self.input = ""
        self.output = ""
        self.hoxd = ""
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
        self.engine = "device"
        self.fast_dovetail = True
        self.batch_size = 1 << 20
        self.device = "cuda"
        self.prescreen = False
        self.debug = False
        self.profile_dir = ""
        self.workdir = "/tmp/seqalign_pipe"

    def settings(self) -> AlignSettings:
        if self.hoxd:
            cm = read_hoxd(self.hoxd)
        elif self.use_simple:
            cm = simple_match_matrix(self.match, self.mismatch)
        else:
            cm = AlignSettings().cost_matrix
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


def _engine(v: str) -> str:
    if v not in ("device", "oracle", "sharded", "amos"):
        raise ValueError(v)
    return v


# flag -> (attribute, parse); the sign conventions of the JAX CLI
_TAKES = {
    "-m": ("hoxd", str), "--matrix": ("hoxd", str),
    "-H": ("hoxd", str), "--HOXD-matrix": ("hoxd", str),
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
    "--engine": ("engine", _engine),
    "--profile": ("profile_dir", str),
    "--workdir": ("workdir", str),
    "--match": ("match", lambda v: abs(int(v))),
    "--mismatch": ("mismatch", lambda v: -abs(int(v))),
}

# flag -> (attribute, value)
_SWITCHES = {
    "--amos-parity": ("amos_parity", True),
    "--prescreen": ("prescreen", True), "--no-prescreen": ("prescreen", False),
    "--st-align": ("engine", "oracle"), "--mt-align": ("engine", "device"),
    "--quadratic-align": ("fast_dovetail", False), "--linear-align": ("fast_dovetail", True),
    "--debug": ("debug", True),
}


def parse_args(argv: list[str]) -> Options:
    o = Options()
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(HELP)
            sys.exit(0)
        elif a in _TAKES:
            if i + 1 >= len(argv):
                _fail(f"Missing value for {a}")
            attr, conv = _TAKES[a]
            try:
                setattr(o, attr, conv(argv[i + 1]))
            except ValueError:
                _fail(f"Invalid value for {a}: {argv[i + 1]}")
            if a in ("--match", "--mismatch"):
                o.use_simple = True
            i += 2
        elif a in _SWITCHES:
            setattr(o, *_SWITCHES[a])
            i += 1
        elif a in ("--st-hash", "--mt-hash"):
            i += 1  # hashing is always the device op; accepted for parity
        elif a == "--block-align":
            o.batch_size = max(o.batch_size, 4096)
            i += 1
        elif a == "--single-align":
            o.batch_size = 1
            i += 1
        elif a == "--sleep-for-debug":
            print("Sleeping so debugger can connect.")
            time.sleep(30)
            i += 1
        elif a in MODES:
            o.action = a[2:]
            i += 1
        else:
            _fail(f"Invalid argument : {a}")
    if o.input == "":
        _fail("No input file specified")
    if o.engine == "amos" and o.action != "pipeline":
        _fail("--engine amos (AMOS hash-overlap) runs only with --pipeline")
    return o


def _read(o: Options):
    from sequence_aligner_tpu_torch.io.fasta import read_fasta

    return read_fasta(o.input)


def _overlapper(o: Options, s: AlignSettings, **kw):
    from sequence_aligner_tpu_torch.models.overlapper import Overlapper

    kw.setdefault("fast_dovetail", o.fast_dovetail)
    kw.setdefault("batch_size", o.batch_size)
    return Overlapper(s, device=o.device, **kw)


def _alignments(o: Options, s: AlignSettings, filter_valid: bool):
    from sequence_aligner_tpu_torch.oracle.overlap import oracle_alignments

    return oracle_alignments(
        _read(o), s, fast_dovetail=o.fast_dovetail, filter_valid=filter_valid
    )


def _occurrences(ov, bases: np.ndarray, lengths: np.ndarray):
    import torch

    return ov._occurrences(torch.from_numpy(bases).to(ov.device), lengths)


def _calc_overlaps(o: Options, s: AlignSettings) -> int:
    from sequence_aligner_tpu_torch.io.ovl import write_ovl, write_ovl_arrays

    if o.engine == "device":
        # the JAX CLI's reader: read_fasta, then the reads as a list
        arrs = _overlapper(o, s, prescreen=o.prescreen).run_arrays(_read(o))
        return write_ovl_arrays(arrs, o.output or None)
    if o.engine == "sharded":
        from sequence_aligner_tpu_torch.parallel.shard import sharded_overlap

        return write_ovl(sharded_overlap(_read(o), s, device=o.device), o.output or None)
    from sequence_aligner_tpu_torch.oracle.overlap import oracle_overlaps

    recs = oracle_overlaps(o.input, s, fast_dovetail=o.fast_dovetail)
    return write_ovl(recs, o.output or None)


def _test_kmer_cover(o: Options) -> None:
    # k in 0..25 uniqueness/collision sweep (src/Project4.scala:299-320)
    from sequence_aligner_tpu_torch.oracle.kmers import KmerTableOracle

    seqs = _read(o)
    for k in range(0, 26):
        tab = KmerTableOracle()
        for q in seqs:
            tab.add_sequence(q, k)
        uniques = tab.unique_kmers()
        ratio = uniques / float(4**k)
        print(f"Kmer Size : {k}")
        print(f"  uniques : {uniques}")
        print(f"  ratio   : {ratio}")
        hist = tab.collision_histogram()
        body = "".join(f"          [{kk} -> {hist[kk]}]\n" for kk in sorted(hist))
        print("  [ number of collisions -> count of "
              f"seqs with that many collisions ] :\n{body}")


def _test_dispatch(o: Options, s: AlignSettings, act: str) -> None:
    from sequence_aligner_tpu_torch.oracle.kmers import KmerTableOracle

    tab = KmerTableOracle()
    for q in _read(o):
        tab.add_sequence(q, s.kmer_size)
    dispatch = tab.calc_dispatch(s)
    seen = set()
    i = 0
    hist: dict[int, int] = {}
    for lead in dispatch:
        trails = dispatch[lead]
        for b in trails:
            i += 1
            if (lead, b) in seen:
                print(f"!!!! Collission {lead}<->{b} Dispatched more than once. ")
            seen.add((lead, b))
            print(f" Dispatched Coll : {i} - {lead} <-> {b}")
        if act == "test-block-dispatch":
            hist[len(trails)] = hist.get(len(trails), 0) + 1
    if act == "test-block-dispatch":
        print("\n Histogram Of Relations : [Number of Aligns -> "
              "Number of Seqs w/ that many Aligns]")
        print("".join(f"          [{k} -> {hist[k]}]\n" for k in sorted(hist)))


def _test_alignment(o: Options, s: AlignSettings) -> None:
    # human-readable alignment dump (src/Project4.scala:425-440)
    for i, a in enumerate(_alignments(o, s, filter_valid=False), 1):
        print(f" Alignment {i} : {a.id_a} <-> {a.id_b}")
        print(f"   Overlap A : {a.align_a}")
        print(f"   Overlap B : {a.align_b}")
        print(f"   Start     : {a.start}")
        print(f"   End       : {a.end}")
        print(f"   Error Rat : {a.err_ratio}")
        print(f"   is Valid? : {a.valid(s)}")
        print()


def _test_overlaps(o: Options, s: AlignSettings) -> None:
    # ASCII overlap layout (src/Project4.scala:484-504)
    from sequence_aligner_tpu_torch.core.records import OverlapRecord

    seqs = {q.id: q for q in _read(o)}
    for i, a in enumerate(_alignments(o, s, filter_valid=False), 1):
        ovl = OverlapRecord.from_alignment(a)
        sa = seqs[a.id_a].seq if a.id_a in seqs else ""
        sb = seqs[a.id_b].seq if a.id_b in seqs else ""
        print(f" Overlap {i} : {a.id_a} <-> {a.id_b}")
        if ovl.ahg >= 0:
            print(f"   Seq A   : {sa}{'-' * max(ovl.bhg, 0)}")
            print(f"   Seq B   : {'-' * ovl.ahg}{sb}")
        else:
            print(f"   Seq A   : {'-' * -ovl.ahg}{sa}")
            print(f"   Seq B   : {sb}{'-' * max(-ovl.bhg, 0)}")
        print(f"   Ahg     : {ovl.ahg}")
        print(f"   Bhg     : {ovl.bhg}")
        print(f"   Start   : {a.start}")
        print(f"   End     : {a.end}")
        print(f"   Error   : {a.err_ratio}")
        print(f"   Valid?  : {a.valid(s) and ovl.hang_valid(s)}")


def _bench_kmer_gen(o: Options, s: AlignSettings) -> None:
    # host oracle against the device k-mer scan (src/Project4.scala:324-349)
    import torch

    from sequence_aligner_tpu_torch.device import resolve_device
    from sequence_aligner_tpu_torch.ops.kmer import kmer_scan
    from sequence_aligner_tpu_torch.oracle.kmers import KmerTableOracle

    dev = resolve_device(o.device)
    seqs = _read(o)
    t0 = time.time()
    tab = KmerTableOracle()
    for q in seqs:
        tab.add_sequence(q, s.kmer_size)
    ms = int((time.time() - t0) * 1000)
    print(f"\nGenerated {tab.unique_kmers()} unique kmers from "
          f"{tab.unique_seqs()} sequences from {o.input} on host in "
          f"{ms} milliseconds.\n")
    bases, lengths = encode_reads(seqs)
    args = (torch.from_numpy(bases).to(dev), torch.from_numpy(lengths).to(dev),
            torch.arange(1, len(seqs) + 1, dtype=torch.int32, device=dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    kmer_scan(*args, s.kmer_size)  # warm-up, as the JAX CLI's compile run
    sync()
    t0 = time.time()
    occ = kmer_scan(*args, s.kmer_size)
    sync()
    ms = int((time.time() - t0) * 1000)
    nk = int(occ["valid"].sum())
    print(f"Generated {nk} kmer occurrences from {len(seqs)} sequences "
          f"from {o.input} on device in {ms} milliseconds.\n")


def _bench_kmer_analysis(o: Options, s: AlignSettings) -> None:
    # pair/dispatch timing (src/Project4.scala:353-373)
    seqs = _read(o)
    ov = _overlapper(o, s)
    bases, lengths = encode_reads(seqs)
    occ = _occurrences(ov, bases, lengths)
    t0 = time.time()
    lead, trail = ov._candidates(occ, bases, lengths)
    ms = int((time.time() - t0) * 1000)
    print(f"\nCalculated pair + dispatch data ({len(lead)} candidate "
          f"pairs) in {ms} milliseconds.\n")


def _bench_align(o: Options, s: AlignSettings, act: str) -> None:
    # the 8-configuration strategy matrix of the reference's {quad, linear}
    # x {ST, MT} x {single, block} sweep (src/Project4.scala:469-481): ST is
    # the host oracle engine, MT the device engine; single is batches of 256
    # pairs, block full batches (the oracle aligns one pair at a time either
    # way).  Quick mode samples the first 500 candidate pairs (the intent of
    # the reference's debugStop = 500, src/Project4.scala:462-465).
    from sequence_aligner_tpu_torch.oracle.overlap import oracle_alignments, oracle_overlaps

    seqs = _read(o)
    sample = 500 if act == "bench-align-quick" else None
    configs = []
    for fd, algo in ((False, "quadratic"), (True, "linear")):
        for engine in ("oracle", "device"):
            thr = "ST" if engine == "oracle" else "MT"
            for block in (False, True):
                style = "block" if block else "single"
                configs.append((f"{algo} {thr} {style}", fd, engine, block))
    for name, fd, engine, block in configs:
        try:
            t0 = time.time()
            if engine == "device":
                ov = _overlapper(o, s, fast_dovetail=fd,
                                 batch_size=o.batch_size if block else 256)
                if sample is None:
                    n = len(ov.run(seqs))
                else:
                    bases, lengths = encode_reads(seqs)
                    occ = _occurrences(ov, bases, lengths)
                    lead, trail = ov._candidates(occ, bases, lengths)
                    res = ov._align(bases, lengths, lead[:sample], trail[:sample])
                    n = int(res["valid"].sum())
            elif sample is None:
                n = len(oracle_overlaps(seqs, s, fast_dovetail=fd))
            else:
                n = sum(r.valid(s) for r in oracle_alignments(
                    seqs, s, fast_dovetail=fd, filter_valid=False, max_pairs=sample))
            ms = int((time.time() - t0) * 1000)
            print(f"\nCalculated {n} {name} alignments in {ms} milliseconds.\n")
        except Exception as e:  # bench modes trap and continue, as the JAX CLI
            print(f"\n{name.capitalize()} Alignment Benchmark Failed:\n")
            print(e)


def main(argv: list[str] | None = None) -> int:
    o = parse_args(sys.argv[1:] if argv is None else argv)
    s = o.settings()
    act = o.action
    from sequence_aligner_tpu_torch.utils.debug import set_debug

    set_debug(o.debug)
    if act == "calc-overlaps":
        from sequence_aligner_tpu_torch.utils.profiling import trace_profile

        with trace_profile(o.profile_dir or None):
            n = _calc_overlaps(o, s)
        if o.debug:
            print(f"# wrote {n} overlaps", file=sys.stderr)
    elif act == "pipeline":
        from sequence_aligner_tpu_torch.pipeline.driver import run_amos_pipeline

        res = run_amos_pipeline(o.input, s, o.workdir, overlapper=o.engine, device=o.device)
        print("============ Time Taken =============")
        for k, v in res.timings.items():
            print(f"  {k:<10}: {v:8.3f}s")
        print(f"contigs: {res.n_contigs} lengths: {[len(c.seq) for c in res.contigs]}")
    elif act == "test-fasta-read":
        # the first 10 reads (src/Project4.scala:272-285)
        print()
        for q in _read(o)[:10]:
            print(f"id : {q.id}")
            print(f"seq: {q.seq}")
            print()
    elif act == "bench-fasta-read":
        t0 = time.time()
        n = len(_read(o))
        ms = int((time.time() - t0) * 1000)
        print(f" Read {n} sequences from {o.input} in {ms} milliseconds.")
    elif act == "test-kmer-cover":
        _test_kmer_cover(o)
    elif act in ("test-dispatch-collisions", "test-block-dispatch"):
        _test_dispatch(o, s, act)
    elif act == "test-alignment":
        _test_alignment(o, s)
    elif act == "test-overlaps":
        _test_overlaps(o, s)
    elif act == "bench-kmer-gen":
        _bench_kmer_gen(o, s)
    elif act == "bench-kmer-analysis":
        _bench_kmer_analysis(o, s)
    elif act in ("bench-align", "bench-align-quick"):
        _bench_align(o, s, act)
    return 0


if __name__ == "__main__":
    sys.exit(main())
