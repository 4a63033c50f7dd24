#!/usr/bin/env python3
"""On-card smoke of the PyTorch / CUDA port (``sequence_aligner_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``sequence_aligner_tpu_torch/csrc`` with
nvcc, then, each phase fatal on failure:

  1. prints the card (nvidia-smi name and power limit), the ptxas
     register / spill lines of the build and, as one JSON line, the
     registers and spill bytes of every kernel instance;
  2. drives the main path — ``Overlapper.run_arrays`` (calc-overlaps) on
     32,000 simulated 100 bp reads at coverage 20 — with every kernel launch
     counter set to 0 just before and read just after.  Its 352,032 pairs
     (one band-width group, at most 2^21 pairs) take the both-phase
     ("mono") route: K1 and K2 must each launch exactly once.  Prints the
     route, reads, candidate pairs, valid records, the stats and DP cells,
     the stage times, reads/s and peak device memory.  Then the same reads
     on the split route (``SEQALIGN_ALIGN_MONO=0``, its own counts: both
     kernels must launch) must give the same records; one more run of each
     route, in turns, and both routes' walls and align stages are printed;
  3. holds each kernel against its plain PyTorch version on the card: the
     first 65,536 real pairs of the mono route's launches (captured from
     the engine's ``phase1_indexed`` / ``phase2_indexed`` calls; phase 2's
     include the phase-1 duds) and of the split route's largest launches,
     random pairs, and mixed-length batches at band widths 12, 16, 20, 31,
     40, 60 and 70 (the exact register instances, the four capacity
     instances and the scratch instance), and scores past 16 bits (the
     scratch instance); outputs must be equal (integers, tolerance 0), and
     ulen = L must equal ulen = 0.  Then times each kernel with CUDA events
     on the mono route's launches and the split route's largest ones, and
     the capacity and general instances on the mixed batch, beside their
     plain versions and bounds;
  3b. reads of 32,768 bp or more: the engine on two 33,000 bp reads offset
     by 10,000 must give the JAX engine's (1, 2, 10000, 10000); both
     kernels' wide instances on two 34,000 bp reads (33,500 rows of phase
     2, counts past 2^15) equal their plain versions, then are timed;
  4. runs the engine on 2,048 reads (100 bp, and mixed lengths with 1%
     errors) on the card and on the CPU: the canonical arrays must be equal
     (the CPU side is the path the CPU tests hold against the JAX package);
  5. writes a 2,048-read FASTA to a temporary directory, runs
     ``python -m sequence_aligner_tpu_torch.cli`` on it and checks that the
     OVL file equals phase 4's records; then the CLI on the card and with
     ``--device cpu`` (all runs at once, one process each) with ``-H`` (a
     pair-format HOXD file written here), ``--quadratic-align``,
     ``--single-align``, ``--engine oracle`` (on 30 reads),
     ``--bench-align-quick``, ``--debug`` and ``--profile``: the OVL files
     must be byte-equal, the bench lines equal but for their milliseconds,
     and on the card ``--profile`` must write a trace and ``--debug`` print
     the card's memory;
  5c. the AMOS pipeline driver: ``run_amos_pipeline(..., overlapper="device")``
     on phase 4's 2,048 reads on the card, against stand-in AMOS
     executables written to a temporary directory
     (``pipeline.standins``), with the launch counters set to 0 just before
     and read just after (both kernels must launch); the OVL file the
     stand-in ``bank-transact`` receives must equal phase 4's records
     written by ``write_ovl``, and the stages must run in the driver's
     order;
  6. the large-input path at full size: 1,000,000 simulated 100 bp reads at
     coverage 8 (k = 16, amos_parity settings) written as FASTA to a
     temporary directory.  The native reader's (bases, lengths) of the file
     must equal the Python reader's (``read_fasta`` + ``encode_reads``);
     then the file is run by ``Overlapper.run_arrays`` and by
     ``run_stream_arrays`` (both read it with the native reader), each with
     the launch counters set to 0 just before and read just after (both
     kernels must launch); the two record sets must be equal and hold the
     JAX engine's record and candidate counts.  Each kernel is held against its plain version on the first
     65,536 pairs of its largest launch in the ``run_arrays`` run (w = 16,
     the exact 16-column instances), then timed there.  Prints reads, candidate
     pairs, records, the raw stream totals, stage times, reads/s and peak
     device memory;
  6b. the sharded engine on the same reads: ``parallel.shard.sharded_overlap``
     at a world size of 1 over NCCL (the k-mer exchange, the read fetch and
     the final gather are NCCL collectives on the card), with the launch
     counters set to 0 just before and read just after (both kernels must
     launch); its records must equal phase 6's.  Each kernel is held against
     its plain version on the first 65,536 pairs of its largest launch there,
     then timed.  Then ``python -m sequence_aligner_tpu_torch.cli --engine
     sharded`` and ``python -m sequence_aligner_tpu_torch.dist.worker
     --nprocs 1`` on the FASTA, at once: both OVL files must equal phase 6's
     records written by ``write_ovl_arrays``.  Prints one ``{"sharded": ...}``
     JSON line (wall, stage split, records, launches, peak device memory, the
     card);
  7. the prescreen on the card: phase 2's reads through the screened and
     the unscreened engine, then each on 2,048 reads with planted repeats
     on the card and on the CPU (equal arrays; the screen must drop
     candidates there);
  8. the probes (csrc/probes.cu): every pack-probe and dtype-probe variant
     against its plain version on the card (equal, tolerance 0) where the
     probes' own inputs never go (SWAR with guard-set and guard-clear columns
     in one warp, any 32-bit words, dtype values at the types' limits, int16
     and int8 at an odd P and on a view one element into its storage), then
     on the probes' inputs, timed at the TPU probes' P = 1024 and at P =
     2^20, with SWAR / native and int32 / int16;
  9. the quadratic path (``Overlapper(fast_dovetail=False)``, torch ops, no
     kernel of its own): 2,048 reads (100 bp, 1% errors) on the card and on
     the CPU must give equal arrays; then the main path's 32,000 reads on the
     card, printing candidate pairs, records beside the banded path's, the
     stage times, the chunks and their size, peak device memory and the
     align stage beside its bound, and one ``{"quadratic": ...}`` JSON line.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
without a card or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BUDGET_S = 1100  # a hang ends with a traceback and a non-zero exit
N_READS, READ_LEN, COVERAGE = 32000, 100, 20.0
N_CHECK = 65536
# the large-input path: BASELINE config 4's dataset on one card (the JAX
# engine's ARTIFACT_1M_r5.json records 3,999,987 records and 4,104,565
# candidate pairs for it)
N_LARGE, K_LARGE, COVERAGE_LARGE = 1_000_000, 16, 8.0
RECORDS_JAX_1M, CANDIDATES_JAX_1M = 3_999_987, 4_104_565
# int32 operations per band cell: the fewest the DP needs by either of two
# counts, with Hopper's fused 3-input max and add-max (VIMNMX3, VIADDMNMX)
# as one operation each and no register moves, control flow, loads or loop
# counters.  By hand from the cell of csrc/dovetail.cu: phase 1 21 (score 1,
# M 1, X chain 3, max 1, Y chain 3, D 1, stop select 4, position 1, live
# select 2, running best 4), phase 2 37.  The straightforward kernel's usual
# path (in band, M branch, no new best): 28 and 34.  Both counts stay at or
# below the compiled row loops' own (python -m
# sequence_aligner_tpu_torch.sass_mix: 22.5 and 38.0 non-move, non-control
# instructions a cell at w = 16), so no bound counts more than the DP needs
OPS_PER_CELL = {"phase1": 21, "phase2": 34}
# int32 operations per cell of the quadratic path's full Smith-Waterman
# (ops/align_lax.py), counted the same way from its row step: score index
# 1, M 3 (3-input max, clamp, add), Y 5 (two adds, clamp, 3-input max, add),
# X input 3 (max, add, clamp), X chain 3 (subtract, running max, add),
# traceback code 7 (3-input max, two compares, two selects, a compare and
# an or), running best 5 (mask, row max, compare, first-index select, min)
QUAD_OPS_PER_CELL = 27
# a HOXD matrix in the pair format (lines "A,C=-96"; absent mirrored pairs
# are filled by the reader) for the CLI's -H run
HOXD_PAIRS = ("HOXD pairs\nA,A=67\nC,C=100\nG,G=100\nT,T=67\nA,C=-96\nA,G=-31\n"
              "A,T=-117\nC,G=-125\nC,T=-31\nG,T=-96\n")
# one width for each instance off the main paths: capacity24 .. capacity64
# (w = 20, 31, 40, 60; the same instance in both phases) and general (70)
OFF_PATH_WIDTHS = (20, 31, 40, 60, 70)
ROOT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


class Stage:
    """Wall time of one phase, printed when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        self.s = time.perf_counter() - self.t0
        log(f"== {self.name}: {self.s:.2f} s")
        return False


def nvidia_smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    """Every kernel's launch count."""
    from sequence_aligner_tpu_torch.ops import align_fused as af
    from sequence_aligner_tpu_torch.probes import dtype_probe as dp
    from sequence_aligner_tpu_torch.probes import pack_probe as pp

    counts = {"phase1": af.phase1_launches, "phase2": af.phase2_launches}
    counts.update({f"pack_probe_{v}": n for v, n in pp.launches.items()})
    counts.update({f"dtype_probe_{v}": n for v, n in dp.launches.items()})
    return counts


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from sequence_aligner_tpu_torch.ops import align_fused as af
    from sequence_aligner_tpu_torch.probes import dtype_probe as dp
    from sequence_aligner_tpu_torch.probes import pack_probe as pp

    af.phase1_launches = af.phase2_launches = 0
    af.instance_launches.clear()
    for counts in (pp.launches, dp.launches):
        for v in counts:
            counts[v] = 0


def check_records(arrs, n_reads: int, s) -> None:
    """Canonical, valid OVL records of int32 arrays; raises otherwise."""
    import numpy as np

    lead, trail, ahg, bhg = arrs
    if not (len(lead) > 0 and all(len(a) == len(lead) and a.dtype == np.int32
                                  for a in arrs)):
        raise AssertionError("records have the wrong shape")
    key = lead.astype(np.int64) << 32 | trail
    if not ((np.diff(key) > 0).all() and lead.min() >= 1 and trail.max() <= n_reads
            and (lead != trail).all() and np.abs(ahg).max() < s.max_ignore
            and np.abs(bhg).max() < s.max_ignore):
        raise AssertionError("records are not canonical valid OVL records")


@contextlib.contextmanager
def largest_launches():
    """Route the engine's ``phase1_indexed`` / ``phase2_indexed`` calls
    through a wrapper that keeps the arguments of each phase's largest
    launch; yields {name: (args, kwargs, pairs)}.  The wrapper adds no
    launch."""
    from sequence_aligner_tpu_torch.models import overlapper as ovmod
    from sequence_aligner_tpu_torch.ops import align_fused as af

    captured = {}

    def capture(name, real):
        def wrapped(*args, **kw):
            p = args[1].shape[0]  # a_idx
            if p > captured.get(name, ((), {}, -1))[2]:
                captured[name] = (args, dict(kw), p)
            return real(*args, **kw)
        return wrapped

    ovmod.phase1_indexed = capture("phase1", af.phase1_indexed)
    ovmod.phase2_indexed = capture("phase2", af.phase2_indexed)
    try:
        yield captured
    finally:
        ovmod.phase1_indexed, ovmod.phase2_indexed = af.phase1_indexed, af.phase2_indexed


@contextlib.contextmanager
def split_route():
    """The engine's split align route for the calls inside
    (``SEQALIGN_ALIGN_MONO=0``, as the JAX engine reads it)."""
    old = os.environ.get("SEQALIGN_ALIGN_MONO")
    os.environ["SEQALIGN_ALIGN_MONO"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["SEQALIGN_ALIGN_MONO"]
        else:
            os.environ["SEQALIGN_ALIGN_MONO"] = old


def timed_run(dev, s, reads, launches=False):
    """A warm engine's ``run_arrays`` on the card: (engine, arrays, wall s,
    the launch counts of the run when ``launches``, else None)."""
    import torch

    from sequence_aligner_tpu_torch.models.overlapper import Overlapper

    ov = Overlapper(s, device=dev)
    torch.cuda.synchronize(dev)
    if launches:
        reset_counts()
    t0 = time.perf_counter()
    arrs = ov.run_arrays(reads)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return ov, arrs, wall, launch_counts() if launches else None


def pair_slice(args, n):
    """A launch's arguments cut to its first ``n`` pairs: the read table and
    the lengths stay whole, the per-pair vectors are cut."""
    return (args[0], *(t[:n].contiguous() for t in args[1:-1]), args[-1])


def plain_kw(kw: dict) -> dict:
    """A wrapper's keywords without the one its plain version lacks."""
    return {k: v for k, v in kw.items() if k != "indices_checked"}


def check_real_pairs(name, args, kw, p, what) -> int:
    """The kernel against its plain version on the first ``N_CHECK`` pairs of
    a captured launch, with the launch's own arguments; returns the largest
    |difference| (0), raises otherwise."""
    import torch

    from sequence_aligner_tpu_torch.ops import align_fused as af

    n = min(N_CHECK, p)
    sub = pair_slice(args, n)
    got = getattr(af, name + "_indexed")(*sub, **kw)
    torch.cuda.synchronize()
    want = getattr(af, name + "_indexed_plain")(*sub, **plain_kw(kw))
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    if err:
        raise AssertionError(f"{name} differs from its plain version on {what}: "
                             f"max |diff| {err}")
    log(f"  equal: {name} on the first {n} pairs of {what} (w={kw['w']}, rows "
        f"{kw['la_max']}, ulen={kw.get('ulen', 0)})")
    return err


def kernel_entry(name, args, kw, p, *, launches, max_err, sms, sm_mhz, tag="",
                 plain_ms=None) -> dict:
    """Times a launch with CUDA events beside its plain version and its
    bound; returns its entry of the kernels line.  ``plain_ms``: the plain
    version's time, where the caller measured it."""
    from sequence_aligner_tpu_torch.measure import bound_ms, event_ms
    from sequence_aligner_tpu_torch.ops import align_fused as af

    # the wrapper as the engine calls it: indices checked once by the caller
    kern = getattr(af, name + "_indexed")
    plain = getattr(af, name + "_indexed_plain")
    kw = plain_kw(kw)
    ms = event_ms(lambda: kern(*args, indices_checked=True, **kw), reps=10, warm=2)
    if plain_ms is None:
        plain_ms = event_ms(lambda: plain(*args, **kw), reps=1, warm=1)
    w = kw["w"]
    packed, lengths = args[0], args[-1]
    wpr = packed.shape[1]
    if name == "phase1":
        _, a_idx, b_idx, _ = args
        rows = lengths[a_idx.long()].clamp(max=kw["la_max"]).long().sum().item()
        cells = rows * w  # band columns 1..w
        # A's row, B's first w codes, two indices and a length in; 5 words out
        nbytes = 4 * p * (wpr + (w + 15) // 16 + 3 + 5)
    else:
        _, a_idx, b_idx, ds, dl, _ = args
        rows = dl.clamp(min=0, max=kw["la_max"]).long().sum().item()
        cells = rows * (w + 1)  # band columns 0..w
        # A's and B's rows, two indices, ds, dlen and a length in; 7 words out
        nbytes = 4 * p * (2 * wpr + 5 + 7)
    bound, by = bound_ms(cells * OPS_PER_CELL[name], nbytes, sms, sm_mhz)
    inst = af.instance(1 if name == "phase1" else 2, w=w, rows=kw["la_max"],
                       cm_tuple=kw["cm_tuple"])
    log(f"  {name}{tag} ({inst} instance): P={p} w={w} rows={kw['la_max']} cells={cells} "
        f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.4f} ms "
        f"({by}; {OPS_PER_CELL[name]} int32 ops/cell, {nbytes} bytes), "
        f"{cells / ms / 1e6:.2f} G cells/s")
    return dict(
        name=f"{name}_kernel{tag}", route="cuda",
        source="sequence_aligner_tpu_torch/csrc/dovetail.cu",
        replaces=("sequence_aligner_tpu/ops/align_fused.py:463" if name == "phase1"
                  else "sequence_aligner_tpu/ops/align_fused.py:821"),
        launches=launches, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by,
        library_ms=None,  # no single PyTorch call computes this DP
    )


def large_input_phase(path: str, n_reads: int, s, sms: int, sm_mhz: float):
    """Phase 6: ``run_arrays`` and ``run_stream_arrays`` on the FASTA at
    ``path``; both kernels must launch in each run, the records must be
    equal and match the JAX engine's counts, and each kernel's largest
    launch in the ``run_arrays`` run must equal its plain version.  Returns
    the kernels' entries of the kernels line for this path and the
    records."""
    import numpy as np
    import torch

    from sequence_aligner_tpu_torch.models.overlapper import Overlapper
    from sequence_aligner_tpu_torch.ops import align_fused as af

    from sequence_aligner_tpu_torch.io.fasta import read_fasta
    from sequence_aligner_tpu_torch.native import fasta_encode_native
    from sequence_aligner_tpu_torch.ops.encode import encode_reads

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    nat = fasta_encode_native(path)
    t1 = time.perf_counter()
    py = encode_reads(read_fasta(path))
    t2 = time.perf_counter()
    if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(nat, py)):
        raise AssertionError("the native reader's (bases, lengths) differ from the Python "
                             "reader's on the 1M FASTA")
    log(f"  equal: native reader and read_fasta + encode_reads on the 1M FASTA, bases "
        f"{nat[0].shape}; native {t1 - t0:.3f} s, Python {t2 - t1:.3f} s (host)")
    del nat, py
    res = {}
    for name in ("run_arrays", "run_stream_arrays"):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ov = Overlapper(s, device=dev)
        with largest_launches() as captured:
            reset_counts()
            t0 = time.perf_counter()
            arrs = getattr(ov, name)(path)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in launch_counts().items() if v}
            by_instance = dict(af.instance_launches)
        peak = torch.cuda.max_memory_allocated(dev) / 2**20
        st = ov.stats
        log(f"  {name}: reads {st.n_reads}  k-mers {st.n_kmers}  h_tot {st.h_tot}  "
            f"t_tot {st.t_tot}  candidate pairs {st.n_candidate_pairs}  phase-2 pairs "
            f"{st.n_phase2_pairs}  records {st.n_valid}  dp_cells {st.dp_cells}")
        log(f"  {name}: stage times (s) "
            + json.dumps({k: round(v, 4) for k, v in ov.stage_s.items()}))
        log(f"  {name}: wall {wall:.3f} s -> {st.n_reads / wall:.1f} reads/s; encode "
            f"(native reader) {ov.stage_s['encode']:.4f} s; peak device memory {peak:.1f} MiB; "
            f"launches {launches}; by instance {by_instance}")
        if min(launches.get("phase1", 0), launches.get("phase2", 0)) < 1:
            raise AssertionError(f"{name}: a kernel of the path never launched: {launches}")
        check_records(arrs, n_reads, s)
        if (len(arrs[0]), st.n_candidate_pairs) != (RECORDS_JAX_1M, CANDIDATES_JAX_1M):
            raise AssertionError(
                f"{name}: {len(arrs[0])} records and {st.n_candidate_pairs} candidate "
                f"pairs; the JAX engine's ARTIFACT_1M_r5.json has {RECORDS_JAX_1M} and "
                f"{CANDIDATES_JAX_1M}")
        res[name] = dict(arrs=arrs, launches=launches, captured=captured)
    a, b = res["run_arrays"]["arrs"], res["run_stream_arrays"]["arrs"]
    if not all(np.array_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("run_stream_arrays and run_arrays give different records")
    log(f"  equal: run_arrays and run_stream_arrays, {len(a[0])} records, as the JAX "
        f"engine's ARTIFACT_1M_r5.json ({RECORDS_JAX_1M} records, {CANDIDATES_JAX_1M} "
        f"candidate pairs)")
    entries = []
    for name in ("phase1", "phase2"):
        args, kw, p = res["run_arrays"]["captured"][name]
        err = check_real_pairs(name, args, kw, p, "the 1M run's largest launch")
        entries.append(kernel_entry(name, args, kw, p, launches=res["run_arrays"]["launches"][name],
                                    max_err=err, sms=sms, sm_mhz=sm_mhz, tag="_1m"))
    return entries, a


def sharded_phase(dev, path: str, reads, want, s, card: str, sms: int,
                  sm_mhz: float) -> list[dict]:
    """Phase 6b: ``sharded_overlap`` on ``reads`` (the FASTA at ``path``) at a
    world size of 1 over NCCL; both kernels must launch, the records must
    equal ``want`` (phase 6's), each kernel's largest launch must equal its
    plain version.  Then the CLI's ``--engine sharded`` and the worker on the
    file, at once, must write ``want``'s bytes.  Returns the kernels'
    entries of the kernels line for this path."""
    import numpy as np
    import torch

    from sequence_aligner_tpu_torch.io.ovl import write_ovl_arrays
    from sequence_aligner_tpu_torch.ops import align_fused as af
    from sequence_aligner_tpu_torch.ops.encode import encode_reads
    from sequence_aligner_tpu_torch.parallel.shard import sharded_overlap

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stats = {}
    with largest_launches() as captured:
        reset_counts()
        t0 = time.perf_counter()
        recs = sharded_overlap(reads, s, device=dev, stats=stats)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in launch_counts().items() if v}
        by_instance = dict(af.instance_launches)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"  sharded_overlap: world {stats['world']} over {stats['backend']}, records "
        f"{len(recs)}, kept pairs by rank {stats['pairs_by_rank']}, wall {wall:.3f} s -> "
        f"{len(reads) / wall:.1f} reads/s; peak device memory {peak:.1f} MiB; launches "
        f"{launches}; by instance {by_instance}")
    # the host parts the stages do not split out: the reads' encode (inside
    # `plan`), then the group's set-up and the records (outside the stages)
    t0 = time.perf_counter()
    encode_reads(reads)
    encode_s = time.perf_counter() - t0
    other_s = wall - sum(stats["stage_s"].values())
    log("  sharded_overlap stage times (s): " + json.dumps(stats["stage_s"])
        + f"; encode_reads alone {encode_s:.3f} s (host, part of plan); outside the "
        f"stages (group set-up, {len(recs)} OverlapRecords) {other_s:.3f} s")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if (stats["backend"], stats["world"]) != (backend, 1):
        raise AssertionError(f"the sharded engine ran over {stats['backend']} at world "
                             f"{stats['world']}, not {backend} at 1")
    if min(launches.get("phase1", 0), launches.get("phase2", 0)) < 1:
        raise AssertionError(f"sharded_overlap: a kernel of the path never launched: {launches}")
    got = tuple(np.fromiter((getattr(r, f) for r in recs), np.int32, len(recs))
                for f in ("id_a", "id_b", "ahg", "bhg"))
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("sharded_overlap's records differ from the single-device engine's")
    log(f"  equal: sharded_overlap and run_arrays, {len(recs)} records")
    entries = []
    for name in ("phase1", "phase2"):
        args, kw, p = captured[name]
        err = check_real_pairs(name, args, kw, p, "the sharded 1M run's largest launch")
        entries.append(kernel_entry(name, args, kw, p, launches=launches[name], max_err=err,
                                    sms=sms, sm_mhz=sm_mhz, tag="_sharded"))
    tmp = os.path.dirname(path)
    want_ovl, cli_ovl, worker_ovl = (os.path.join(tmp, f) for f in
                                     ("want.ovl", "cli_sharded.ovl", "worker.ovl"))
    write_ovl_arrays(want, want_ovl)
    with socket.socket() as sk:  # a free port for the worker's rendezvous
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    k = str(s.kmer_size)
    cmds = {
        "cli": ["sequence_aligner_tpu_torch.cli", "-i", path, "-o", cli_ovl, "--engine",
                "sharded", "--amos-parity", "-k", k, "--device", dev.type],
        "worker": ["sequence_aligner_tpu_torch.dist.worker", "--coordinator",
                   f"127.0.0.1:{port}", "--nprocs", "1", "--pid", "0", "-i", path, "-o",
                   worker_ovl, "--amos-parity", "--kmer-size", k, "--device", dev.type],
    }
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen([sys.executable, "-m", *c], cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for n, c in cmds.items()}
    out = {}
    try:
        for n, pr in procs.items():
            out[n] = pr.communicate(timeout=300)
            if pr.returncode != 0:
                raise AssertionError(f"{n} exited {pr.returncode}: {out[n][1][-2000:]}")
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    procs_s = time.perf_counter() - t0
    ref = Path(want_ovl).read_bytes()
    for n, f in (("cli", cli_ovl), ("worker", worker_ovl)):
        if Path(f).read_bytes() != ref:
            raise AssertionError(f"the {n}'s OVL differs from the single-device engine's")
    log(f"  equal: CLI --engine sharded and dist.worker --nprocs 1 OVL files and the "
        f"single-device records ({len(ref)} bytes); both processes {procs_s:.1f} s; worker: "
        + out["worker"][1].strip().splitlines()[-1])
    log(json.dumps({"sharded": dict(
        reads=len(reads), world=stats["world"], backend=stats["backend"], wall_s=wall,
        stage_s=stats["stage_s"], encode_reads_s=encode_s, outside_stages_s=other_s,
        records=len(recs), pairs_by_rank=stats["pairs_by_rank"],
        launches={n: launches[n] for n in ("phase1", "phase2")}, peak_mib=peak,
        cli_and_worker_s=procs_s, card=card)}))
    return entries


def long_pair(total: int, length: int, offset: int):
    """Two reads of ``length`` bp from one random genome of ``total`` bp, the
    second starting ``offset`` bp into the first."""
    import numpy as np

    from sequence_aligner_tpu_torch.core.records import Sequence

    g = "".join("ACTG"[i] for i in np.random.RandomState(0).randint(0, 4, total))
    return [Sequence(1, g[:length]), Sequence(2, g[offset : offset + length])]


def wide_rows_phase(dev, sms: int, sm_mhz: float) -> list[dict]:
    """Phase 3b: reads of 32,768 bp or more.  The engine on two 33,000 bp
    reads offset by 10,000 must give the JAX engine's record; then both
    kernels' wide instances on two 34,000 bp reads offset by 500 (phase 2's
    dove is 33,500 rows) against their plain versions, run on CPU copies of
    the same inputs.  Returns the wide instances' entries of the kernels
    line."""
    import numpy as np
    import torch

    from sequence_aligner_tpu_torch.core.settings import AlignSettings
    from sequence_aligner_tpu_torch.models.overlapper import Overlapper
    from sequence_aligner_tpu_torch.ops import align_fused as af
    from sequence_aligner_tpu_torch.ops.encode import encode_reads

    s = AlignSettings(min_identity=0.9996, max_ignore=100000, max_collisions=10**8)
    got = [a.tolist() for a in Overlapper(s, device=dev).run_arrays(
        long_pair(43000, 33000, 10000))]
    if got != [[1], [2], [10000], [10000]]:
        raise AssertionError(f"two 33,000 bp reads give {got}, the JAX engine "
                             f"(1, 2, 10000, 10000)")
    log("  engine: two 33,000 bp reads offset by 10,000 -> (1, 2, 10000, 10000), as "
        "the JAX engine")
    bases, lengths = encode_reads(long_pair(34500, 34000, 500))
    packed = af.pack_reads_le(torch.from_numpy(bases).to(dev))
    ln = torch.from_numpy(lengths).to(dev)
    ia = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    ib = (1 - ia).contiguous()
    w = s.band_width(34000)
    common = dict(w=w, gO=s.gap_open, gE=s.gap_extend, cm_tuple=s.cm_tuple())
    entries = []
    ops = (packed, ia, ib, ln)
    for name in ("phase1", "phase2"):
        if name == "phase1":
            kw = dict(common, la_max=34000)
        else:  # from phase 1's dove anchors (its plain outputs, equal to the kernel's)
            ds = torch.where(want[0] > 0, want[3], want[1]).to(dev)
            dl = (ln[ia.long()] - ds).contiguous()
            ops = (packed, ia, ib, ds, dl, ln)
            kw = dict(common, la_max=int(dl.max()), zero_row=w // 2)
        inst = af.instance(1 if name == "phase1" else 2, w=w, rows=kw["la_max"],
                           cm_tuple=s.cm_tuple())
        if inst != "wide":
            raise AssertionError(f"{name} at {kw['la_max']} rows took the {inst} instance")
        got = getattr(af, name + "_indexed")(*ops, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = getattr(af, name + "_indexed_plain")(*(t.cpu() for t in ops), **kw)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(int((g.cpu().long() - h.long()).abs().max()) for g, h in zip(got, want))
        if err:
            raise AssertionError(f"{name}'s wide instance differs from its plain version: "
                                 f"max |diff| {err}")
        log(f"  equal: {name}, wide instance, {kw['la_max']} rows, w={w}: "
            + ", ".join(str(t.tolist()) for t in got))
        entries.append(kernel_entry(name, ops, kw, 2, launches=0, max_err=err, sms=sms,
                                    sm_mhz=sm_mhz, tag="_wide", plain_ms=plain_ms))
    if not int(np.asarray(got[5].cpu()).max()) > 1 << 15:
        raise AssertionError("phase 2's counts did not pass 2^15 on the wide pair")
    return entries


def cli_phase(fasta: str, tmp: str) -> None:
    """Phase 5b: the CLI on the card and with ``--device cpu`` for each flag
    set, every run a process of its own and all started at once; OVL files
    must be byte-equal, bench lines equal but for their milliseconds."""
    import re

    from sequence_aligner_tpu_torch.pipeline.datasets import simulated_reads, write_seq

    hoxd = os.path.join(tmp, "hoxd_pairs.txt")
    Path(hoxd).write_text(HOXD_PAIRS)
    fasta30 = os.path.join(tmp, "r30.fasta")
    write_seq(simulated_reads(30, READ_LEN, coverage=6.0, error_rate=0.01, seed=4), fasta30)
    runs = {"hoxd": [fasta, "-H", hoxd], "quadratic": [fasta, "--quadratic-align"],
            "single": [fasta, "--single-align"], "oracle": [fasta30, "--engine", "oracle"],
            "bench": [fasta, "--bench-align-quick"], "debug": [fasta, "--debug"],
            "profile": [fasta, "--profile", os.path.join(tmp, "prof_{dev}")]}
    procs = {}
    for name, (inp, *flags) in runs.items():
        for dev in ("cuda", "cpu"):
            out = [] if name == "bench" else ["-o", os.path.join(tmp, f"{name}_{dev}.ovl")]
            procs[name, dev] = subprocess.Popen(
                [sys.executable, "-m", "sequence_aligner_tpu_torch.cli", "-i", inp,
                 *(f.format(dev=dev) for f in flags), *out, "--device", dev], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    res = {}
    try:
        for key, pr in procs.items():
            res[key] = pr.communicate(timeout=600)
            if pr.returncode != 0:
                raise AssertionError(f"CLI {runs[key[0]][1:]} on {key[1]} exited "
                                     f"{pr.returncode}: {res[key][1][-2000:]}")
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for name in runs:
        if name == "bench":
            card, cpu = (re.sub(r"\d+ milliseconds", "N milliseconds", res[name, d][0])
                         for d in ("cuda", "cpu"))
            lines = [ln for ln in card.splitlines() if ln]
            if card != cpu or len([ln for ln in lines if ln.startswith("Calculated ")]) != 8:
                raise AssertionError(f"--bench-align-quick differs on the card:\n{card}\n{cpu}")
            log("  equal: --bench-align-quick on the card and the CPU, " + "; ".join(
                ln.split(" in ")[0] for ln in res[name, "cuda"][0].splitlines() if ln))
            continue
        a, b = (Path(tmp, f"{name}_{d}.ovl").read_bytes() for d in ("cuda", "cpu"))
        if not (a and a == b):
            raise AssertionError(f"CLI {runs[name][1:]}: the card's OVL differs from the CPU's")
        log(f"  equal: CLI {' '.join(runs[name][1:])} on the card and the CPU "
            f"({a.count(b'{OVL')} records)")
    trace = Path(tmp, "prof_cuda", "trace.json")
    if not (trace.is_file() and trace.stat().st_size > 0):
        raise AssertionError("--profile wrote no trace on the card")
    if "device memory: {'cuda:0'" not in res["debug", "cuda"][1]:
        raise AssertionError(f"--debug on the card: {res['debug', 'cuda'][1][-2000:]}")
    log(f"  --profile trace on the card: {trace.stat().st_size} bytes; --debug stderr: "
        + " | ".join(res["debug", "cuda"][1].splitlines()[-3:]))


def pipeline_phase(dev, s, reads, want, tmp: str) -> None:
    """Phase 5c: ``run_amos_pipeline`` with the device engine on ``reads``
    on the card, against stand-in AMOS executables; both kernels must
    launch, and the OVL file the stand-in ``bank-transact`` receives must
    equal ``want`` (phase 4's records) written by ``write_ovl``."""
    import json as js

    from sequence_aligner_tpu_torch.core.records import OverlapRecord
    from sequence_aligner_tpu_torch.io.ovl import write_ovl
    from sequence_aligner_tpu_torch.pipeline.driver import run_amos_pipeline
    from sequence_aligner_tpu_torch.pipeline.standins import write_standins

    bins = write_standins(os.path.join(tmp, "amos_bin"))
    work = os.path.join(tmp, "pipe")
    reset_counts()
    t0 = time.perf_counter()
    res = run_amos_pipeline(reads, s, work, overlapper="device", amos_bin=bins, device=dev)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    if min(launches.get("phase1", 0), launches.get("phase2", 0)) < 1:
        raise AssertionError(f"run_amos_pipeline: a kernel of the path never launched: {launches}")
    want_ovl = os.path.join(tmp, "pipe_want.ovl")
    write_ovl(OverlapRecord.bulk_build(*(a.tolist() for a in want)), want_ovl)
    got = Path(work, "input.bnk", "overlaps.ovl").read_bytes()
    if not (got and got == Path(want_ovl).read_bytes()):
        raise AssertionError("the OVL file bank-transact received differs from phase 4's records")
    stages = [js.loads(ln)[0] for ln in Path(bins, "argv.log").read_text().splitlines()]
    if stages != ["toAmos_new", "bank-transact", "tigger", "make-consensus", "bank2fasta"]:
        raise AssertionError(f"the pipeline ran {stages}")
    if res.n_overlaps != len(want[0]) or res.n_contigs != 1:
        raise AssertionError(f"run_amos_pipeline: {res.n_overlaps} overlaps, "
                             f"{res.n_contigs} contigs")
    log(f"  equal: the OVL file bank-transact received and phase 4's records "
        f"({res.n_overlaps} records, {len(got)} bytes); stages {stages}; wall {wall:.3f} s, "
        f"timings " + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
        + f"; launches {launches}")


def quadratic_phase(dev, s, reads, banded_records: int, sms: int, sm_mhz: float) -> None:
    """Phase 9: the quadratic path on 2,048 reads on the card and the CPU
    (equal arrays), then on the main path's reads on the card, timed."""
    import numpy as np
    import torch

    from sequence_aligner_tpu_torch.measure import bound_ms
    from sequence_aligner_tpu_torch.models.overlapper import Overlapper
    from sequence_aligner_tpu_torch.ops import align_lax
    from sequence_aligner_tpu_torch.pipeline.datasets import simulated_reads

    small = simulated_reads(2048, READ_LEN, coverage=COVERAGE, error_rate=0.01, seed=12)
    t0 = time.perf_counter()
    got = Overlapper(s, fast_dovetail=False, device=dev).run_arrays(small)
    t1 = time.perf_counter()
    want = Overlapper(s, fast_dovetail=False, device="cpu").run_arrays(small)
    t2 = time.perf_counter()
    if not (len(got[0]) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))):
        raise AssertionError("quadratic path: card and CPU engines differ on 2,048 reads")
    log(f"  equal: quadratic path on 2,048 reads (1% errors), card and CPU, {len(got[0])} "
        f"records; card {t1 - t0:.3f} s, CPU {t2 - t1:.3f} s")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    align_lax.calls = 0
    ov = Overlapper(s, fast_dovetail=False, device=dev)
    t0 = time.perf_counter()
    arrs = ov.run_arrays(reads)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    check_records(arrs, len(reads), s)
    st = ov.stats
    n = st.n_candidate_pairs
    if st.dp_cells != 0 or st.dp_cells_raw != 0:  # the JAX engine counts no quadratic cells
        raise AssertionError(f"quadratic path: dp_cells {st.dp_cells}, dp_cells_raw "
                             f"{st.dp_cells_raw}; the JAX engine counts 0")
    la_max = max(len(r.seq) for r in reads)
    cells = n * (la_max + 1) ** 2  # the full (la_max + 1)^2 matrix a pair
    # each pair's two reads, two lengths and two ids in, four words out
    nbytes = n * (2 * READ_LEN + 4 * 4 + 4 * 4)
    bound, by = bound_ms(cells * QUAD_OPS_PER_CELL, nbytes, sms, sm_mhz)
    align_ms = ov.stage_s["align"] * 1e3
    log(f"  quadratic, {len(reads)} reads: candidate pairs {n}, records {len(arrs[0])} "
        f"(banded path {banded_records}), cells {cells}, chunks {align_lax.calls} of up to "
        f"{ov.quad_chunk(n, READ_LEN)} pairs, wall {wall:.3f} s, peak device memory "
        f"{peak:.1f} MiB")
    log("  quadratic stage times (s): "
        + json.dumps({k: round(v, 4) for k, v in ov.stage_s.items()}))
    log(f"  quadratic align {align_ms:.1f} ms, bound {bound:.3f} ms ({by}; "
        f"{QUAD_OPS_PER_CELL} int32 ops/cell, {nbytes} bytes): {align_ms / bound:.1f}x")
    log(json.dumps({"quadratic": dict(
        reads=len(reads), candidate_pairs=n, records=len(arrs[0]),
        banded_records=banded_records, chunks=align_lax.calls,
        chunk_pairs=ov.quad_chunk(n, READ_LEN), wall_s=wall, align_ms=align_ms,
        bound_ms=bound, bound_by=by, peak_mib=peak,
        stages={k: round(v, 4) for k, v in ov.stage_s.items()})}))


def register_report(logs: dict) -> dict:
    """{kernel instance: {registers, spill_stores, spill_loads}} from the
    ptxas -v lines of the build."""
    import re

    from sequence_aligner_tpu_torch.sass_mix import _demangle_short

    out, cur = {}, None
    for text in logs.values():
        for line in text.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                cur = _demangle_short(m.group(1))
                out[cur] = {}
            elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                                         r"loads", line)):
                out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            elif cur and (m := re.search(r"Used (\d+) registers", line)):
                out[cur]["registers"] = int(m.group(1))
    return out


def prescreen_phase(dev, reads, s) -> None:
    """Phase 7: ``reads`` through the unscreened and the screened engine on
    the card; then 2,048 reads with planted repeats (amos_parity settings),
    where the screen drops candidates, on the card and on the CPU, each
    equal."""
    import numpy as np

    from sequence_aligner_tpu_torch.core.settings import AlignSettings
    from sequence_aligner_tpu_torch.models.overlapper import Overlapper
    from sequence_aligner_tpu_torch.pipeline.datasets import planted_repeat_reads

    for screen in (False, True):
        ov = Overlapper(s, prescreen=screen, device=dev)
        t0 = time.perf_counter()
        arrs = ov.run_arrays(reads)
        wall = time.perf_counter() - t0
        if screen and ov._prescreen_w() is None:
            raise AssertionError("the prescreen is not active on this input")
        log(f"  prescreen={screen}: window {ov._prescreen_w()}, candidate pairs "
            f"{ov.stats.n_candidate_pairs}, records {len(arrs[0])}, {wall:.3f} s, "
            f"stages " + json.dumps({k: round(v, 4) for k, v in ov.stage_s.items()}))
        check_records(arrs, len(reads), s)
    small = planted_repeat_reads(2048, READ_LEN, seed=7)
    sp = AlignSettings.amos_parity()
    n_cand = {}
    for screen in (False, True):
        ov = Overlapper(sp, prescreen=screen, device=dev)
        got = ov.run_arrays(small)
        want = Overlapper(sp, prescreen=screen, device="cpu").run_arrays(small)
        if not (len(got[0]) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))):
            raise AssertionError(f"prescreen={screen}: card and CPU engines differ")
        n_cand[screen] = ov.stats.n_candidate_pairs
        log(f"  equal: prescreen={screen} on {len(small)} planted-repeat reads, card and "
            f"CPU, {n_cand[screen]} candidate pairs, {len(got[0])} records")
    if not n_cand[True] < n_cand[False]:
        raise AssertionError(f"the screen dropped no candidate on the card: {n_cand}")


def probe_phase(launches: dict) -> list[dict]:
    """Phase 8: every probe variant checked against its plain version and
    timed; returns their entries of the kernels line (P = 2^20 rows)."""
    from sequence_aligner_tpu_torch import probes
    from sequence_aligner_tpu_torch.probes import dtype_probe as dp
    from sequence_aligner_tpu_torch.probes import pack_probe as pp

    replaces = {"native": "tools/pack_probe.py:59", "swar": "tools/pack_probe.py:80",
                "vmax2": "tools/pack_probe.py:80"}
    entries = []
    for mod, prefix in ((pp, "pack_probe"), (dp, "dtype_probe")):
        log(f"  {prefix} equal to its plain version: " + "; ".join(mod.check_edges()))
        rows = mod.measure()
        for r in rows:
            lib = r["library_ms"]
            log(f"  {prefix} {r['variant']:8s} P={r['P']:8d}: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms"
                + (f", amax {lib:.4f} ms" if lib is not None else "") + " (equal)")
            if r["P"] == probes.SIZES[-1]:
                entries.append(dict(
                    name=f"{prefix}_{r['variant']}", route="cuda",
                    source="sequence_aligner_tpu_torch/csrc/probes.cu",
                    replaces=replaces.get(r["variant"], "tools/dtype_probe.py:33"),
                    launches=launches[f"{prefix}_{r['variant']}"],
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=lib))
        for p in probes.SIZES:
            t = {r["variant"]: r["ms"] for r in rows if r["P"] == p}
            if mod is pp:
                log(f"  P={p}: SWAR / native {t['swar'] / t['native']:.3f}x, "
                    f"vmax2 / native {t['vmax2'] / t['native']:.3f}x (equal logical volume)")
            else:
                log(f"  P={p}: int32 / int16 {t['int32'] / t['int16']:.3f}x, "
                    f"int32 / int16x2 {t['int32'] / t['int16x2']:.3f}x, "
                    f"int32 / int8 {t['int32'] / t['int8']:.3f}x, "
                    f"int32 / int8x4 {t['int32'] / t['int8x4']:.3f}x")
    return entries


def main() -> int:
    faulthandler.dump_traceback_later(BUDGET_S, exit=True)
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke needs an NVIDIA card")
    if not (ROOT / "sequence_aligner_tpu_torch" / "csrc").is_dir():
        return fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))

    import numpy as np

    from sequence_aligner_tpu_torch import _build, probes
    from sequence_aligner_tpu_torch.core.records import Sequence
    from sequence_aligner_tpu_torch.core.settings import AlignSettings
    from sequence_aligner_tpu_torch.io.ovl import write_ovl_arrays
    from sequence_aligner_tpu_torch.models import overlapper as ovmod
    from sequence_aligner_tpu_torch.ops import align_fused as af
    from sequence_aligner_tpu_torch.pipeline.datasets import simulated_reads, write_seq

    dev = torch.device("cuda")
    t_all = time.perf_counter()
    s = AlignSettings()
    cm = s.cm_tuple()

    # ---- 1. device and build ----
    with Stage("device and build"):
        card = nvidia_smi("name,power.limit")
        sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        props = torch.cuda.get_device_properties(0)
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"{torch.cuda.get_device_name(0)}, {props.multi_processor_count} SMs, "
            f"max SM clock {sm_mhz:.0f} MHz")
        t0 = time.perf_counter()
        logs = _build.build_all(["dovetail", "probes"])  # one nvcc each, in parallel
        log(f"nvcc build: {time.perf_counter() - t0:.1f} s")
        for src, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"  ptxas ({src}): {line.strip()}")
        log(json.dumps({"registers": register_report(logs)}))
        af._lib()  # load and bind now, so a binding fault fails here
        probes.lib()

    # ---- 2. the main path at full size ----
    with Stage("main path: Overlapper.run_arrays, 32,000 x 100 bp"):
        t0 = time.perf_counter()
        reads = simulated_reads(N_READS, READ_LEN, coverage=COVERAGE, error_rate=0.0, seed=0)
        log(f"simulated reads (host set-up): {time.perf_counter() - t0:.2f} s")
        warm = ovmod.Overlapper(s, device=dev)
        warm.run_arrays(reads[:2048])  # CUDA context, allocator and library warm-up
        with split_route():
            warm.run_arrays(reads[:2048])  # and the split route's own ops
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with largest_launches() as captured:
            ov, arrs, wall, launches = timed_run(dev, s, reads, launches=True)
            by_instance = dict(af.instance_launches)
        peak = torch.cuda.max_memory_allocated()
        st = ov.stats
        route = "mono" if st.n_phase2_pairs == st.n_candidate_pairs else "split"
        log(f"route {route} ({st.n_candidate_pairs} pairs in one band-width group, at most "
            f"2^21)  reads {st.n_reads}  k-mers {st.n_kmers}  candidate pairs "
            f"{st.n_candidate_pairs}  phase-2 pairs {st.n_phase2_pairs}  valid records "
            f"{st.n_valid}  dp_cells {st.dp_cells}  dp_cells_raw {st.dp_cells_raw}")
        log("stage times (s): " + json.dumps({k: round(v, 4) for k, v in ov.stage_s.items()}))
        log(f"run_arrays wall {wall:.3f} s -> {st.n_reads / wall:.1f} reads/s; "
            f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}; by "
            f"instance {by_instance}")
        if (route, launches["phase1"], launches["phase2"]) != ("mono", 1, 1):
            return fail(f"the main path should take the mono route, one launch of each "
                        f"kernel: route {route}, launches {launches}")
        if len(arrs[0]) != st.n_valid:
            return fail("main path output has the wrong shape")
        check_records(arrs, N_READS, s)
        # the split route on the same reads, its launches counted on their own
        with split_route(), largest_launches() as captured_split:
            ov_s, arrs_s, wall_s, launches_split = timed_run(dev, s, reads, launches=True)
        st_s = ov_s.stats
        if min(launches_split["phase1"], launches_split["phase2"]) < 1:
            return fail(f"a kernel of the split route never launched: {launches_split}")
        if not all(np.array_equal(a, b) for a, b in zip(arrs, arrs_s)):
            return fail("the split route's records differ from the mono route's")
        log(f"split route: phase-2 pairs {st_s.n_phase2_pairs}  dp_cells {st_s.dp_cells}  "
            f"dp_cells_raw {st_s.dp_cells_raw}  launches {launches_split}; records equal to the "
            f"mono route's ({len(arrs_s[0])})")
        # four more runs of each route, in turns (split, mono, mono, split, twice)
        walls = {"mono": [wall], "split": [wall_s]}
        aligns = {"mono": [ov.stage_s["align"]], "split": [ov_s.stage_s["align"]]}
        for name in ("split", "mono", "mono", "split") * 2:
            with split_route() if name == "split" else contextlib.nullcontext():
                o, _, w_, _ = timed_run(dev, s, reads)
            walls[name].append(w_)
            aligns[name].append(o.stage_s["align"])
        for name in ("mono", "split"):
            log(f"{name} route: walls (s) {[round(x, 4) for x in walls[name]]} (median "
                f"{np.median(walls[name]):.4f}), align stages (s) "
                f"{[round(x, 4) for x in aligns[name]]} (median {np.median(aligns[name]):.4f})")
        log(json.dumps({"routes_32k": dict(
            walls_s=walls, align_s=aligns, launches={"mono": launches, "split": launches_split},
            dp_cells={"mono": st.dp_cells, "split": st_s.dp_cells},
            phase2_pairs={"mono": st.n_phase2_pairs, "split": st_s.n_phase2_pairs},
            records=len(arrs[0]), card=card)}))

    # ---- 3. kernels against their plain versions; timing ----
    max_err = {"phase1": 0, "phase2": 0}

    def compare(name, got, want, what):
        for i, (g, w) in enumerate(zip(got, want)):
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            max_err[name] = max(max_err[name], err)
            if err:
                raise AssertionError(f"{name} output {i} differs from its plain version "
                                     f"({what}): max |diff| {err}")

    def check_phase1(ops, la_max, w, what, ulen=0):
        kw = dict(la_max=la_max, w=w, gO=s.gap_open, gE=s.gap_extend, cm_tuple=cm)
        k1 = af.phase1_indexed(*ops, **kw)
        torch.cuda.synchronize()
        p1 = af.phase1_indexed_plain(*ops, **kw)
        compare("phase1", k1, p1, what)
        if ulen:
            compare("phase1", af.phase1_indexed(*ops, ulen=ulen, **kw), k1, what + ", ulen")
            torch.cuda.synchronize()
        return p1

    def check_phase2(ops, la_max, w, what, ulen=0):
        kw = dict(la_max=la_max, w=w, zero_row=w // 2, gO=s.gap_open, gE=s.gap_extend,
                  cm_tuple=cm)
        k2 = af.phase2_indexed(*ops, **kw)
        torch.cuda.synchronize()
        compare("phase2", k2, af.phase2_indexed_plain(*ops, **kw), what)
        if ulen:
            compare("phase2", af.phase2_indexed(*ops, ulen=ulen, **kw), k2, what + ", ulen")
            torch.cuda.synchronize()
        return int((k2[0] > 0).sum())

    def phase2_ops(ops, p1, w):
        """Phase 2's operands from phase 1's dove anchors."""
        packed, ia, ib, ln = ops
        a_len, b_len = ln[ia.long()], ln[ib.long()]
        ds = torch.where((p1[0] > 0) & (b_len >= w), p1[3], p1[1]).contiguous()
        return packed, ia, ib, ds, (a_len - ds).contiguous(), ln

    def check(ops, la_max, w, what, ulen=0):
        """Both phases on one batch; phase 2 from phase 1's dove anchors."""
        p1 = check_phase1(ops, la_max, w, what, ulen)
        live = check_phase2(phase2_ops(ops, p1, w), la_max, w, what, ulen)
        log(f"  equal: {what} ({ops[1].numel()} pairs, w={w}"
            f"{', ulen=%d' % ulen if ulen else ''}, instance "
            f"{af.instance(1, w=w, rows=la_max, cm_tuple=cm)}; phase-2 live {live})")

    def batch(seqs, pairs):
        """(packed read table, a_idx, b_idx, lengths) and la_max on the card."""
        from sequence_aligner_tpu_torch.ops.encode import encode_reads

        bases, lengths = encode_reads(seqs)
        to = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
        return (af.pack_reads_le(torch.from_numpy(bases).to(dev)), to(pairs[0]),
                to(pairs[1]), to(lengths)), bases.shape[1]

    with Stage("kernels against their plain versions"):
        a1, kw1, p1n = captured["phase1"]
        a2, kw2, p2n = captured["phase2"]
        n = min(N_CHECK, p1n)
        p1 = check_phase1(pair_slice(a1, n), kw1["la_max"], kw1["w"], "real pairs",
                          ulen=READ_LEN)
        b_len1 = a1[3][a1[2][:n].long()]
        duds = int(((p1[0] <= 0) | (b_len1 < kw1["w"]) | (p1[4] != 0)).sum())
        log(f"  equal: phase 1 on the first {n} pairs of the mono route's launch "
            f"({p1n} pairs; {duds} phase-1 duds among them), also with ulen={READ_LEN}")
        n2 = min(N_CHECK, p2n)
        live = check_phase2(pair_slice(a2, n2), kw2["la_max"], kw2["w"], "real pairs",
                            ulen=READ_LEN)
        dl2 = a2[4][:n2]
        log(f"  equal: phase 2 on the first {n2} pairs of the mono route's launch ({p2n} "
            f"pairs, rows {kw2['la_max']}; live {live}; dove length 0 on "
            f"{int((dl2 == 0).sum())}, {kw2['la_max']} on {int((dl2 == kw2['la_max']).sum())}, "
            f"B shorter than w on {int((a2[5][a2[2][:n2].long()] < kw2['w']).sum())}), "
            f"also with ulen={READ_LEN}")
        split_err = {name: check_real_pairs(name, *captured_split[name],
                                            "the split route's largest launch")
                     for name in ("phase1", "phase2")}
        rng = np.random.RandomState(1)
        rnd = simulated_reads(4096, READ_LEN, coverage=COVERAGE, error_rate=0.02, seed=1)
        ia = rng.randint(0, 4096, 16384)
        ops, lmax = batch(rnd, (ia, rng.randint(0, 4096, 16384)))
        check(ops, lmax, 12, "random pairs")
        ops, lmax = batch(rnd, (ia, np.clip(ia + rng.randint(-12, 13, 16384), 0, 4095)))
        check(ops, lmax, 12, "near pairs, 2% errors", ulen=READ_LEN)
        check(ops, lmax, 16, "near pairs, 2% errors", ulen=READ_LEN)
        mixed = [Sequence(q.id, q.seq[: rng.randint(40, 301)]) for q in
                 simulated_reads(2048, 300, coverage=40.0, error_rate=0.01, seed=2)]
        ia = rng.randint(0, 2048, 8192)
        mixed_ops, mixed_lmax = batch(mixed, (ia, np.clip(ia + rng.randint(-6, 7, 8192), 0, 2047)))
        for w in (12, 16) + OFF_PATH_WIDTHS:
            check(mixed_ops, mixed_lmax, w, "mixed lengths 40..300 bp")
        big = tuple(40000 if a == b else -50000 for a in range(4) for b in range(4))
        kwb = dict(la_max=mixed_lmax, w=16, gO=s.gap_open, gE=s.gap_extend, cm_tuple=big)
        if af.instance(1, w=16, rows=mixed_lmax, cm_tuple=big) != "general":
            raise AssertionError("scores past 16 bits did not take the general instance")
        compare("phase1", af.phase1_indexed(*mixed_ops, **kwb),
                af.phase1_indexed_plain(*mixed_ops, **kwb), "scores past 16 bits")
        log("  equal: phase 1, scores past 16 bits (general instance)")

    with Stage("kernel timing at both routes' launches at 32k and the other instances"):
        sms = props.multi_processor_count
        # the split route's largest launches, then the mono route's (the main path's)
        kernels = [kernel_entry(name, *captured_split[name], launches=launches_split[name],
                                max_err=split_err[name], sms=sms, sm_mhz=sm_mhz)
                   for name in ("phase1", "phase2")]
        kernels += [kernel_entry(name, *captured[name], launches=launches[name],
                                 max_err=max_err[name], sms=sms, sm_mhz=sm_mhz, tag="_mono")
                    for name in ("phase1", "phase2")]
        # the capacity and general instances, off the main paths, on the
        # mixed-length batch
        for w in OFF_PATH_WIDTHS:
            tag = "_" + af.instance(1, w=w, rows=mixed_lmax, cm_tuple=cm)
            kw = dict(la_max=mixed_lmax, w=w, gO=s.gap_open, gE=s.gap_extend, cm_tuple=cm)
            p1 = af.phase1_indexed(*mixed_ops, **kw)
            kernels.append(kernel_entry("phase1", mixed_ops, kw, 8192, launches=0,
                                        max_err=max_err["phase1"], sms=sms, sm_mhz=sm_mhz,
                                        tag=tag))
            kernels.append(kernel_entry("phase2", phase2_ops(mixed_ops, p1, w),
                                        dict(kw, zero_row=w // 2), 8192, launches=0,
                                        max_err=max_err["phase2"], sms=sms, sm_mhz=sm_mhz,
                                        tag=tag))

    with Stage("wide rows: reads of 32,768 bp or more"):
        kernels += wide_rows_phase(dev, sms, sm_mhz)

    # ---- 4. card against CPU ----
    with Stage("engine on the card against the CPU, 2,048 reads"):
        uni = simulated_reads(2048, READ_LEN, coverage=COVERAGE, error_rate=0.0, seed=3)
        mix = [Sequence(q.id, q.seq[: 60 + (q.id * 37) % 91]) for q in
               simulated_reads(2048, 150, coverage=COVERAGE, error_rate=0.01, seed=4)]
        engine_out = {}
        for what, seqs in (("100 bp", uni), ("mixed 60..150 bp, 1% errors", mix)):
            got = ovmod.Overlapper(s, device=dev).run_arrays(seqs)
            want = ovmod.Overlapper(s, device="cpu").run_arrays(seqs)
            if not (len(got[0]) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))):
                return fail(f"card and CPU engines differ on {what}")
            log(f"  equal: {what}: {len(got[0])} records")
            engine_out[what] = got

    # ---- 5. CLI ----
    with Stage("CLI"):
        with tempfile.TemporaryDirectory() as tmp:
            fasta, out, want = (os.path.join(tmp, f) for f in ("r.fasta", "o.ovl", "w.ovl"))
            write_seq(uni, fasta)
            r = subprocess.run(
                [sys.executable, "-m", "sequence_aligner_tpu_torch.cli", "-i", fasta,
                 "-o", out], cwd=ROOT, capture_output=True, text=True, timeout=300,
            )
            if r.returncode != 0:
                return fail(f"CLI exited {r.returncode}: {r.stderr[-2000:]}")
            write_ovl_arrays(engine_out["100 bp"], want)
            if Path(out).read_bytes() != Path(want).read_bytes():
                return fail("CLI output differs from the engine's records")
            log(f"  CLI OVL equal ({Path(out).stat().st_size} bytes)")
            cli_phase(fasta, tmp)

    # ---- 5c. the AMOS pipeline driver on stand-in binaries ----
    with Stage("AMOS pipeline driver: device engine on the card, stand-in AMOS binaries"):
        with tempfile.TemporaryDirectory() as tmp:
            pipeline_phase(dev, s, uni, engine_out["100 bp"], tmp)

    # ---- 6. the large-input path at full size ----
    with Stage("large-input path: 1,000,000 x 100 bp, k = 16, run_arrays and "
               "run_stream_arrays"):
        s16 = AlignSettings.amos_parity(kmer_size=K_LARGE)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            path = os.path.join(tmp, "reads_1m.fasta")
            reads_1m = simulated_reads(N_LARGE, READ_LEN, coverage=COVERAGE_LARGE, seed=0)
            write_seq(reads_1m, path)
            log(f"simulated reads written as FASTA (host set-up): "
                f"{time.perf_counter() - t0:.2f} s")
            entries, arrs_1m = large_input_phase(path, N_LARGE, s16, sms, sm_mhz)
            kernels += entries

            # ---- 6b. the sharded engine on the same reads ----
            with Stage("sharded engine: sharded_overlap, 1,000,000 x 100 bp, one NCCL "
                       "rank; CLI --engine sharded and dist.worker"):
                kernels += sharded_phase(dev, path, reads_1m, arrs_1m, s16, card, sms, sm_mhz)
            del reads_1m, arrs_1m

    # ---- 7. prescreen ----
    with Stage("prescreen on the card, 32,000 reads; card against CPU, 2,048 "
               "planted-repeat reads"):
        prescreen_phase(dev, reads, s)

    # ---- 8. probes ----
    with Stage("probes: every variant against its plain version, then timed"):
        kernels += probe_phase(launches)

    # ---- 9. the quadratic path ----
    with Stage("quadratic path: card against CPU, 2,048 reads; 32,000 x 100 bp on the card"):
        quadratic_phase(dev, s, reads, len(arrs[0]), sms, sm_mhz)

    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # any phase failing fails the smoke, with its traceback
        import traceback

        traceback.print_exc()
        rc = fail(f"{type(e).__name__}: {e}")
    sys.exit(rc)
