#!/usr/bin/env python3
"""On-card smoke of the PyTorch / CUDA port (``sequence_aligner_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA kernels from ``sequence_aligner_tpu_torch/csrc`` with
nvcc, then, each phase fatal on failure:

  1. prints the card (nvidia-smi name and power limit) and the ptxas
     register / spill lines of the build;
  2. drives the main path — ``Overlapper.run_arrays`` (calc-overlaps) on
     32,000 simulated 100 bp reads at coverage 20 — with every kernel launch
     counter set to 0 just before and read just after; both kernels must have
     launched.  Prints reads, candidate pairs, valid records, DP cells, the
     stage times, reads/s and peak device memory;
  3. holds each kernel against its plain PyTorch version on the card: the
     first 65,536 real pairs of the main path's largest launch, random pairs,
     and mixed-length batches at band widths 12, 20, 40 and 70 (every
     register capacity and the scratch instance); outputs must be equal
     (integers, tolerance 0), and ulen = L must equal ulen = 0.  Then times
     each kernel with CUDA events on the main path's largest launch, beside
     its plain version and its bound;
  4. runs the engine on 2,048 reads (100 bp, and mixed lengths with 1%
     errors) on the card and on the CPU: the canonical arrays must be equal
     (the CPU side is the path the CPU tests hold against the JAX package);
  5. writes a 2,048-read FASTA to a temporary directory, runs
     ``python -m sequence_aligner_tpu_torch.cli`` on it and checks that the
     OVL file equals phase 4's records.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
without a card or outside a checkout of the repository.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BUDGET_S = 1100  # a hang ends with a traceback and a non-zero exit
N_READS, READ_LEN, COVERAGE = 32000, 100, 20.0
N_CHECK = 65536
# int32 operations per band cell, counted from csrc/dovetail.cu along one
# cell's usual path (in band, M branch, no new best), with Hopper's fused
# 3-input max and add-max (VIMNMX3, VIADDMNMX) as one operation each and
# register moves not counted (python -m sequence_aligner_tpu_torch.sass_mix
# shows the compiled instruction mix)
OPS_PER_CELL = {"phase1": 28, "phase2": 34}
INT32_LANES_PER_SM = 64  # Hopper: 4 partitions x 16 INT32 units
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
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


def event_ms(fn, reps: int, warm: int = 1) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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

    from sequence_aligner_tpu_torch import _build
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
        logs = _build.build_all(["dovetail"])
        log(f"nvcc build: {time.perf_counter() - t0:.1f} s")
        for line in logs["dovetail"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")
        af._lib()  # load and bind now, so a binding fault fails here

    # ---- 2. the main path at full size ----
    captured = {}

    def capture(name, real):
        def wrapped(*args, **kw):
            p = kw.get("a_len", args[2] if name == "phase1" else args[4]).shape[0]
            if p > captured.get(name, ((), {}, -1))[2]:
                captured[name] = (args, dict(kw), p)
            return real(*args, **kw)
        return wrapped

    with Stage("main path: Overlapper.run_arrays, 32,000 x 100 bp"):
        t0 = time.perf_counter()
        reads = simulated_reads(N_READS, READ_LEN, coverage=COVERAGE, error_rate=0.0, seed=0)
        log(f"simulated reads (host set-up): {time.perf_counter() - t0:.2f} s")
        warm = ovmod.Overlapper(s, device=dev)
        warm.run_arrays(reads[:2048])  # CUDA context, allocator and library warm-up
        ovmod.phase1 = capture("phase1", af.phase1)
        ovmod.phase2 = capture("phase2", af.phase2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        af.phase1_launches = 0
        af.phase2_launches = 0
        ov = ovmod.Overlapper(s, device=dev)
        t0 = time.perf_counter()
        arrs = ov.run_arrays(reads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"phase1": af.phase1_launches, "phase2": af.phase2_launches}
        ovmod.phase1, ovmod.phase2 = af.phase1, af.phase2
        peak = torch.cuda.max_memory_allocated()
        st = ov.stats
        log(f"reads {st.n_reads}  k-mers {st.n_kmers}  candidate pairs "
            f"{st.n_candidate_pairs}  phase-2 pairs {st.n_phase2_pairs}  valid records "
            f"{st.n_valid}  dp_cells {st.dp_cells}  dp_cells_raw {st.dp_cells_raw}")
        log("stage times (s): " + json.dumps({k: round(v, 4) for k, v in ov.stage_s.items()}))
        log(f"run_arrays wall {wall:.3f} s -> {st.n_reads / wall:.1f} reads/s; "
            f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
        if min(launches.values()) < 1:
            return fail(f"a kernel of the main path never launched: {launches}")
        lead, trail, ahg, bhg = arrs
        if not (len(lead) > 0 and len(lead) == st.n_valid
                and all(len(a) == len(lead) and a.dtype == np.int32 for a in arrs)):
            return fail("main path output has the wrong shape")
        key = lead.astype(np.int64) << 16 | trail
        if not ((np.diff(key) > 0).all() and lead.min() >= 1 and trail.max() <= N_READS
                and (lead != trail).all() and np.abs(ahg).max() < s.max_ignore
                and np.abs(bhg).max() < s.max_ignore):
            return fail("main path output is not canonical valid OVL records")

    # ---- 3. kernels against their plain versions; timing ----
    max_err = {"phase1": 0, "phase2": 0}

    def compare(name, got, want, what):
        for i, (g, w) in enumerate(zip(got, want)):
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            max_err[name] = max(max_err[name], err)
            if err:
                raise AssertionError(f"{name} output {i} differs from its plain version "
                                     f"({what}): max |diff| {err}")

    def check_phase1(aw, bw, a_len, la_max, w, what, ulen=0):
        kw = dict(la_max=la_max, w=w, gO=s.gap_open, gE=s.gap_extend, cm_tuple=cm)
        k1 = af.phase1(aw, bw, a_len, **kw)
        torch.cuda.synchronize()
        p1 = af.phase1_plain(aw, bw, a_len, **kw)
        compare("phase1", k1, p1, what)
        if ulen:
            compare("phase1", af.phase1(aw, bw, a_len, ulen=ulen, **kw), k1, what + ", ulen")
            torch.cuda.synchronize()
        return p1

    def check_phase2(aw, bw, ds, dl, b_len, la_max, w, what, ulen=0):
        kw = dict(la_max=la_max, w=w, zero_row=w // 2, gO=s.gap_open, gE=s.gap_extend,
                  cm_tuple=cm)
        k2 = af.phase2(aw, bw, ds, dl, b_len, **kw)
        torch.cuda.synchronize()
        compare("phase2", k2, af.phase2_plain(aw, bw, ds, dl, b_len, **kw), what)
        if ulen:
            compare("phase2", af.phase2(aw, bw, ds, dl, b_len, ulen=ulen, **kw), k2,
                    what + ", ulen")
            torch.cuda.synchronize()
        return int((k2[0] > 0).sum())

    def check(aw, bw, a_len, b_len, la_max, w, what, ulen=0):
        """Both phases on one batch; phase 2 from phase 1's dove anchors."""
        p1 = check_phase1(aw, bw, a_len, la_max, w, what, ulen)
        ds = torch.where((p1[0] > 0) & (b_len >= w), p1[3], p1[1]).contiguous()
        live = check_phase2(aw, bw, ds, (a_len - ds).contiguous(), b_len, la_max, w,
                            what, ulen)
        log(f"  equal: {what} ({a_len.numel()} pairs, w={w}"
            f"{', ulen=%d' % ulen if ulen else ''}; phase-2 live {live})")

    def batch(seqs, pairs):
        from sequence_aligner_tpu_torch.ops.encode import encode_reads

        bases, lengths = encode_reads(seqs)
        packed = af.pack_reads_le(torch.from_numpy(bases).to(dev))
        ln = torch.from_numpy(lengths).to(dev)
        ia, ib = (torch.as_tensor(x, device=dev) for x in pairs)
        return (packed[ia].t().contiguous(), packed[ib].t().contiguous(),
                ln[ia].contiguous(), ln[ib].contiguous(), bases.shape[1])

    with Stage("kernels against their plain versions"):
        a1, kw1, p1n = captured["phase1"]
        a2, kw2, p2n = captured["phase2"]
        n = min(N_CHECK, p1n)
        check_phase1(*(t[..., :n].contiguous() for t in a1[:3]), kw1["la_max"], kw1["w"],
                     "real pairs", ulen=READ_LEN)
        log(f"  equal: phase 1 on the first {n} pairs of the main path's largest "
            f"launch, also with ulen={READ_LEN}")
        n2 = min(N_CHECK, p2n)
        live = check_phase2(*(t[..., :n2].contiguous() for t in a2[:5]), kw2["la_max"],
                            kw2["w"], "real pairs", ulen=READ_LEN)
        log(f"  equal: phase 2 on the first {n2} pairs of the main path's largest "
            f"launch (rows {kw2['la_max']}; live {live}), also with ulen={READ_LEN}")
        rng = np.random.RandomState(1)
        rnd = simulated_reads(4096, READ_LEN, coverage=COVERAGE, error_rate=0.02, seed=1)
        ia = rng.randint(0, 4096, 16384)
        aw, bw, la, lb, lmax = batch(rnd, (ia, rng.randint(0, 4096, 16384)))
        check(aw, bw, la, lb, lmax, 12, "random pairs")
        aw, bw, la, lb, lmax = batch(rnd, (ia, np.clip(ia + rng.randint(-12, 13, 16384), 0, 4095)))
        check(aw, bw, la, lb, lmax, 12, "near pairs, 2% errors", ulen=READ_LEN)
        mixed = [Sequence(q.id, q.seq[: rng.randint(40, 301)]) for q in
                 simulated_reads(2048, 300, coverage=40.0, error_rate=0.01, seed=2)]
        ia = rng.randint(0, 2048, 8192)
        pairs = (ia, np.clip(ia + rng.randint(-6, 7, 8192), 0, 2047))
        for w in (12, 20, 40, 70):
            aw, bw, la, lb, lmax = batch(mixed, pairs)
            check(aw, bw, la, lb, lmax, w, "mixed lengths 40..300 bp")

    kernels = []
    with Stage("kernel timing at the main path's largest launches"):
        sms = props.multi_processor_count
        peak_ops = sms * INT32_LANES_PER_SM * sm_mhz * 1e6
        for name, (args, kw, p) in (("phase1", captured["phase1"]),
                                    ("phase2", captured["phase2"])):
            kern = getattr(af, name)
            plain = getattr(af, name + "_plain")
            ms = event_ms(lambda: kern(*args, **kw), reps=10, warm=2)
            plain_ms = event_ms(lambda: plain(*args, **kw), reps=1, warm=1)
            w = kw["w"]
            if name == "phase1":
                aw, bw, a_len = args
                rows = a_len.clamp(max=kw["la_max"]).long().sum().item()
                cells = rows * w  # band columns 1..w
                nbytes = 4 * (aw.numel() + bw.numel() + a_len.numel() + 5 * p)
            else:
                aw, bw, ds, dl, bl = args
                rows = dl.clamp(min=0, max=kw["la_max"]).long().sum().item()
                cells = rows * (w + 1)  # band columns 0..w
                nbytes = 4 * (aw.numel() + bw.numel() + 3 * p + 7 * p)
            ops_ms = cells * OPS_PER_CELL[name] / peak_ops * 1e3
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(ops_ms, bytes_ms)
            log(f"  {name}: P={p} w={w} rows={kw['la_max']} cells={cells} "
                f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.4f} ms "
                f"(ops {ops_ms:.4f} ms at {OPS_PER_CELL[name]} int32 ops/cell, "
                f"bytes {bytes_ms:.5f} ms), {cells / ms / 1e6:.2f} G cells/s")
            kernels.append(dict(
                name=f"{name}_kernel", route="cuda",
                source="sequence_aligner_tpu_torch/csrc/dovetail.cu",
                replaces=("sequence_aligner_tpu/ops/align_fused.py:463" if name == "phase1"
                          else "sequence_aligner_tpu/ops/align_fused.py:821"),
                launches=launches[name], max_abs_err=max_err[name], ms=ms,
                plain_ms=plain_ms, bound_ms=bound,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None,  # no single PyTorch call computes this DP
            ))

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
