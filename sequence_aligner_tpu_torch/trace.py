"""Where one calc-overlaps run spends its time on the card.

    python -m sequence_aligner_tpu_torch.trace [--reads 32000] [--length 100]
        [--coverage 20] [--seed 0] [--kmer-size 12] [--amos-parity]
        [--trace-out trace.json]

Runs ``Overlapper.run_arrays`` on simulated reads twice to warm up, then once
under ``torch.profiler`` (CPU and CUDA activity), and prints one JSON line:
the run's wall time and stage split, the device's busy time (the union of
its kernel and copy intervals) and busy share of the wall time, and the
device time by kernel name.  ``--trace-out`` also writes the Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from sequence_aligner_tpu_torch.core.settings import AlignSettings
from sequence_aligner_tpu_torch.device import resolve_device
from sequence_aligner_tpu_torch.models.overlapper import Overlapper
from sequence_aligner_tpu_torch.pipeline.datasets import simulated_reads


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=32000)
    ap.add_argument("--length", type=int, default=100)
    ap.add_argument("--coverage", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kmer-size", type=int, default=12)
    ap.add_argument("--amos-parity", action="store_true",
                    help="collision band [2, 222] (AlignSettings.amos_parity)")
    ap.add_argument("--trace-out", default="")
    a = ap.parse_args(argv)
    dev = resolve_device("cuda")
    reads = simulated_reads(a.reads, a.length, coverage=a.coverage, seed=a.seed)
    s = (AlignSettings.amos_parity if a.amos_parity else AlignSettings)(kmer_size=a.kmer_size)
    ov = Overlapper(s, device=dev)
    for _ in range(2):
        ov.run_arrays(reads)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ov.run_arrays(reads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in dev_events:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += e.time_range.elapsed_us()
        d[1] += 1
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in dev_events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(dev),
        "reads": a.reads, "records": ov.stats.n_valid,
        "candidate_pairs": ov.stats.n_candidate_pairs,
        "wall_s": wall, "stage_s": ov.stage_s,
        "device_busy_s": busy_us * 1e-6 if dev_events else None,
        "device_busy_share": busy_us * 1e-6 / wall if dev_events else None,
        "device_ms_by_kernel": {n: {"ms": t * 1e-3, "count": c} for n, (t, c) in top},
    }))
    if a.trace_out:
        prof.export_chrome_trace(a.trace_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
