"""Yardsticks for kernel timings on the card: a CUDA-event timer and the
least time the card could take for a kernel's work (its bound).

Used by ``chip_smoke.py`` for the engine's kernels and by ``probes`` for
the timing probes.
"""

from __future__ import annotations

import subprocess

# the card's integer dispatch rate for the kernels' bounds: each of an SM's
# 4 schedulers dispatches one warp instruction (32 lanes) a clock.  One
# instruction class alone peaks at 64 lanes an SM (the ALU pipe, or the FMA
# pipe for IMAD), but classes on the two pipes run together: the int32
# dtype probe ran at 77.5 and the SWAR pack probe at 84 instructions a lane
# an SM a clock on an H100 at 700 W (PERF.md), above 64.  A 16x2 or 8x4 SIMD
# instruction does 2 or 4 lanes of work.
DISPATCH_LANES_PER_SM = 128
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def event_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls after ``warm``."""
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


def bound_ms(int32_ops: float, nbytes: float, sms: int, sm_mhz: float) -> tuple[float, str]:
    """(least time in ms, "operations" or "bytes"): int32-lane operations
    over the card's integer dispatch rate against bytes over its memory rate."""
    ops_ms = int32_ops / (sms * DISPATCH_LANES_PER_SM * sm_mhz * 1e6) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def card() -> tuple[int, float]:
    """(SM count, max SM clock in MHz) of card 0."""
    import torch

    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0]
    return torch.cuda.get_device_properties(0).multi_processor_count, float(mhz)
