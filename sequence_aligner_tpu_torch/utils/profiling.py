"""Profiling and device-memory observability: the port's counterparts of
``sequence_aligner_tpu/utils/profiling.py`` (``jax.profiler`` traces and
device memory stats) with ``torch.profiler`` and ``torch.cuda``."""

from __future__ import annotations

import contextlib
import os

import torch


def device_memory_stats() -> dict:
    """Per-card memory stats (bytes in use, peak, card total); an empty
    dict where no card is visible."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


@contextlib.contextmanager
def trace_profile(logdir: str | None):
    """``torch.profiler`` trace of the block, written to
    ``<logdir>/trace.json`` (Chrome trace format; the card's activity too
    where one is visible); no-op when logdir is None."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
