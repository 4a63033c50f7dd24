"""Debug output and profiling (host).

The stage clock is ``Overlapper.stage_s`` with ``debug.time_report``; the
port has no compile cache."""

from sequence_aligner_tpu_torch.utils.debug import format_duration, printdb, set_debug
from sequence_aligner_tpu_torch.utils.profiling import device_memory_stats, trace_profile

__all__ = [
    "format_duration", "set_debug", "printdb", "device_memory_stats", "trace_profile",
]
