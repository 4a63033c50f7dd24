"""Debug logging: the reference's --debug-gated printdb helpers
(src/Project4.scala:261, src/KmerTable.scala:19-20, src/BioLibs.scala:18-19)
and progress heartbeats, copied from ``sequence_aligner_tpu/utils``, with the
stage-time report the engine prints under --debug (the JAX package's
``StageTimer.report`` format, over the port's ``Overlapper.stage_s``)."""

from __future__ import annotations

import sys

_DEBUG = False


def set_debug(on: bool) -> None:
    global _DEBUG
    _DEBUG = on


def debug_enabled() -> bool:
    return _DEBUG


def printdb(msg: str) -> None:
    if _DEBUG:
        print(msg, file=sys.stderr)


def heartbeat(i: int, every: int, msg: str) -> None:
    """Progress print every N items (the reference's `% 1000` heartbeats)."""
    if _DEBUG and every > 0 and i % every == 0:
        print(msg, file=sys.stderr)


def format_duration(seconds: float) -> str:
    """h:m:s:ms rendering like the Rakefile's print_time_diff."""
    hrs = int(seconds // 3600)
    rem = seconds % 3600
    mins = int(rem // 60)
    rem = rem % 60
    secs = int(rem)
    ms = int((rem % 1) * 1000)
    return f"{hrs}h:{mins}m:{secs}s:{ms}ms"


def time_report(stages: dict[str, float]) -> str:
    """The stage-time block; dotted names ("pairgen.plan") are nested in
    their parent stage and not added to the total."""
    total = sum(v for k, v in stages.items() if "." not in k)
    lines = ["============ Time Taken =============", f"Total Time : {format_duration(total)}"]
    lines += [f"  {name:<18}: {format_duration(v)}" for name, v in stages.items()]
    return "\n".join(lines)
