"""Joining a multi-process group (port of ``sequence_aligner_tpu/dist/init.py``).

The JAX engine joins ``jax.distributed`` and builds one mesh over every
device of every process.  Here each process drives one device and is one
rank of the default ``torch.distributed`` group: NCCL between cards (NVLink
within a host, the network across hosts), gloo between CPU processes.  The
sharded engine's collectives name that group, so the same code runs one
process or many.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from sequence_aligner_tpu_torch.device import resolve_device
from sequence_aligner_tpu_torch.parallel.mesh import BACKENDS, TIMEOUT


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> torch.device:
    """Join the default process group and return this rank's device.

    With ``coordinator_address`` ("HOST:PORT", served by process 0) the
    three arguments give the rendezvous, world size and rank.  Without it,
    ``torchrun``'s environment gives them (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), as the JAX function reads a
    pod's; with neither, the process is a group of one.  One process drives
    one card: ``cuda`` selects card ``LOCAL_RANK`` (else the rank modulo the
    host's cards) before the NCCL group starts; ``cpu`` joins over gloo.
    The JAX function's ``local_device_count`` (N virtual CPU devices in one
    process) has no counterpart: a torch rank is a process."""
    dev = resolve_device(device)
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                  rank=process_id)
    elif "RANK" in os.environ:
        kw = dict(init_method="env://")
    else:
        kw = dict(store=dist.HashStore(), world_size=1, rank=0)
    if dev.type == "cuda":
        rank = kw["rank"] if "rank" in kw else int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(BACKENDS[dev.type], timeout=TIMEOUT, **kw)
    return dev


def distributed_group() -> dist.ProcessGroup:
    """The group of every process, ranks in process order (the counterpart
    of ``distributed_mesh``): rank r holds the r-th block of the reads."""
    if not dist.is_initialized():
        raise RuntimeError("initialize_distributed() has not been called")
    return dist.group.WORLD
