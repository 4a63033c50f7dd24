"""Process groups for the sharded engine (port of ``parallel/mesh.py``).

The JAX engine's one mesh axis, ``shard``, becomes a ``torch.distributed``
process group with one rank a device: the reads are split over its ranks,
the k-mer table is split by hash, and each pair's collision count lands on
one owner rank.  A caller either passes a group whose processes it started
(``dist.init.initialize_distributed``, or ``torchrun``) or passes none, and
``make_group`` creates a group of one rank on the caller's device: NCCL on
the card, gloo on the CPU.  A card is never driven through gloo.
"""

from __future__ import annotations

import contextlib
import datetime

import torch
import torch.distributed as dist

from sequence_aligner_tpu_torch.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# how long a collective waits for the other ranks before it fails
TIMEOUT = datetime.timedelta(seconds=600)


@contextlib.contextmanager
def make_group(group: dist.ProcessGroup | None = None, *,
               device: str | torch.device = "cuda"):
    """Yields (group, rank, world_size, device).

    With ``group`` None and no default group in this process, a group of one
    rank is created on ``device`` (an in-memory store, no socket) and
    destroyed when the block ends; with ``group`` None under an initialised
    default group, that group is used.  A card's index defaults to the
    current card.  The group's backend must be the device's: NCCL for
    ``cuda``, gloo for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    created = group is None and not dist.is_initialized()
    if created:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(BACKENDS[dev.type], store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    try:
        g = group if group is not None else dist.group.WORLD
        backend = dist.get_backend(g)
        if backend != BACKENDS[dev.type]:
            raise ValueError(f"a {backend} group cannot drive {dev.type} tensors; the "
                             f"sharded engine takes {BACKENDS[dev.type]} there")
        yield g, dist.get_rank(g), dist.get_world_size(g), dev
    finally:
        if created:
            dist.destroy_process_group()
