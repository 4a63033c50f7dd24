"""Vectorized k-mer extraction (port of ``sequence_aligner_tpu/ops/kmer.py``).

The reference's per-read k-mer loop (src/BioLibs.scala:54-61 with the
seqHash packing of src/ObjectStore.scala:48-67) as tensor ops over the whole
read batch: the rolling 2-bit hash is an unrolled shift/xor over k slices
(only the first min(k, 16) bases contribute, like the reference's 16-base
cap), wrapping in int32 exactly as the JAX op does; ``loc = i / (len - k)``
is computed in float32 (0/0 -> NaN like the reference).

Output is a flat occurrence table (hash, read_id, loc, valid, pos), each
[N * (L - k + 1)]; slots past a read's end are masked, not compacted.
``pos`` is the integer k-mer position that ``loc`` normalises: the
prescreen's collision diagonals are differences of it, never recovered
from the float ``loc``.
"""

from __future__ import annotations

import torch

_MASK32 = (1 << 32) - 1


def kmer_scan(bases: torch.Tensor, lengths: torch.Tensor,
              read_ids: torch.Tensor, k: int) -> dict[str, torch.Tensor]:
    """bases [N, L] int8, lengths [N] int32, read_ids [N] int32 ->
    dict(hash int32, read_id int32, loc float32, valid bool, pos int32),
    each [N * (L - k + 1)], on the device of ``bases``."""
    n, l = bases.shape
    dev = bases.device
    npos = max(l - k + 1, 0)
    if npos == 0 or k <= 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return dict(hash=z, read_id=z.clone(),
                    loc=torch.zeros(0, dtype=torch.float32, device=dev),
                    valid=torch.zeros(0, dtype=torch.bool, device=dev), pos=z.clone())
    b = bases.to(torch.int64)
    # int64 with a 32-bit mask is the int32 wrap of (h << 2) ^ code
    h = torch.zeros((n, npos), dtype=torch.int64, device=dev)
    for t in range(min(k, 16)):
        h = ((h << 2) ^ b[:, t : t + npos]) & _MASK32
    h = torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)
    pos = torch.arange(npos, dtype=torch.int32, device=dev)[None, :]
    lengths = lengths.to(device=dev, dtype=torch.int32)
    denom = (lengths - k).to(torch.float32)[:, None]
    loc = pos.to(torch.float32) / denom
    valid = pos <= (lengths[:, None] - k)
    rid = read_ids.to(device=dev, dtype=torch.int32)[:, None].expand(n, npos)
    return dict(
        hash=h.reshape(-1),
        read_id=rid.reshape(-1).contiguous(),
        loc=loc.reshape(-1),
        valid=valid.reshape(-1),
        pos=pos.expand(n, npos).reshape(-1),
    )
