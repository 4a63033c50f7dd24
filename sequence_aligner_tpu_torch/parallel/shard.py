"""Sharded overlap engine on ``torch.distributed`` (port of
``sequence_aligner_tpu/parallel/shard.py``).

The JAX engine runs two ``shard_map`` programs over a 1-D device mesh; here
every rank of a process group runs the same plain functions on its own
device, and the collectives are ``all_to_all_single`` and ``all_gather``:

``sharded_plan_step`` (``make_sharded_plan_step``), steps 1-3, and
``sharded_pairs_step`` (``make_sharded_pairs_step``), steps 4-5:
  1. ``kmer_scan`` on the rank's block of reads, with global read ids;
  2. each occurrence goes to rank ``hash mod world``, the hash taken as
     uint32 (the JAX rule, so every rank holds whole hash groups);
  3. ``sort_occurrences`` and ``plan_totals``, with the single-device
     engine's stream guard applied to every rank;
  4. ``pair_counts``: the rank's distinct pair keys and their collisions;
  5. above one rank, each (key, partial count) row goes to its owner rank
     ``(lead * 2654435761 ^ trail) mod world`` in uint32 (the JAX rule),
     which sums the partials: the collision band (``band_pairs``) sees
     global counts, as the reference's does.  One rank owns every pair and
     skips that exchange, as the JAX engine does.

``sharded_align_step`` (``make_sharded_align_step``, ``_fetch_read_rows``),
steps 6-7:
  6. the rank marks the read ids its pairs touch and requests each row once
     from its owner, rank ``(id - 1) // n_local``; the responses come back
     in request order;
  7. the single-device engine's split-phase aligner
     (``Overlapper._align_device``, which launches ``phase1_indexed`` and
     ``phase2_indexed``) runs on the fetched table, and the results' ids
     are mapped back to global read ids.

``sharded_overlap`` gathers every rank's records to every rank and sorts
them canonically.  Every exchange first sends the per-destination counts,
then the rows with exact split sizes, so nothing is sized in advance: the
JAX engine's capacity bins, drop counters and retries exist because XLA
needs static shapes (the same choice as the single-device port's pair keys,
``ops/pairgen.py``).  Every rank issues every collective in the same order,
also with nothing to send.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from sequence_aligner_tpu_torch.core.records import OverlapRecord
from sequence_aligner_tpu_torch.core.settings import AlignSettings
from sequence_aligner_tpu_torch.models.overlapper import _MAX_STREAM, Overlapper
from sequence_aligner_tpu_torch.ops.encode import encode_reads
from sequence_aligner_tpu_torch.ops.kmer import kmer_scan
from sequence_aligner_tpu_torch.ops.pairgen import (
    band_pairs, pair_counts, plan_totals, sort_occurrences,
)
from sequence_aligner_tpu_torch.parallel.mesh import make_group

# the JAX engine's capacity names (sharded_overlap's ``caps``)
JAX_CAPS = frozenset({
    "cap_route", "cap_head", "cap_tail", "cap_agg", "cap_pair_route", "cap_out",
    "cap_align", "cap_uniq", "cap_fetch", "cap_width",
})
_M32 = 0xFFFFFFFF
_PAIR_HASH = 2654435761  # the pair-owner multiplier of the JAX engine


@dataclasses.dataclass(frozen=True)
class Rank:
    """This process's place in the group."""

    group: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device


def _exchange(fields: dict[str, torch.Tensor], target: torch.Tensor, r: Rank):
    """Send row i of every field (equal first dimensions) to rank
    ``target[i]``.

    Returns (received, order, recv_counts): the received fields, grouped by
    source rank in rank order, each source's rows in the order it sent them;
    ``order``, the permutation that put this rank's rows in sending order
    (stable by target); the rows received from each rank."""
    order = torch.sort(target, stable=True).indices
    send = torch.bincount(target, minlength=r.world)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=r.group)
    send_l, recv_l = send.tolist(), recv.tolist()
    out = {}
    for name, t in fields.items():
        dst = t.new_empty((sum(recv_l), *t.shape[1:]))
        dist.all_to_all_single(dst, t[order].contiguous(), recv_l, send_l, group=r.group)
        out[name] = dst
    return out, order, recv_l


def _geom(s: AlignSettings) -> dict:
    return dict(head_edge=s.kmer_head_edge, tail_edge=s.kmer_tail_edge,
                mid_lead=s.kmer_mid_lead_edge, mid_tail=s.kmer_mid_tail_edge)


def sharded_plan_step(bases_d, lengths_d, ids_d, s: AlignSettings, r: Rank):
    """Steps 1-3 on this rank's block of reads (``ids_d`` global, 0 for
    padding).  Returns the hash-sorted occurrences of the hashes this rank
    owns and their raw (head, tail) stream totals."""
    occ = kmer_scan(bases_d, lengths_d, ids_d, s.kmer_size)
    v = occ["valid"]
    h = occ["hash"][v]
    got, _, _ = _exchange(dict(hash=h, read_id=occ["read_id"][v], loc=occ["loc"][v]),
                          (h.to(torch.int64) & _M32) % r.world, r)
    del occ, v, h
    got["valid"] = torch.ones_like(got["hash"], dtype=torch.bool)
    occ_s = sort_occurrences(got)
    h_tot, t_tot = plan_totals(occ_s, **_geom(s))
    # every rank raises together, or the others would wait in a collective
    top = torch.tensor([h_tot, t_tot], dtype=torch.int64, device=r.device)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=r.group)
    if int(top.max()) > _MAX_STREAM:
        raise RuntimeError(
            f"raw candidate stream too large for one device (head={int(top[0])}, "
            f"tail={int(top[1])}, max={_MAX_STREAM}): lower --max-collisions to cap "
            f"repeat-rich k-mers")
    return occ_s, h_tot, t_tot


def sharded_pairs_step(occ_s, h_tot: int, t_tot: int, s: AlignSettings, r: Rank):
    """Steps 4-5 on ``sharded_plan_step``'s output: (lead, trail) int32
    tensors of the pairs this rank owns, in (lead, trail) order."""
    keys, cnt, _, _ = pair_counts(occ_s, **_geom(s), cap_head=h_tot, cap_tail=t_tot)
    if r.world > 1:
        fst, snd = keys >> 32, keys & _M32
        owner = (((fst * _PAIR_HASH) & _M32) ^ snd) % r.world
        got, _, _ = _exchange(dict(key=keys, cnt=cnt), owner, r)
        keys, perm = torch.sort(got["key"])
        keys, run = torch.unique_consecutive(keys, return_counts=True)
        ends = torch.cumsum(got["cnt"][perm], 0)[torch.cumsum(run, 0) - 1]
        cnt = torch.diff(ends, prepend=ends.new_zeros(1))
    out = band_pairs(keys, cnt, min_collisions=s.min_collisions,
                     max_collisions=s.max_collisions, cap_out=keys.numel())
    n = out["n_out"]
    return out["lead"][:n], out["trail"][:n]


def _fetch_read_rows(ids, bases_d, lengths_d, n_local: int, r: Rank):
    """Rows and lengths of the (ascending, 1-based) read ids ``ids`` from
    the ranks that hold them: one request each, answered in request
    order."""
    got, order, recv_counts = _exchange(dict(rid=ids), (ids.long() - 1) // n_local, r)
    local = got["rid"].long() - 1 - r.rank * n_local
    src = torch.repeat_interleave(
        torch.arange(r.world, device=r.device),
        torch.tensor(recv_counts, dtype=torch.int64, device=r.device))
    back, _, _ = _exchange(dict(rows=bases_d[local], lens=lengths_d[local]), src, r)
    rows = torch.empty_like(back["rows"])
    lens = torch.empty_like(back["lens"])
    rows[order] = back["rows"]
    lens[order] = back["lens"]
    return rows, lens


def sharded_align_step(bases_d, lengths_d, lead, trail, n_local: int, ov: Overlapper,
                       r: Rank):
    """Steps 6-7 on this rank's pairs: (lead, trail, ahg, bhg) host int32
    arrays of its valid overlaps, in global read ids."""
    ids = torch.unique(torch.cat([lead, trail]))
    rows, lens = _fetch_read_rows(ids, bases_d, lengths_d, n_local, r)
    a = torch.searchsorted(ids, lead).int() + 1  # rows of the fetched table, 1-based
    b = torch.searchsorted(ids, trail).int() + 1
    la, tr, ahg, bhg = ov._align_device(rows, lens.cpu().numpy(), a, b, int(lead.numel()))
    ids_h = ids.cpu().numpy().astype(np.int32)
    return ids_h[la - 1], ids_h[tr - 1], ahg, bhg


def _gather_rows(local: np.ndarray, n_pairs: int, r: Rank):
    """Every rank's [m, 4] int32 rows, concatenated in rank order, on every
    rank, and each rank's kept-pair count."""
    dev = r.device
    mine = torch.tensor([local.shape[0], n_pairs], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(mine) for _ in range(r.world)]
    dist.all_gather(counts, mine, group=r.group)
    counts = [c.tolist() for c in counts]
    top = max(c[0] for c in counts)
    buf = torch.zeros((top, 4), dtype=torch.int32, device=dev)
    buf[: local.shape[0]] = torch.from_numpy(local).to(dev)
    parts = [torch.empty_like(buf) for _ in range(r.world)]
    dist.all_gather(parts, buf, group=r.group)
    rows = torch.cat([p[: c[0]] for p, c in zip(parts, counts)]).cpu().numpy()
    return rows, [c[1] for c in counts]


def check_caps(caps: dict | None) -> None:
    """Accept the JAX engine's capacity names, refuse any other."""
    bad = sorted(set(caps or ()) - JAX_CAPS)
    if bad:
        raise ValueError(f"unknown capacities {bad}; the JAX engine's are {sorted(JAX_CAPS)}")


def sharded_overlap_arrays(seqs, s: AlignSettings, group: dist.ProcessGroup | None = None,
                           *, device: str | torch.device = "cuda", caps: dict | None = None,
                           stats: dict | None = None):
    """``sharded_overlap`` as canonical (lead, trail, ahg, bhg) int32 numpy
    arrays sorted by (lead, trail), the same on every rank.  ``stats``, when
    given, is filled with ``stage_s`` (host seconds by stage, each ended by
    a device synchronise), ``pairs_by_rank`` (each rank's kept pairs),
    ``records``, ``world`` and ``backend`` (the group's)."""
    check_caps(caps)
    t0 = time.perf_counter()
    stage_s = {}
    with make_group(group, device=device) as (g, rank, world, dev):
        def mark(name):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            stage_s[name] = time.perf_counter() - t0 - sum(stage_s.values())

        r = Rank(g, rank, world, dev)
        bases, lengths = encode_reads(seqs)
        n = bases.shape[0]
        pad = (-n) % world  # empty reads of id 0, as the JAX engine pads
        ids = np.concatenate([np.arange(1, n + 1, dtype=np.int32), np.zeros(pad, np.int32)])
        if pad:
            bases = np.pad(bases, ((0, pad), (0, 0)))
            lengths = np.pad(lengths, (0, pad))
        n_local = (n + pad) // world
        blk = slice(rank * n_local, (rank + 1) * n_local)
        bases_d = torch.from_numpy(bases[blk]).to(dev)
        lengths_d = torch.from_numpy(lengths[blk]).to(dev)
        occ_s, h_tot, t_tot = sharded_plan_step(
            bases_d, lengths_d, torch.from_numpy(ids[blk]).to(dev), s, r)
        mark("plan")
        lead, trail = sharded_pairs_step(occ_s, h_tot, t_tot, s, r)
        del occ_s
        mark("pairs")
        ov = Overlapper(s, device=dev)
        local = np.stack(sharded_align_step(bases_d, lengths_d, lead, trail, n_local, ov, r),
                         axis=1).astype(np.int32)
        mark("align_dispatch")
        rows, pairs_by_rank = _gather_rows(local, int(lead.numel()), r)
        order = np.lexsort((rows[:, 1], rows[:, 0]))
        arrs = tuple(np.ascontiguousarray(rows[order, i]) for i in range(4))
        mark("align_fetch_sort")
        backend = dist.get_backend(g)
    if int(os.environ.get("SEQALIGN_DIST_TIMING", "0")):
        print("# sharded_overlap timing " + json.dumps(dict(
            {k: round(v, 3) for k, v in stage_s.items()},
            total=round(time.perf_counter() - t0, 3), n_records=len(arrs[0]))),
            file=sys.stderr, flush=True)
    if stats is not None:
        stats.update(stage_s=stage_s, pairs_by_rank=pairs_by_rank, records=len(arrs[0]),
                     world=world, backend=backend)
    return arrs


def sharded_overlap(seqs, s: AlignSettings, group: dist.ProcessGroup | None = None, *,
                    device: str | torch.device = "cuda", caps: dict | None = None,
                    stats: dict | None = None) -> list[OverlapRecord]:
    """Overlap records of ``seqs`` by the sharded engine over ``group``'s
    ranks (one device each), returned on every rank in canonical order.

    ``group`` None runs one rank on ``device`` (``parallel.mesh.make_group``).
    Every rank passes the same reads.  ``caps`` takes the JAX engine's
    capacity names and has no effect: every exchange here is sized from
    the counts it sends first, so there is no capacity to set (any other
    name raises ``ValueError``).  Under ``SEQALIGN_DIST_TIMING=1`` the
    stage times go to stderr as the JAX engine's ``# sharded_overlap
    timing`` line.  ``stats``: as ``sharded_overlap_arrays``."""
    arrs = sharded_overlap_arrays(seqs, s, group, device=device, caps=caps, stats=stats)
    return OverlapRecord.bulk_build(*(c.tolist() for c in arrs))
