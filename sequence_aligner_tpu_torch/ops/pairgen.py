"""Candidate-pair generation as sorted-array joins.

Port of ``sequence_aligner_tpu/ops/pairgen.py`` (the packed 16-bit-id path).
The reference's hash tables (``calcPairData`` + ``calcDispatchData``,
src/KmerTable.scala:85-187) become sort and segment ops:

  1. the valid occurrences are sorted by hash once; equal hashes form
     segments;
  2. positional classes (head edge / middle / tail edge, the geometry of
     src/ObjectStore.scala:32-35) are masks over the sorted table; each
     segment's middle rows are addressable by rank through a prefix count;
  3. every edge occurrence is crossed with its segment's middle rows — a
     flat stream of raw pairs whose exact length per class comes from
     ``plan_totals`` — expanded in chunks so memory stays bounded;
  4. pair order follows addKmerPair (src/KmerTable.scala:57-80): self pairs
     drop and the occurrence with strictly greater loc leads;
  5. pairs aggregate by one sort of (lead << 16 | trail) keys; run lengths
     inside [min_collisions, max_collisions] are kept.

Read ids must fit 16 bits (the reference's own ceiling: it packs pairs as
(id << 16) ^ id, src/KmerTable.scala:73).  The JAX package's general-id
path for 65,536 reads or more is not ported yet, so larger inputs raise.

Unlike XLA, PyTorch has int64 and dynamic shapes, so the JAX package's hi/lo
split sums, sign-flipped int32 keys and packed sort payloads are not needed.
"""

from __future__ import annotations

import torch

# slots of one class's raw-pair stream expanded at a time (bounds the
# per-chunk temporaries to a few hundred MB)
EXPAND_CHUNK = 1 << 24
MAX_READ_ID = (1 << 16) - 1


def sort_occurrences(occ: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Valid occurrences only, sorted by hash (ties in no fixed order):
    dict(hash int32, read_id int32, loc float32)."""
    v = occ["valid"]
    h, perm = torch.sort(occ["hash"][v])
    return dict(hash=h, read_id=occ["read_id"][v][perm], loc=occ["loc"][v][perm])


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def _classes(occ_s, head_edge, tail_edge, mid_lead, mid_tail):
    loc = occ_s["loc"]
    d = loc.device
    is_head = loc <= _f32(head_edge, d)
    is_mid = (_f32(mid_lead, d) <= loc) & (loc <= _f32(mid_tail, d))
    is_tail = loc >= _f32(tail_edge, d)
    return is_head, is_mid, is_tail


def _seg_mid_counts(h: torch.Tensor, is_mid: torch.Tensor):
    """Per row: (middle-class count of its hash segment, rank of the
    segment's first middle row among all middle rows), both int64."""
    n = h.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=h.device)
    first[1:] = h[1:] != h[:-1]
    seg = torch.cumsum(first, 0) - 1
    starts = torch.nonzero(first)[:, 0]
    ends = torch.cat([starts[1:], torch.tensor([n], device=h.device)])
    incl = torch.cat([torch.zeros(1, dtype=torch.int64, device=h.device),
                      torch.cumsum(is_mid, 0)])
    seg_base = incl[starts]
    seg_cnt = incl[ends] - seg_base
    return seg_cnt[seg], seg_base[seg]


def plan_totals(occ_s, *, head_edge, tail_edge, mid_lead, mid_tail) -> tuple[int, int]:
    """Exact raw head x middle and tail x middle cross-product totals
    (calcPairData's accounting, src/KmerTable.scala:105-128) as Python
    ints, summed in int64 on the device."""
    is_head, is_mid, is_tail = _classes(occ_s, head_edge, tail_edge, mid_lead, mid_tail)
    if occ_s["hash"].numel() == 0:
        return 0, 0
    mid_cnt, _ = _seg_mid_counts(occ_s["hash"], is_mid)
    h_tot = torch.where(is_head, mid_cnt, 0).sum()
    t_tot = torch.where(is_tail, mid_cnt, 0).sum()
    return int(h_tot), int(t_tot)


def _expand_class(occ_s, edge, mid_cnt, mid_base, mid_rows, *, cap: int, chunk: int):
    """Packed keys (lead << 16 | trail, int64) of the valid pairs among the
    first ``cap`` slots of one edge class's raw-pair stream, and the
    stream's full length."""
    rows = torch.nonzero(edge & (mid_cnt > 0))[:, 0]
    npairs = mid_cnt[rows]
    incl = torch.cumsum(npairs, 0)
    total = int(incl[-1]) if rows.numel() else 0
    rid = occ_s["read_id"].to(torch.int64)
    loc = occ_s["loc"]
    keys = []
    for t0 in range(0, min(total, cap), chunk):
        t = torch.arange(t0, min(t0 + chunk, total, cap), device=rows.device)
        q = torch.searchsorted(incl, t, right=True)  # slot -> source row
        a = rows[q]
        b = mid_rows[mid_base[a] + t - (incl[q] - npairs[q])]
        ra, rb = rid[a], rid[b]
        a_first = loc[a] > loc[b]  # strictly greater loc leads (:65-71)
        key = torch.where(a_first, (ra << 16) | rb, (rb << 16) | ra)
        keys.append(key[ra != rb])  # self pairs skipped (:61-63)
    return keys, total


def candidate_pairs_stream(
    occ_s, *, head_edge, tail_edge, mid_lead, mid_tail,
    min_collisions: int, max_collisions: int,
    cap_head: int, cap_tail: int, cap_out: int,
    chunk: int = EXPAND_CHUNK,
):
    """Candidate pairs from hash-sorted occurrences (``sort_occurrences``).

    Returns dict(lead, trail, count) — int32 [cap_out], the kept pairs in
    (lead, trail) order followed by zeros — and n_out, h_tot, t_tot (ints)
    and overflow (bool), as the JAX function does: the streams cover their
    first cap_head / cap_tail slots, and overflow is set when a stream or
    the kept pairs exceed their capacity."""
    rid = occ_s["read_id"]
    dev = rid.device
    if rid.numel() and int(rid.max()) > MAX_READ_ID:
        raise ValueError(
            f"read ids above {MAX_READ_ID} need the general-id pair path, "
            "which this port does not have yet"
        )
    is_head, is_mid, is_tail = _classes(occ_s, head_edge, tail_edge, mid_lead, mid_tail)
    if rid.numel():
        mid_cnt, mid_base = _seg_mid_counts(occ_s["hash"], is_mid)
    else:
        mid_cnt = mid_base = torch.zeros(0, dtype=torch.int64, device=dev)
    mid_rows = torch.nonzero(is_mid)[:, 0]
    keys_h, h_tot = _expand_class(occ_s, is_head, mid_cnt, mid_base, mid_rows,
                                  cap=cap_head, chunk=chunk)
    keys_t, t_tot = _expand_class(occ_s, is_tail, mid_cnt, mid_base, mid_rows,
                                  cap=cap_tail, chunk=chunk)
    keys = torch.cat(keys_h + keys_t) if keys_h or keys_t else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    keys = torch.sort(keys).values
    uniq, cnt = torch.unique_consecutive(keys, return_counts=True)
    keep = (cnt >= int(min_collisions)) & (cnt <= int(max_collisions))
    uniq, cnt = uniq[keep], cnt[keep]
    n_out = int(uniq.numel())
    m = min(n_out, cap_out)
    out = {f: torch.zeros(cap_out, dtype=torch.int32, device=dev)
           for f in ("lead", "trail", "count")}
    out["lead"][:m] = (uniq[:m] >> 16).to(torch.int32)
    out["trail"][:m] = (uniq[:m] & 0xFFFF).to(torch.int32)
    out["count"][:m] = cnt[:m].to(torch.int32)
    overflow = h_tot > cap_head or t_tot > cap_tail or n_out > cap_out
    return dict(out, n_out=n_out, h_tot=h_tot, t_tot=t_tot, overflow=overflow)
