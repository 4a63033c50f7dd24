"""Candidate-pair generation as sorted-array joins.

Port of ``sequence_aligner_tpu/ops/pairgen.py``.  The reference's hash
tables (``calcPairData`` + ``calcDispatchData``, src/KmerTable.scala:85-187)
become sort and segment ops:

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
  5. pairs aggregate by one sort of int64 keys (``pair_counts``); run
     lengths inside [min_collisions, max_collisions] are kept
     (``band_pairs``).  The sharded engine sums each pair's counts across
     ranks between the two, so the band sees global counts.

The key is (lead << 32 | trail), one int64 for any int32 read id: the JAX
package's two branches (a 16-bit packed key for ids that fit it, the
reference's own ceiling, src/KmerTable.scala:73, and a (fst, snd)
lexicographic sort past it) exist because the TPU has no int64, and both
give this table.  The optional diagonal-coherence prescreen sorts (key,
diagonal) as one int64, so it keys (lead << 16 | trail) and needs ids that
fit 16 bits (the engine screens only there, as the JAX engine does); it
keeps a run of two or more collisions only if two adjacent diagonals lie
within the window.

Unlike XLA, PyTorch has int64 and dynamic shapes, so the JAX package's hi/lo
split sums, sign-flipped int32 keys and packed sort payloads are not needed.
The JAX package's ``aggregate_pairs`` has no caller there and is not ported.
"""

from __future__ import annotations

import torch

# slots of one class's raw-pair stream expanded at a time (bounds the
# per-chunk temporaries to a few hundred MB)
EXPAND_CHUNK = 1 << 24
# prescreen: (key << 31 | diagonal + _DIAG_BIAS) sorts as one int64; the key
# (lead << 16 | trail) takes 32 bits and diagonals lie well inside +-2^30
MAX_SCREEN_ID = (1 << 16) - 1
_DIAG_BIAS = 1 << 30


def sort_occurrences(occ: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Valid occurrences only, sorted by hash (ties in no fixed order):
    dict(hash int32, read_id int32, loc float32, and pos int32 where the
    table has it)."""
    v = occ["valid"]
    h, perm = torch.sort(occ["hash"][v])
    return dict(hash=h, **{f: t[v][perm] for f, t in occ.items()
                           if f not in ("hash", "valid")})


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


def _expand_class(occ_s, edge, mid_cnt, mid_base, mid_rows, *, cap: int, chunk: int,
                  shift: int, with_diag: bool):
    """Keys (lead << shift | trail, int64) of the valid pairs among the first
    ``cap`` slots of one edge class's raw-pair stream, with their collision
    diagonals (pos_lead - pos_trail) when ``with_diag``, and the stream's
    full length."""
    rows = torch.nonzero(edge & (mid_cnt > 0))[:, 0]
    npairs = mid_cnt[rows]
    incl = torch.cumsum(npairs, 0)
    total = int(incl[-1]) if rows.numel() else 0
    rid = occ_s["read_id"].to(torch.int64)
    loc = occ_s["loc"]
    keys, diags = [], []
    for t0 in range(0, min(total, cap), chunk):
        t = torch.arange(t0, min(t0 + chunk, total, cap), device=rows.device)
        q = torch.searchsorted(incl, t, right=True)  # slot -> source row
        a = rows[q]
        b = mid_rows[mid_base[a] + t - (incl[q] - npairs[q])]
        ra, rb = rid[a], rid[b]
        a_first = loc[a] > loc[b]  # strictly greater loc leads (:65-71)
        ok = ra != rb  # self pairs skipped (:61-63)
        keys.append(torch.where(a_first, (ra << shift) | rb, (rb << shift) | ra)[ok])
        if with_diag:
            d = occ_s["pos"][a] - occ_s["pos"][b]
            diags.append(torch.where(a_first, d, -d)[ok].to(torch.int64))
    return keys, diags, total


def _screen_passes(keys: torch.Tensor, diags: torch.Tensor, cnt: torch.Tensor,
                   window: int) -> torch.Tensor:
    """Per run of equal keys (sorted by key, then diagonal): does some
    adjacent pair of its collisions lie within ``window`` diagonals?
    (``_finish_core``'s ``diag_s`` branch.)"""
    mark = torch.zeros(keys.numel(), dtype=torch.int64, device=keys.device)
    mark[1:] = (keys[1:] == keys[:-1]) & ((diags[1:] - diags[:-1]) <= window)
    cm = torch.cumsum(mark, 0)
    ends = torch.cumsum(cnt, 0)
    starts = ends - cnt
    return (cm[ends - 1] - cm[starts]) > 0


def pair_counts(
    occ_s, *, head_edge, tail_edge, mid_lead, mid_tail, cap_head: int, cap_tail: int,
    prescreen_w: int | None = None, chunk: int = EXPAND_CHUNK,
):
    """Run-length counts of the raw pair keys, before the collision band.

    Returns (uniq, counts, h_tot, t_tot): the distinct int64 keys (lead <<
    32 | trail, or lead << 16 | trail under the prescreen) in ascending
    order, the collisions of each (int64), and the full raw stream lengths.
    The streams cover their first cap_head / cap_tail slots.  With
    ``prescreen_w`` the runs of two or more collisions that fail the
    diagonal-coherence screen are dropped here (the occurrences must then
    carry ``pos`` and read ids up to 65,535); the band alone drops the
    rest."""
    rid = occ_s["read_id"]
    dev = rid.device
    screen = bool(prescreen_w)
    if screen and rid.numel() and int(rid.max()) > MAX_SCREEN_ID:
        raise ValueError(f"the prescreen's 16-bit pair key takes read ids up to {MAX_SCREEN_ID}")
    shift = 16 if screen else 32
    is_head, is_mid, is_tail = _classes(occ_s, head_edge, tail_edge, mid_lead, mid_tail)
    if rid.numel():
        mid_cnt, mid_base = _seg_mid_counts(occ_s["hash"], is_mid)
    else:
        mid_cnt = mid_base = torch.zeros(0, dtype=torch.int64, device=dev)
    mid_rows = torch.nonzero(is_mid)[:, 0]
    kw = dict(chunk=chunk, shift=shift, with_diag=screen)
    keys_h, diags_h, h_tot = _expand_class(occ_s, is_head, mid_cnt, mid_base, mid_rows,
                                           cap=cap_head, **kw)
    keys_t, diags_t, t_tot = _expand_class(occ_s, is_tail, mid_cnt, mid_base, mid_rows,
                                           cap=cap_tail, **kw)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    keys = torch.cat(keys_h + keys_t) if keys_h or keys_t else empty
    del keys_h, keys_t
    if screen:
        diags = torch.cat(diags_h + diags_t) if diags_h or diags_t else empty
        comb = torch.sort((keys << 31) | (diags + _DIAG_BIAS)).values
        keys, diags = comb >> 31, (comb & ((1 << 31) - 1)) - _DIAG_BIAS
        del comb
    else:
        keys = torch.sort(keys).values
    uniq, cnt = torch.unique_consecutive(keys, return_counts=True)
    if screen:  # size-1 runs exempt
        ok = _screen_passes(keys, diags, cnt, int(prescreen_w)) | (cnt < 2)
        uniq, cnt = uniq[ok], cnt[ok]
    return uniq, cnt, h_tot, t_tot


def band_pairs(uniq, cnt, *, min_collisions: int, max_collisions: int, cap_out: int,
               shift: int = 32):
    """The collision band and compaction of ``pair_counts``' runs: returns
    dict(lead, trail, count) — [cap_out] int32, the runs with
    min_collisions <= count <= max_collisions in key order, then zeros — and
    n_out, the kept runs (which may pass cap_out)."""
    keep = (cnt >= int(min_collisions)) & (cnt <= int(max_collisions))
    uniq, cnt = uniq[keep], cnt[keep]
    n_out = int(uniq.numel())
    m = min(n_out, cap_out)
    out = {f: torch.zeros(cap_out, dtype=torch.int32, device=uniq.device)
           for f in ("lead", "trail", "count")}
    out["lead"][:m] = (uniq[:m] >> shift).to(torch.int32)
    out["trail"][:m] = (uniq[:m] & ((1 << shift) - 1)).to(torch.int32)
    out["count"][:m] = cnt[:m].to(torch.int32)
    return dict(out, n_out=n_out)


def candidate_pairs_stream(
    occ_s, *, head_edge, tail_edge, mid_lead, mid_tail,
    min_collisions: int, max_collisions: int,
    cap_head: int, cap_tail: int, cap_out: int,
    prescreen_w: int | None = None, chunk: int = EXPAND_CHUNK,
):
    """Candidate pairs from hash-sorted occurrences (``sort_occurrences``):
    ``pair_counts``, then ``band_pairs``.

    Returns dict(lead, trail, count) — [cap_out] int32, the kept pairs in
    (lead, trail) order followed by zeros — and n_out, h_tot, t_tot (ints)
    and overflow (bool), as the JAX function does: the streams cover their
    first cap_head / cap_tail slots, and overflow is set when a stream or
    the kept pairs exceed their capacity.

    ``prescreen_w`` turns on the diagonal-coherence prescreen with that
    window; the occurrences must then carry ``pos`` and read ids up to
    65,535."""
    uniq, cnt, h_tot, t_tot = pair_counts(
        occ_s, head_edge=head_edge, tail_edge=tail_edge, mid_lead=mid_lead,
        mid_tail=mid_tail, cap_head=cap_head, cap_tail=cap_tail,
        prescreen_w=prescreen_w, chunk=chunk)
    out = band_pairs(uniq, cnt, min_collisions=min_collisions,
                     max_collisions=max_collisions, cap_out=cap_out,
                     shift=16 if prescreen_w else 32)
    overflow = h_tot > cap_head or t_tot > cap_tail or out["n_out"] > cap_out
    return dict(out, h_tot=h_tot, t_tot=t_tot, overflow=overflow)
