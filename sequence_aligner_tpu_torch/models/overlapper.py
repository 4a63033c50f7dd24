"""The end-to-end overlap engine (port of ``sequence_aligner_tpu/models``).

The reference's production call stack (src/Project4.scala:56-59: k-mer table
-> candidate dispatch -> block alignment -> OVL emission) as tensor stages on
one device:

  encode (host) -> kmer_scan -> hash sort + exact capacity plan ->
  candidate_pairs_stream -> per band width, one of two routes -> validity
  -> canonical (lead, trail) order.

The two align routes are the JAX engine's, chosen by its rule for each
band-width group of ``cnt`` pairs: the both-phase ("mono") route when
``cnt <= 2^21`` (``SEQALIGN_ALIGN_MONO=1`` forces it up to 2^25 pairs,
``=0`` forces the split route), else the split route.

  mono   one phase-1 launch over the whole group, the dove anchor
         (``dovetail_glue``), one phase-2 launch over every pair, duds
         included, at the group's full rows.
  split  phase 1 on every pair (most candidates dud there and stop) ->
         dove-length histogram and tiers (planned unless
         ``SEQALIGN_ADAPTIVE_TIERS=0``) -> phase 2 on the pairs that can
         still be valid, one tier at a time, each launch looping at most
         the tier's top dove length in rows.

Both give the same records; ``OverlapStats`` counts what each loops over,
as the JAX engine counts it.

Pair generation keys pairs as one int64 for any read id.  The JAX engine
picks its packed 16-bit-id pair path when the read count's padded tier (the
next power of two from 256, which it pads its read matrix to) is below 2^16,
so at most 32,768 reads; records do not depend on that choice, but the
opt-in prescreen does, and the port computes the same tier to activate the
screen exactly where the JAX engine does (packed ids, one read length,
``prescreen=True``).

The pair table, the per-pair dove lengths and the alignment results stay
on the device until the valid records are fetched once.

``fast_dovetail=False`` aligns every candidate with the quadratic full
Smith-Waterman of ``ops.align_lax`` instead (the reference's
``--quadratic-align``), in chunks whose int8 traceback codes stay within
``QUAD_DIRS_BUDGET`` bytes; the records do not depend on the chunk size.

A FASTA path is read by the native reader (``native.fasta_encode_native``,
and its scan and chunk reader for ``run_stream_arrays``), the JAX engine's
own reader, so both engines take the same bytes as the same reads.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import math
import os
import time
import warnings

import numpy as np
import torch

from sequence_aligner_tpu_torch.core.records import OverlapRecord, Sequence
from sequence_aligner_tpu_torch.core.settings import AlignSettings
from sequence_aligner_tpu_torch.device import resolve_device
from sequence_aligner_tpu_torch.native import (
    fasta_encode_chunks_native, fasta_encode_native, fasta_scan_native,
)
from sequence_aligner_tpu_torch.ops.align_fused import (
    check_pair_indices, dovetail_glue, fast_dovetail_batch, pack_reads_le, phase1_indexed,
    phase2_indexed, phase2_results,
)
from sequence_aligner_tpu_torch.ops.align_lax import OUT_KEYS, local_align_batch
from sequence_aligner_tpu_torch.ops.encode import encode_reads
from sequence_aligner_tpu_torch.ops.kmer import kmer_scan
from sequence_aligner_tpu_torch.ops.pairgen import (
    candidate_pairs_stream, plan_totals, sort_occurrences,
)
from sequence_aligner_tpu_torch.utils.debug import debug_enabled, printdb, time_report
from sequence_aligner_tpu_torch.utils.profiling import device_memory_stats

# Per-class raw-stream ceiling for one device (the JAX engine's bound; its
# int64 keys alone would be 16 GB here).
_MAX_STREAM = (2**31 - 1) * 8 // 9
# the JAX engine's route rule for a band-width group of cnt pairs: the
# both-phase route at or below MONO_AUTO pairs, never above MONO_MAX
MONO_AUTO, MONO_MAX = 1 << 21, 1 << 25
# bytes of int8 traceback codes one chunk of the quadratic path may hold:
# (la_max + 1)^2 a pair, 10,201 at 100 bp, so a 2^20-pair batch would
# need 10.7 GB
QUAD_DIRS_BUDGET = 4 << 30


def _pow2_at_least(n: int, floor: int = 1024) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


def _cap_at_least(n: int, floor: int = 1024) -> int:
    """Capacity tier: next multiple of pow2/8 above n (<= 12.5% padding)."""
    p = _pow2_at_least(n, floor)
    step = p // 8
    return ((n + step - 1) // step) * step


@dataclasses.dataclass
class OverlapStats:
    n_reads: int = 0
    n_kmers: int = 0
    n_candidate_pairs: int = 0
    n_alignments: int = 0
    n_valid: int = 0
    # pairs that reach phase 2, the DP cells the launches loop over
    # (dp_cells) and the two-full-band volume (dp_cells_raw) — the JAX
    # engine's definitions, so the quadratic path counts none of either
    n_phase2_pairs: int = 0
    dp_cells: int = 0
    dp_cells_raw: int = 0
    # raw head x middle and tail x middle stream lengths of pair generation
    h_tot: int = 0
    t_tot: int = 0


def _dove_tiers(la_max: int, width: int, min_overlap: int, min_identity: float):
    """Static (lo, hi] dove-length buckets (copied from the JAX engine).

    Pairs below the first bucket are provably invalid and skipped: every
    backtrack step consumes a column, steps = du + dk + #Y with
    du <= dove_len, dk <= w, and gaps are errors, so
    steps * min_identity <= dove_len + w; validity needs
    steps >= min_overlap, hence dove_len >= min_overlap*min_identity - w."""
    lo0 = max(-1, int(math.floor(min_overlap * min_identity - width)) - 1)
    if la_max <= 48:
        return ((lo0, la_max),)
    t1 = max(width + 4, la_max // 3, lo0 + 1)
    t2 = max(2 * la_max // 3, t1 + 1)
    if t2 >= la_max:
        return ((lo0, t1), (t1, la_max))
    return ((lo0, t1), (t1, t2), (t2, la_max))


def _plan_tiers(counts, lo0: int, la_max: int, *, batch: int = 1 << 20,
                max_tiers: int = 5, over_rows: int = 31):
    """Work-optimal contiguous partition of dove lengths (lo0, la_max]
    into <= max_tiers (lo, hi] tiers (the JAX engine's planner, same
    result): a tier's cost is its padded pair count times
    (hi + 1 + over_rows), tier bounds on multiples of 8.  Any partition
    gives the same records.

    Two shortcuts keep long reads (thousands of edges) cheap without
    changing the result: pair counts come from a prefix sum, and an edge
    with no pair since the previous edge is never tried, as it cannot
    strictly beat that edge (the same pairs above it, a higher bound)."""
    cum = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)]).tolist()

    def seg_n(a: int, b: int) -> int:  # pairs with dlen in (a, b]
        return cum[b + 2] - cum[a + 2] if b > a else 0

    def padded(n: int) -> int:
        b = _pow2_at_least(min(batch, _pow2_at_least(n, 1024)), 128)
        return ((n + b - 1) // b) * b

    def cost(n: int, hi: int) -> int:
        return padded(n) * (hi + 1 + over_rows) if n else 0

    edges = [e for e in range(((lo0 // 8) + 1) * 8, la_max, 8) if e > lo0]
    # edges with a pair since the previous edge
    fresh = [e for e0, e in zip(edges, edges[1:]) if seg_n(e0, e)]
    memo = {}

    def solve(lo: int, k: int):
        n_all = seg_n(lo, la_max)
        if n_all == 0:
            return 0, []
        base = (cost(n_all, la_max), [(lo, la_max)])
        if k == 1:
            return base
        key = (lo, k)
        if key in memo:
            return memo[key]
        r = base
        t = bisect.bisect_right(edges, lo)
        tries = edges[t : t + 1] + fresh[bisect.bisect_right(fresh, edges[t]) :] \
            if t < len(edges) else []
        for e in tries:
            n1 = seg_n(lo, e)
            c2, t2 = solve(e, k - 1)
            c1 = cost(n1, e)
            if c1 + c2 < r[0]:
                r = (c1 + c2, ([(lo, e)] if n1 else []) + t2)
        memo[key] = r
        return r

    _, tiers = solve(lo0, max_tiers)
    return tuple(tiers) if tiers else ((lo0, la_max),)


class Overlapper:
    """Overlap engine on one device (``"cuda"`` unless the caller asks for
    ``"cpu"``, where the kernels' plain versions run).

    ``fast_dovetail=False`` takes the quadratic full Smith-Waterman in
    place of the two-phase banded dovetail aligner.  ``prescreen=True``
    turns on the diagonal-coherence candidate prescreen (``ops.pairgen``;
    empirically lossless, off by default, as in the JAX engine); None
    reads ``SEQALIGN_PRESCREEN`` (0 or 1), as the JAX engine does."""

    def __init__(self, settings: AlignSettings, *, fast_dovetail: bool = True,
                 batch_size: int = 1 << 20, prescreen: bool | None = None,
                 device: str | torch.device = "cuda"):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.s = settings
        self.fast_dovetail = fast_dovetail
        self.batch_size = batch_size
        if prescreen is None:
            prescreen = bool(int(os.environ.get("SEQALIGN_PRESCREEN", "0")))
        self.prescreen = prescreen
        self.device = resolve_device(device)
        self.stats = OverlapStats()
        self.stage_s: dict[str, float] = {}
        self._packed_ids = True
        self._uniform_den = 0

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Host clock around a stage, ended by a device synchronise."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stage_s[name] = self.stage_s.get(name, 0.0) + time.perf_counter() - t0

    # ---- stage 1+2: k-mer occurrences ----
    def _occurrences(self, bases_d: torch.Tensor, lengths: np.ndarray):
        n = bases_d.shape[0]
        # the JAX engine's gating, from the read tier it pads to: packed
        # 16-bit ids below a tier of 2^16 (the prescreen's rule); the uniform
        # read length's position range (pack_den) while (id << pos_bits |
        # pos) fits 31 bits
        n_tier = _pow2_at_least(n, 256)
        self._packed_ids = n_tier < (1 << 16)
        real = lengths[lengths > 0]
        den = int(real[0]) - self.s.kmer_size if real.size else 0
        self._uniform_den = (
            den if 0 < den and n_tier.bit_length() + den.bit_length() <= 31
            and bool((real == real[0]).all()) else 0
        )
        ids = torch.arange(1, n + 1, dtype=torch.int32, device=self.device)
        return kmer_scan(bases_d, torch.from_numpy(lengths).to(self.device), ids,
                         self.s.kmer_size)

    # ---- stage 3: candidate pairs ----
    def _geom(self):
        s = self.s
        return dict(head_edge=s.kmer_head_edge, tail_edge=s.kmer_tail_edge,
                    mid_lead=s.kmer_mid_lead_edge, mid_tail=s.kmer_mid_tail_edge)

    def _prescreen_w(self) -> int | None:
        """The prescreen's diagonal window where it is active (packed ids,
        one read length, ``prescreen=True``), else None.  Two collisions on
        one valid alignment's path differ in diagonal by at most its indel
        count <= floor((1 - min_identity) * align_len), align_len <=
        la + w + 2 (the JAX engine's window, min_identity as float32);
        ``SEQALIGN_PRESCREEN_W`` overrides it, as in the JAX engine."""
        s = self.s
        if not (self.prescreen and self._packed_ids and self._uniform_den):
            return None
        la = self._uniform_den + s.kmer_size
        w = int(s.band_width(la))
        tight = int((1.0 - float(s.min_identity)) * (la + w + 2))
        if float(s.min_identity) < 0.9 or s.min_overlap < 20:
            warnings.warn(
                "--prescreen's losslessness argument was validated "
                "in the amos_parity regime (min_identity ~0.98, "
                "min_overlap 40); at these permissive settings the "
                "window still scales with the indel budget, but "
                "off-path-collision candidacy becomes likelier — "
                "verify against an unscreened run before trusting "
                "record-level parity.",
                stacklevel=3,
            )
        return int(os.environ.get("SEQALIGN_PRESCREEN_W", max(tight, 1)))

    def _candidates_dev(self, occ):
        """The pair stream with capacities planned from the exact raw
        totals.  Returns (output dict, n_out)."""
        s = self.s
        occ_s = sort_occurrences(occ)
        with self._stage("pairgen.plan"):
            h_tot, t_tot = plan_totals(occ_s, **self._geom())
        printdb(f"pairgen plan: h_total={h_tot} t_total={t_tot}")
        if max(h_tot, t_tot) > _MAX_STREAM:
            raise RuntimeError(
                f"raw candidate stream too large for one device (head={h_tot}, "
                f"tail={t_tot}, max={_MAX_STREAM}): lower --max-collisions to "
                f"cap repeat-rich k-mers"
            )
        cap_head = _cap_at_least(h_tot, 1 << 14)
        cap_tail = _cap_at_least(t_tot, 1 << 14)
        # every kept pair carries >= min_collisions raw events
        out_bound = (h_tot + t_tot) // max(s.min_collisions, 1)
        cap_out = _cap_at_least(min(out_bound, h_tot + t_tot), 1 << 14)
        out = candidate_pairs_stream(
            occ_s, **self._geom(),
            min_collisions=s.min_collisions, max_collisions=s.max_collisions,
            cap_head=cap_head, cap_tail=cap_tail, cap_out=cap_out,
            prescreen_w=self._prescreen_w(),
        )
        self.stats.h_tot, self.stats.t_tot = out["h_tot"], out["t_tot"]
        if out["overflow"]:  # the exact plan rules this out
            raise RuntimeError(
                f"pair stream overflowed its planned capacity: h={h_tot}/{cap_head} "
                f"t={t_tot}/{cap_tail} out={out['n_out']}/{cap_out}"
            )
        return out, out["n_out"]

    # ---- stage 4: alignment per band width, on the mono or the split route ----
    def _align_device(self, bases_d: torch.Tensor, lengths: np.ndarray,
                      lead_d: torch.Tensor, trail_d: torch.Tensor, n_pairs: int):
        """(lead, trail, ahg, bhg) host int32 arrays of the VALID overlaps
        among the first n_pairs candidates."""
        s = self.s
        dev = self.device
        empty = tuple(np.zeros(0, np.int32) for _ in range(4))
        if n_pairs == 0:
            return empty
        lengths_d = torch.from_numpy(lengths).to(dev)
        if not self.fast_dovetail:
            a_all = (lead_d[:n_pairs] - 1).int()
            b_all = (trail_d[:n_pairs] - 1).int()
            found = [torch.stack([a + 1, b + 1, r["ahg"], r["bhg"]], dim=1).int()[r["valid"]]
                     for _, a, b, r in self._quadratic_chunks(bases_d, lengths_d, a_all, b_all)]
            return self._fetch_valid(found, n_pairs)
        packed = pack_reads_le(bases_d)
        la_max = bases_d.shape[1]
        wtab_host = s.band_widths(np.arange(la_max + 1, dtype=np.int32))
        widths = sorted(set(int(w) for w in wtab_host[lengths[lengths > 0]]))
        cm = s.cm_tuple()
        real = lengths[lengths > 0]
        ulen = int(real[0]) if real.size and bool((real == real[0]).all()) else 0
        # the kernels read the pairs' rows of `packed` by index: only the
        # per-pair indices and lengths are gathered here, and the indices are
        # checked once
        a_all = (lead_d[:n_pairs] - 1).int()
        b_all = (trail_d[:n_pairs] - 1).int()
        if dev.type == "cuda":
            check_pair_indices(a_all, b_all, packed.shape[0])
        pair_w = torch.from_numpy(wtab_host).to(dev)[lengths_d[a_all.long()].long()]
        # a width group's rows: its longest read (an A of the group is one of
        # them), so one long read sends only its own group to a wider instance
        # (lengths ascending: the longest of each width is written last)
        rows_w = {int(wtab_host[l]): int(l) for l in np.flatnonzero(np.bincount(real))}
        p1kw = dict(gO=s.gap_open, gE=s.gap_extend, cm_tuple=cm, ulen=ulen,
                    indices_checked=True)
        vkw = dict(min_identity=s.min_identity, min_overlap=s.min_overlap,
                   max_ignore=s.max_ignore)
        found = []

        for w in widths:
            sel = (torch.arange(n_pairs, device=dev) if len(widths) == 1
                   else torch.nonzero(pair_w == w)[:, 0])
            cnt = int(sel.numel())
            if cnt == 0:
                continue
            a_w, b_w = a_all[sel], b_all[sel]
            mono_env = os.environ.get("SEQALIGN_ALIGN_MONO")
            mono = bool(int(mono_env)) if mono_env is not None else cnt <= MONO_AUTO
            if mono and cnt <= MONO_MAX:
                found.append(self._align_mono(packed, lengths_d, a_w, b_w, w, rows_w[w],
                                              p1kw, vkw))
                cells = 2 * cnt * (la_max + 1) * (w + 1)
                self.stats.dp_cells += cells
                self.stats.dp_cells_raw += cells
                self.stats.n_phase2_pairs += cnt
                continue
            bs = self._batch(cnt)
            # pass A: phase 1 on every pair; dove length, -1 for duds
            dlen = torch.empty(cnt, dtype=torch.int32, device=dev)
            for lo in range(0, cnt, bs):
                a_idx, b_idx = a_w[lo : lo + bs], b_w[lo : lo + bs]
                best1, bi, bj, fi_c, fj_c = phase1_indexed(
                    packed, a_idx, b_idx, lengths_d, la_max=rows_w[w], w=w, **p1kw)
                a_len, b_len = lengths_d[a_idx.long()], lengths_d[b_idx.long()]
                act1 = (best1 > 0) & (b_len >= w)  # the glue's dud rule
                fi = torch.where(act1, fi_c, bi)
                fj = torch.where(act1, fj_c, bj)
                dlen[lo : lo + bs] = torch.where(act1 & (fj == 0), a_len - fi, -1)
            self.stats.dp_cells += cnt * (la_max + 1) * (w + 1)
            self.stats.dp_cells_raw += 2 * cnt * (la_max + 1) * (w + 1)

            # pass B: phase 2 per dove-length tier; short doves are provably
            # invalid and skipped
            tiers = _dove_tiers(la_max, w, s.min_overlap, float(s.min_identity))
            lo0 = tiers[0][0]
            hist = torch.bincount(dlen.clamp(-1, la_max).long() + 1,
                                  minlength=la_max + 2).cpu().numpy()
            if len(tiers) > 1 and bool(int(os.environ.get("SEQALIGN_ADAPTIVE_TIERS", "1"))):
                tiers = _plan_tiers(hist, lo0, la_max, batch=bs)
            # one stable sort groups every tier into a contiguous slice
            key = torch.where(dlen > lo0, dlen, 1 << 30)
            order = torch.sort(key, stable=True).indices
            toff = 0
            for tlo, thi in tiers:
                tcnt = int(hist[tlo + 2 : thi + 2].sum())
                self.stats.n_phase2_pairs += tcnt
                self.stats.dp_cells += tcnt * (thi + 1) * (w + 1)
                for lo in range(toff, toff + tcnt, bs):
                    opos = order[lo : min(lo + bs, toff + tcnt)]
                    a_idx, b_idx = a_w[opos], b_w[opos]
                    a_len, b_len = lengths_d[a_idx.long()], lengths_d[b_idx.long()]
                    dl = dlen[opos]
                    ds = a_len - dl
                    p2 = phase2_indexed(packed, a_idx, b_idx, ds, dl, lengths_d,
                                        la_max=min(thi, rows_w[w]), w=w, zero_row=w // 2,
                                        **p1kw)
                    res = phase2_results(p2, ds, a_len, b_len, width=w, **vkw)
                    ahg, bhg, valid = res["ahg"], res["bhg"], res["valid"]
                    found.append(torch.stack(
                        [a_idx + 1, b_idx + 1, ahg, bhg], dim=1)[valid])
                toff += tcnt
        return self._fetch_valid(found, n_pairs)

    @staticmethod
    def _align_mono(packed, lengths_d, a_w, b_w, w: int, rows: int, p1kw: dict, vkw: dict):
        """The both-phase route on one band-width group (the JAX engine's
        ``_align_chunk_compact``): one phase-1 launch over every pair, the
        dove anchor, one phase-2 launch over every pair, duds included, at
        ``rows`` rows.  Launches take the group whole, whatever the batch
        size (the JAX engine's launch is the group rounded up to its
        capacity tier, padding a compiled program needs and a CUDA launch
        does not).  Returns the valid (lead, trail, ahg, bhg) rows."""
        p1 = phase1_indexed(packed, a_w, b_w, lengths_d, la_max=rows, w=w, **p1kw)

        def run_phase2(dove_start, dove_len):
            return phase2_indexed(packed, a_w, b_w, dove_start.contiguous(),
                                  dove_len.contiguous(), lengths_d, la_max=rows, w=w,
                                  zero_row=w // 2, **p1kw)

        res = dovetail_glue(p1, run_phase2, lengths_d[a_w.long()], lengths_d[b_w.long()],
                            width=w, **vkw)
        return torch.stack([a_w + 1, b_w + 1, res["ahg"], res["bhg"]], dim=1)[res["valid"]]

    def _fetch_valid(self, found: list[torch.Tensor], n_pairs: int):
        """The valid [n, 4] rows of every launch -> four host int32 arrays."""
        self.stats.n_alignments = n_pairs
        rows = torch.cat(found).cpu().numpy() if found else np.zeros((0, 4), np.int32)
        self.stats.n_valid = int(rows.shape[0])
        return tuple(np.ascontiguousarray(rows[:, i]) for i in range(4))

    def _batch(self, count: int) -> int:
        """Pairs a launch takes out of ``count``: the JAX engine's batch
        (``_bs_pblk``), a power of two of at least 128 and at most
        ``batch_size`` rounded up, so ``batch_size=1`` gives 128 pairs."""
        return _pow2_at_least(min(self.batch_size, _pow2_at_least(count, 1024)), 128)

    # ---- the quadratic path ----
    def quad_chunk(self, n_pairs: int, la_max: int) -> int:
        """Pairs in one chunk of the quadratic path: the engine's batch, cut
        so that the chunk's traceback codes, (la_max + 1)^2 bytes a pair,
        stay within ``QUAD_DIRS_BUDGET``."""
        return max(1, min(self._batch(n_pairs), QUAD_DIRS_BUDGET // (la_max + 1) ** 2))

    def _quadratic_chunks(self, bases_d, lengths_d, a_idx, b_idx):
        """Full Smith-Waterman of pairs (a_idx[p], b_idx[p]) (0-based rows of
        the read matrix), chunk by chunk; yields (first pair, a rows, b rows,
        result dict) per chunk.  Counts no ``dp_cells``, as the JAX engine's
        quadratic branch counts none."""
        s = self.s
        la_max = bases_d.shape[1]
        n = a_idx.numel()
        bs = self.quad_chunk(n, la_max)
        for lo in range(0, n, bs):
            a, b = a_idx[lo : lo + bs].long(), b_idx[lo : lo + bs].long()
            yield lo, a, b, local_align_batch(
                bases_d[a], lengths_d[a], bases_d[b], lengths_d[b], cm=s.cost_matrix,
                gO=s.gap_open, gE=s.gap_extend, min_identity=s.min_identity,
                min_overlap=s.min_overlap, max_ignore=s.max_ignore, la_max=la_max,
                lb_max=la_max)

    # ---- host-facing stages (the CLI's bench modes) ----
    def _candidates(self, occ, bases: np.ndarray | None = None,
                    lengths: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Host candidate list (lead, trail) in canonical order."""
        if occ["hash"].numel() == 0:  # e.g. every read shorter than k
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        out, k = self._candidates_dev(occ)
        lead = out["lead"][:k].cpu().numpy().astype(np.int32)
        trail = out["trail"][:k].cpu().numpy().astype(np.int32)
        order = np.lexsort((trail, lead))
        return lead[order], trail[order]

    def _align(self, bases: np.ndarray, lengths: np.ndarray, lead: np.ndarray,
               trail: np.ndarray) -> dict[str, np.ndarray]:
        """Per-pair results (``OUT_KEYS``; int32, ``valid`` bool) of the
        engine's aligner over an explicit pair list of 1-based read ids."""
        s = self.s
        npairs = len(lead)
        out = {k: np.zeros(npairs, dtype=np.int32) for k in OUT_KEYS if k != "valid"}
        out["valid"] = np.zeros(npairs, dtype=bool)
        if npairs == 0:
            return out
        dev = self.device
        a_h = np.asarray(lead, np.int64) - 1
        b_h = np.asarray(trail, np.int64) - 1
        if min(a_h.min(), b_h.min()) < 0 or max(a_h.max(), b_h.max()) >= bases.shape[0]:
            raise ValueError("pair ids outside the read set")
        bases_d = torch.from_numpy(np.ascontiguousarray(bases)).to(dev)
        lengths_d = torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(dev)
        a_idx = torch.from_numpy(a_h.astype(np.int32)).to(dev)
        b_idx = torch.from_numpy(b_h.astype(np.int32)).to(dev)

        def put(sel, res):
            for k in OUT_KEYS:
                out[k][sel] = res[k].cpu().numpy().astype(out[k].dtype)

        if not self.fast_dovetail:
            for lo, a, _, res in self._quadratic_chunks(bases_d, lengths_d, a_idx, b_idx):
                put(slice(lo, lo + a.numel()), res)
            return out
        widths = s.band_widths(np.asarray(lengths)[a_h])
        for w in np.unique(widths).tolist():
            sel = np.flatnonzero(widths == w)
            sel_d = torch.from_numpy(sel).to(dev)
            a, b = a_idx[sel_d].long(), b_idx[sel_d].long()
            put(sel, fast_dovetail_batch(
                bases_d[a], lengths_d[a], bases_d[b], lengths_d[b], cm_tuple=s.cm_tuple(),
                gO=s.gap_open, gE=s.gap_extend, min_identity=s.min_identity,
                min_overlap=s.min_overlap, max_ignore=s.max_ignore, la_max=bases.shape[1],
                width=w))
        return out

    # ---- full pipeline ----
    def run(self, path_or_seqs: str | list[Sequence]) -> list[OverlapRecord]:
        """Full pipeline to OverlapRecord objects (``run_arrays`` is the
        array surface, which builds no per-record objects)."""
        return self._to_records(self.run_arrays(path_or_seqs))

    def run_stream(self, path: str, *, chunk_reads: int = 1 << 15) -> list[OverlapRecord]:
        """Streamed variant of ``run``: ``run_stream_arrays`` as records."""
        return self._to_records(self.run_stream_arrays(path, chunk_reads=chunk_reads))

    def _to_records(self, arrs) -> list[OverlapRecord]:
        with self._stage("emit.records"):
            return OverlapRecord.bulk_build(*(c.tolist() for c in arrs))

    def run_arrays(self, path_or_seqs: str | list[Sequence]):
        """Full pipeline to canonical (lead, trail, ahg, bhg) int32 numpy
        arrays sorted by (lead, trail)."""
        self.stats = OverlapStats()
        self.stage_s = {}
        with self._stage("encode"):
            if isinstance(path_or_seqs, str):
                bases, lengths = fasta_encode_native(path_or_seqs)
            else:
                bases, lengths = encode_reads(path_or_seqs)
            bases_d = torch.from_numpy(bases).to(self.device)
        return self._run_encoded(bases_d, lengths, bases.shape[0])

    def run_stream_arrays(self, path: str, *, chunk_reads: int = 1 << 15):
        """Streamed variant of ``run_arrays`` for a FASTA file: the
        [n_reads, l_max] read matrix is allocated on the device once and
        each encoded chunk of ``chunk_reads`` reads is copied into its row
        slice, so host memory stays O(chunk_reads * l_max) whatever the
        input size.  The output equals ``run_arrays(path)``."""
        if chunk_reads < 1:
            raise ValueError("chunk_reads must be >= 1")
        self.stats = OverlapStats()
        self.stage_s = {}
        with self._stage("encode"):
            n_input, l_max = fasta_scan_native(path)
            bases_d = torch.zeros((n_input, l_max), dtype=torch.int8, device=self.device)
            lengths = np.zeros(n_input, np.int32)
            lo = 0
            for bases_c, lens_c in fasta_encode_chunks_native(
                    path, min(chunk_reads, max(n_input, 1)), l_max):
                m = bases_c.shape[0]
                bases_d[lo : lo + m].copy_(torch.from_numpy(bases_c))
                lengths[lo : lo + m] = lens_c
                lo += m
            if lo != n_input:
                raise RuntimeError(f"{path}: scanned {n_input} reads, encoded {lo}")
        return self._run_encoded(bases_d, lengths, n_input)

    def _run_encoded(self, bases_d: torch.Tensor, lengths: np.ndarray, n_input: int):
        self.stats.n_reads = n_input
        with self._stage("kmer"):
            occ = self._occurrences(bases_d, lengths)
            self.stats.n_kmers = int(occ["valid"].sum())
        with self._stage("pairgen"):
            if occ["hash"].numel() == 0:
                out, n_pairs = None, 0
            else:
                out, n_pairs = self._candidates_dev(occ)
            self.stats.n_candidate_pairs = n_pairs
        printdb(f"pairgen: {n_pairs} candidate pairs")
        del occ
        with self._stage("align"):
            if n_pairs:
                lead, trail, ahg, bhg = self._align_device(
                    bases_d, lengths, out["lead"], out["trail"], n_pairs)
            else:
                lead = trail = ahg = bhg = np.zeros(0, np.int32)
        with self._stage("emit"):
            order = np.lexsort((trail, lead))
            arrs = tuple(np.ascontiguousarray(c[order]) for c in (lead, trail, ahg, bhg))
        printdb(time_report(self.stage_s))
        if debug_enabled():
            printdb(f"device memory: {device_memory_stats()}")
        return arrs
