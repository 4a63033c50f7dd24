"""Batched full Smith-Waterman (the quadratic path) in torch ops.

Port of ``sequence_aligner_tpu/ops/align_lax.py``: ``local_align_batch`` is
the reference's ``--quadratic-align`` aligner (src/BioLibs.scala:171-263)
with value-based traceback (M -> X -> Y branch preference) and the validity
and hang predicates of src/ObjectStore.scala:102-141.  The JAX function is
XLA ``lax.scan`` code, not a Pallas kernel, so this is torch ops on the
device of its inputs, with no kernel of its own:

  * the fill loops over A's rows; each row is a handful of tensor ops on
    ``[P, lb_max + 1]`` (pairs by columns), the in-row affine-X recurrence
    solved in closed form by a ``torch.cummax`` along the row (``_row_x``);
  * the running max takes, like the reference's strict-> row-major scan,
    the first row and then the first column reaching each new maximum;
  * each cell leaves a 3-bit traceback code (branch in bits 0-1, cell max
    > 0 in bit 2), stored as int8: ``(la_max + 1) * (lb_max + 1)`` bytes a
    pair, so callers chunk pairs to bound that memory;
  * the traceback steps every pair at once for ``la_max + lb_max + 2``
    steps, one int8 gather a step, and stops early once no pair is live
    (checked every ``_LIVE_CHECK`` steps: each check syncs with the card).

``OUT_KEYS`` / ``stack_result`` are the stacked result contract the
host-facing ``Overlapper._align`` shares with the dovetail aligner.
Integers and the float32 identity test equal the JAX function's bit for
bit; ``calls`` counts the function's calls (chunks).
"""

from __future__ import annotations

import numpy as np
import torch

_NEG = -(2**30)
_I32 = torch.int32
_LIVE_CHECK = 16

# calls since import (or since a caller last set it to 0)
calls = 0

OUT_KEYS = (
    "start_i", "start_j", "end_i", "end_j", "correct", "error",
    "align_len", "ahg", "bhg", "valid",
)


def stack_result(res) -> torch.Tensor:
    """[len(OUT_KEYS), P] int32 of a result dict."""
    return torch.stack([res[k].to(_I32) for k in OUT_KEYS])


def _max3(a, b, c):
    return torch.maximum(a, torch.maximum(b, c))


def _row_x(c: torch.Tensor, ge: int) -> torch.Tensor:
    """Solve X_k = gE + max(c_k, X_{k-1}) for k = 1..W as a cummax along
    the row: c [P, W] with c_k = max(M_{k-1}+gO, Y_{k-1}+gO, 0) >= 0.
    Returns X for columns 1..W: (k+1)*gE + cummax_{m<=k} (c_m - m*gE)."""
    m = torch.arange(1, c.shape[1] + 1, dtype=_I32, device=c.device)
    return (m + 1) * ge + torch.cummax(c - m * ge, dim=1).values


def _dir_code(mv, xv, yv) -> torch.Tensor:
    """3-bit traceback code per cell: bits 0-1 the argmax with M -> X -> Y
    preference (0 = M, 1 = X, 2 = Y); bit 2 set where the max is > 0."""
    mx = _max3(mv, xv, yv)
    branch = torch.where(mv == mx, 0, torch.where(xv == mx, 1, 2))
    return (branch | torch.where(mx > 0, 4, 0)).to(torch.int8)


def _fill(a_bases, b_bases, a_len, b_len, cm_flat, gO: int, gE: int, la_max: int, w: int):
    """Full SW of A against B[0:w] -> (dirs [la_max+1, P, w+1] int8, best,
    bi, bj), the running max restricted to rows <= a_len and columns <=
    b_len."""
    p = a_bases.shape[0]
    dev = a_bases.device
    b_pref = b_bases[:, :w].long()
    cols = torch.arange(1, w + 1, dtype=_I32, device=dev)
    colmask = cols[None, :] <= b_len[:, None]
    zero = torch.zeros((p, 1), dtype=_I32, device=dev)
    mp = xp = yp = torch.zeros((p, w + 1), dtype=_I32, device=dev)
    best = torch.zeros(p, dtype=_I32, device=dev)
    bi = torch.zeros_like(best)
    bj = torch.zeros_like(best)
    dirs = torch.zeros((la_max + 1, p, w + 1), dtype=torch.int8, device=dev)
    for i in range(1, la_max + 1):
        sub = cm_flat[a_bases[:, i - 1].long()[:, None] * 4 + b_pref]
        m_new = torch.cat([zero, sub + _max3(mp[:, :-1], yp[:, :-1], xp[:, :-1].clamp(min=0))],
                          dim=1)
        y_new = torch.cat([zero, gE + _max3(mp[:, 1:] + gO, yp[:, 1:],
                                            (xp[:, 1:] + gO).clamp(min=0))], dim=1)
        c = (torch.maximum(m_new[:, :-1], y_new[:, :-1]) + gO).clamp(min=0)
        x_new = torch.cat([zero, _row_x(c, gE)], dim=1)
        dirs[i] = _dir_code(m_new, x_new, y_new)
        row_t = torch.where(colmask, _max3(m_new, x_new, y_new)[:, 1:], _NEG)
        rb = row_t.amax(dim=1)
        # the FIRST column reaching the row's max, taken explicitly
        jb = torch.where(row_t == rb[:, None], cols, w + 1).amin(dim=1)
        upd = (i <= a_len) & (rb > best)
        best = torch.where(upd, rb, best)
        bi = torch.where(upd, i, bi)
        bj = torch.where(upd, jb, bj)
        mp, xp, yp = m_new, x_new, y_new
    return dirs, best, bi, bj


def _traceback(dirs, i0, j0, active, steps: int, a_bases, b_bases):
    """Step-locked traceback of every pair over the direction codes; each
    step's (A, B) codes count as a match where equal.  Returns the final
    (i, j), correct, error and steps taken."""
    rows, p, cols = dirs.shape
    lanes = torch.arange(p, device=dirs.device)
    flat = dirs.reshape(-1)
    la_top = max(a_bases.shape[1] - 1, 0)
    lb_top = max(b_bases.shape[1] - 1, 0)

    def code_at(i, j):
        return flat[(i.long() * p + lanes) * cols + j.long()]

    i, j = i0, j0
    code = code_at(i, j)
    c = torch.zeros(p, dtype=_I32, device=dirs.device)
    e = torch.zeros_like(c)
    n = torch.zeros_like(c)
    for step in range(steps):
        branch = code & 3
        is_m = active & (branch == 0)
        is_x = active & (branch == 1)
        is_y = active & (branch == 2)
        pa = a_bases[lanes, (i - 1).clamp(0, la_top).long()]
        pb = b_bases[lanes, (j - 1).clamp(0, lb_top).long()]
        eq = pa == pb
        c = c + (is_m & eq).to(_I32)
        e = e + ((is_m & ~eq) | is_x | is_y).to(_I32)
        n = n + active.to(_I32)
        i = i - (is_m | is_y).to(_I32)
        j = j - (is_m | is_x).to(_I32)
        code = code_at(i, j)
        active = active & ((code & 4) != 0)
        if step % _LIVE_CHECK == _LIVE_CHECK - 1 and not bool(active.any()):
            break  # no pair moves again: the rest of the steps change nothing
    return i, j, c, e, n


def local_align_batch(a_bases, a_len, b_bases, b_len, *, cm, gO, gE, min_identity,
                      min_overlap, max_ignore, la_max: int, lb_max: int) -> dict:
    """Batched full Smith-Waterman of P pairs: a_bases [P, >= la_max] and
    b_bases [P, >= lb_max] 2-bit codes with lengths a_len, b_len [P] ->
    dict of [P] tensors (start_i, start_j, end_i, end_j, correct, error,
    align_len, dud, valid, ahg, bhg, align_valid), on the inputs' device."""
    global calls
    calls += 1
    dev = a_bases.device
    a_b = a_bases[:, :la_max].to(_I32)
    b_b = b_bases[:, :lb_max].to(_I32)
    a_len = a_len.to(device=dev, dtype=_I32)
    b_len = b_len.to(device=dev, dtype=_I32)
    cm_flat = torch.as_tensor(np.asarray(cm, dtype=np.int32).reshape(-1), device=dev)
    gO, gE = int(gO), int(gE)
    dirs, best, bi, bj = _fill(a_b, b_b, a_len, b_len, cm_flat, gO, gE, la_max, lb_max)
    act = best > 0
    fi, fj, corr, err, steps = _traceback(dirs, bi, bj, act, la_max + lb_max + 2, a_b, b_b)
    del dirs
    tot = (corr + err).to(torch.float32)
    mi = torch.tensor(float(np.float32(min_identity)), dtype=torch.float32, device=dev)
    ident_ok = corr.to(torch.float32) / tot >= mi
    len_ok = steps >= int(min_overlap)
    dovetail = ((fi == 0) & (b_len == bj)) | ((fj == 0) & (a_len == bi))
    ahg = fi - fj
    bhg = b_len - a_len + ahg
    hang_ok = (ahg.abs() < int(max_ignore)) & (bhg.abs() < int(max_ignore))
    align_valid = act & (tot > 0) & ident_ok & len_ok & dovetail
    return dict(
        start_i=fi, start_j=fj, end_i=bi, end_j=bj,
        correct=corr, error=err, align_len=steps, dud=~act,
        valid=align_valid & hang_ok, ahg=ahg, bhg=bhg, align_valid=align_valid,
    )
