"""Two-phase banded dovetail alignment: CUDA kernels and their plain versions.

Port of ``sequence_aligner_tpu/ops/align_fused.py``.  Each pair is aligned
in two banded affine-gap DPs with the traceback folded into the fill
(src/BioLibs.scala:373-591; validity src/ObjectStore.scala:102-141):

  phase 1  A against B's first w codes; anchors where B's prefix lands in A.
           ``phase1`` launches ``phase1_kernel`` (csrc/dovetail.cu), which
           replaces the TPU kernel ``_phase1_packed_kernel``.
  phase 2  A shifted by the phase-1 dove start, against B in a band rotated
           along the diagonal.  ``phase2`` launches ``phase2_kernel``, which
           replaces ``_phase2_packed_kernel``.

Operands are little-endian packed words (16 two-bit codes an int32, base r
at bits 2*(r % 16) of word r // 16) in the word-major ``[words, pairs]``
layout of the TPU kernels, so neighbouring CUDA threads read neighbouring
words.

Beside each wrapper is its plain PyTorch version (``phase1_plain``,
``phase2_plain``): the same function, written row by row over ``[P, w+1]``
tensors with the in-row X and stop chains as Python loops over the band.  A
wrapper takes the plain version only for tensors on the CPU; for CUDA tensors
it launches its kernel or raises.  The CPU tests hold the plain versions
against the JAX package; ``chip_smoke.py`` holds the kernels against them.

Each wrapper counts its kernel launches in ``phase1_launches`` /
``phase2_launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sequence_aligner_tpu_torch import _build

# kernel launches since import (or since a caller last set them to 0)
phase1_launches = 0
phase2_launches = 0

# stop words are (row << 16 | col) and counts (correct << 16 | error), so
# the kernels take fewer than 2^15 rows
MAX_ROWS = (1 << 15) - 1

_I32 = torch.int32


def pack_reads_le(bases: torch.Tensor) -> torch.Tensor:
    """[N, L] 2-bit codes -> [N, ceil(L/16)] int32 little-endian words."""
    n, l = bases.shape
    pad = (-l) % 16
    b = torch.nn.functional.pad(bases.to(torch.int64), (0, pad))
    b = b.reshape(n, -1, 16)
    sh = 2 * torch.arange(16, dtype=torch.int64, device=bases.device)
    words = (b << sh).sum(dim=2)
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(_I32)


def _code_plane(words_t: torch.Tensor) -> torch.Tensor:
    """[nw, P] packed words -> [P, 16 * nw] codes."""
    sh = 2 * torch.arange(16, dtype=_I32, device=words_t.device)
    codes = (words_t.t()[:, :, None] >> sh) & 3  # arithmetic >> is safe under & 3
    return codes.reshape(words_t.shape[1], -1)


def _max3(a, b, c):
    return torch.maximum(a, torch.maximum(b, c))


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
    """Per-row (value, index of the FIRST maximum) of a [P, n] tensor."""
    vmax = v.max(dim=1).values
    idx = (v == vmax[:, None]).to(torch.uint8).argmax(dim=1)
    return vmax, idx


# ---------------------------------------------------------------------------
# Phase 1 — banded SW of A against B[0:w] (src/BioLibs.scala:399-466)
# ---------------------------------------------------------------------------


def phase1_plain(aw_t, bw_t, a_len, *, la_max, w, gO, gE, cm_tuple, ulen=0):
    """Plain PyTorch phase 1 -> (best, bi, bj, fi, fj), each [P] int32.

    Band column k = 1..w is B column j = k; column 0 is the boundary.
    The backtrack stop (row << 16 | col) is carried through the fill with
    M -> X -> Y preference; the running best is the first maximum in
    row-major order (strict >) over rows i <= a_len.  ``ulen`` only lets the
    kernel skip reading the lengths; this version always reads them."""
    p = a_len.shape[0]
    dev = a_len.device
    cm = torch.tensor(cm_tuple, dtype=_I32, device=dev)
    acode = _code_plane(aw_t)
    bplane = _code_plane(bw_t)
    bcode = torch.zeros((p, w), dtype=_I32, device=dev)
    nb = min(w, bplane.shape[1])
    bcode[:, :nb] = bplane[:, :nb]  # codes past the words are 0
    kcol = torch.arange(w + 1, dtype=_I32, device=dev)
    zero = torch.zeros((p, w + 1), dtype=_I32, device=dev)
    M, X, Y, S = zero, zero, zero, zero
    live = torch.zeros((p, w + 1), dtype=torch.bool, device=dev)
    best, bi, bj, bs = (torch.zeros(p, dtype=_I32, device=dev) for _ in range(4))
    for i in range(1, la_max + 1):
        a = acode[:, i - 1] if i - 1 < acode.shape[1] else torch.zeros_like(best)
        sub = cm[(a[:, None] * 4 + bcode).long()]
        m = zero.clone()
        m[:, 1:] = sub + _max3(M[:, :-1], Y[:, :-1], X[:, :-1].clamp_min(0))
        y = zero.clone()
        y[:, 1:] = gE + _max3(M[:, 1:] + gO, Y[:, 1:], (X[:, 1:] + gO).clamp_min(0))
        c = (torch.maximum(m, y) + gO).clamp_min(0)
        x = zero.clone()
        for k in range(1, w + 1):  # in-row X chain
            x[:, k] = gE + torch.maximum(c[:, k - 1], x[:, k - 1])
        mx = _max3(m, x, y)
        is_m = m == mx
        is_x = ~is_m & (x == mx)
        # M: pred (i-1, k-1); Y: pred (i-1, k); column 0 is never a pred
        s0 = torch.where(live, S, ((i - 1) << 16) | kcol)
        s0[:, 1:] = torch.where(
            is_m[:, 1:],
            torch.where(live[:, :-1], S[:, :-1], ((i - 1) << 16) | kcol[:-1]),
            s0[:, 1:],
        )
        s = s0.clone()
        for k in range(1, w + 1):  # X: pred (i, k-1), in-row chain
            xs = torch.where(mx[:, k - 1] > 0, s[:, k - 1], (i << 16) | (k - 1))
            s[:, k] = torch.where(is_x[:, k], xs, s0[:, k])
        rb, jb = _first_argmax(mx[:, 1:])
        upd = (rb > best) & (i <= a_len)
        best = torch.where(upd, rb, best)
        bi = torch.where(upd, i, bi)
        bj = torch.where(upd, (jb + 1).to(_I32), bj)
        bs = torch.where(upd, s.gather(1, (jb + 1)[:, None])[:, 0], bs)
        M, X, Y, S, live = m, x, y, s, mx > 0
    return best, bi, bj, bs >> 16, bs & 0xFFFF


# ---------------------------------------------------------------------------
# Phase 2 — rotated-band dovetail DP from the phase-1 anchor
# (src/BioLibs.scala:473-589)
# ---------------------------------------------------------------------------


def phase2_plain(aw_t, bw_t, dove_start, dove_len, b_len, *,
                 la_max, w, zero_row, gO, gE, cm_tuple, ulen=0):
    """Plain PyTorch phase 2 -> (best, bu, bk, uf, kf, corr, err), each [P].

    Row u (1..la_max) reads A code ``dove_start + u - 1``; band column
    k = 0..w is B column j = k - zero_row + u, live while u <= dove_len and
    1 <= j <= b_len.  The aux state is the stop (u << 16 | k) and the counts
    (correct << 16 | error).  ``ulen`` only lets the kernel skip reading
    b_len; this version always reads it."""
    p = b_len.shape[0]
    dev = b_len.device
    cm = torch.tensor(cm_tuple, dtype=_I32, device=dev)
    acodes = _code_plane(aw_t)
    bcodes = _code_plane(bw_t)
    na, nb = acodes.shape[1], bcodes.shape[1]
    kcol = torch.arange(w + 1, dtype=_I32, device=dev)
    zero = torch.zeros((p, w + 1), dtype=_I32, device=dev)
    M, X, Y, S, CE = zero, zero, zero, zero, zero
    live = torch.zeros((p, w + 1), dtype=torch.bool, device=dev)
    best, bu, bk, bs, bc = (torch.zeros(p, dtype=_I32, device=dev) for _ in range(5))
    nxt = lambda t: torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], dim=1)  # noqa: E731
    not_w = kcol != w
    for u in range(1, la_max + 1):
        r = dove_start + (u - 1)
        a = acodes.gather(1, r.clamp(0, na - 1).long()[:, None])[:, 0]
        a = torch.where((r >= 0) & (r < na), a, 0)
        jm1 = kcol - zero_row + (u - 1)  # B code index per band column
        bwin = bcodes[:, jm1.clamp(0, nb - 1).long()]
        bwin = torch.where(((jm1 >= 0) & (jm1 < nb))[None, :], bwin, 0)
        j = jm1 + 1
        inb = (u <= dove_len)[:, None] & (j >= 1)[None, :] & (j[None, :] <= b_len[:, None])
        sub = cm[(a[:, None] * 4 + bwin).long()]
        eq = a[:, None] == bwin
        m = torch.where(inb, sub + _max3(M, Y, X.clamp_min(0)), 0)
        y = torch.where(
            inb & not_w,
            gE + _max3(nxt(M) + gO, nxt(Y), (nxt(X) + gO).clamp_min(0)), 0,
        )
        c = (torch.maximum(m, y) + gO).clamp_min(0)
        x = zero.clone()
        for k in range(1, w + 1):  # in-row X chain
            x[:, k] = torch.where(
                inb[:, k], gE + torch.maximum(c[:, k - 1], x[:, k - 1]), 0
            )
        mx = _max3(m, x, y)
        is_m = m == mx
        is_x = ~is_m & (x == mx)
        # M: pred (u-1, k), +1 correct on a match else +1 error
        sm = torch.where(live, S, ((u - 1) << 16) | kcol)
        cmv = torch.where(live, CE, 0) + torch.where(eq, 1 << 16, 1)
        # Y: pred (u-1, k+1), +1 error
        live1 = nxt(live)
        sy = torch.where(live1, nxt(S), ((u - 1) << 16) | (kcol + 1))
        cy = torch.where(live1, nxt(CE), 0) + 1
        s0 = torch.where(is_m, sm, sy)
        c0 = torch.where(is_m, cmv, cy)
        s, ce = s0.clone(), c0.clone()
        for k in range(1, w + 1):  # X: pred (u, k-1), in-row chain, +1 error
            lc = mx[:, k - 1] > 0
            xs = torch.where(lc, s[:, k - 1], (u << 16) | (k - 1))
            xc = torch.where(lc, ce[:, k - 1], 0) + 1
            s[:, k] = torch.where(is_x[:, k], xs, s0[:, k])
            ce[:, k] = torch.where(is_x[:, k], xc, c0[:, k])
        rb, kb = _first_argmax(mx)
        upd = rb > best
        best = torch.where(upd, rb, best)
        bu = torch.where(upd, u, bu)
        bk = torch.where(upd, kb.to(_I32), bk)
        bs = torch.where(upd, s.gather(1, kb[:, None])[:, 0], bs)
        bc = torch.where(upd, ce.gather(1, kb[:, None])[:, 0], bc)
        M, X, Y, S, CE, live = m, x, y, s, ce, mx > 0
    return best, bu, bk, bs >> 16, bs & 0xFFFF, bc >> 16, bc & 0xFFFF


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the CUDA kernel for CUDA tensors
# ---------------------------------------------------------------------------

_VP, _CI = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dovetail")
    lib.phase1_launch.argtypes = [_VP] * 5 + [_CI] * 7 + [_VP, _CI, _VP]
    lib.phase1_launch.restype = _CI
    lib.phase2_launch.argtypes = [_VP] * 7 + [_CI] * 8 + [_VP, _CI, _VP]
    lib.phase2_launch.restype = _CI
    for f in (lib.phase1_scratch_words, lib.phase2_scratch_words):
        f.argtypes = [_CI, _CI]
        f.restype = ctypes.c_longlong
    return lib


def _check(name: str, t, shape: tuple, device: torch.device) -> None:
    """int32, contiguous, on ``device``, of ``shape`` (None: any extent)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != _I32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != len(shape) or any(n is not None and n != m for n, m in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_kernel_args(la_max: int, w: int, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not 0 <= la_max <= MAX_ROWS:
        raise ValueError(f"la_max must be in [0, {MAX_ROWS}], got {la_max}")
    if w < 1:
        raise ValueError(f"band width must be >= 1, got {w}")


def _cm_words(cm_tuple) -> ctypes.Array:
    if len(cm_tuple) != 16:
        raise ValueError("cm_tuple must hold 16 scores")
    return (ctypes.c_int32 * 16)(*(int(v) for v in cm_tuple))


def phase1(aw_t, bw_t, a_len, *, la_max, w, gO, gE, cm_tuple, ulen=0):
    """Phase 1 over P pairs: aw_t [wpr, P], bw_t [wpr_b, P] packed words,
    a_len [P], all int32 -> (best, bi, bj, fi, fj), each [P] int32.
    ``ulen`` > 0 asserts every A has that length."""
    _check("a_len", a_len, (None,), a_len.device if isinstance(a_len, torch.Tensor) else None)
    p, dev = a_len.shape[0], a_len.device
    _check("aw_t", aw_t, (None, p), dev)
    _check("bw_t", bw_t, (None, p), dev)
    kw = dict(la_max=la_max, w=w, gO=gO, gE=gE, cm_tuple=cm_tuple, ulen=ulen)
    if dev.type == "cpu":
        return phase1_plain(aw_t, bw_t, a_len, **kw)
    _check_kernel_args(la_max, w, dev)
    out = torch.empty((5, p), dtype=_I32, device=dev)
    if p == 0:
        return tuple(out)
    lib = _lib()
    nscr = lib.phase1_scratch_words(p, w)
    scratch = torch.empty(nscr, dtype=_I32, device=dev) if nscr else None
    cm = _cm_words(cm_tuple)
    rc = lib.phase1_launch(
        aw_t.data_ptr(), bw_t.data_ptr(), a_len.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if nscr else None,
        p, aw_t.shape[0], bw_t.shape[0], la_max, w, gO, gE,
        ctypes.addressof(cm), ulen, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"phase1_kernel launch failed: CUDA error {rc}")
    global phase1_launches
    phase1_launches += 1
    return tuple(out)


def phase2(aw_t, bw_t, dove_start, dove_len, b_len, *,
           la_max, w, zero_row, gO, gE, cm_tuple, ulen=0):
    """Phase 2 over P pairs: aw_t [wpr, P], bw_t [wpr_b, P] packed words,
    dove_start, dove_len, b_len [P], all int32; ``la_max`` rows at most ->
    (best, bu, bk, uf, kf, corr, err), each [P] int32.  ``ulen`` > 0 asserts
    every B has that length."""
    _check("b_len", b_len, (None,), b_len.device if isinstance(b_len, torch.Tensor) else None)
    p, dev = b_len.shape[0], b_len.device
    _check("dove_start", dove_start, (p,), dev)
    _check("dove_len", dove_len, (p,), dev)
    _check("aw_t", aw_t, (None, p), dev)
    _check("bw_t", bw_t, (None, p), dev)
    kw = dict(la_max=la_max, w=w, zero_row=zero_row, gO=gO, gE=gE,
              cm_tuple=cm_tuple, ulen=ulen)
    if dev.type == "cpu":
        return phase2_plain(aw_t, bw_t, dove_start, dove_len, b_len, **kw)
    _check_kernel_args(la_max, w, dev)
    out = torch.empty((7, p), dtype=_I32, device=dev)
    if p == 0:
        return tuple(out)
    lib = _lib()
    nscr = lib.phase2_scratch_words(p, w)
    scratch = torch.empty(nscr, dtype=_I32, device=dev) if nscr else None
    cm = _cm_words(cm_tuple)
    rc = lib.phase2_launch(
        aw_t.data_ptr(), bw_t.data_ptr(), dove_start.data_ptr(),
        dove_len.data_ptr(), b_len.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if nscr else None,
        p, aw_t.shape[0], bw_t.shape[0], la_max, w, zero_row, gO, gE,
        ctypes.addressof(cm), ulen, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"phase2_kernel launch failed: CUDA error {rc}")
    global phase2_launches
    phase2_launches += 1
    return tuple(out)


# ---------------------------------------------------------------------------
# Glue: phase 1 -> dove anchor -> phase 2 -> reference validity
# ---------------------------------------------------------------------------


def dovetail_glue(p1, run_phase2, a_len, b_len, *,
                  width, min_identity, min_overlap, max_ignore):
    """Port of ``_dovetail_glue``: phase 1 -> dove anchor -> phase 2 ->
    per-pair results.  ``run_phase2(dove_start, dove_len)`` runs phase 2."""
    best1, bi, bj, fi_c, fj_c = p1
    dud_short = b_len < width  # the reference would index past B (BioLibs.scala:418)
    act1 = (best1 > 0) & ~dud_short
    fi = torch.where(act1, fi_c, bi)
    fj = torch.where(act1, fj_c, bj)
    dud = ~act1 | (fj != 0)
    p2 = run_phase2(fi, a_len - fi)
    return phase2_results(p2, fi, a_len, b_len, dud, width=width,
                          min_identity=min_identity, min_overlap=min_overlap,
                          max_ignore=max_ignore)


def phase2_results(p2, dove_start, a_len, b_len, dud=None, *,
                   width, min_identity, min_overlap, max_ignore):
    """Alignment coordinates, counts and the reference's validity
    (src/ObjectStore.scala:102-141) from phase-2 outputs; ``dud`` marks
    pairs phase 1 already failed (None: none did)."""
    zero_row = width // 2
    best2, bu, bk, uf_c, kf_c, corr_c, err_c = p2
    act2 = best2 > 0 if dud is None else (best2 > 0) & ~dud
    uf = torch.where(act2, uf_c, bu)
    kf = torch.where(act2, kf_c, bk)
    corr = torch.where(act2, corr_c, 0)
    err = torch.where(act2, err_c, 0)
    steps = corr + err  # each backtrack step is exactly one match or error
    start_i = uf + dove_start
    start_j = kf - zero_row + uf
    end_i = bu + dove_start
    end_j = bk - zero_row + bu
    tot = steps.to(torch.float32)
    ident_ok = corr.to(torch.float32) / tot >= _f32(min_identity, tot.device)
    len_ok = steps >= int(min_overlap)
    dovetail = ((start_i == 0) & (b_len == end_j)) | ((start_j == 0) & (a_len == end_i))
    ahg = start_i - start_j
    bhg = b_len - a_len + ahg
    hang_ok = (ahg.abs() < int(max_ignore)) & (bhg.abs() < int(max_ignore))
    align_valid = act2 & (tot > 0) & ident_ok & len_ok & dovetail
    return dict(
        start_i=start_i, start_j=start_j, end_i=end_i, end_j=end_j,
        correct=corr, error=err, align_len=steps, dud=~act2,
        valid=align_valid & hang_ok, ahg=ahg, bhg=bhg, align_valid=align_valid,
    )


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def fast_dovetail_batch(a_bases, a_len, b_bases, b_len, *, cm_tuple, gO, gE,
                        min_identity, min_overlap, max_ignore, la_max, width,
                        ulen=0):
    """Port of ``fast_dovetail_batch_fused``: two-phase banded dovetail
    alignment of P pairs given as code rows a_bases [P, La], b_bases
    [P, Lb] with lengths [P] -> dict of per-pair results (same keys)."""
    aw_t = pack_reads_le(a_bases).t().contiguous()
    bw_t = pack_reads_le(b_bases).t().contiguous()
    a_len = a_len.to(_I32).contiguous()
    b_len = b_len.to(_I32).contiguous()
    w = width
    common = dict(w=w, gO=gO, gE=gE, cm_tuple=cm_tuple, ulen=ulen)
    p1 = phase1(aw_t, bw_t, a_len, la_max=la_max, **common)

    def run_phase2(dove_start, dove_len):
        return phase2(aw_t, bw_t, dove_start.contiguous(), dove_len.contiguous(),
                      b_len, la_max=la_max, zero_row=w // 2, **common)

    return dovetail_glue(
        p1, run_phase2, a_len, b_len, width=w, min_identity=min_identity,
        min_overlap=min_overlap, max_ignore=max_ignore,
    )
