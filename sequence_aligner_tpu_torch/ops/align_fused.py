"""Two-phase banded dovetail alignment: CUDA kernels and their plain versions.

Port of ``sequence_aligner_tpu/ops/align_fused.py``.  Each pair is aligned
in two banded affine-gap DPs with the traceback folded into the fill
(src/BioLibs.scala:373-591; validity src/ObjectStore.scala:102-141):

  phase 1  A against B's first w codes; anchors where B's prefix lands in A.
           ``phase1_indexed`` launches ``phase1_kernel`` (csrc/dovetail.cu),
           which replaces the TPU kernel ``_phase1_packed_kernel``.
  phase 2  A shifted by the phase-1 dove start, against B in a band rotated
           along the diagonal.  ``phase2_indexed`` launches ``phase2_kernel``,
           which replaces ``_phase2_packed_kernel``.

Reads are little-endian packed words (16 two-bit codes an int32, base r at
bits 2*(r % 16) of word r // 16), one row a read: the ``[n_reads, wpr]``
table of ``pack_reads_le``.  The wrappers take that table with the pair's
row indices ``a_idx`` / ``b_idx`` and the per-read ``lengths``; each kernel
thread reads its own pair's rows, so nothing is gathered before a launch.

Beside each wrapper is its plain PyTorch version (``phase1_indexed_plain``,
``phase2_indexed_plain``): it gathers the pairs' words into the word-major
``[words, pairs]`` layout of the TPU kernels and runs ``phase1_plain`` /
``phase2_plain``, the same function written row by row over ``[P, w+1]``
tensors.  A wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches its kernel or raises.  The CPU tests hold the
plain versions against the JAX package; ``chip_smoke.py`` holds the kernels
against them.

Stops and counts: the plain versions carry (row << 32 | col) and
(correct << 32 | error) in int64, so any read length is exact.  The kernels
carry 16-bit fields up to ``MAX_ROWS`` rows and a wide instance with 32-bit
fields up to ``MAX_ROWS_WIDE`` rows.

Each wrapper counts its kernel launches in ``phase1_launches`` /
``phase2_launches``, and by kernel instance in ``instance_launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sequence_aligner_tpu_torch import _build

# kernel launches since import (or since a caller last set them to 0), and
# by (phase, instance)
phase1_launches = 0
phase2_launches = 0
instance_launches: dict[tuple[int, str], int] = {}

# the narrow kernel instances' 16-bit stop and count fields take up to
# MAX_ROWS rows (and band columns); past it the wide instance (32-bit
# fields) runs, up to MAX_ROWS_WIDE
MAX_ROWS = (1 << 15) - 1
MAX_ROWS_WIDE = 1 << 30

_I32, _I64 = torch.int32, torch.int64


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


def _split(word: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) int32 halves of an int64 (row << 32 | col) or
    (correct << 32 | error) word."""
    return (word >> 32).to(_I32), (word & 0xFFFFFFFF).to(_I32)


def _max3(a, b, c):
    return torch.maximum(a, torch.maximum(b, c))


def _x_chain(c: torch.Tensor, kg: torch.Tensor, r0: int) -> torch.Tensor:
    """Columns r0+1.. of the in-row X chain x[k] = gE + max(c[k-1], x[k-1])
    started from x[r0] = 0, in closed form: c >= 0, so x[k] = k*gE +
    max over r0 <= j < k of (c[j] - j*gE); ``kg`` is k*gE per column."""
    return kg[r0 + 1 :] + torch.cummax(c[:, r0:-1] - kg[r0:-1], dim=1).values


def _chain_start(is_x: torch.Tensor, mx: torch.Tensor, kcol: torch.Tensor) -> torch.Tensor:
    """Per cell, the column where its in-row chain of X steps starts: an X
    cell whose left neighbour is live (max > 0) continues that neighbour's
    chain, any other cell starts its own."""
    cont = torch.zeros_like(is_x)
    cont[:, 1:] = is_x[:, 1:] & (mx[:, :-1] > 0)
    return torch.where(cont, 0, kcol).cummax(dim=1).values


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
    The backtrack stop (row << 32 | col, int64) is carried through the fill with
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
    bcode = bcode.long()
    a4 = torch.zeros((p, max(la_max, acode.shape[1])), dtype=_I64, device=dev)
    a4[:, : acode.shape[1]] = acode.long() * 4  # 4 * A's code on row i - 1
    kcol = torch.arange(w + 1, dtype=_I64, device=dev)
    kg = (kcol * gE).to(_I32)
    zero = torch.zeros((p, w + 1), dtype=_I32, device=dev)
    M, X, Y = zero, zero, zero
    S = torch.zeros((p, w + 1), dtype=_I64, device=dev)
    live = torch.zeros((p, w + 1), dtype=torch.bool, device=dev)
    best, bi, bj = (torch.zeros(p, dtype=_I32, device=dev) for _ in range(3))
    bs = torch.zeros(p, dtype=_I64, device=dev)
    for i in range(1, la_max + 1):
        sub = cm[a4[:, i - 1 : i] + bcode]
        m = zero.clone()
        m[:, 1:] = sub + _max3(M[:, :-1], Y[:, :-1], X[:, :-1].clamp_min(0))
        y = zero.clone()
        y[:, 1:] = gE + _max3(M[:, 1:] + gO, Y[:, 1:], (X[:, 1:] + gO).clamp_min(0))
        c = (torch.maximum(m, y) + gO).clamp_min(0)
        x = zero.clone()  # in-row X chain x[k] = gE + max(c[k-1], x[k-1])
        x[:, 1:] = _x_chain(c, kg, 0)
        mx = _max3(m, x, y)
        is_m = m == mx
        is_x = ~is_m & (x == mx)
        # M: pred (i-1, k-1); Y: pred (i-1, k); column 0 is never a pred
        s0 = torch.where(live, S, ((i - 1) << 32) | kcol)
        s0[:, 1:] = torch.where(
            is_m[:, 1:],
            torch.where(live[:, :-1], S[:, :-1], ((i - 1) << 32) | kcol[:-1]),
            s0[:, 1:],
        )
        # X: pred (i, k-1), in-row chain
        is_x[:, 0] = False
        start = _chain_start(is_x, mx, kcol)
        s = torch.where(is_x, (i << 32) | (kcol - 1), s0).gather(1, start)
        rb, jb = _first_argmax(mx[:, 1:])
        upd = (rb > best) & (i <= a_len)
        best = torch.where(upd, rb, best)
        bi = torch.where(upd, i, bi)
        bj = torch.where(upd, (jb + 1).to(_I32), bj)
        bs = torch.where(upd, s.gather(1, (jb + 1)[:, None])[:, 0], bs)
        M, X, Y, S, live = m, x, y, s, mx > 0
    return best, bi, bj, *_split(bs)


# ---------------------------------------------------------------------------
# Phase 2 — rotated-band dovetail DP from the phase-1 anchor
# (src/BioLibs.scala:473-589)
# ---------------------------------------------------------------------------


def phase2_plain(aw_t, bw_t, dove_start, dove_len, b_len, *,
                 la_max, w, zero_row, gO, gE, cm_tuple, ulen=0):
    """Plain PyTorch phase 2 -> (best, bu, bk, uf, kf, corr, err), each [P].

    Row u (1..la_max) reads A code ``dove_start + u - 1``; band column
    k = 0..w is B column j = k - zero_row + u, live while u <= dove_len and
    1 <= j <= b_len.  The aux state is the stop (u << 32 | k) and the counts
    (correct << 32 | error), both int64.  ``ulen`` only lets the kernel skip reading
    b_len; this version always reads it."""
    p = b_len.shape[0]
    dev = b_len.device
    cm = torch.tensor(cm_tuple, dtype=_I32, device=dev)
    acodes = _code_plane(aw_t)
    bcodes = _code_plane(bw_t)
    na, nb = acodes.shape[1], bcodes.shape[1]
    # A's code on each row u (dove-shifted, 0 outside A), as a4 = 4 * code
    r = dove_start[:, None] + torch.arange(la_max, dtype=_I32, device=dev)
    acol = torch.where((r >= 0) & (r < na),
                       acodes.gather(1, r.clamp(0, max(na - 1, 0)).long()), 0)
    a4 = acol.long() * 4
    # B's codes shifted by zero_row, 0 outside B: row u's window is the
    # slice [u - 1, u + w] (band column k is B code k - zero_row + u - 1)
    bpad = torch.zeros((p, la_max + w), dtype=_I32, device=dev)
    nbc = max(min(nb, la_max + w - zero_row), 0)
    bpad[:, zero_row : zero_row + nbc] = bcodes[:, :nbc]
    top = b_len + zero_row  # band columns k <= top - u have j <= b_len
    kcol = torch.arange(w + 1, dtype=_I64, device=dev)
    kg = (kcol * gE).to(_I32)
    zero = torch.zeros((p, w + 1), dtype=_I32, device=dev)
    M, X, Y = zero, zero, zero
    S, CE = (torch.zeros((p, w + 1), dtype=_I64, device=dev) for _ in range(2))
    live = torch.zeros((p, w + 1), dtype=torch.bool, device=dev)
    best, bu, bk = (torch.zeros(p, dtype=_I32, device=dev) for _ in range(3))
    bs, bc = (torch.zeros(p, dtype=_I64, device=dev) for _ in range(2))
    for u in range(1, la_max + 1):
        bwin = bpad[:, u - 1 : u + w]
        khi = torch.where(u <= dove_len, top - u, -1)
        inb = (kcol > zero_row - u) & (kcol <= khi[:, None])  # 1 <= j <= b_len
        sub = cm[a4[:, u - 1 : u] + bwin]
        eq = acol[:, u - 1 : u] == bwin
        m = torch.where(inb, sub + _max3(M, Y, X.clamp_min(0)), 0)
        y = zero.clone()  # column w is outside the band's Y
        y[:, :w] = torch.where(
            inb[:, :w],
            gE + _max3(M[:, 1:] + gO, Y[:, 1:], (X[:, 1:] + gO).clamp_min(0)), 0,
        )
        c = (torch.maximum(m, y) + gO).clamp_min(0)
        # in-row X chain x[k] = gE + max(c[k-1], x[k-1]) in the band, 0 out
        # of it; x is 0 at column r0: column 0, or the one below the band
        r0 = max(zero_row - u, 0)
        x = zero.clone()
        x[:, r0 + 1 :] = torch.where(inb[:, r0 + 1 :], _x_chain(c, kg, r0), 0)
        mx = _max3(m, x, y)
        is_m = m == mx
        is_x = ~is_m & (x == mx)
        # M: pred (u-1, k), +1 correct on a match else +1 error
        sm = torch.where(live, S, ((u - 1) << 32) | kcol)
        cmv = torch.where(live, CE, 0) + torch.where(eq, 1 << 32, 1)
        # Y: pred (u-1, k+1), +1 error; column w + 1 is never live
        sy = ((u - 1) << 32) | (kcol + 1)
        cy = torch.ones_like(CE)
        sy = sy.expand(p, -1).clone()
        sy[:, :w] = torch.where(live[:, 1:], S[:, 1:], sy[:, :w])
        cy[:, :w] += torch.where(live[:, 1:], CE[:, 1:], 0)
        s0 = torch.where(is_m, sm, sy)
        c0 = torch.where(is_m, cmv, cy)
        # X: pred (u, k-1), in-row chain, +1 error a step
        is_x[:, 0] = False
        start = _chain_start(is_x, mx, kcol)
        s = torch.where(is_x, (u << 32) | (kcol - 1), s0).gather(1, start)
        ce = torch.where(is_x, 1, c0).gather(1, start) + (kcol - start)
        rb, kb = _first_argmax(mx)
        upd = rb > best
        best = torch.where(upd, rb, best)
        bu = torch.where(upd, u, bu)
        bk = torch.where(upd, kb.to(_I32), bk)
        bs = torch.where(upd, s.gather(1, kb[:, None])[:, 0], bs)
        bc = torch.where(upd, ce.gather(1, kb[:, None])[:, 0], bc)
        M, X, Y, S, CE, live = m, x, y, s, ce, mx > 0
    return best, bu, bk, *_split(bs), *_split(bc)


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the CUDA kernel for CUDA tensors
# ---------------------------------------------------------------------------

_VP, _CI = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("dovetail")
    lib.phase1_launch.argtypes = [_VP] * 6 + [_CI] * 6 + [_VP, _CI, _VP]
    lib.phase1_launch.restype = _CI
    lib.phase2_launch.argtypes = [_VP] * 8 + [_CI] * 7 + [_VP, _CI, _VP]
    lib.phase2_launch.restype = _CI
    for f in (lib.phase1_scratch_words, lib.phase2_scratch_words):
        f.argtypes = [_CI, _CI, _CI, _VP]
        f.restype = ctypes.c_longlong
    for f in (lib.phase1_instance, lib.phase2_instance):
        f.argtypes = [_CI, _CI, _VP]
        f.restype = _CI
    return lib


# the kernel instances, as phase*_instance numbers them
INSTANCES = ("exact_a", "exact_b", "capacity24", "capacity32", "capacity48", "capacity64",
             "general", "wide")


def _check(name: str, t, shape: tuple, device: torch.device | None) -> None:
    """int32, contiguous, on ``device`` (None: any), of ``shape`` (None:
    any extent)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != _I32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != len(shape) or any(n is not None and n != m for n, m in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_operands(packed, lengths, idx: dict) -> torch.device:
    """Checks the read table, the lengths and the per-pair vectors; returns
    their device."""
    _check("packed", packed, (None, None), None)
    dev = packed.device
    _check("lengths", lengths, (packed.shape[0],), dev)
    p = idx["a_idx"].shape[0] if isinstance(idx["a_idx"], torch.Tensor) else None
    for name, t in idx.items():
        _check(name, t, (p,), dev)
    return dev


def check_pair_indices(a_idx: torch.Tensor, b_idx: torch.Tensor, n_reads: int) -> None:
    """Raises IndexError unless every pair index lies in [0, n_reads): the
    kernels read the packed rows at these indices.  One reduction and one
    host sync."""
    if bool(((a_idx < 0) | (a_idx >= n_reads) | (b_idx < 0) | (b_idx >= n_reads)).any()):
        raise IndexError(f"a_idx and b_idx must index the {n_reads} rows of packed")


def _check_kernel_args(rows: int, w: int, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not 0 <= rows <= MAX_ROWS_WIDE:
        raise ValueError(f"rows must be in [0, {MAX_ROWS_WIDE}] (the wide kernel "
                         f"instance's 32-bit row field), got {rows}")
    if not 1 <= w < MAX_ROWS_WIDE:
        raise ValueError(f"band width must be in [1, {MAX_ROWS_WIDE}), got {w}")


def _cm_words(cm_tuple) -> ctypes.Array:
    if len(cm_tuple) != 16:
        raise ValueError("cm_tuple must hold 16 scores")
    return (ctypes.c_int32 * 16)(*(int(v) for v in cm_tuple))


def instance(phase: int, *, w: int, rows: int, cm_tuple) -> str:
    """The kernel instance a launch of ``phase`` (1 or 2) takes: the
    register instances "exact_a" / "exact_b" (w = 12 / 16), "capacity24" ..
    "capacity64" (up to 24, 32, 48, 64 band columns: w in phase 1, w + 1 in
    phase 2), "general" (device scratch) or "wide"."""
    lib = _lib()
    f = lib.phase1_instance if phase == 1 else lib.phase2_instance
    cm = _cm_words(cm_tuple)  # alive across the call
    return INSTANCES[f(w, rows, ctypes.addressof(cm))]


def _gather_pairs(packed, a_idx, b_idx, lengths):
    """Word-major [wpr, P] A and B words and the A and B lengths of pairs."""
    ia, ib = a_idx.long(), b_idx.long()
    return (packed[ia].t().contiguous(), packed[ib].t().contiguous(),
            lengths[ia], lengths[ib])


def phase1_indexed_plain(packed, a_idx, b_idx, lengths, *, la_max, w, gO, gE,
                         cm_tuple, ulen=0):
    """Plain version of ``phase1_indexed``: gather, then ``phase1_plain``."""
    aw_t, bw_t, a_len, _ = _gather_pairs(packed, a_idx, b_idx, lengths)
    return phase1_plain(aw_t, bw_t, a_len, la_max=la_max, w=w, gO=gO, gE=gE,
                        cm_tuple=cm_tuple, ulen=ulen)


def phase2_indexed_plain(packed, a_idx, b_idx, dove_start, dove_len, lengths, *,
                         la_max, w, zero_row, gO, gE, cm_tuple, ulen=0):
    """Plain version of ``phase2_indexed``: gather, then ``phase2_plain``."""
    aw_t, bw_t, _, b_len = _gather_pairs(packed, a_idx, b_idx, lengths)
    return phase2_plain(aw_t, bw_t, dove_start, dove_len, b_len, la_max=la_max, w=w,
                        zero_row=zero_row, gO=gO, gE=gE, cm_tuple=cm_tuple, ulen=ulen)


def _count_instance(phase: int, number: int) -> None:
    key = (phase, INSTANCES[number])
    instance_launches[key] = instance_launches.get(key, 0) + 1


def _scratch(f, p: int, w: int, rows: int, cm, dev) -> torch.Tensor | None:
    n = f(p, w, rows, ctypes.addressof(cm))
    if n < 0:
        raise ValueError(f"no kernel instance takes {rows} rows at band width {w}")
    return torch.empty(n, dtype=_I32, device=dev) if n else None


def phase1_indexed(packed, a_idx, b_idx, lengths, *, la_max, w, gO, gE, cm_tuple,
                   ulen=0, indices_checked=False):
    """Phase 1 over P pairs: ``packed`` [n_reads, wpr] read words, pair rows
    ``a_idx`` / ``b_idx`` [P] and per-read ``lengths`` [n_reads], all int32;
    at most ``la_max`` rows -> (best, bi, bj, fi, fj), each [P] int32.
    ``ulen`` > 0 asserts every A has that length.  ``indices_checked``: the
    caller ran ``check_pair_indices`` on these indices (the kernel path
    checks them otherwise, with one host sync)."""
    dev = _check_operands(packed, lengths, dict(a_idx=a_idx, b_idx=b_idx))
    kw = dict(la_max=la_max, w=w, gO=gO, gE=gE, cm_tuple=cm_tuple, ulen=ulen)
    if dev.type == "cpu":
        return phase1_indexed_plain(packed, a_idx, b_idx, lengths, **kw)
    _check_kernel_args(la_max, w, dev)
    if not indices_checked:
        check_pair_indices(a_idx, b_idx, packed.shape[0])
    return _launch_phase1(packed, a_idx, b_idx, lengths, **kw)


def _launch_phase1(packed, a_idx, b_idx, lengths, *, la_max, w, gO, gE, cm_tuple,
                   ulen=0):
    """``phase1_kernel``'s launch on operands ``phase1_indexed`` checked."""
    p, dev = a_idx.shape[0], a_idx.device
    out = torch.empty((5, p), dtype=_I32, device=dev)
    if p == 0:
        return tuple(out)
    lib = _lib()
    cm = _cm_words(cm_tuple)
    scratch = _scratch(lib.phase1_scratch_words, p, w, la_max, cm, dev)
    rc = lib.phase1_launch(
        packed.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        p, packed.shape[1], la_max, w, gO, gE,
        ctypes.addressof(cm), ulen, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"phase1_kernel launch failed: CUDA error {rc}")
    global phase1_launches
    phase1_launches += 1
    _count_instance(1, lib.phase1_instance(w, la_max, ctypes.addressof(cm)))
    return tuple(out)


def phase2_indexed(packed, a_idx, b_idx, dove_start, dove_len, lengths, *,
                   la_max, w, zero_row, gO, gE, cm_tuple, ulen=0, indices_checked=False):
    """Phase 2 over P pairs: ``packed`` [n_reads, wpr] read words, pair rows
    ``a_idx`` / ``b_idx``, ``dove_start`` and ``dove_len`` [P], per-read
    ``lengths`` [n_reads], all int32; at most ``la_max`` rows ->
    (best, bu, bk, uf, kf, corr, err), each [P] int32.  ``ulen`` > 0
    asserts every B has that length; ``indices_checked`` as in
    ``phase1_indexed``."""
    dev = _check_operands(packed, lengths, dict(
        a_idx=a_idx, b_idx=b_idx, dove_start=dove_start, dove_len=dove_len))
    kw = dict(la_max=la_max, w=w, zero_row=zero_row, gO=gO, gE=gE,
              cm_tuple=cm_tuple, ulen=ulen)
    if dev.type == "cpu":
        return phase2_indexed_plain(packed, a_idx, b_idx, dove_start, dove_len,
                                    lengths, **kw)
    _check_kernel_args(la_max, w, dev)
    if not indices_checked:
        check_pair_indices(a_idx, b_idx, packed.shape[0])
    return _launch_phase2(packed, a_idx, b_idx, dove_start, dove_len, lengths, **kw)


def _launch_phase2(packed, a_idx, b_idx, dove_start, dove_len, lengths, *, la_max, w,
                   zero_row, gO, gE, cm_tuple, ulen=0):
    """``phase2_kernel``'s launch on operands ``phase2_indexed`` checked."""
    p, dev = a_idx.shape[0], a_idx.device
    out = torch.empty((7, p), dtype=_I32, device=dev)
    if p == 0:
        return tuple(out)
    lib = _lib()
    cm = _cm_words(cm_tuple)
    scratch = _scratch(lib.phase2_scratch_words, p, w, la_max, cm, dev)
    rc = lib.phase2_launch(
        packed.data_ptr(), a_idx.data_ptr(), b_idx.data_ptr(), dove_start.data_ptr(),
        dove_len.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        p, packed.shape[1], la_max, w, zero_row, gO, gE,
        ctypes.addressof(cm), ulen, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"phase2_kernel launch failed: CUDA error {rc}")
    global phase2_launches
    phase2_launches += 1
    _count_instance(2, lib.phase2_instance(w, la_max, ctypes.addressof(cm)))
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
    [P, Lb] with lengths [P] -> dict of per-pair results (same keys).
    The A and B rows go into one packed table, A's at rows 0..P-1 and B's
    at rows P..2P-1."""
    p = a_bases.shape[0]
    l = max(a_bases.shape[1], b_bases.shape[1])
    pad = lambda t: torch.nn.functional.pad(t, (0, l - t.shape[1]))  # noqa: E731
    packed = pack_reads_le(torch.cat([pad(a_bases), pad(b_bases)]))
    a_len = a_len.to(_I32).contiguous()
    b_len = b_len.to(_I32).contiguous()
    lengths = torch.cat([a_len, b_len])
    a_idx = torch.arange(p, dtype=_I32, device=packed.device)
    b_idx = a_idx + p
    w = width
    common = dict(w=w, gO=gO, gE=gE, cm_tuple=cm_tuple, ulen=ulen)
    p1 = phase1_indexed(packed, a_idx, b_idx, lengths, la_max=la_max, **common)

    def run_phase2(dove_start, dove_len):
        return phase2_indexed(packed, a_idx, b_idx, dove_start.contiguous(),
                              dove_len.contiguous(), lengths, la_max=la_max,
                              zero_row=w // 2, **common)

    return dovetail_glue(
        p1, run_phase2, a_len, b_len, width=w, min_identity=min_identity,
        min_overlap=min_overlap, max_ignore=max_ignore,
    )
