"""NumPy reference-semantics aligners (the golden parity oracle).

Copied from ``sequence_aligner_tpu/oracle/align.py``.

These reproduce, operation for operation, the reference's two aligners:

  * ``local_alignment``        — full O(N*M) Smith-Waterman with affine gaps
                                 and 3 DP matrices (src/BioLibs.scala:171-263)
  * ``fast_dovetail_alignment``— the two-phase banded "linear" dovetail
                                 aligner (src/BioLibs.scala:373-591)

including the reference's exact boundary-fill loops (which leave the last
row/column boundary cells at their zero default), running-max tracking with
strict ``>`` in row-major scan order, and backtrack branch preference
M -> X -> Y.  Where the reference would throw (all-nonpositive DP, or a
trailing read shorter than the band), we return the shared DUD failure
alignment instead — DUD never passes the validity filter, so emitted output
is unaffected.

Device implementations (ops/align_fused.py, ops/align_lax.py) are validated
cell-for-cell against this module.
"""

from __future__ import annotations

import numpy as np

from sequence_aligner_tpu_torch.core.records import AlignmentResult, Sequence
from sequence_aligner_tpu_torch.core.settings import AlignSettings, BASE_CODE

# Shared failure alignment (src/BioLibs.scala:22): errRatio == 0, never valid.
DUD = AlignmentResult(
    id_a=0, id_b=0, len_a=0, len_b=0, start=(0, 0), end=(0, 0),
    correct=0, error=1, align_len=0, align_a="", align_b="", dud=True,
)


def _codes(s: str) -> np.ndarray:
    return np.asarray([BASE_CODE.get(c, 0) for c in s], dtype=np.int32)


def _fill_affine_band(A, B, cm, gO, gE, n_rows, n_cols):
    """Shared fill for SW (n_cols == len(B)) and dovetail phase 1
    (n_cols == width).  Returns (M, X, Y, max_val, max_loc).

    Boundary handling replicates the reference loops exactly
    (src/BioLibs.scala:399-409 / :181-191): row loop writes rows
    0..n_rows-1 of column 0, then the column loop overwrites row 0 for
    columns 0..n_cols-1; untouched cells stay 0.
    """
    M = np.zeros((n_rows + 1, n_cols + 1), dtype=np.int64)
    X = np.zeros_like(M)
    Y = np.zeros_like(M)
    for i in range(n_rows):
        Y[i, 0] = gO + i * gE
    for j in range(n_cols):
        X[0, j] = gO + j * gE
        Y[0, j] = 0
    best = 0
    best_loc = (0, 0)
    sub = cm[A[:, None], B[None, :n_cols]]  # (n_rows, n_cols) match scores
    for i in range(1, n_rows + 1):
        Mi, Mp = M[i], M[i - 1]
        Xi, Xp = X[i], X[i - 1]
        Yi, Yp = Y[i], Y[i - 1]
        # M and Y depend only on the previous row -> vectorized
        Mi[1:] = sub[i - 1] + np.maximum(
            np.maximum(Mp[:-1], Yp[:-1]), np.maximum(Xp[:-1], 0)
        )
        Yi[1:] = gE + np.maximum(
            np.maximum(Mp[1:] + gO, Yp[1:]), np.maximum(Xp[1:] + gO, 0)
        )
        # X has an in-row dependency -> short scalar loop over the band
        for j in range(1, n_cols + 1):
            Xi[j] = gE + max(Mi[j - 1] + gO, Yi[j - 1] + gO, Xi[j - 1], 0)
        row_t = np.maximum(Mi[1:], np.maximum(Xi[1:], Yi[1:]))
        rb = int(row_t.max()) if n_cols else 0
        if rb > best:
            best = rb
            best_loc = (i, 1 + int(np.argmax(row_t == rb)))
    return M, X, Y, best, best_loc


def local_alignment(
    seq_a: Sequence, seq_b: Sequence, s: AlignSettings, *, want_strings: bool = True
) -> AlignmentResult:
    """Full Smith-Waterman with affine gaps (src/BioLibs.scala:171-263)."""
    A, B = seq_a.seq, seq_b.seq
    a, b = _codes(A), _codes(B)
    M, X, Y, best, (i, j) = _fill_affine_band(
        a, b, s.cost_matrix.astype(np.int64), s.gap_open, s.gap_extend,
        len(A), len(B),
    )
    if best <= 0:
        return DUD
    opt = (i, j)
    xs: list[str] = []
    ys: list[str] = []
    c = e = 0
    mx = max(M[i, j], X[i, j], Y[i, j])
    while True:
        if M[i, j] == mx:
            pa, pb = A[i - 1], B[j - 1]
            i -= 1
            j -= 1
        elif X[i, j] == mx:
            pa, pb = A[i - 1], "-"
            j -= 1
        else:  # Y[i, j] == mx
            pa, pb = "-", B[j - 1]
            i -= 1
        if pa != pb:
            e += 1
        else:
            c += 1
        xs.append(pa)
        ys.append(pb)
        mx = max(M[i, j], X[i, j], Y[i, j])
        if mx <= 0:
            break
    xs.reverse()
    ys.reverse()
    return AlignmentResult(
        id_a=seq_a.id, id_b=seq_b.id, len_a=len(A), len_b=len(B),
        start=(i, j), end=opt, correct=c, error=e, align_len=len(xs),
        align_a="".join(xs) if want_strings else None,
        align_b="".join(ys) if want_strings else None,
    )


def fast_dovetail_alignment(
    seq_a: Sequence, seq_b: Sequence, s: AlignSettings, *, want_strings: bool = True
) -> AlignmentResult:
    """Two-phase banded dovetail aligner (src/BioLibs.scala:373-591).

    Phase 1 anchors where B's prefix (first ``width`` bases) lands in A via a
    banded SW; if its backtrack does not reach B column 0 the pair is a dud
    (:464-466).  Phase 2 runs the banded DP in rotated (u, k) coordinates
    where the main diagonal is horizontal (:489-493), with out-of-band cells
    forced to 0 (:501-504), then backtracks and maps to (i, j) space.
    """
    A, B = seq_a.seq, seq_b.seq
    a, b = _codes(A), _codes(B)
    width = s.band_width(len(A))
    if len(B) < width or len(A) == 0:
        # reference would index past B's end (src/BioLibs.scala:418)
        return DUD
    cm = s.cost_matrix.astype(np.int64)
    gO, gE = s.gap_open, s.gap_extend

    # ---- phase 1: banded SW of A vs B[0:width] ----
    M, X, Y, best, (i, j) = _fill_affine_band(a, b, cm, gO, gE, len(A), width)
    if best <= 0:
        return DUD
    mx = max(M[i, j], X[i, j], Y[i, j])
    while True:
        if M[i, j] == mx:
            i -= 1
            j -= 1
        elif X[i, j] == mx:
            j -= 1
        else:
            i -= 1
        mx = max(M[i, j], X[i, j], Y[i, j])
        if mx <= 0:
            break
    if j != 0:
        return DUD

    # ---- phase 2: banded DP in rotated (u, k) coordinates ----
    dove_start = i
    dove_len = len(A) - dove_start
    zero_row = width // 2
    M2 = np.zeros((dove_len + 1, width + 1), dtype=np.int64)
    X2 = np.zeros_like(M2)
    Y2 = np.zeros_like(M2)
    best = 0
    best_loc = (0, 0)
    ks = np.arange(width + 1)
    for u in range(1, dove_len + 1):
        # u == 0 row: i == dove_start everywhere -> all boundary cells, stays 0
        ii = u + dove_start
        jj = ks - zero_row + u  # j for every k in this row
        inb = (jj > 0) & (jj <= len(B))  # ii > dove_start holds for u >= 1
        Mp, Xp, Yp = M2[u - 1], X2[u - 1], Y2[u - 1]
        # M[u,k] depends on previous row, same k (vertical in rotated space)
        subk = np.where(inb, cm[a[ii - 1], b[np.clip(jj, 1, len(B)) - 1]], 0)
        m_row = subk + np.maximum(np.maximum(Mp, Yp), np.maximum(Xp, 0))
        M2[u] = np.where(inb, m_row, 0)
        # Y[u,k] reads previous row at k+1, guarded k != width
        Yn = gE + np.maximum(
            np.maximum(Mp[1:] + gO, Yp[1:]), np.maximum(Xp[1:] + gO, 0)
        )
        y_row = np.zeros(width + 1, dtype=np.int64)
        y_row[:-1] = Yn
        Y2[u] = np.where(inb & (ks != width), y_row, 0)
        # X has the in-row dependency (k-1): scalar loop over the band
        Xu = X2[u]
        Mu, Yu = M2[u], Y2[u]
        for k in range(width + 1):
            if not inb[k] or k == 0:
                Xu[k] = 0
            else:
                Xu[k] = gE + max(Mu[k - 1] + gO, Yu[k - 1] + gO, Xu[k - 1], 0)
        row_t = np.maximum(Mu, np.maximum(Xu, Yu))
        rb = int(row_t.max())
        if rb > best:
            best = rb
            best_loc = (u, int(np.argmax(row_t == rb)))
    if best <= 0:
        return DUD

    u, k = best_loc
    opt = best_loc
    xs: list[str] = []
    ys: list[str] = []
    c = e = 0
    mx = max(M2[u, k], X2[u, k], Y2[u, k])
    while True:
        i = u + dove_start
        j = k - zero_row + u
        if M2[u, k] == mx:
            pa, pb = A[i - 1], B[j - 1]
            u -= 1
        elif X2[u, k] == mx:
            pa, pb = A[i - 1], "-"
            k -= 1
        else:  # Y2
            pa, pb = "-", B[j - 1]
            u -= 1
            k += 1
        if pa != pb:
            e += 1
        else:
            c += 1
        xs.append(pa)
        ys.append(pb)
        mx = max(M2[u, k], X2[u, k], Y2[u, k])
        if mx <= 0:
            break
    i = u + dove_start
    j = k - zero_row + u
    new_end = (opt[0] + dove_start, opt[1] - zero_row + opt[0])
    xs.reverse()
    ys.reverse()
    return AlignmentResult(
        id_a=seq_a.id, id_b=seq_b.id, len_a=len(A), len_b=len(B),
        start=(i, j), end=new_end, correct=c, error=e, align_len=len(xs),
        align_a="".join(xs) if want_strings else None,
        align_b="".join(ys) if want_strings else None,
    )
