"""Two-fields-per-int32 (SWAR) probe for the DP's max chains on the card.

Port of the TPU probe ``tools/pack_probe.py`` (``native_kernel`` :59 and
``swar_kernel`` :80): ROWS x REPS = 3,000 steps of ``v = op(v, roll_up(v))``
on a [13, P] int32 block, where ``roll_up(v)[r] = v[(r + 1) % 13]`` and op is

  native  int32 max on [13, P];
  swar    the guard-bit emulation ``swar_max`` of two 15-bit fields a word
          (bits 0-14 and 16-30, guard bits 15 and 31), on [13, P / 2] —
          the same logical volume;
  vmax2   the card's own answer: the same words through the signed 16x2
          max, which on the probe's inputs (fields below 2^14, guard bits
          zero) gives SWAR's words.

``pack_probe`` launches ``pack_probe_kernel`` (csrc/probes.cu) for CUDA
tensors and counts its launches in ``launches``; for CPU tensors it runs
``pack_probe_plain``, the plain PyTorch version.  The kernel takes two
repetitions as one 3-input max (Hopper's VIMNMX3: max is associative and
idempotent), and runs SWAR that way, as the 16x2 unsigned max, on every
column whose words all have clear guard bits (there ``swar_max`` is that
max); a column with a guard bit set runs the emulation.  Native's output
is the column max broadcast over rows (``amax``); the probe exists to time
the chain, not to compute it.

    python -m sequence_aligner_tpu_torch.probes.pack_probe

times every variant at the TPU probe's P = 1024 and at a size that fills the
card, against its plain version and its bound, and prints SWAR / native.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from sequence_aligner_tpu_torch import probes
from sequence_aligner_tpu_torch.device import resolve_device
from sequence_aligner_tpu_torch.measure import bound_ms, card, event_ms

ROWS, REPS, COLS = 100, 30, 13
VARIANTS = ("native", "swar", "vmax2")
_MODE = {"native": 0, "swar": 1, "vmax2": 2}
_GUARD = (1 << 15) | (1 << 31)
_U32 = (1 << 32) - 1

# kernel launches by variant since import (or since a caller set them to 0)
launches = dict.fromkeys(VARIANTS, 0)


def probe_input(p: int, *, fields: int = 1, seed: int = 0) -> np.ndarray:
    """[13, p] int32: the TPU probe's input (values in [0, 2^14)) in the low
    field; with ``fields=2`` the high field (bits 16-29) is drawn too."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 1 << 14, (COLS, p)).astype(np.int32)
    if fields == 2:
        x |= rng.randint(0, 1 << 14, (COLS, p)).astype(np.int32) << 16
    return x


def guard_input(p: int, *, seed: int = 0) -> np.ndarray:
    """[13, p] int32 for SWAR where columns of both kinds share a warp: even
    columns have two 15-bit fields of any value (guard bits clear), odd ones
    any 32-bit words (guard bits set)."""
    rng = np.random.RandomState(seed)
    clear = rng.randint(0, 1 << 15, (COLS, p)) | rng.randint(0, 1 << 15, (COLS, p)) << 16
    any_bits = rng.randint(0, 1 << 32, (COLS, p), dtype=np.int64)
    words = np.where(np.arange(p) % 2 == 0, clear, any_bits)
    return words.astype(np.uint32).view(np.int32)


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit patterns -> int32 with those bits."""
    v = v & _U32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _swar_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``swar_max`` of tools/pack_probe.py on 32-bit patterns held in int64."""
    diff = ((a | _GUARD) - b) & _U32  # the int32 wrap of (a | GUARD) - b
    f0 = (diff >> 15) & 1
    f1 = (diff >> 31) & 1
    mask = (f0 * 0x7FFF) | ((f1 * 0x7FFF) << 16)
    return b ^ ((a ^ b) & mask)


def _halves(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed low and high 16-bit fields of 32-bit patterns held in int64."""
    lo, hi = v & 0xFFFF, (v >> 16) & 0xFFFF
    return lo - ((lo & 0x8000) << 1), hi - ((hi & 0x8000) << 1)


def _vmax2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (alo, ahi), (blo, bhi) = _halves(a), _halves(b)
    return ((torch.maximum(ahi, bhi) & 0xFFFF) << 16) | (torch.maximum(alo, blo) & 0xFFFF)


def pack_probe_plain(x: torch.Tensor, variant: str = "native", *, rows: int = ROWS) -> torch.Tensor:
    """The plain PyTorch version: the same steps as tensor ops, in int64 so
    the 32-bit wrap is explicit."""
    step = {"native": torch.maximum, "swar": _swar_max, "vmax2": _vmax2}[variant]
    v = x.to(torch.int64)
    if variant != "native":
        v = v & _U32
    for _ in range(rows * REPS):
        v = step(v, torch.roll(v, -1, dims=0))
    return _to_int32(v)


def pack_probe(x: torch.Tensor, variant: str = "native", *, rows: int = ROWS) -> torch.Tensor:
    """3,000-step chain (ROWS x REPS) on x [13, P] int32 -> [13, P] int32."""
    if variant not in _MODE:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32 or x.dim() != 2 \
            or x.shape[0] != COLS or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [{COLS}, P] int32 tensor")
    if rows < 0:
        raise ValueError("rows must be >= 0")
    if x.device.type == "cpu":
        return pack_probe_plain(x, variant, rows=rows)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = torch.empty_like(x)
    if x.shape[1] == 0:
        return out
    rc = probes.lib().pack_probe_launch(
        _MODE[variant], x.data_ptr(), out.data_ptr(), x.shape[1], rows,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pack_probe_kernel ({variant}) launch failed: CUDA error {rc}")
    launches[variant] += 1
    return out


def check_edges(p: int = 1000) -> list[str]:
    """Every variant on the card against its plain version (tolerance 0,
    raises otherwise) where the probe's inputs never go: SWAR on
    ``guard_input`` (guard-set and guard-clear columns in one warp), and
    every variant on any 32-bit words.  Returns what was checked."""
    dev = resolve_device("cuda")
    rng = np.random.RandomState(p)
    cases = [("swar", "guard-set and guard-clear columns", guard_input(p, seed=p))]
    words = rng.randint(0, 1 << 32, (COLS, p), dtype=np.int64).astype(np.uint32).view(np.int32)
    cases += [(v, "any 32-bit words", words) for v in VARIANTS]
    for variant, what, a in cases:
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        err = int((pack_probe(x, variant).long()
                   - pack_probe_plain(x, variant).long()).abs().max())
        if err:
            raise AssertionError(f"pack probe {variant} on {what} differs from its plain "
                                 f"version: max |diff| {err}")
    return [f"{v} on {w}, P={p}" for v, w, _ in cases]


def measure(sizes=probes.SIZES, *, reps: int = 20) -> list[dict]:
    """Every variant at each P of ``sizes`` on the card: checked equal to its
    plain version (tolerance 0, raises otherwise), then timed with CUDA
    events beside the plain version, the bound and, for native, ``amax``."""
    dev = resolve_device("cuda")  # raises where there is no card
    sms, mhz = card()
    rows = []
    for p in sizes:
        for variant in VARIANTS:
            words = p if variant == "native" else p // 2  # same logical volume
            x = torch.from_numpy(probe_input(words, fields=1 if variant == "native" else 2,
                                             seed=p)).to(dev)
            got = pack_probe(x, variant)
            want = pack_probe_plain(x, variant)
            err = int((got.long() - want.long()).abs().max())
            if err:
                raise AssertionError(f"pack probe {variant} at P={p} differs from its "
                                     f"plain version: max |diff| {err}")
            ms = event_ms(lambda: pack_probe(x, variant), reps=reps, warm=2)
            plain_ms = event_ms(lambda: pack_probe_plain(x, variant), reps=1, warm=0)  # the check just ran it
            library_ms = None
            if variant == "native":  # the output is the column max, one amax
                library_ms = event_ms(lambda: torch.amax(x, 0, keepdim=True), reps=reps)
                if not torch.equal(got, torch.amax(x, 0, keepdim=True).expand_as(x)):
                    raise AssertionError("pack probe native is not the column max")
            # one int32-lane operation per word per step: a max, or one 16x2
            # SIMD max doing both fields
            bound, by = bound_ms(ROWS * REPS * COLS * words, 2 * 4 * COLS * words,
                                        sms, mhz)
            rows.append(dict(variant=variant, P=p, words=words, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library_ms=library_ms))
    return rows


def main(argv: list[str] | None = None) -> int:
    print("pack probe, equal to the plain version: " + "; ".join(check_edges()))
    res = measure()
    for r in res:
        print(f"pack probe {r['variant']:6s} P={r['P']:8d} [13, {r['words']}]: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms"
              + (f", amax {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
              + ")")
    for p in probes.SIZES:
        t = {r["variant"]: r["ms"] for r in res if r["P"] == p}
        print(f"P={p}: SWAR / native {t['swar'] / t['native']:.3f}x, "
              f"vmax2 / native {t['vmax2'] / t['native']:.3f}x (equal logical volume)")
    print(json.dumps({"pack_probe": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
