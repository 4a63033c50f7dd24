"""Narrow-type probe of the DP's max / add / compare / select mix on the card.

Port of the TPU probe ``tools/dtype_probe.py`` (``kernel`` :33): ITERS =
2,000 steps on [14, P] blocks x, y of one integer type of

    xs = x shifted down one row (row 0 takes 0)
    m  = max(x + 1, max(xs, y));  y2 = (m == x) ? y + 1 : m
    x  = max(m - 1, y2);          y = y2

and the output x + y, every add wrapping in two's complement as XLA's does
(the int8 variant wraps within about 128 steps).  Variants:

  int32, int16, int8   one column a thread in its own type;
  int16x2, int8x4      the int16 / int8 block with 2 / 4 neighbouring
                       columns in one 32-bit register (SIMD video
                       intrinsics): the only way this card gives narrow
                       types more throughput.

``dtype_probe`` launches the kernel of csrc/probes.cu for CUDA tensors and
counts its launches in ``launches``; for CPU tensors it runs
``dtype_probe_plain``, the plain PyTorch version.

    python -m sequence_aligner_tpu_torch.probes.dtype_probe

times every variant at the TPU probe's P = 1024 and at a size that fills the
card, and prints the int32 / int16 speed ratio the TPU probe printed.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from sequence_aligner_tpu_torch import probes
from sequence_aligner_tpu_torch.device import resolve_device
from sequence_aligner_tpu_torch.measure import bound_ms, card, event_ms

ROWS, ITERS = 14, 2000
VARIANTS = ("int32", "int16", "int8", "int16x2", "int8x4")
# one step on one value, with Hopper's fused add-max (VIADDMNMX) as one
# operation: max(x + 1, max(xs, y)) 2, the compare, y + 1 and the select 3,
# max(m - 1, y2) 1
OPS_PER_STEP = 6
_BITS = {torch.int32: 32, torch.int16: 16, torch.int8: 8}

# kernel launches by variant since import (or since a caller set them to 0)
launches = dict.fromkeys(VARIANTS, 0)


def probe_inputs(p: int, dtype: str, *, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The TPU probe's inputs: base in [-100, 100) of shape [14, p];
    x = base, y = base // 2, in ``dtype``."""
    base = np.random.RandomState(seed).randint(-100, 100, (ROWS, p))
    return base.astype(dtype), (base // 2).astype(dtype)


def dtype_probe_plain(x: torch.Tensor, y: torch.Tensor, *, iters: int = ITERS) -> torch.Tensor:
    """The plain PyTorch version: the same steps as tensor ops in the
    inputs' type (PyTorch's integer adds wrap in two's complement)."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xs = torch.cat([zero, x[:-1]])
        m = torch.maximum(x + one, torch.maximum(xs, y))
        y2 = torch.where(m == x, y + one, m)
        x = torch.maximum(m - one, y2)
        y = y2
    return x + y


def _variant(dtype: torch.dtype, packed: bool) -> str:
    name = str(dtype).removeprefix("torch.")
    return name + {16: "x2", 8: "x4"}[_BITS[dtype]] if packed else name


def dtype_probe(x: torch.Tensor, y: torch.Tensor, *, packed: bool = False,
                iters: int = ITERS) -> torch.Tensor:
    """ITERS steps on x, y [14, P] of int32, int16 or int8 -> x + y [14, P].
    ``packed`` (int16, int8) runs the SIMD form: P must be a multiple of 2
    (int16) or 4 (int8)."""
    if x.dtype not in _BITS or y.dtype != x.dtype:
        raise TypeError("x and y must both be int32, int16 or int8")
    if x.dim() != 2 or x.shape[0] != ROWS or y.shape != x.shape \
            or not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"x and y must be contiguous [{ROWS}, P] tensors of one shape")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    bits = _BITS[x.dtype]
    lanes = 32 // bits
    if packed and (bits == 32 or x.shape[1] % lanes):
        raise ValueError(f"the packed form takes int16 / int8 with P a multiple of {lanes}")
    if x.device.type == "cpu":
        return dtype_probe_plain(x, y, iters=iters)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = torch.empty_like(x)
    if x.shape[1] == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    so = probes.lib()
    if packed:
        rc = so.dtype_probe_packed_launch(lanes, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                          x.shape[1] // lanes, iters, stream)
    else:
        rc = so.dtype_probe_launch(bits, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                   x.shape[1], iters, stream)
    variant = _variant(x.dtype, packed)
    if rc != 0:
        raise RuntimeError(f"dtype probe kernel ({variant}) launch failed: CUDA error {rc}")
    launches[variant] += 1
    return out


def measure(sizes=probes.SIZES, *, reps: int = 10) -> list[dict]:
    """Every variant at each P of ``sizes`` on the card: checked equal to its
    plain version (tolerance 0, raises otherwise), then timed with CUDA
    events beside the plain version and the bound."""
    dev = resolve_device("cuda")  # raises where there is no card
    sms, mhz = card()
    rows = []
    for p in sizes:
        for variant in VARIANTS:
            name = variant[:-2] if variant.endswith(("x2", "x4")) else variant
            packed = name != variant
            x, y = (torch.from_numpy(a).to(dev) for a in probe_inputs(p, name, seed=p))
            got = dtype_probe(x, y, packed=packed)
            want = dtype_probe_plain(x, y)
            err = int((got.long() - want.long()).abs().max())
            if err:
                raise AssertionError(f"dtype probe {variant} at P={p} differs from its "
                                     f"plain version: max |diff| {err}")
            ms = event_ms(lambda: dtype_probe(x, y, packed=packed), reps=reps, warm=2)
            plain_ms = event_ms(lambda: dtype_probe_plain(x, y), reps=1, warm=0)  # the check just ran it
            # the card's least time for this type's work: 32 / bits lanes an
            # int32 unit through the SIMD forms, scalar or not
            lanes = 32 // _BITS[x.dtype]
            bound, by = bound_ms(OPS_PER_STEP * ITERS * ROWS * p / lanes,
                                        3 * x.numel() * x.element_size(), sms, mhz)
            rows.append(dict(variant=variant, P=p, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library_ms=None))
    return rows


def main(argv: list[str] | None = None) -> int:
    res = measure()
    for r in res:
        print(f"dtype probe {r['variant']:8s} P={r['P']:8d}: {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms)")
    for p in probes.SIZES:
        t = {r["variant"]: r["ms"] for r in res if r["P"] == p}
        print(f"P={p}: int32 / int16 {t['int32'] / t['int16']:.3f}x, "
              f"int32 / int16x2 {t['int32'] / t['int16x2']:.3f}x, "
              f"int32 / int8x4 {t['int32'] / t['int8x4']:.3f}x")
    print(json.dumps({"dtype_probe": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
