"""Narrow-type probe of the DP's max / add / compare / select mix on the card.

Port of the TPU probe ``tools/dtype_probe.py`` (``kernel`` :33): ITERS =
2,000 steps on [14, P] blocks x, y of one integer type of

    xs = x shifted down one row (row 0 takes 0)
    m  = max(x + 1, max(xs, y));  y2 = (m == x) ? y + 1 : m
    x  = max(m - 1, y2);          y = y2

and the output x + y, every add wrapping in two's complement as XLA's does
(the int8 variant wraps within about 128 steps).  Variants:

  int32             one column a thread, in 32-bit DPX instructions;
  int16, int16x2    two neighbouring columns in the 16-bit lanes of one
                    register (``__vmaxs2``, ``__viaddmax_s16x2``);
  int8, int8x4      the same, each int8 value in its lane's high byte, where
                    the 16-bit wrap is int8's.

The kernel (csrc/probes.cu) takes a step as max, add-max, add-max while the
thread's values are far enough below the type's maximum that no compare can
hold, and the whole step otherwise.  The packed names (``packed=True``) are
those of the earlier SIMD forms: they run the same kernel as their type and
keep the rule that P is a multiple of 2 (int16) or 4 (int8).  Elements are
read one by one, so any P and any view PyTorch aligns to its type are taken.

``dtype_probe`` launches the kernel for CUDA tensors and counts its launches
in ``launches``; for CPU tensors it runs ``dtype_probe_plain``, the plain
PyTorch version.

    python -m sequence_aligner_tpu_torch.probes.dtype_probe

checks every variant on the probe's inputs and on inputs at the types'
limits, times them at the TPU probe's P = 1024 and at a size that fills the
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


def edge_inputs(p: int, dtype: str, *, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """x, y [14, p] of ``dtype``, each value drawn from the type's top 64,
    its bottom 64 or the probe's [-100, 100): lanes reach the maximum, where
    x + 1 and y + 1 wrap and m == x holds, within the first steps."""
    info = np.iinfo(dtype)
    rng = np.random.RandomState(seed)

    def draw():
        pick = rng.randint(0, 3, (ROWS, p))
        top = rng.randint(info.max - 63, info.max + 1, (ROWS, p), dtype=np.int64)
        bottom = rng.randint(info.min, info.min + 64, (ROWS, p), dtype=np.int64)
        mid = rng.randint(-100, 100, (ROWS, p))
        return np.select([pick == 0, pick == 1], [top, bottom], mid).astype(dtype)

    return draw(), draw()


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
    ``packed`` (int16, int8) names the packed variant: P must be a multiple
    of 2 (int16) or 4 (int8)."""
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
    rc = probes.lib().dtype_probe_launch(bits, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                                         x.shape[1], iters,
                                         torch.cuda.current_stream(x.device).cuda_stream)
    variant = _variant(x.dtype, packed)
    if rc != 0:
        raise RuntimeError(f"dtype probe kernel ({variant}) launch failed: CUDA error {rc}")
    launches[variant] += 1
    return out


def _check(what: str, x: torch.Tensor, y: torch.Tensor, packed: bool) -> None:
    err = int((dtype_probe(x, y, packed=packed).long()
               - dtype_probe_plain(x, y).long()).abs().max())
    if err:
        raise AssertionError(f"dtype probe {what} differs from its plain version: "
                             f"max |diff| {err}")


def check_edges(p: int = 1000) -> list[str]:
    """Every variant on the card against its plain version (tolerance 0,
    raises otherwise) where the probe's inputs never go: values at the
    types' limits (``edge_inputs``), an odd P, and a view that starts one
    element into its storage.  Returns what was checked."""
    dev = resolve_device("cuda")
    done = []
    for variant in VARIANTS:
        name = variant[:-2] if variant.endswith(("x2", "x4")) else variant
        x, y = (torch.from_numpy(a).to(dev) for a in edge_inputs(p, name, seed=p))
        _check(f"{variant} at its limits, P={p}", x, y, name != variant)
        done.append(f"{variant} limits P={p}")
    for name in ("int16", "int8"):
        x, y = (torch.from_numpy(a).to(dev) for a in edge_inputs(p + 1, name, seed=p + 1))
        _check(f"{name} at odd P={p + 1}", x, y, False)
        flat = torch.from_numpy(edge_inputs(p, name, seed=p + 2)[0]).to(dev).flatten()
        store = torch.cat([flat[:1], flat])  # the view starts one element in
        xv = store[1:].view(ROWS, p)
        _check(f"{name} on a view at byte offset {xv.element_size()}", xv, xv.flip(1).contiguous(),
               False)
        done += [f"{name} odd P={p + 1}", f"{name} view offset {xv.element_size()} B"]
    return done


def measure(sizes=probes.SIZES, *, reps: int = 10, inputs: str = "probe") -> list[dict]:
    """Every variant at each P of ``sizes`` on the card: checked equal to its
    plain version (tolerance 0, raises otherwise), then timed with CUDA
    events beside the plain version and the bound.  ``inputs`` "probe" are
    the TPU probe's (``probe_inputs``); "limits" (``edge_inputs``) keep lanes
    at the type's maximum, so the kernel takes the whole step, compare and
    select included."""
    make = {"probe": probe_inputs, "limits": edge_inputs}[inputs]
    dev = resolve_device("cuda")  # raises where there is no card
    sms, mhz = card()
    rows = []
    for p in sizes:
        for variant in VARIANTS:
            name = variant[:-2] if variant.endswith(("x2", "x4")) else variant
            packed = name != variant
            x, y = (torch.from_numpy(a).to(dev) for a in make(p, name, seed=p))
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
            rows.append(dict(variant=variant, P=p, inputs=inputs, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library_ms=None))
    return rows


def main(argv: list[str] | None = None) -> int:
    print("dtype probe, equal to the plain version: " + ", ".join(check_edges()))
    res = measure() + measure(probes.SIZES[-1:], inputs="limits")
    for r in res:
        print(f"dtype probe {r['variant']:8s} P={r['P']:8d} {r['inputs']:6s}: {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms)")
    for inputs, p in sorted({(r["inputs"], r["P"]) for r in res}):
        t = {r["variant"]: r["ms"] for r in res if (r["inputs"], r["P"]) == (inputs, p)}
        print(f"P={p}, {inputs} inputs: int32 / int16 {t['int32'] / t['int16']:.3f}x, "
              f"int32 / int16x2 {t['int32'] / t['int16x2']:.3f}x, "
              f"int32 / int8x4 {t['int32'] / t['int8x4']:.3f}x")
    print(json.dumps({"dtype_probe": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
