"""Timing probes of the card's integer units (ports of the TPU probes in
``tools/``): ``pack_probe`` (does packing two 15-bit DP values into one
32-bit word pay for a max chain?) and ``dtype_probe`` (does a narrower type
give the DP's max / add / compare / select mix more throughput?).

Each module has its CUDA kernels (``csrc/probes.cu``: built from Hopper's
DPX instructions, the 3-input max and the add-max, in 32-bit and 16x2
lanes) behind a wrapper with a launch count, a plain PyTorch version beside
it, and a ``main`` that times every variant on the card:

    python -m sequence_aligner_tpu_torch.probes.pack_probe
    python -m sequence_aligner_tpu_torch.probes.dtype_probe
"""

from __future__ import annotations

import ctypes
import functools

from sequence_aligner_tpu_torch import _build

# the probes' sizes: the TPU probes' P = 1024 columns (8 of 132 SMs get a
# block: latency) and one that fills the card
SIZES = (1024, 1 << 20)

_VP, _CI = ctypes.c_void_p, ctypes.c_int


@functools.cache
def lib() -> ctypes.CDLL:
    """``csrc/probes.cu``, built at first use and bound."""
    so = _build.load("probes")
    so.pack_probe_launch.argtypes = [_CI, _VP, _VP, _CI, _CI, _VP]
    so.dtype_probe_launch.argtypes = [_CI, _VP, _VP, _VP, _CI, _CI, _VP]
    for f in (so.pack_probe_launch, so.dtype_probe_launch):
        f.restype = _CI
    return so
