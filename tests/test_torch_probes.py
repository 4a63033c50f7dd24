"""Port parity for the two probes of ``sequence_aligner_tpu_torch.probes``:
their plain PyTorch versions against the TPU probe kernels of ``tools/`` run
by ``pl.pallas_call(..., interpret=True)`` on the CPU, at every dtype and
variant.  The tool files keep their kernels inside ``main()``, so this file
carries a verbatim copy of the kernel bodies, checks that the copy still
appears in the tool files, and runs exactly that text.  Tolerance 0."""

import textwrap
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from sequence_aligner_tpu_torch.probes import dtype_probe as dp
from sequence_aligner_tpu_torch.probes import pack_probe as pp

ROOT = Path(__file__).resolve().parents[1]

# tools/pack_probe.py:59-86, verbatim
PACK_KERNELS = """\
    def native_kernel(x_ref, o_ref):
        def body(i, v):
            for _ in range(REPS):
                v = jnp.maximum(v, pltpu_roll(v))
            return v

        o_ref[:, :] = jax.lax.fori_loop(0, ROWS, body, x_ref[:, :])

    def pltpu_roll(v):
        return jnp.concatenate([v[1:], v[:1]], axis=0)

    def swar_max(a, b):
        # 15-bit fields at bits 0-14 and 16-30, guard bits 15 and 31:
        # borrow isolation — each field's a >= b flag lands in its guard
        GUARD = jnp.int32((1 << 15) | -(2**31))
        diff = (a | GUARD) - b
        f0 = (diff >> 15) & 1
        f1 = (diff >> 31) & 1  # arithmetic shift; & 1 keeps the flag
        mask = (f0 * jnp.int32(0x7FFF)) | ((f1 * jnp.int32(0x7FFF)) << 16)
        return b ^ ((a ^ b) & mask)

    def swar_kernel(x_ref, o_ref):
        def body(i, v):
            for _ in range(REPS):
                v = swar_max(v, pltpu_roll(v))
            return v

        o_ref[:, :] = jax.lax.fori_loop(0, ROWS, body, x_ref[:, :])
"""

# tools/dtype_probe.py:33-49, verbatim
DTYPE_KERNEL = """\
        def kernel(x_ref, y_ref, o_ref):
            x = x_ref[:]
            y = y_ref[:]
            one = jnp.ones((), dtype)

            def body(i, carry):
                x, y = carry
                z = jnp.zeros((1, P), dtype)
                xs = jnp.concatenate([z, x[:-1]], axis=0)
                m = jnp.maximum(x + one, jnp.maximum(xs, y))
                br = (m == x).astype(dtype)
                y2 = jnp.where(br == 1, y + one, m)
                x2 = jnp.maximum(m - one, y2)
                return x2, y2

            x, y = jax.lax.fori_loop(0, ITERS, body, (x, y))
            o_ref[:] = x + y
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tool,text,first", [
    ("tools/pack_probe.py", PACK_KERNELS, 59),
    ("tools/dtype_probe.py", DTYPE_KERNEL, 33),
])
def test_copies_are_verbatim(tool, text, first):
    lines = (ROOT / tool).read_text().splitlines(keepends=True)
    n = text.count("\n")
    assert "".join(lines[first - 1 : first - 1 + n]) == text


def _kernels(text: str, **free) -> dict:
    ns = dict(jax=jax, jnp=jnp, **free)
    exec(textwrap.dedent(text), ns)  # noqa: S102  (the tool's own kernel text)
    return ns


def _interpret(kernel, out_like: np.ndarray, *args: np.ndarray) -> np.ndarray:
    call = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_like.shape, out_like.dtype),
        interpret=True)
    return np.asarray(jax.jit(call)(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("variant,fields", [("native", 1), ("swar", 1), ("swar", 2)])
def test_pack_probe_plain_matches_pallas(variant, fields):
    """The plain version against the TPU kernel under the interpreter, on
    the TPU probe's input (fields=1) and with both 15-bit fields drawn."""
    p = 1024 if variant == "native" else 512  # the TPU probe's shapes
    x = pp.probe_input(p, fields=fields, seed=fields)
    k = _kernels(PACK_KERNELS, ROWS=pp.ROWS, REPS=pp.REPS)
    want = _interpret(k[f"{variant}_kernel"], x, x)
    got = pp.pack_probe(torch.from_numpy(x), variant)  # CPU tensor: the plain version
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_pack_probe_native_is_the_column_max():
    x = pp.probe_input(1024, seed=4)
    got = pp.pack_probe_plain(torch.from_numpy(x), "native").numpy()
    assert np.array_equal(got, np.broadcast_to(x.max(axis=0), x.shape))


@pytest.mark.parametrize("fields", [1, 2])
def test_pack_probe_vmax2_equals_swar(fields):
    """The 16x2 SIMD max gives SWAR's words on the probe's inputs (fields
    below 2^14, guard bits zero), each field its column max."""
    x = torch.from_numpy(pp.probe_input(512, fields=fields, seed=5))
    swar = pp.pack_probe_plain(x, "swar")
    assert torch.equal(pp.pack_probe_plain(x, "vmax2"), swar)
    xn = x.numpy()
    for sh in (0, 16):
        field = (xn >> sh) & 0x7FFF
        assert np.array_equal((swar.numpy() >> sh) & 0x7FFF,
                              np.broadcast_to(field.max(axis=0), field.shape))


@pytest.mark.parametrize("dtype", ["int32", "int16", "int8"])
def test_dtype_probe_plain_matches_pallas(dtype):
    """ITERS = 2,000 steps at the TPU probe's [14, 1024]; int8 wraps around
    on the way (within about 128 steps), int16 reaches about 4,200."""
    p = 1024
    x, y = dp.probe_inputs(p, dtype)
    k = _kernels(DTYPE_KERNEL, P=p, ITERS=dp.ITERS, dtype=getattr(jnp, dtype))
    want = _interpret(k["kernel"], x, x, y)
    got = dp.dtype_probe(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == getattr(torch, dtype) and np.array_equal(got.numpy(), want)
    if dtype == "int8":  # the wrap really happens
        short = dp.dtype_probe_plain(torch.from_numpy(x).long(), torch.from_numpy(y).long())
        assert not np.array_equal(short.numpy(), want.astype(np.int64))


def test_probe_wrappers_check_their_input():
    x = torch.zeros((13, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        pp.pack_probe(x, "int16")
    with pytest.raises(ValueError):
        pp.pack_probe(x[:12].contiguous())
    a = torch.zeros((14, 6), dtype=torch.int8)
    with pytest.raises(TypeError):
        dp.dtype_probe(a, a.short())
    with pytest.raises(ValueError, match="multiple of 4"):
        dp.dtype_probe(a, a, packed=True)
    with pytest.raises(ValueError, match="packed form"):
        dp.dtype_probe(a.int(), a.int(), packed=True)
    # on the CPU the packed form is the plain version of its type
    b = torch.from_numpy(dp.probe_inputs(8, "int8")[0])
    assert torch.equal(dp.dtype_probe(b, b, packed=True, iters=50),
                       dp.dtype_probe_plain(b, b, iters=50))
