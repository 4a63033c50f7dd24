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


# ---- the kernels' rewrites (csrc/probes.cu), proved on the CPU ----
#
# Torch emulations of the DPX forms the kernels use, from the CUDA Math API's
# definitions (32-bit words held in int64; 16-bit lanes worked in int64), and
# of the kernels' steps built from them, held against the plain versions.

U32 = (1 << 32) - 1


def _t(v):
    return torch.as_tensor(v, dtype=torch.int64)


def _s32(w):
    w = _t(w) & U32
    return torch.where(w >= 1 << 31, w - (1 << 32), w)


def _lanes(w):
    """(low, high) unsigned 16-bit lanes of 32-bit words."""
    w = _t(w)
    lo, hi = w & 0xFFFF, (w >> 16) & 0xFFFF
    return lo, hi


def _s16(v):
    v = _t(v) & 0xFFFF
    return torch.where(v >= 1 << 15, v - (1 << 16), v)


def _join(lo, hi):
    return ((hi & 0xFFFF) << 16) | (lo & 0xFFFF)


def _per_lane(f, signed, *ws):
    lanes = [_lanes(w) for w in ws]
    conv = _s16 if signed else (lambda v: v)
    lo = f(*(conv(a) for a, _ in lanes))
    hi = f(*(conv(b) for _, b in lanes))
    return _join(lo, hi)


def vimax3_s32(a, b, c):
    return torch.maximum(torch.maximum(_s32(a), _s32(b)), _s32(c)) & U32


def vimax3_s16x2(a, b, c):
    return _per_lane(lambda p, q, r: torch.maximum(torch.maximum(p, q), r), True, a, b, c)


def vimax3_u16x2(a, b, c):
    return _per_lane(lambda p, q, r: torch.maximum(torch.maximum(p, q), r), False, a, b, c)


def vmaxs2(a, b):
    return _per_lane(torch.maximum, True, a, b)


def viaddmax_s32(a, b, c):
    """max(a + b, c), the add wrapping in two's complement."""
    return torch.maximum(_s32(a + b), _s32(c)) & U32


def viaddmax_s16x2(a, b, c):
    return _per_lane(lambda p, q, r: torch.maximum(_s16(p + q), r), True, a, b, c)


def vminu2(a, b):
    return _per_lane(torch.minimum, False, a, b)


def _fused_chain(v, max3, steps):
    """``steps`` of pack_probe_kernel's fused loop, row by row in the
    kernel's order."""
    v = list(v)
    for _ in range(steps):
        v0, v1 = v[0], v[1]
        for r in range(pp.COLS - 2):
            v[r] = max3(v[r], v[r + 1], v[r + 2])
        v[pp.COLS - 2] = max3(v[pp.COLS - 2], v[pp.COLS - 1], v0)
        v[pp.COLS - 1] = max3(v[pp.COLS - 1], v0, v1)
    return torch.stack(v)


def pack_probe_model(x: torch.Tensor, variant: str, rows: int) -> torch.Tensor:
    """pack_probe_kernel: fused 3-input maxes; SWAR fused as the unsigned
    16x2 max on guard-clear columns, the emulation on the others."""
    v = x.long() & U32
    max3 = {"native": vimax3_s32, "vmax2": vimax3_s16x2, "swar": vimax3_u16x2}[variant]
    out = _fused_chain(v, max3, rows * pp.REPS // 2)
    if variant == "swar":  # the check at load: the OR of the column's words
        any_bits = torch.zeros_like(v[0])
        for row in v:
            any_bits |= row
        clear = (any_bits & pp._GUARD) == 0
        out = torch.where(clear, out, pp.pack_probe_plain(x, "swar", rows=rows).long() & U32)
    return pp._to_int32(out)


class Lane32:
    """dtype_probe_kernel's Lane32: one int32 column a 32-bit word."""
    columns, shift, vmax_value = 1, 0, (1 << 31) - 1
    one, minus_one, lowest = 1, U32, 1 << 31

    vmax = staticmethod(lambda a, b: torch.maximum(_s32(a), _s32(b)) & U32)
    vmax3 = staticmethod(vimax3_s32)
    addmax = staticmethod(viaddmax_s32)
    inc = staticmethod(lambda y: (y + 1) & U32)
    select_eq = staticmethod(lambda m, x, a, b: torch.where(m == x, a, b))
    top = staticmethod(_s32)


class Lane16x2:
    """dtype_probe_kernel's Lane16x2<shift>: two columns a word in signed
    16-bit lanes, int8 values in the lanes' high bytes (shift 8)."""
    columns, lowest = 2, 0x80008000

    def __init__(self, shift):
        self.shift = shift
        self.vmax_value = 0x7FFF >> shift
        self.one = 0x00010001 << shift
        self.minus_one = ((0x10000 - (1 << shift)) & 0xFFFF) * 0x10001
        self.lane_mask = ((0xFFFF << shift) & 0xFFFF) * 0x10001
        self.spread = -(0xFFFF >> shift) & U32

    vmax = staticmethod(vmaxs2)
    vmax3 = staticmethod(vimax3_s16x2)
    addmax = staticmethod(viaddmax_s16x2)

    def inc(self, y):
        """y + 1: a plain 32-bit add at shift 8 (its carry may reach the high
        lane's low byte), the add-max against the minimum at shift 0."""
        return (y + self.one) & U32 if self.shift else viaddmax_s16x2(y, self.one, self.lowest)

    def select_eq(self, m, x, a, b):
        eq = (vminu2(m ^ x, self.one) * self.spread + self.lane_mask) & U32  # the IMAD
        return (a & eq) | (b & ~eq & U32)

    def top(self, w):
        lo, hi = _lanes(w)
        return torch.maximum(_s16(lo), _s16(hi)) >> self.shift


LANES = {"int32": Lane32(), "int16": Lane16x2(0), "int8": Lane16x2(8)}
GENERAL_RUN = 32  # kGeneralRun


def _pack_words(a: np.ndarray, lane) -> torch.Tensor:
    """[14, P] of the type -> [14, threads] words as the kernel loads them."""
    if lane.columns == 1:
        return torch.from_numpy(a.astype(np.int64)) & U32
    bits = 16 if lane.shift == 0 else 8
    u = a.astype(np.int64) & ((1 << bits) - 1)
    if u.shape[1] % 2:
        u = np.concatenate([u, np.zeros((u.shape[0], 1), np.int64)], 1)
    return torch.from_numpy((u[:, 0::2] | u[:, 1::2] << 16) << lane.shift)


def _unpack_words(w: torch.Tensor, lane, p: int, dtype: str) -> np.ndarray:
    w = w.numpy()
    if lane.columns == 1:
        cols = w
    else:
        lo, hi = (w >> lane.shift) & 0xFFFF, (w >> (16 + lane.shift)) & 0xFFFF
        cols = np.stack([lo, hi], 2).reshape(w.shape[0], -1)[:, :p]
    bits = np.iinfo(dtype).bits
    cols = cols & ((1 << bits) - 1)
    return np.where(cols >= 1 << (bits - 1), cols - (1 << bits), cols).astype(dtype)


def dtype_probe_model(x: np.ndarray, y: np.ndarray, iters: int):
    """dtype_probe_kernel: per thread, the headroom check, then that many
    fast steps (max, add-max, add-max) or a run of general steps.  Returns
    (x + y, the share of thread steps that were fast)."""
    dtype = str(x.dtype)
    lane = LANES[dtype]
    xv, yv = _pack_words(x, lane), _pack_words(y, lane)
    threads = xv.shape[1]
    budget = torch.zeros(threads, dtype=torch.int64)
    fast = torch.zeros(threads, dtype=torch.bool)
    n_fast = 0
    for it in range(iters):
        need = budget == 0
        if need.any():
            acc = torch.zeros(threads, dtype=torch.int64)
            for r in range(dp.ROWS):
                acc = lane.vmax3(acc, xv[r], yv[r])
            h = lane.vmax_value - lane.top(acc)
            assert bool((h >= 0).all())
            fast = torch.where(need, h > 0, fast)
            budget = torch.where(need, torch.where(h > 0, torch.clamp(h, max=iters - it),
                                                   min(GENERAL_RUN, iters - it)), budget)
        xs = torch.cat([torch.zeros_like(xv[:1]), xv[:-1]])  # descending rows: old x
        m = lane.addmax(xv, lane.one, lane.vmax(xs, yv))
        x_fast = lane.addmax(m, lane.minus_one, m)
        y2 = lane.select_eq(m, xv, lane.inc(yv), m)
        x_gen = lane.addmax(m, lane.minus_one, y2)
        xv = torch.where(fast, x_fast, x_gen)
        yv = torch.where(fast, m, y2)
        n_fast += int(fast.sum())
        budget -= 1
    out = lane.addmax(xv, yv, lane.lowest)
    return _unpack_words(out, lane, x.shape[1], dtype), n_fast / (iters * threads)


@pytest.mark.parametrize("variant,inputs", [
    ("native", "probe"), ("native", "any"), ("vmax2", "probe"), ("vmax2", "any"),
    ("swar", "probe"), ("swar", "guard"),
])
def test_fused_pack_steps_equal_plain(variant, inputs):
    """Two in-place repetitions as one 3-input max, in the kernel's row
    order, equal the plain chain bit for bit; SWAR runs fused on the
    guard-clear columns and the emulation on the others."""
    p, rows = 96, 3
    if inputs == "probe":
        x = pp.probe_input(p, fields=1 if variant == "native" else 2, seed=11)
    elif inputs == "guard":
        x = pp.guard_input(p, seed=12)
    else:
        x = np.random.RandomState(13).randint(0, 1 << 32, (pp.COLS, p),
                                              dtype=np.int64).astype(np.uint32).view(np.int32)
    xt = torch.from_numpy(np.ascontiguousarray(x))
    want = pp.pack_probe_plain(xt, variant, rows=rows)
    assert torch.equal(pack_probe_model(xt, variant, rows), want)


@pytest.mark.parametrize("steps", [1, 2, 5])
@pytest.mark.parametrize("variant", ["native", "vmax2", "swar"])
def test_one_fused_step_is_two_repetitions(variant, steps):
    """Before the chain settles to its column maxima: ``steps`` fused steps
    (one 3-input max a row) equal twice as many repetitions of the plain
    v = op(v, roll_up(v)), on any words (SWAR on guard-clear ones)."""
    rng = np.random.RandomState(steps)
    if variant == "swar":
        x = rng.randint(0, 1 << 15, (pp.COLS, 256)) | rng.randint(0, 1 << 15, (pp.COLS, 256)) << 16
    else:
        x = rng.randint(0, 1 << 32, (pp.COLS, 256), dtype=np.int64)
    v = torch.from_numpy(x)
    max3 = {"native": vimax3_s32, "vmax2": vimax3_s16x2, "swar": vimax3_u16x2}[variant]
    step = {"native": lambda a, b: torch.maximum(_s32(a), _s32(b)) & U32,
            "vmax2": pp._vmax2, "swar": pp._swar_max}[variant]
    want = v
    for _ in range(2 * steps):
        want = step(want, torch.roll(want, -1, dims=0))
    got = _fused_chain(v, max3, steps)
    assert torch.equal(got, want & U32)
    assert not torch.equal(got, _fused_chain(v, max3, steps - 1))  # not yet settled


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_swar_on_guard_clear_words_is_the_u16x2_max(seed):
    """On words with clear guard bits swar_max is the per-field unsigned max
    (VIMNMX3.U16x2 with a repeated operand) and keeps the guard bits clear;
    on words with a guard bit set it is not, so those keep the emulation."""
    rng = np.random.RandomState(seed)
    edges = np.array([0, 1, 0x3FFF, 0x4000, 0x7FFE, 0x7FFF])
    f = lambda: np.concatenate([edges, rng.randint(0, 1 << 15, 4090)])
    a = torch.from_numpy(f() | rng.permutation(f()) << 16)
    b = torch.from_numpy(rng.permutation(f()) | f() << 16)
    got = pp._swar_max(a, b)
    assert torch.equal(got, vimax3_u16x2(a, b, b))
    assert int((got & pp._GUARD).count_nonzero()) == 0
    guard = a | pp._GUARD
    assert not torch.equal(pp._swar_max(guard, b), vimax3_u16x2(guard, b, b))


@pytest.mark.parametrize("dtype", ["int32", "int16", "int8"])
@pytest.mark.parametrize("inputs,p,iters", [
    ("probe", 64, 300), ("limits", 64, 300), ("limits", 33, 150),
])
def test_dtype_kernel_steps_equal_plain(dtype, inputs, p, iters):
    """The kernel's steps (DPX add-max, the hoisted compare, the 16x2 mask,
    int8 in the lanes' high bytes, an odd P's half-empty word) equal the
    plain version, on the probe's inputs and on lanes at the types' limits."""
    make = dp.probe_inputs if inputs == "probe" else dp.edge_inputs
    x, y = make(p, dtype, seed=p)
    got, fast = dtype_probe_model(x, y, iters)
    want = dp.dtype_probe_plain(torch.from_numpy(x), torch.from_numpy(y), iters=iters)
    assert np.array_equal(got, want.numpy())
    if inputs == "probe" and dtype != "int8":  # headroom all the way
        assert fast == 1.0
    if inputs == "limits":  # the general step really ran
        assert fast < 1.0


def test_dtype_kernel_steps_equal_plain_through_the_int8_wrap():
    """ITERS steps at int8 on the probe's inputs: values wrap again and
    again, and the kernel mostly takes general steps."""
    x, y = dp.probe_inputs(32, "int8", seed=3)
    got, fast = dtype_probe_model(x, y, dp.ITERS)
    want = dp.dtype_probe_plain(torch.from_numpy(x), torch.from_numpy(y))
    assert np.array_equal(got, want.numpy()) and fast < 0.5


@pytest.mark.parametrize("dtype", ["int32", "int16", "int8"])
def test_m_equals_x_only_at_the_maximum(dtype):
    """m = max(x + 1, xs, y) equals x only where x is the type's maximum (and
    max(xs, y) is too): x + 1 > x wherever it does not wrap.  The 16x2 select
    (an unsigned 16x2 min and an IMAD make its mask) is lane-wise m == x."""
    info = np.iinfo(dtype)
    vals = np.unique(np.array([info.max, info.max - 1, info.min, info.min + 1, 0, -1, 1,
                               np.iinfo(np.int8).max, np.iinfo(np.int8).min,
                               np.iinfo(np.int16).max, np.iinfo(np.int16).min]
                              ).clip(info.min, info.max))
    g = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), 0).reshape(3, -1)
    xi, xsi, yi = (torch.from_numpy(a.astype(dtype)) for a in g)
    m = torch.maximum(xi + 1, torch.maximum(xsi, yi))
    eq = m == xi
    assert torch.equal(eq, (xi == info.max) & (torch.maximum(xsi, yi) == info.max))
    lane = LANES[dtype]
    n = xi.numel() // lane.columns * lane.columns  # the same columns, packed

    def words(t):
        return _pack_words(t[:n].numpy()[None], lane)[0]

    y1 = yi + 1
    got = lane.select_eq(words(m), words(xi), words(y1), words(m))
    want = torch.where(eq, y1, m)[:n]
    assert np.array_equal(_unpack_words(got[None], lane, n, dtype)[0], want.numpy())


def test_sass_mix_counts_min_max_instructions_per_loop():
    """Every backward branch is a loop; its min / max instructions are
    counted by full opcode, the DPX forms apart from the plain IMNMX."""
    from sequence_aligner_tpu_torch import sass_mix

    body = sass_mix.parse("\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_117pack_probe_kernelILi2EEEvPKjPjii",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;",
        "        /*0010*/                   VIMNMX3.S16x2 R4, R5, R6, R7 ;",
        "        /*0020*/                   VIADDMNMX R4, R5, 0x1, R6, !PT ;",
        "        /*0030*/                   VIMNMX.S16x2 R4, R5, R6, !PT ;",
        "        /*0040*/              @!P0 BRA 0x10 ;",
        "        /*0050*/                   IMNMX R4, R5, R6, !PT ;",
        "        /*0060*/                   VIMNMX3 R4, R5, R6, R7 ;",
        "        /*0070*/               @P1 BRA 0x50 ;",
        "        /*0080*/                   EXIT ;",
    ]))["_ZN12_GLOBAL__N_117pack_probe_kernelILi2EEEvPKjPjii"]
    spans = sass_mix.loops(body)
    assert spans == [(0x10, 0x40), (0x50, 0x70)]
    first, second = ([(a, i) for a, i in body if lo <= a <= hi] for lo, hi in spans)
    assert sass_mix.minmax(first) == {"VIMNMX3.S16x2": 1, "VIADDMNMX": 1, "VIMNMX.S16x2": 1}
    assert sass_mix.minmax(second) == {"IMNMX": 1, "VIMNMX3": 1}


@pytest.mark.parametrize("dtype", ["int16", "int8"])
def test_16x2_increment_stays_in_its_lane(dtype):
    """y + 1 in 16x2 lanes at every pair of the type's values around -1, 0
    and the limits: each lane's value wraps on its own (at int8 the carry
    reaches only the high lane's low byte, and the select drops it)."""
    lane, info = LANES[dtype], np.iinfo(dtype)
    vals = np.array([info.min, info.min + 1, -2, -1, 0, 1, info.max - 1, info.max])
    lo, hi = (a.ravel() for a in np.meshgrid(vals, vals, indexing="ij"))
    y = _pack_words(np.stack([lo, hi], 1).reshape(1, -1).astype(dtype), lane)[0]
    want = np.stack([lo, hi], 1).reshape(1, -1).astype(dtype) + np.array(1, dtype)
    inc = lane.inc(y)
    zero = torch.zeros_like(y)
    picked = lane.select_eq(zero, zero, inc, zero)  # m == x in every lane: take y + 1
    assert np.array_equal(_unpack_words(picked[None], lane, want.shape[1], dtype), want)
    assert int((picked & ~lane.lane_mask & U32).count_nonzero()) == 0


@pytest.mark.parametrize("mangled,short", [
    ("_ZN41_GLOBAL__N__9a8b7c6d_9_probes_cu_1234567817pack_probe_kernelILi1EEEvPKjPjii",
     "pack_probe_kernel<1>"),
    ("_ZN41_GLOBAL__N__9a8b7c6d_9_probes_cu_1234567818dtype_probe_kernelINS_6Lane32EEEvPKNT_1TES5_PS3_ii",
     "dtype_probe_kernel<Lane32>"),
    ("_ZN41_GLOBAL__N__9a8b7c6d_9_probes_cu_1234567818dtype_probe_kernelINS_8Lane16x2ILi8EEEEEvPKNT_1TES6_PS4_ii",
     "dtype_probe_kernel<Lane16x2<8>>"),
    ("_ZN12_GLOBAL__N_113phase1_kernelILi16ELb1ELb0EEEvPKi", "phase1_kernel<16, true, false>"),
])
def test_sass_mix_names_kernel_instances(mangled, short):
    from sequence_aligner_tpu_torch import sass_mix

    assert sass_mix._demangle_short(mangled) == short
