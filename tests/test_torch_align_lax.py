"""Port parity for the quadratic path: ``ops.align_lax.local_align_batch``
(torch ops) against the JAX ``local_align_batch``, and the engine with
``fast_dovetail=False`` against the JAX engine's, including its chunking
(``batch_size=1`` and a traceback-code budget that forces several chunks),
plus the engine's host-facing ``_candidates`` / ``_align`` for both
aligners.  Inputs are made with numpy from a seed; the tolerance is 0."""

import numpy as np
import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py forces)
import jax.numpy as jnp
import pytest
import torch

from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.models.overlapper import Overlapper as JOverlapper
from sequence_aligner_tpu.ops.align_lax import local_align_batch as j_local_align_batch
from sequence_aligner_tpu.ops.encode import encode_reads as j_encode
from sequence_aligner_tpu.pipeline.datasets import simulated_reads as j_sim

from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import settings_from_jax
from sequence_aligner_tpu_torch.models import overlapper as ovmod
from sequence_aligner_tpu_torch.models.overlapper import Overlapper
from sequence_aligner_tpu_torch.ops import align_lax
from sequence_aligner_tpu_torch.ops.align_lax import OUT_KEYS, local_align_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a HOXD-style matrix of another scale than the default HOXD70 (A, C, T, G order)
HOXD_OTHER = np.array([[67, -96, -117, -31], [-96, 100, -31, -125],
                       [-117, -31, 67, -96], [-31, -125, -96, 100]], np.int32)


def _pairs(n=240, l_max=150, seed=0):
    """Pairs of unequal lengths 5..150 bp: B is A shifted by 0..59 bases
    with 3% substitutions (so many pairs overlap), or random."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 4, (n, l_max)).astype(np.int8)
    b = rng.randint(0, 4, (n, l_max)).astype(np.int8)
    for p in range(n // 2):
        s = rng.randint(0, 60)
        b[p, : l_max - s] = a[p, s:]
        m = rng.rand(l_max) < 0.03
        b[p, m] = rng.randint(0, 4, int(m.sum()))
    al = rng.randint(5, l_max + 1, n).astype(np.int32)
    bl = rng.randint(5, l_max + 1, n).astype(np.int32)
    bl[: n // 4] = np.clip(al[: n // 4] + rng.randint(-5, 6, n // 4), 5, l_max)
    for p in range(n):
        a[p, al[p]:] = 0
        b[p, bl[p]:] = 0
    return a, al, b, bl


@pytest.mark.parametrize("matrix", ["default", "hoxd_other"])
@pytest.mark.parametrize("gaps", [(-200, -20), (-120, -45)])
def test_local_align_batch_equals_jax(matrix, gaps):
    js = JSettings() if matrix == "default" else JSettings(cost_matrix=HOXD_OTHER)
    a, al, b, bl = _pairs(seed=1 if matrix == "default" else 2)
    kw = dict(gO=gaps[0], gE=gaps[1], min_identity=js.min_identity,
              min_overlap=js.min_overlap, max_ignore=js.max_ignore, la_max=150, lb_max=150)
    want = j_local_align_batch(jnp.asarray(a), jnp.asarray(al), jnp.asarray(b), jnp.asarray(bl),
                               cm=jnp.asarray(js.cost_matrix), **kw)
    n0 = align_lax.calls
    got = local_align_batch(torch.from_numpy(a), torch.from_numpy(al), torch.from_numpy(b),
                            torch.from_numpy(bl), cm=js.cost_matrix, **kw)
    assert align_lax.calls == n0 + 1
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == (np.bool_ if w.dtype == np.bool_ else np.int32), k
        assert np.array_equal(g, w), k
    assert 0 < int(np.asarray(want["valid"]).sum()) < len(a)


def _engine_pair(seqs, js, **kw):
    want = JOverlapper(js, fast_dovetail=False, **kw).run_arrays(seqs)
    ov = Overlapper(settings_from_jax(js), fast_dovetail=False, device="cpu", **kw)
    got = ov.run_arrays([Sequence(q.id, q.seq) for q in seqs])
    assert len(want[0]) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
    return ov


def test_quadratic_engine_equals_jax_300_reads():
    seqs = j_sim(300, 100, coverage=20.0, error_rate=0.02, seed=5)
    ov = _engine_pair(seqs, JSettings())
    assert ov.stats.n_valid == len(ov.run_arrays([Sequence(q.id, q.seq) for q in seqs])[0])


def test_quadratic_engine_batch_size_one_and_chunk_budget(monkeypatch):
    """batch_size=1 (the CLI's --single-align): chunks of 128 pairs, as the
    JAX engine's _bs_pblk clamps; then a traceback-code budget of 40 pairs
    (101^2 bytes each) with the default batch: the same records."""
    seqs = j_sim(60, 100, coverage=20.0, error_rate=0.02, seed=6)
    js = JSettings()
    n0 = align_lax.calls
    ov = _engine_pair(seqs, js, batch_size=1)
    n_pairs = ov.stats.n_candidate_pairs
    assert ov.quad_chunk(n_pairs, 100) == 128
    assert align_lax.calls - n0 == -(-n_pairs // 128) > 1
    monkeypatch.setattr(ovmod, "QUAD_DIRS_BUDGET", 40 * 101 * 101)
    n0 = align_lax.calls
    ov = _engine_pair(seqs, js)
    assert align_lax.calls - n0 == -(-n_pairs // 40)


@pytest.mark.parametrize("fast_dovetail", [True, False])
def test_host_candidates_and_align_equal_jax(fast_dovetail):
    """The bench modes' host-facing stages: the candidate list and every
    per-pair result key of both aligners equal the JAX engine's."""
    seqs = j_sim(120, 100, coverage=15.0, error_rate=0.02, seed=8)
    js = JSettings()
    bases, lengths = j_encode(seqs)
    jov = JOverlapper(js, fast_dovetail=fast_dovetail)
    want_lead, want_trail = jov._candidates(jov._occurrences(bases, lengths), bases, lengths)
    ov = Overlapper(settings_from_jax(js), fast_dovetail=fast_dovetail, device="cpu")
    lead, trail = ov._candidates(ov._occurrences(torch.from_numpy(bases), lengths),
                                 bases, lengths)
    assert np.array_equal(lead, want_lead) and np.array_equal(trail, want_trail)
    want = jov._align(bases, lengths, want_lead, want_trail)
    got = ov._align(bases, lengths, lead, trail)
    assert set(got) == set(want) == set(OUT_KEYS)
    for k in OUT_KEYS:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert 0 < int(got["valid"].sum()) < len(lead)
