"""Reads of 32,768 bp or more through the port (device="cpu", the kernels'
plain versions), against the JAX engine where its int32 stop words decode,
and against the JAX package's numpy oracle (``fast_dovetail_alignment``)
where stop rows or counts pass 2^15.  Inputs are made with numpy from a
seed; the tolerance is 0."""

import numpy as np
import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py forces)
import pytest
import torch

from sequence_aligner_tpu.core.records import Sequence as JSeq
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.models.overlapper import Overlapper as JOverlapper
from sequence_aligner_tpu.models.overlapper import _plan_tiers as j_plan_tiers
from sequence_aligner_tpu.oracle.align import fast_dovetail_alignment

from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import settings_from_jax
from sequence_aligner_tpu_torch.models.overlapper import Overlapper, _plan_tiers
from sequence_aligner_tpu_torch.ops import align_fused as af
from sequence_aligner_tpu_torch.ops.encode import encode_reads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# min_identity 0.9996 keeps the band at 14-15 columns at these lengths; the
# hang and collision limits admit the long overlap
JS = JSettings(min_identity=0.9996, max_ignore=100000, max_collisions=10**8)


def _genome(n: int) -> str:
    return "".join("ACTG"[i] for i in np.random.RandomState(0).randint(0, 4, n))


def test_reads_of_33000_bp_match_the_jax_engine():
    """Two 33,000 bp reads offset by 10,000: the JAX engine's record."""
    g = _genome(43000)
    raw = [g[:33000], g[10000:43000]]
    want = JOverlapper(JS).run_arrays([JSeq(i + 1, q) for i, q in enumerate(raw)])
    got = Overlapper(settings_from_jax(JS), device="cpu").run_arrays(
        [Sequence(i + 1, q) for i, q in enumerate(raw)])
    assert [a.tolist() for a in want] == [[1], [2], [10000], [10000]]
    for g_, w_ in zip(got, want):
        assert g_.dtype == np.int32 and np.array_equal(g_, np.asarray(w_))


def test_stop_rows_and_counts_past_15_bits_match_the_oracle():
    """Two pairs in one batch: a dove start at row 34,000 (phase 1's stop row
    past 2^15) and an overlap of 35,500 bp (phase 2's correct count past
    2^15), through the indexed wrappers and the glue, against the oracle."""
    g = _genome(38000)
    seqs = [g[:36000], g[34000:38000], g[500:36500]]
    pairs = [(seqs[0], seqs[1]), (seqs[0], seqs[2])]
    bases, lengths = encode_reads([Sequence(i + 1, q) for i, q in enumerate(seqs)])
    packed = af.pack_reads_le(torch.from_numpy(bases))
    ln = torch.from_numpy(lengths)
    a_idx = torch.tensor([0, 0], dtype=torch.int32)
    b_idx = torch.tensor([1, 2], dtype=torch.int32)
    w = JS.band_width(36000)
    common = dict(w=w, gO=JS.gap_open, gE=JS.gap_extend, cm_tuple=settings_from_jax(JS).cm_tuple())
    p1 = af.phase1_indexed(packed, a_idx, b_idx, ln, la_max=bases.shape[1], **common)

    def run_phase2(ds, dl):  # rows up to the longest dove only
        return af.phase2_indexed(packed, a_idx, b_idx, ds.contiguous(), dl.contiguous(), ln,
                                 la_max=int(dl.max()), zero_row=w // 2, **common)

    got = af.dovetail_glue(p1, run_phase2, ln[a_idx.long()], ln[b_idx.long()], width=w,
                           min_identity=JS.min_identity, min_overlap=JS.min_overlap,
                           max_ignore=JS.max_ignore)
    for n, (a, b) in enumerate(pairs):
        want = fast_dovetail_alignment(JSeq(1, a), JSeq(2, b), JS, want_strings=False)
        assert not want.dud and not got["dud"][n]
        assert (int(got["start_i"][n]), int(got["start_j"][n])) == want.start
        assert (int(got["end_i"][n]), int(got["end_j"][n])) == want.end
        assert (int(got["correct"][n]), int(got["error"][n])) == (want.correct, want.error)
    assert int(got["start_i"][0]) == 34000 and int(got["correct"][1]) == 35500
    assert bool(got["valid"].all())


@pytest.mark.parametrize("kind", ["spread", "one_long_dove", "clustered", "empty_low"])
def test_plan_tiers_equals_the_jax_planner(kind):
    """The port's tier planner (prefix sums, only edges that gained pairs
    tried) gives the JAX planner's partition."""
    rng = np.random.RandomState(sum(map(ord, kind)))
    for trial in range(12):
        la = int(rng.choice([60, 100, 150, 300]))
        counts = np.zeros(la + 2, np.int64)
        n = int(rng.choice([1, 40, 3000, 2_000_000]))
        if kind == "spread":
            idx = rng.randint(0, la + 2, n)
        elif kind == "one_long_dove":
            idx = np.full(n, la + 1 - int(rng.randint(0, 5)))
        elif kind == "clustered":
            idx = rng.choice(rng.randint(0, la + 2, 3), n)
        else:
            idx = np.clip((la + 1 - rng.exponential(la / 5, n)).astype(int), la // 2, la + 1)
        np.add.at(counts, idx, 1)
        lo0 = int(rng.randint(-1, la // 2))
        batch = int(rng.choice([256, 1 << 20]))
        assert _plan_tiers(counts, lo0, la, batch=batch) == \
            j_plan_tiers(counts, lo0, la, batch=batch), (trial, la, lo0)
