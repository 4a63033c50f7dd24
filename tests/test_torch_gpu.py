"""On-card tests of the port's CUDA kernels against their plain PyTorch
versions (exact), and of the engine on the card against the CPU.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card, which skips
the test where there is none.  Run them on a machine with an NVIDIA GPU and
nvcc:

    python -m pytest tests/test_torch_gpu.py -q -m gpu
"""

import numpy as np
import jax  # noqa: F401  (imported like every port test; unused on the card)
import pytest
import torch

from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import AlignSettings
from sequence_aligner_tpu_torch.models.overlapper import Overlapper
from sequence_aligner_tpu_torch.ops import align_fused as af
from sequence_aligner_tpu_torch.ops import pairgen
from sequence_aligner_tpu_torch.ops.encode import encode_reads
from sequence_aligner_tpu_torch.ops.kmer import kmer_scan
from sequence_aligner_tpu_torch.pipeline.datasets import (
    planted_repeat_reads, simulated_reads, write_seq,
)
from sequence_aligner_tpu_torch.probes import dtype_probe as dp
from sequence_aligner_tpu_torch.probes import pack_probe as pp

pytestmark = pytest.mark.gpu

S = AlignSettings()
CM = S.cm_tuple()


@pytest.fixture
def cuda():
    # decided here, per test, never at import or collection time
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _batch(dev, n_pairs, length, *, mixed=False, seed=0):
    rng = np.random.RandomState(seed)
    seqs = simulated_reads(512, length, coverage=20.0, error_rate=0.01, seed=seed)
    if mixed:
        seqs = [Sequence(q.id, q.seq[: rng.randint(30, length + 1)]) for q in seqs]
    bases, lengths = encode_reads(seqs)
    ia = rng.randint(0, len(seqs), n_pairs)
    ib = np.clip(ia + rng.randint(-8, 9, n_pairs), 0, len(seqs) - 1)
    packed = af.pack_reads_le(torch.from_numpy(bases).to(dev))
    ln = torch.from_numpy(lengths).to(dev)
    ia, ib = torch.from_numpy(ia).to(dev), torch.from_numpy(ib).to(dev)
    return (packed[ia].t().contiguous(), packed[ib].t().contiguous(),
            ln[ia].contiguous(), ln[ib].contiguous(), bases.shape[1])


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (what, i)


@pytest.mark.parametrize("w", [12, 20, 40, 70])  # register capacities 16/32/64, scratch
@pytest.mark.parametrize("mixed", [False, True])
def test_kernels_equal_plain_versions(cuda, w, mixed):
    aw, bw, la, lb, la_max = _batch(cuda, 3000, 150, mixed=mixed, seed=w)
    kw = dict(la_max=la_max, w=w, gO=S.gap_open, gE=S.gap_extend, cm_tuple=CM)
    n1, n2 = af.phase1_launches, af.phase2_launches
    k1 = af.phase1(aw, bw, la, **kw)
    torch.cuda.synchronize()
    p1 = af.phase1_plain(aw, bw, la, **kw)
    _assert_equal(k1, p1, "phase1")
    ds = torch.where((p1[0] > 0) & (lb >= w), p1[3], p1[1]).contiguous()
    dl = (la - ds).contiguous()
    kw2 = dict(kw, zero_row=w // 2)
    k2 = af.phase2(aw, bw, ds, dl, lb, **kw2)
    torch.cuda.synchronize()
    _assert_equal(k2, af.phase2_plain(aw, bw, ds, dl, lb, **kw2), "phase2")
    assert (af.phase1_launches, af.phase2_launches) == (n1 + 1, n2 + 1)
    assert (k2[0] > 0).any()


def test_uniform_length_variants_equal(cuda):
    aw, bw, la, lb, la_max = _batch(cuda, 4096, 100, seed=3)
    kw = dict(la_max=la_max, w=12, gO=S.gap_open, gE=S.gap_extend, cm_tuple=CM)
    _assert_equal(af.phase1(aw, bw, la, ulen=100, **kw), af.phase1(aw, bw, la, **kw), "p1")
    ds = (torch.arange(la.numel(), device=cuda, dtype=torch.int32) % 101).contiguous()
    dl = (la - ds).contiguous()
    kw2 = dict(kw, zero_row=6)
    _assert_equal(af.phase2(aw, bw, ds, dl, lb, ulen=100, **kw2),
                  af.phase2(aw, bw, ds, dl, lb, **kw2), "p2")
    torch.cuda.synchronize()


def test_kernel_wrappers_reject_bad_input(cuda):
    aw, bw, la, lb, la_max = _batch(cuda, 64, 100)
    kw = dict(la_max=la_max, w=12, gO=S.gap_open, gE=S.gap_extend, cm_tuple=CM)
    with pytest.raises(TypeError):
        af.phase1(aw, bw, la.long(), **kw)
    with pytest.raises(ValueError):
        af.phase1(aw, bw.cpu(), la, **kw)
    with pytest.raises(ValueError):
        af.phase1(aw, bw, la, **dict(kw, la_max=1 << 15))


def test_engine_on_the_card_equals_the_cpu(cuda):
    seqs = simulated_reads(1024, 100, coverage=20.0, error_rate=0.01, seed=9)
    got = Overlapper(S, device=cuda).run_arrays(seqs)
    want = Overlapper(S, device="cpu").run_arrays(seqs)
    assert len(got[0]) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("p", [1024, 1000])  # one ragged block
@pytest.mark.parametrize("variant", pp.VARIANTS)
def test_pack_probe_kernels_equal_plain_versions(cuda, variant, p):
    x = torch.from_numpy(pp.probe_input(p, fields=1 if variant == "native" else 2,
                                        seed=p)).to(cuda)
    n = pp.launches[variant]
    got = pp.pack_probe(x, variant)
    torch.cuda.synchronize()
    assert pp.launches[variant] == n + 1
    assert torch.equal(got, pp.pack_probe_plain(x, variant))
    if variant == "native":
        assert torch.equal(got, torch.amax(x, 0, keepdim=True).expand_as(x))


@pytest.mark.parametrize("p", [1024, 1000])
@pytest.mark.parametrize("variant", dp.VARIANTS)
def test_dtype_probe_kernels_equal_plain_versions(cuda, variant, p):
    name = variant[:-2] if variant.endswith(("x2", "x4")) else variant
    packed = name != variant
    x, y = (torch.from_numpy(a).to(cuda) for a in dp.probe_inputs(p, name, seed=p))
    n = dp.launches[variant]
    got = dp.dtype_probe(x, y, packed=packed)
    torch.cuda.synchronize()
    assert dp.launches[variant] == n + 1
    assert torch.equal(got, dp.dtype_probe_plain(x, y))


def test_ids_past_16_bits_on_the_card_equal_the_cpu(cuda):
    bases, lengths = encode_reads(simulated_reads(4000, 100, coverage=20.0, seed=5))
    ids = torch.arange(70001, 74001, dtype=torch.int32)
    geom = dict(head_edge=S.kmer_head_edge, tail_edge=S.kmer_tail_edge,
                mid_lead=S.kmer_mid_lead_edge, mid_tail=S.kmer_mid_tail_edge)
    kw = dict(min_collisions=S.min_collisions, max_collisions=S.max_collisions,
              cap_head=1 << 22, cap_tail=1 << 22, cap_out=1 << 20, **geom)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        occ = pairgen.sort_occurrences(kmer_scan(torch.from_numpy(bases).to(dev),
                                                 torch.from_numpy(lengths).to(dev),
                                                 ids.to(dev), 12))
        out[dev.type] = pairgen.candidate_pairs_stream(occ, chunk=1 << 16, **kw)
    a, b = out["cuda"], out["cpu"]
    assert a["n_out"] == b["n_out"] > 0 and int(a["lead"].max()) > 70000
    for f in ("lead", "trail", "count"):
        assert torch.equal(a[f].cpu(), b[f])


def test_stream_and_prescreen_on_the_card_equal_the_cpu(cuda, tmp_path):
    seqs = simulated_reads(1500, 100, coverage=20.0, error_rate=0.01, seed=6)
    path = str(tmp_path / "r.fasta")
    write_seq(seqs, path)
    s = AlignSettings.amos_parity()
    got = Overlapper(s, device=cuda).run_stream_arrays(path, chunk_reads=256)
    want = Overlapper(s, device="cpu").run_arrays(seqs)
    assert len(got[0]) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))
    rep = planted_repeat_reads(1500, 100, seed=7)
    n_cand = []
    for screen in (False, True):
        ov = Overlapper(s, prescreen=screen, device=cuda)
        got = ov.run_arrays(rep)
        want = Overlapper(s, prescreen=screen, device="cpu").run_arrays(rep)
        assert len(got[0]) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))
        n_cand.append(ov.stats.n_candidate_pairs)
    assert n_cand[1] < n_cand[0]  # the screen dropped candidates on the card
