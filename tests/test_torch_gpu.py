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
    """(packed read table, a_idx, b_idx, lengths, la_max) on ``dev``."""
    rng = np.random.RandomState(seed)
    seqs = simulated_reads(512, length, coverage=20.0, error_rate=0.01, seed=seed)
    if mixed:
        seqs = [Sequence(q.id, q.seq[: rng.randint(30, length + 1)]) for q in seqs]
    bases, lengths = encode_reads(seqs)
    ia = rng.randint(0, len(seqs), n_pairs)
    ib = np.clip(ia + rng.randint(-8, 9, n_pairs), 0, len(seqs) - 1)
    packed = af.pack_reads_le(torch.from_numpy(bases).to(dev))
    to = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    return packed, to(ia), to(ib), to(lengths), bases.shape[1]


def _assert_equal(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (what, i)


def _both_phases(packed, ia, ib, ln, kw):
    """Both kernels against their plain versions, phase 2 from phase 1's
    dove anchors; returns phase 2's outputs."""
    n1, n2 = af.phase1_launches, af.phase2_launches
    k1 = af.phase1_indexed(packed, ia, ib, ln, **kw)
    torch.cuda.synchronize()
    p1 = af.phase1_indexed_plain(packed, ia, ib, ln, **kw)
    _assert_equal(k1, p1, "phase1")
    a_len, b_len = ln[ia.long()], ln[ib.long()]
    ds = torch.where((p1[0] > 0) & (b_len >= kw["w"]), p1[3], p1[1]).contiguous()
    dl = (a_len - ds).contiguous()
    kw2 = dict(kw, zero_row=kw["w"] // 2)
    k2 = af.phase2_indexed(packed, ia, ib, ds, dl, ln, **kw2)
    torch.cuda.synchronize()
    _assert_equal(k2, af.phase2_indexed_plain(packed, ia, ib, ds, dl, ln, **kw2), "phase2")
    assert (af.phase1_launches, af.phase2_launches) == (n1 + 1, n2 + 1)
    return k2


# exact register instances (12, 16), the capacity instances of 24, 32, 48
# and 64 columns (20, 31, 40, 60), the general scratch instance (70)
@pytest.mark.parametrize("w,inst", [(12, "exact_a"), (16, "exact_b"), (20, "capacity24"),
                                    (31, "capacity32"), (40, "capacity48"),
                                    (60, "capacity64"), (70, "general")])
@pytest.mark.parametrize("mixed", [False, True])
def test_kernels_equal_plain_versions(cuda, w, inst, mixed):
    packed, ia, ib, ln, la_max = _batch(cuda, 3000, 150, mixed=mixed, seed=w)
    kw = dict(la_max=la_max, w=w, gO=S.gap_open, gE=S.gap_extend, cm_tuple=CM)
    assert af.instance(1, w=w, rows=la_max, cm_tuple=CM) == inst
    k2 = _both_phases(packed, ia, ib, ln, kw)
    assert (k2[0] > 0).any()


def test_uniform_length_variants_equal(cuda):
    packed, ia, ib, ln, la_max = _batch(cuda, 4096, 100, seed=3)
    kw = dict(la_max=la_max, w=12, gO=S.gap_open, gE=S.gap_extend, cm_tuple=CM)
    _assert_equal(af.phase1_indexed(packed, ia, ib, ln, ulen=100, **kw),
                  af.phase1_indexed(packed, ia, ib, ln, **kw), "p1")
    # dove starts up to 116: past |A| = 100 the dove length is negative
    ds = (torch.arange(ia.numel(), device=cuda, dtype=torch.int32) % 117).contiguous()
    dl = (ln[ia.long()] - ds).contiguous()
    kw2 = dict(kw, zero_row=6)
    k2 = af.phase2_indexed(packed, ia, ib, ds, dl, ln, **kw2)
    _assert_equal(af.phase2_indexed(packed, ia, ib, ds, dl, ln, ulen=100, **kw2), k2, "p2")
    torch.cuda.synchronize()
    _assert_equal(k2, af.phase2_indexed_plain(packed, ia, ib, ds, dl, ln, **kw2), "p2 plain")


def test_kernel_wrappers_reject_bad_input(cuda):
    packed, ia, ib, ln, la_max = _batch(cuda, 64, 100)
    kw = dict(la_max=la_max, w=12, gO=S.gap_open, gE=S.gap_extend, cm_tuple=CM)
    with pytest.raises(TypeError):
        af.phase1_indexed(packed, ia, ib, ln.long(), **kw)
    with pytest.raises(ValueError):
        af.phase1_indexed(packed, ia, ib.cpu(), ln, **kw)
    with pytest.raises(ValueError):
        af.phase1_indexed(packed, ia, ib, ln, **dict(kw, la_max=af.MAX_ROWS_WIDE + 1))
    with pytest.raises(IndexError):  # a row past the read table
        af.phase1_indexed(packed, ia, torch.full_like(ib, packed.shape[0]), ln, **kw)


def test_general_instance_takes_scores_past_16_bits(cuda):
    cm = tuple(40000 if a == b else -50000 for a in range(4) for b in range(4))
    packed, ia, ib, ln, la_max = _batch(cuda, 2000, 100, seed=11)
    kw = dict(la_max=la_max, w=12, gO=S.gap_open, gE=S.gap_extend, cm_tuple=cm)
    assert af.instance(1, w=12, rows=la_max, cm_tuple=cm) == "general"
    assert (_both_phases(packed, ia, ib, ln, kw)[0] > 0).any()


def _long_pair(dev):
    """Two reads of 33,000 bp, the second starting 10,000 bp into the first."""
    rng = np.random.RandomState(0)
    g = "".join("ACTG"[i] for i in rng.randint(0, 4, 43000))
    return [Sequence(1, g[:33000]), Sequence(2, g[10000:43000])]


def test_wide_instance_equals_plain_versions(cuda):
    """Rows past MAX_ROWS take the wide instance (32-bit row and count
    fields); both directions of the 33,000 bp pair."""
    bases, lengths = encode_reads(_long_pair(cuda))
    packed = af.pack_reads_le(torch.from_numpy(bases).to(cuda))
    ln = torch.from_numpy(lengths).to(cuda)
    ia = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    s = AlignSettings(min_identity=0.9996, max_ignore=100000, max_collisions=10**8)
    w = s.band_width(33000)
    kw = dict(la_max=33000, w=w, gO=s.gap_open, gE=s.gap_extend, cm_tuple=s.cm_tuple())
    assert af.instance(1, w=w, rows=33000, cm_tuple=s.cm_tuple()) == "wide"
    k2 = _both_phases(packed, ia, 1 - ia, ln, kw)
    assert int(k2[0].max()) > 0


def test_long_reads_on_the_card_give_the_jax_record(cuda):
    """The 33,000 bp pair through the engine on the card: the JAX engine's
    (1, 2, 10000, 10000)."""
    s = AlignSettings(min_identity=0.9996, max_ignore=100000, max_collisions=10**8)
    got = Overlapper(s, device=cuda).run_arrays(_long_pair(cuda))
    assert [a.tolist() for a in got] == [[1], [2], [10000], [10000]]


def test_one_long_read_sends_only_its_own_group_wide(cuda):
    """A 33,000 bp read among 100 bp reads: each width group's rows are its
    own longest read, so the 100 bp reads' group keeps its exact register
    instance while the long read's group takes the wide one, and the short
    reads' records are those of a run without the long read."""
    g = "".join("ACTG"[i] for i in np.random.RandomState(5).randint(0, 4, 36000))
    short = [g[p : p + 100] for p in range(0, 35900, 30)]
    reads = [Sequence(1, g[1000:34000])] + [Sequence(i + 2, q) for i, q in enumerate(short)]
    af.instance_launches.clear()
    got = Overlapper(S, device=cuda).run_arrays(reads)
    by_instance = dict(af.instance_launches)
    assert by_instance.get((1, "exact_a"), 0) >= 1, by_instance
    assert by_instance.get((1, "wide"), 0) >= 1, by_instance
    alone = Overlapper(S, device=cuda).run_arrays(
        [Sequence(i + 1, q) for i, q in enumerate(short)])
    keep = (got[0] > 1) & (got[1] > 1)  # pairs of two short reads, renumbered
    assert keep.sum() > 0
    assert np.array_equal(got[0][keep] - 1, alone[0]) and np.array_equal(got[1][keep] - 1, alone[1])
    assert np.array_equal(got[2][keep], alone[2]) and np.array_equal(got[3][keep], alone[3])


def test_engine_on_the_card_equals_the_cpu(cuda):
    seqs = simulated_reads(1024, 100, coverage=20.0, error_rate=0.01, seed=9)
    got = Overlapper(S, device=cuda).run_arrays(seqs)
    want = Overlapper(S, device="cpu").run_arrays(seqs)
    assert len(got[0]) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("w", [12, 16])
def test_phase2_on_pure_duds_equals_its_plain_version(cuda, w):
    """The mono route hands phase 2 every pair, duds included: dove length
    0 (the dove start at |A|), dove starts anywhere in A, and B shorter
    than the band."""
    rng = np.random.RandomState(w)
    seqs = simulated_reads(1024, 100, coverage=20.0, error_rate=0.01, seed=w)
    seqs = [Sequence(q.id, q.seq if q.id % 2 else q.seq[: 1 + q.id % (w - 1)]) for q in seqs]
    bases, lengths = encode_reads(seqs)
    packed = af.pack_reads_le(torch.from_numpy(bases).to(cuda))
    ln = torch.from_numpy(lengths).to(cuda)
    ia = torch.from_numpy(2 * rng.randint(0, 512, 8192)).int().to(cuda)  # 100 bp
    ib = torch.from_numpy(np.where(rng.rand(8192) < 0.75, 2 * rng.randint(0, 512, 8192) + 1,
                                   2 * rng.randint(0, 512, 8192))).int().to(cuda)
    a_len = ln[ia.long()]
    assert (ln[ib.long()] < w).float().mean() > 0.7
    kw = dict(la_max=100, w=w, zero_row=w // 2, gO=S.gap_open, gE=S.gap_extend, cm_tuple=CM)
    for ds in (a_len, torch.from_numpy(rng.randint(0, 101, 8192)).int().to(cuda) % (a_len + 1)):
        ds = ds.contiguous()
        dl = (a_len - ds).contiguous()
        k2 = af.phase2_indexed(packed, ia, ib, ds, dl, ln, **kw)
        torch.cuda.synchronize()
        _assert_equal(k2, af.phase2_indexed_plain(packed, ia, ib, ds, dl, ln, **kw), "duds")


@pytest.mark.parametrize("what", ["one_width", "two_widths"])
def test_mono_route_on_the_card_equals_the_split_route_and_the_cpu(cuda, what, monkeypatch):
    """Below 2^21 pairs a width group takes the mono route, one launch of
    each kernel; its records equal the split route's
    (``SEQALIGN_ALIGN_MONO=0``) and the CPU path's."""
    if what == "one_width":
        s, seqs = S, simulated_reads(2048, 100, coverage=20.0, error_rate=0.01, seed=13)
    else:
        s, seqs = AlignSettings.amos_parity(kmer_size=8, min_identity=0.9, max_ignore=200), \
            _mixed_width_reads()
    n_widths = len({s.band_width(len(q.seq)) for q in seqs})
    assert n_widths == (1 if what == "one_width" else 2)
    monkeypatch.delenv("SEQALIGN_ALIGN_MONO", raising=False)
    af.phase1_launches = af.phase2_launches = 0
    ov = Overlapper(s, device=cuda)
    mono = ov.run_arrays(seqs)
    assert (af.phase1_launches, af.phase2_launches) == (n_widths, n_widths)
    assert ov.stats.n_phase2_pairs == ov.stats.n_candidate_pairs
    cpu = Overlapper(s, device="cpu").run_arrays(seqs)
    monkeypatch.setenv("SEQALIGN_ALIGN_MONO", "0")
    split_ov = Overlapper(s, device=cuda)
    split = split_ov.run_arrays(seqs)
    assert split_ov.stats.n_phase2_pairs < ov.stats.n_phase2_pairs
    assert len(mono[0]) > 0
    for m, sp, c in zip(mono, split, cpu):
        assert np.array_equal(m, sp) and np.array_equal(m, c)


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


def test_pack_probe_swar_guard_set_and_clear_columns_in_one_warp(cuda):
    """Even columns guard-clear (the fused 16x2 path), odd ones guard-set
    (the emulation): both paths diverge inside every warp."""
    x = torch.from_numpy(pp.guard_input(1000, seed=8)).to(cuda)
    clear = ((x.long() & pp._GUARD) == 0).all(0)
    assert clear[0::2].all() and not clear[1::2].any()
    assert torch.equal(pp.pack_probe(x, "swar"), pp.pack_probe_plain(x, "swar"))


@pytest.mark.parametrize("variant", pp.VARIANTS)
def test_pack_probe_kernels_on_any_words(cuda, variant):
    a = np.random.RandomState(9).randint(0, 1 << 32, (pp.COLS, 1000), dtype=np.int64)
    x = torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(cuda)
    assert torch.equal(pp.pack_probe(x, variant), pp.pack_probe_plain(x, variant))


@pytest.mark.parametrize("variant", dp.VARIANTS)
def test_dtype_probe_kernels_at_the_types_limits(cuda, variant):
    """Lanes at the maximum: x + 1 and y + 1 wrap inside __viaddmax_* (a
    saturating add would differ from the plain version) and m == x holds."""
    name = variant[:-2] if variant.endswith(("x2", "x4")) else variant
    x, y = (torch.from_numpy(a).to(cuda) for a in dp.edge_inputs(1000, name, seed=10))
    assert int(x.max()) == torch.iinfo(x.dtype).max
    got = dp.dtype_probe(x, y, packed=name != variant)
    assert torch.equal(got, dp.dtype_probe_plain(x, y))


@pytest.mark.parametrize("name", ["int16", "int8"])
def test_dtype_probe_odd_p_and_offset_views(cuda, name):
    """An odd P (the last thread holds one column) and a view that starts
    one element into its storage (2-byte aligned int16)."""
    for p in (1, 1001):
        x, y = (torch.from_numpy(a).to(cuda) for a in dp.edge_inputs(p, name, seed=p))
        assert torch.equal(dp.dtype_probe(x, y), dp.dtype_probe_plain(x, y))
    x, y = (torch.from_numpy(a).to(cuda).flatten() for a in dp.probe_inputs(1000, name))
    xs, ys = (torch.cat([t[:1], t])[1:].view(dp.ROWS, 1000) for t in (x, y))
    assert xs.data_ptr() % 4 != 0 and xs.is_contiguous()
    assert torch.equal(dp.dtype_probe(xs, ys), dp.dtype_probe_plain(xs, ys))


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


@pytest.mark.parametrize("n_reads,batch_size", [(512, 1 << 20), (2048, 1 << 20), (300, 1)])
def test_quadratic_engine_on_the_card_equals_the_cpu(cuda, n_reads, batch_size):
    """fast_dovetail=False (torch ops on the card) at two sizes and with
    batch_size=1 (chunks of 128 pairs)."""
    seqs = simulated_reads(n_reads, 100, coverage=20.0, error_rate=0.01, seed=n_reads)
    ov = Overlapper(S, fast_dovetail=False, batch_size=batch_size, device=cuda)
    got = ov.run_arrays(seqs)
    want = Overlapper(S, fast_dovetail=False, batch_size=batch_size,
                      device="cpu").run_arrays(seqs)
    assert len(got[0]) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))
    if batch_size == 1:
        assert ov.quad_chunk(ov.stats.n_candidate_pairs, 100) == 128


# the four layouts on which the native reader and a text reader disagree
# ('\r>' in a body, a header ended by '\r', a 0xFF byte, a UTF-8 letter),
# each planted in a FASTA of 600 simulated reads
_PLANTS = {
    "cr_gt": lambda r: r[:-1] + b"\r",
    "cr_header": lambda r: r.replace(b"\n", b"\r", 1),
    "byte_ff": lambda r: r[:30] + b"\xff" + r[31:],
    "utf8": lambda r: r[:30] + "é".encode() + r[31:],
}


@pytest.mark.parametrize("layout", sorted(_PLANTS))
def test_run_arrays_path_on_the_card_equals_the_cpu(cuda, tmp_path, layout):
    recs = [b">r%d\n%s\n" % (q.id, q.seq.encode())
            for q in simulated_reads(600, 100, coverage=20.0, error_rate=0.01, seed=11)]
    recs[9] = _PLANTS[layout](recs[9])
    path = tmp_path / "r.fasta"
    path.write_bytes(b"".join(recs))
    got = Overlapper(S, device=cuda).run_arrays(str(path))
    want = Overlapper(S, device="cpu").run_arrays(str(path))
    assert len(got[0]) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))


def _mixed_width_reads():
    """200 reads of 120 and 64 bp (band widths 13 and 8 at k = 8,
    min_identity 0.9), as tests/test_torch_shard.py builds them."""
    from sequence_aligner_tpu_torch.pipeline.datasets import shred_genome

    rng = np.random.RandomState(5)
    genome = "".join("ACTG"[i] for i in rng.randint(0, 4, 3000))
    a = shred_genome(genome, 100, 120, error_rate=0.01, seed=1)
    b = shred_genome(genome, 100, 64, error_rate=0.01, seed=2)
    return [Sequence(i + 1, q.seq) for i, q in enumerate(x for ab in zip(a, b) for x in ab)]


@pytest.mark.parametrize("what", ["32k", "mixed_widths"])
def test_sharded_one_nccl_rank_equals_the_single_device_engine(cuda, what):
    """The sharded engine at a world size of 1 over NCCL on the card: the
    single-device engine's records, with both kernels launched on its path."""
    import torch.distributed as dist

    from sequence_aligner_tpu_torch.parallel.shard import sharded_overlap_arrays

    if what == "32k":
        s, seqs = S, simulated_reads(32000, 100, coverage=20.0, seed=0)
    else:
        s, seqs = AlignSettings.amos_parity(kmer_size=8, min_identity=0.9, max_ignore=200), \
            _mixed_width_reads()
    want = Overlapper(s, device=cuda).run_arrays(seqs)
    af.phase1_launches = af.phase2_launches = 0
    stats = {}
    got = sharded_overlap_arrays(seqs, s, device=cuda, stats=stats)
    assert min(af.phase1_launches, af.phase2_launches) >= 1
    assert (stats["backend"], stats["world"]) == ("nccl", 1)
    assert not dist.is_initialized()
    assert len(got[0]) > 0 and all(np.array_equal(g, w) for g, w in zip(got, want))


def test_make_group_refuses_gloo_on_the_card(cuda):
    import torch.distributed as dist

    from sequence_aligner_tpu_torch.parallel.mesh import make_group

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="gloo"):
            with make_group(device=cuda):
                pass
    finally:
        dist.destroy_process_group()
