"""Port parity: the plain PyTorch versions of the two dovetail kernels and
their glue, against the JAX package's lax.scan formulation
(``fast_dovetail_batch_fused``) and its Pallas kernels run under the Pallas
interpreter (``phase1_fused_packed`` / ``phase2_fused_packed`` /
``_fused_core_packed`` with ``interpret=True``).  All outputs are integers
or booleans and must be equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sequence_aligner_tpu.core.records import Sequence as JSeq
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.ops.align_fused import (
    _extract_bits, _fused_core_packed, _p2_pack, fast_dovetail_batch_fused,
    pack_reads_le as j_pack, phase1_fused_packed, phase2_fused_packed,
)
from sequence_aligner_tpu.ops.encode import encode_reads as j_encode
from sequence_aligner_tpu.pipeline.datasets import simulated_reads as j_sim

from sequence_aligner_tpu_torch.ops import align_fused as af

S = JSettings()
CM = tuple(int(x) for x in S.cost_matrix.reshape(-1))
# match / mismatch scores so large that the JAX rows' packed running-best
# word overflows 31 bits at 100 bp (its legacy rows with the merged aux word)
BIG_CM = tuple(20000 if a == b else -15000 for a in range(4) for b in range(4))

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes, and
    the plain versions' many small ops only lose to thread hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _random_reads(rng, n, length, genome_len=2000, mixed=False):
    """Reads from one random genome with ~1% substitutions."""
    genome = "".join("ACTG"[i] for i in rng.randint(0, 4, genome_len))
    seqs = []
    for i in range(n):
        ln = int(rng.randint(60, length + 1)) if mixed else length
        start = rng.randint(0, genome_len - ln)
        body = list(genome[start : start + ln])
        for _ in range(max(1, ln // 100)):
            body[rng.randint(0, ln)] = "ACTG"[rng.randint(0, 4)]
        seqs.append(JSeq(i + 1, "".join(body)))
    return seqs


def _case(name):
    """(bases, lengths, a_idx, b_idx, width) for one scenario."""
    rng = np.random.RandomState(sum(map(ord, name)))
    width = None
    if name in ("random", "width16", "width40"):
        seqs = _random_reads(rng, 24, 100)
        pairs = [(a, b) for a in range(24) for b in range(24) if a != b]
        rng.shuffle(pairs)
        pairs = pairs[:128]
        width = {"width16": 16, "width40": 40}.get(name)
    elif name == "shredded":  # true overlaps: most pairs validate
        seqs = j_sim(64, 100, coverage=12.0, error_rate=0.01, seed=5)
        pairs = [(i, i + d) for i in range(56) for d in (1, 2, 3, 5, 8)]
        pairs += [(b, a) for a, b in pairs[:40]]
    elif name == "mixed":
        seqs = _random_reads(rng, 30, 150, genome_len=1200, mixed=True)
        pairs = [(a, b) for a in range(30) for b in range(30) if a != b]
        rng.shuffle(pairs)
        pairs = pairs[:160]
    elif name == "long":  # 800 bp: the JAX rows' packed fields overflow (legacy rows)
        seqs = j_sim(20, 800, coverage=10.0, error_rate=0.005, seed=8)
        pairs = [(i, i + d) for i in range(17) for d in (1, 2)]
    else:
        raise ValueError(name)
    bases, lengths = j_encode(seqs)
    a_idx = np.asarray([a for a, _ in pairs])
    b_idx = np.asarray([b for _, b in pairs])
    if width is None:
        width = S.band_width(int(lengths[a_idx].max()))
    return bases, lengths, a_idx, b_idx, width


def _jax_kw(bases, width, cm=CM):
    return dict(
        cm_tuple=cm, gO=S.gap_open, gE=S.gap_extend,
        min_identity=jnp.float32(S.min_identity), min_overlap=jnp.int32(S.min_overlap),
        max_ignore=jnp.int32(S.max_ignore), la_max=bases.shape[1], lb_max=bases.shape[1],
        width=width, pblk=128,
    )


def _port_batch(bases, lengths, a_idx, b_idx, width, cm=CM):
    return af.fast_dovetail_batch(
        torch.from_numpy(bases[a_idx]), torch.from_numpy(lengths[a_idx]),
        torch.from_numpy(bases[b_idx]), torch.from_numpy(lengths[b_idx]),
        cm_tuple=cm, gO=S.gap_open, gE=S.gap_extend, min_identity=S.min_identity,
        min_overlap=S.min_overlap, max_ignore=S.max_ignore, la_max=bases.shape[1],
        width=width,
    )


@pytest.mark.parametrize("name", [
    "random", "shredded", "mixed", "width16", "width40", "long", "bigscore",
])
def test_dovetail_batch_matches_lax_scan(name):
    cm = BIG_CM if name == "bigscore" else CM
    bases, lengths, a_idx, b_idx, width = _case("shredded" if name == "bigscore" else name)
    want = fast_dovetail_batch_fused(
        jnp.asarray(bases[a_idx]), jnp.asarray(lengths[a_idx]),
        jnp.asarray(bases[b_idx]), jnp.asarray(lengths[b_idx]),
        **_jax_kw(bases, width, cm),
    )
    got = _port_batch(bases, lengths, a_idx, b_idx, width, cm)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    if name == "shredded":
        assert got["valid"].sum() > len(a_idx) // 2
    if name == "long":  # the shape the JAX rows cannot pack
        assert _extract_bits(bases.shape[1], width, CM) is None
        assert _p2_pack(bases.shape[1], width) is None
        assert got["valid"].any()
    if name == "bigscore":  # legacy rows, merged aux word
        assert _extract_bits(bases.shape[1], width, cm) is None
        assert _p2_pack(bases.shape[1], width) is not None
    assert not got["dud"].all()


def test_glue_matches_pallas_interpret():
    """The port's glue and plain phases against the TPU kernels' own code
    path (_fused_core_packed) under the Pallas interpreter."""
    bases, lengths, a_idx, b_idx, width = _case("shredded")
    a_idx, b_idx = a_idx[:128], b_idx[:128]
    kw = _jax_kw(bases, width)
    want = _fused_core_packed(
        j_pack(jnp.asarray(bases[a_idx])).T, j_pack(jnp.asarray(bases[b_idx])).T,
        jnp.asarray(lengths[a_idx]), jnp.asarray(lengths[b_idx]), interpret=True, **kw,
    )
    got = _port_batch(bases, lengths, a_idx, b_idx, width)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def _indexed(bases, lengths, a_idx, b_idx):
    """The engine's operands: the packed read table, pair rows, lengths."""
    return (af.pack_reads_le(torch.from_numpy(bases)),
            torch.from_numpy(a_idx.astype(np.int32)), torch.from_numpy(b_idx.astype(np.int32)),
            torch.from_numpy(lengths.astype(np.int32)))


def _dove_starts(a_len, la_max, seed, *, clamp):
    """Dove starts in [0, la_max] with word boundaries (ds % 16 == 0), 0 and
    la_max among them; ``clamp``: cut to |A| (else a start past |A| gives a
    negative dove length)."""
    rng = np.random.RandomState(seed)
    ds = rng.randint(0, la_max + 1, len(a_len)).astype(np.int32)
    ds[:8] = [0, 16, 32, 48, 64, la_max, 15, 17]
    return np.minimum(ds, a_len).astype(np.int32) if clamp else ds


def _pallas_and_indexed(bases, lengths, a_idx, b_idx, width, ulen, ds_seed, *, clamp):
    """Both phases through the Pallas kernels under the interpreter and
    through the port's indexed wrappers (CPU: their plain versions)."""
    la_max = bases.shape[1]
    aw = j_pack(jnp.asarray(bases[a_idx])).T
    bw = j_pack(jnp.asarray(bases[b_idx])).T
    a_len, b_len = lengths[a_idx], lengths[b_idx]
    ds = _dove_starts(a_len, la_max, ds_seed, clamp=clamp)
    dl = (a_len - ds).astype(np.int32)
    common = dict(w=width, gO=S.gap_open, gE=S.gap_extend, cm_tuple=CM, ulen=ulen)
    j1 = phase1_fused_packed(aw, bw, jnp.asarray(a_len), la_max=la_max, pblk=128,
                             interpret=True, **common)
    j2 = phase2_fused_packed(aw, bw, jnp.asarray(ds), jnp.asarray(dl), jnp.asarray(b_len),
                             la_max=la_max, zero_row=width // 2, pblk=128,
                             interpret=True, **common)
    packed, ia, ib, ln = _indexed(bases, lengths, a_idx, b_idx)
    t1 = af.phase1_indexed(packed, ia, ib, ln, la_max=la_max, **common)
    t2 = af.phase2_indexed(packed, ia, ib, torch.from_numpy(ds), torch.from_numpy(dl), ln,
                           la_max=la_max, zero_row=width // 2, **common)
    for i, (w_, g) in enumerate(zip(j1, t1)):
        assert np.array_equal(g.numpy(), np.asarray(w_)), ("phase1", i)
    for i, (w_, g) in enumerate(zip(j2, t2)):
        assert np.array_equal(g.numpy(), np.asarray(w_)), ("phase2", i)
    return j2


@pytest.mark.parametrize("name,ulen", [
    ("random", 0), ("random", 100), ("shredded", 0), ("shredded", 100), ("mixed", 0),
])
def test_phases_match_pallas_kernels(name, ulen):
    """Raw outputs of both phases' indexed wrappers (their plain versions on
    the CPU) against the Pallas kernels under the interpreter, including the
    kernels' uniform-length (ulen) variants and dove starts on word
    boundaries (ds % 16 == 0), at 0, at |A| and past it (negative dove
    lengths)."""
    bases, lengths, a_idx, b_idx, width = _case(name)
    assert not ulen or (lengths == ulen).all()  # ulen is for uniform batches
    a_idx, b_idx = a_idx[:128], b_idx[:128]
    j2 = _pallas_and_indexed(bases, lengths, a_idx, b_idx, width, ulen, len(a_idx),
                             clamp=False)
    assert (np.asarray(j2[0]) > 0).any() and (np.asarray(j2[0]) == 0).any()


@pytest.mark.parametrize("width,kind,ulen", [
    (12, "uniform", 100),  # the register instance of the AlignSettings() defaults
    (16, "mixed", 0),      # amos_parity(kmer_size=16)'s instance
    (17, "uniform", 0),    # phase 1 in the capacity instance, phase 2 past 17 columns
    (31, "mixed", 0),
    (33, "uniform", 100),
    (70, "mixed", 0),      # the general (scratch) instance
])
def test_indexed_plain_versions_match_gather_and_pallas(width, kind, ulen):
    """The indexed wrappers' plain versions against the gather-then-plain
    path (phase*_plain on word-major operands) and the Pallas kernels under
    the interpreter, at the widths the kernel instances split on."""
    rng = np.random.RandomState(width)
    if kind == "uniform":
        seqs = j_sim(48, 100, coverage=12.0, error_rate=0.01, seed=width)
    else:
        base = j_sim(48, 150, coverage=12.0, error_rate=0.01, seed=width)
        seqs = [JSeq(q.id, q.seq[: int(rng.randint(40, 151))]) for q in base]
    bases, lengths = j_encode(seqs)
    pairs = [(i, i + d) for i in range(43) for d in (1, 2, 3)][:128]  # Pallas blocks of 128
    a_idx = np.asarray([a for a, _ in pairs])
    b_idx = np.asarray([b for _, b in pairs])
    j2 = _pallas_and_indexed(bases, lengths, a_idx, b_idx, width, ulen, width, clamp=True)
    # gather, then the plain versions on [words, pairs] operands
    packed, ia, ib, ln = _indexed(bases, lengths, a_idx, b_idx)
    aw_t, bw_t = packed[ia.long()].t().contiguous(), packed[ib.long()].t().contiguous()
    la_max = bases.shape[1]
    common = dict(w=width, gO=S.gap_open, gE=S.gap_extend, cm_tuple=CM, ulen=ulen)
    g1 = af.phase1_plain(aw_t, bw_t, ln[ia.long()], la_max=la_max, **common)
    i1 = af.phase1_indexed(packed, ia, ib, ln, la_max=la_max, **common)
    assert all(torch.equal(a, b) for a, b in zip(g1, i1))
    ds = torch.from_numpy(_dove_starts(lengths[a_idx], la_max, width, clamp=True))
    dl = ln[ia.long()] - ds
    g2 = af.phase2_plain(aw_t, bw_t, ds, dl, ln[ib.long()], la_max=la_max,
                         zero_row=width // 2, **common)
    i2 = af.phase2_indexed(packed, ia, ib, ds, dl, ln, la_max=la_max, zero_row=width // 2,
                           **common)
    assert all(torch.equal(a, b) for a, b in zip(g2, i2))
    assert (np.asarray(j2[0]) > 0).any()


def test_pack_reads_le_matches():
    rng = np.random.RandomState(0)
    for l in (1, 15, 16, 17, 100, 150):
        b = rng.randint(0, 4, (9, l)).astype(np.int8)
        want = np.asarray(j_pack(jnp.asarray(b)))
        got = af.pack_reads_le(torch.from_numpy(b)).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, want), l


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    p, w = 8, 12
    packed = torch.zeros((p, 7), dtype=torch.int32)
    idx = torch.arange(p, dtype=torch.int32)
    n = torch.full((p,), 100, dtype=torch.int32)
    kw = dict(la_max=100, w=w, gO=-200, gE=-20, cm_tuple=CM)
    before = (af.phase1_launches, af.phase2_launches)
    af.phase1_indexed(packed, idx, idx, n, **kw)
    af.phase2_indexed(packed, idx, idx, n * 0, n, n, zero_row=w // 2, **kw)
    assert (af.phase1_launches, af.phase2_launches) == before  # CPU: plain versions
    with pytest.raises(TypeError, match="int32"):
        af.phase1_indexed(packed.long(), idx, idx, n, **kw)
    with pytest.raises(ValueError, match="shape"):
        af.phase1_indexed(packed, idx, idx[:4], n, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        af.phase1_indexed(torch.zeros((7, p), dtype=torch.int32).t(), idx, idx, n, **kw)
    with pytest.raises(ValueError, match="shape"):
        af.phase2_indexed(packed, idx, idx, n[:4], n, n, zero_row=w // 2, **kw)
    with pytest.raises(ValueError, match="shape"):  # one length a read
        af.phase1_indexed(packed, idx, idx, n[:4], **kw)


def test_sass_mix_counts_the_row_loop():
    """The instruction-mix tool reads a cuobjdump -sass listing: the
    longest backward branch's span, by opcode family."""
    from sequence_aligner_tpu_torch import sass_mix

    text = "\n".join([
        "\t\tFunction : _ZN12_GLOBAL__N_113phase1_kernelILi16EEEvPKi",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;",
        "        /*0010*/                   IMAD.MOV.U32 R2, RZ, RZ, R3 ;",
        "        /*0020*/                   VIMNMX3 R4, R5, RZ, R6, !PT ;",
        "        /*0030*/              @!P0 BRA 0x50 ;",
        "        /*0040*/                   SEL R7, R8, R9, P1 ;",
        "        /*0050*/              @!P2 BRA 0x10 ;",
        "        /*0060*/                   EXIT ;",
    ])
    funcs = sass_mix.parse(text)
    (name, body), = funcs.items()
    loop = sass_mix.row_loop(body)
    assert [a for a, _ in loop] == [0x10, 0x20, 0x30, 0x40, 0x50]
    m = sass_mix.mix(loop)
    assert (m["instructions"], m["moves"], m["control"], m["other"]) == (5, 1, 2, 2)
    assert m["families"]["VIMNMX3"] == 1 and m["families"]["IMAD.MOV"] == 1
