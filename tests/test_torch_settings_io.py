"""Port parity: settings, records, FASTA/OVL IO, encoding and simulated reads
of ``sequence_aligner_tpu_torch`` against the JAX package (exact)."""

import numpy as np
import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import pytest
import torch

from sequence_aligner_tpu.core.records import Sequence as JSeq
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.io.fasta import read_fasta as j_read_fasta
from sequence_aligner_tpu.io.ovl import write_ovl_arrays as j_write_ovl_arrays
from sequence_aligner_tpu.ops.encode import encode_reads as j_encode
from sequence_aligner_tpu.pipeline.datasets import shred_genome as j_shred
from sequence_aligner_tpu.pipeline.datasets import simulated_reads as j_sim

from sequence_aligner_tpu_torch.core.records import OverlapRecord, Sequence
from sequence_aligner_tpu_torch.core.settings import AlignSettings, settings_from_jax
from sequence_aligner_tpu_torch.io.fasta import read_fasta
from sequence_aligner_tpu_torch.io.ovl import write_ovl_arrays
from sequence_aligner_tpu_torch.ops.encode import encode_reads
from sequence_aligner_tpu_torch.pipeline.datasets import shred_genome, simulated_reads

_JAX_PROFILES = {
    "default": JSettings(),
    "amos_parity": JSettings.amos_parity(),
    "custom": JSettings(min_identity=0.96, kmer_size=16, min_collisions=3,
                        max_collisions=500, kmer_edge=0.35, kmer_center=0.3,
                        gap_open=-150, gap_extend=-15, min_overlap=30, max_ignore=120),
}


@pytest.mark.parametrize("profile", sorted(_JAX_PROFILES))
def test_band_width_matches_for_lengths_1_to_2000(profile):
    js = _JAX_PROFILES[profile]
    ts = settings_from_jax(js)
    assert [ts.band_width(n) for n in range(1, 2001)] == [
        js.band_width(n) for n in range(1, 2001)
    ]


@pytest.mark.parametrize("as_dict", [False, True])
@pytest.mark.parametrize("profile", sorted(_JAX_PROFILES))
def test_settings_from_jax_round_trips(profile, as_dict):
    js = _JAX_PROFILES[profile]
    src = {f: getattr(js, f) for f in js.__dataclass_fields__} if as_dict else js
    ts = settings_from_jax(src)
    for f in js.__dataclass_fields__:
        want, got = getattr(js, f), getattr(ts, f)
        if f == "cost_matrix":
            assert got.dtype == np.int32 and np.array_equal(got, want)
        else:
            assert type(got) is type(want) and got == want, f
    for prop in ("kmer_head_edge", "kmer_tail_edge", "kmer_mid_lead_edge",
                 "kmer_mid_tail_edge"):
        assert np.float32(getattr(ts, prop)).tobytes() == \
            np.float32(getattr(js, prop)).tobytes(), prop
    assert ts.cm_tuple() == tuple(int(x) for x in js.cost_matrix.reshape(-1))


def test_port_profiles_equal_jax_profiles():
    for mine, theirs in ((AlignSettings(), JSettings()),
                         (AlignSettings.amos_parity(), JSettings.amos_parity())):
        for f in theirs.__dataclass_fields__:
            assert np.array_equal(getattr(mine, f), getattr(theirs, f)), f


def test_settings_from_jax_rejects_bad_fields():
    fields = {f: getattr(JSettings(), f) for f in JSettings.__dataclass_fields__}
    with pytest.raises(ValueError, match="missing"):
        settings_from_jax({k: v for k, v in fields.items() if k != "kmer_size"})
    with pytest.raises(ValueError, match="unknown"):
        settings_from_jax(dict(fields, bogus=1))


def _mixed_seqs(rng, n=40):
    alphabet = np.array(list("ACGTacgtNn"))
    return [
        "".join(alphabet[rng.randint(0, len(alphabet), rng.randint(0, 130))])
        for _ in range(n)
    ]


@pytest.mark.parametrize("uniform", [True, False])
def test_encode_reads_matches(uniform):
    rng = np.random.RandomState(1)
    bodies = (["".join("ACGT"[i] for i in rng.randint(0, 4, 100)) for _ in range(50)]
              if uniform else _mixed_seqs(rng))
    jb, jl = j_encode([JSeq(i + 1, b) for i, b in enumerate(bodies)])
    tb, tl = encode_reads([Sequence(i + 1, b) for i, b in enumerate(bodies)])
    assert tb.dtype == jb.dtype and np.array_equal(tb, jb)
    assert tl.dtype == jl.dtype and np.array_equal(tl, jl)


@pytest.mark.parametrize("n,length,coverage,err,seed", [
    (200, 100, 20.0, 0.0, 0), (150, 120, 8.0, 0.01, 7), (64, 80, 3.0, 0.05, 11),
])
def test_simulated_reads_match(n, length, coverage, err, seed):
    want = j_sim(n, length, coverage=coverage, error_rate=err, seed=seed)
    got = simulated_reads(n, length, coverage=coverage, error_rate=err, seed=seed)
    assert [(q.id, q.seq) for q in got] == [(q.id, q.seq) for q in want]


def test_shred_genome_matches():
    rng = np.random.RandomState(4)
    genome = "".join("ACTG"[i] for i in rng.randint(0, 4, 3000))
    want = j_shred(genome, 90, 150, error_rate=0.02, seed=9)
    got = shred_genome(genome, 90, 150, error_rate=0.02, seed=9)
    assert [(q.id, q.seq) for q in got] == [(q.id, q.seq) for q in want]


def test_read_fasta_matches(tmp_path):
    p = tmp_path / "r.fasta"
    p.write_text(">a x\nacgtNN\nACGT\n>b\n\n>c\nTTTT\r\nGG\n")
    assert [(q.id, q.seq) for q in read_fasta(str(p))] == [
        (q.id, q.seq) for q in j_read_fasta(str(p))
    ]
    bad = tmp_path / "bad.fasta"
    bad.write_text("ACGT\n")
    with pytest.raises(ValueError):
        read_fasta(str(bad))


def test_write_ovl_arrays_byte_identical(tmp_path, capsys):
    rng = np.random.RandomState(2)
    n = 700
    arrs = (
        np.sort(rng.randint(1, 65536, n)).astype(np.int32),
        rng.randint(1, 65536, n).astype(np.int32),
        rng.randint(-89, 90, n).astype(np.int32),
        rng.randint(-89, 90, n).astype(np.int32),
    )
    mine, theirs = tmp_path / "t.ovl", tmp_path / "j.ovl"
    assert write_ovl_arrays(arrs, str(mine)) == n
    assert j_write_ovl_arrays(arrs, str(theirs)) == n
    assert mine.read_bytes() == theirs.read_bytes()
    # torch tensors and empty output too; stdout when no path is given
    t_arrs = tuple(torch.from_numpy(a) for a in arrs)
    assert write_ovl_arrays(t_arrs, str(mine)) == n
    assert mine.read_bytes() == theirs.read_bytes()
    empty = tuple(np.zeros(0, np.int32) for _ in range(4))
    assert write_ovl_arrays(empty, str(mine)) == 0 and mine.read_bytes() == b""
    write_ovl_arrays(tuple(a[:3] for a in arrs), None)
    # 7 lines per record
    assert capsys.readouterr().out == "".join(
        theirs.read_text().splitlines(keepends=True)[:21])
    rec = OverlapRecord(int(arrs[0][0]), int(arrs[1][0]), int(arrs[2][0]), int(arrs[3][0]))
    assert theirs.read_text().startswith(rec.render() + "\n")
