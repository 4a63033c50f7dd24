"""Port parity for the diagonal-coherence prescreen and the streamed FASTA
input of ``sequence_aligner_tpu_torch`` against the JAX engine (CPU, the
kernels' plain versions).  Inputs are made with numpy from a seed; the
tolerance is 0."""

import numpy as np
import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py forces)
import pytest
import torch

from sequence_aligner_tpu.core.records import Sequence as JSeq
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.models.overlapper import Overlapper as JOverlapper
from sequence_aligner_tpu.ops.encode import encode_reads as j_encode

from sequence_aligner_tpu_torch.cli import main as cli_main
from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import settings_from_jax
from sequence_aligner_tpu_torch.io.ovl import write_ovl_arrays
from sequence_aligner_tpu_torch.io.stream import fasta_scan, iter_encoded_chunks
from sequence_aligner_tpu_torch.models.overlapper import Overlapper
from sequence_aligner_tpu_torch.ops.encode import encode_reads
from sequence_aligner_tpu_torch.pipeline.datasets import planted_repeat_reads, simulated_reads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JS = JSettings.amos_parity()
S = settings_from_jax(JS)


def _repeat_reads(n_reads=300, seed=2):
    """100 bp reads (1% substitutions) of a 6,000 bp genome with 16 planted
    12-mers, 20 copies each (``planted_repeat_reads``)."""
    return [q.seq for q in planted_repeat_reads(n_reads, 100, seed=seed)]


def _both(raw, prescreen):
    """(JAX engine, its arrays), (port engine, its arrays) on the same reads."""
    jov = JOverlapper(JS, prescreen=prescreen)
    want = jov.run_arrays([JSeq(i + 1, q) for i, q in enumerate(raw)])
    ov = Overlapper(S, prescreen=prescreen, device="cpu")
    got = ov.run_arrays([Sequence(i + 1, q) for i, q in enumerate(raw)])
    return (jov, want), (ov, got)


def _assert_arrays_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))


def test_prescreen_matches_jax_and_drops_candidates():
    """Screened candidate tables and records equal the JAX engine's; the
    screen really drops candidates in both engines, and no record."""
    raw = _repeat_reads()
    (jov, want), (ov, got) = _both(raw, True)
    (jov0, want0), (ov0, got0) = _both(raw, False)
    _assert_arrays_equal(got, want)
    _assert_arrays_equal(got0, want0)
    assert len(want[0]) > 0
    n, n0 = ov.stats.n_candidate_pairs, ov0.stats.n_candidate_pairs
    assert n == jov.stats.n_candidate_pairs and n0 == jov0.stats.n_candidate_pairs
    assert n < n0
    _assert_arrays_equal(got, got0)
    assert ov._prescreen_w() == 2  # int(0.02 * (100 + 12 + 2)) at 100 bp
    # the screened candidate tables themselves, in canonical order
    bases, lengths = j_encode([JSeq(i + 1, q) for i, q in enumerate(raw)])
    jl, jt = jov._candidates(jov._occurrences(bases, lengths), bases, lengths)
    tb, tl = encode_reads([Sequence(i + 1, q) for i, q in enumerate(raw)])
    out, k = ov._candidates_dev(ov._occurrences(torch.from_numpy(tb), tl))
    assert k == len(jl) == n
    assert np.array_equal(out["lead"][:k].numpy(), jl)
    assert np.array_equal(out["trail"][:k].numpy(), jt)


@pytest.mark.parametrize("n_total,active", [(32768, True), (32769, False)])
def test_prescreen_gating_follows_the_read_tier(n_total, active):
    """The screen is active up to 32,768 reads (a tier below 2^16, packed
    ids) and ignored from 32,769 (the JAX engine pads to 65,536 and takes
    its general-id path); most reads are empty, so the case stays cheap."""
    rep = _repeat_reads()
    raw = [""] * n_total
    for i, q in enumerate(rep):
        raw[n_total - len(rep) + i] = q
    (jov, want), (ov, got) = _both(raw, True)
    _assert_arrays_equal(got, want)
    assert ov.stats.n_candidate_pairs == jov.stats.n_candidate_pairs
    assert (ov._prescreen_w() is not None) == active == ov._packed_ids
    unscreened = Overlapper(S, device="cpu")
    unscreened.run_arrays([Sequence(i + 1, q) for i, q in enumerate(raw)])
    if active:
        assert ov.stats.n_candidate_pairs < unscreened.stats.n_candidate_pairs
    else:
        assert ov.stats.n_candidate_pairs == unscreened.stats.n_candidate_pairs


def test_prescreen_warns_at_permissive_settings():
    seqs = [Sequence(q.id, q.seq) for q in simulated_reads(60, 100, coverage=10.0, seed=3)]
    ov = Overlapper(S.replace(min_identity=0.85), prescreen=True, device="cpu")
    with pytest.warns(UserWarning, match="permissive"):
        ov.run_arrays(seqs)


def _write_wrapped(seqs, path, width=37):
    """FASTA with bodies wrapped at ``width`` columns, lower case on odd ids."""
    with open(path, "w") as f:
        for i, q in enumerate(seqs):
            body = q.lower() if i % 2 else q
            f.write(f">read{i + 1} some header\n")
            f.writelines(body[j : j + width] + "\n" for j in range(0, len(body), width))


def _mixed_reads():
    rng = np.random.RandomState(8)
    base = simulated_reads(300, 150, coverage=20.0, error_rate=0.01, seed=8)
    return [q.seq[: int(c)] for q, c in zip(base, rng.randint(50, 151, len(base)))]


@pytest.mark.parametrize("chunk_reads", [64, 1 << 15])
def test_stream_matches_jax_stream(tmp_path, chunk_reads):
    """run_stream_arrays on mixed-length, line-wrapped FASTA equals the JAX
    run_stream_arrays and the port's own run_arrays; 64-read chunks give four
    full chunks and a short tail of 44."""
    raw = _mixed_reads()
    path = str(tmp_path / "mixed.fasta")
    _write_wrapped(raw, path)
    want = JOverlapper(JS).run_stream_arrays(path, chunk_reads=chunk_reads)
    ov = Overlapper(S, device="cpu")
    got = ov.run_stream_arrays(path, chunk_reads=chunk_reads)
    assert len(want[0]) > 0
    _assert_arrays_equal(got, want)
    _assert_arrays_equal(Overlapper(S, device="cpu").run_arrays(path), got)
    assert ov.stats.n_reads == 300


def test_stream_chunks_and_scan(tmp_path):
    raw = _mixed_reads()[:150]
    path = str(tmp_path / "r.fasta")
    _write_wrapped(raw, path)
    assert fasta_scan(path) == (150, max(len(q) for q in raw))
    chunks = list(iter_encoded_chunks(path, 64, 150))
    assert [c[0].shape[0] for c in chunks] == [64, 64, 22]
    bases = np.concatenate([c[0] for c in chunks])
    lengths = np.concatenate([c[1] for c in chunks])
    want_b, want_l = encode_reads([Sequence(i + 1, q.upper()) for i, q in enumerate(raw)], 150)
    assert np.array_equal(bases, want_b) and np.array_equal(lengths, want_l)
    bad = tmp_path / "bad.fasta"
    bad.write_text("ACGT\n>r\nACGT\n")
    with pytest.raises(ValueError, match="Invalid Sequence File"):
        fasta_scan(str(bad))


def test_cli_prescreen_flag(tmp_path):
    raw = _repeat_reads(200)
    path = tmp_path / "r.fasta"
    _write_wrapped(raw, str(path), width=100)
    on, off = tmp_path / "on.ovl", tmp_path / "off.ovl"
    assert cli_main(["-i", str(path), "-o", str(on), "--amos-parity", "--prescreen",
                     "--device", "cpu"]) == 0
    assert cli_main(["-i", str(path), "-o", str(off), "--amos-parity", "--prescreen",
                     "--no-prescreen", "--device", "cpu"]) == 0
    want = tmp_path / "want.ovl"
    write_ovl_arrays(JOverlapper(JS, prescreen=True).run_arrays(str(path)), str(want))
    assert on.read_bytes() and on.read_bytes() == want.read_bytes() == off.read_bytes()


def _write_with_line_ends(seqs, path, end):
    """FASTA with two sequence lines a record, each ending in ``end``."""
    with open(path, "wb") as f:
        for i, q in enumerate(seqs):
            h = len(q) // 2
            f.write(f">r{i + 1}\n{q[:h]}{end}{q[h:]}{end}".encode())


def test_stream_keeps_trailing_blanks_as_the_jax_engine(tmp_path):
    """Sequence lines ending in two spaces: the blanks are bases (code 0) to
    the JAX engine's reader, so the streamed records equal run_arrays and the
    JAX run_stream_arrays."""
    raw = [q.seq for q in simulated_reads(200, 100, coverage=20.0, error_rate=0.01, seed=1)]
    path = str(tmp_path / "blanks.fasta")
    _write_with_line_ends(raw, path, "  \n")
    want = JOverlapper(JS).run_stream_arrays(path, chunk_reads=64)
    got = Overlapper(S, device="cpu").run_stream_arrays(path, chunk_reads=64)
    assert len(want[0]) > 0
    _assert_arrays_equal(got, want)
    _assert_arrays_equal(Overlapper(S, device="cpu").run_arrays(path), got)
    assert fasta_scan(path) == (200, 104)


@pytest.mark.parametrize("end", ["\r\n", " \t\n", "\r\r\n", "\n\n"])
def test_stream_reader_agrees_with_read_fasta(tmp_path, end):
    """fasta_scan and iter_encoded_chunks agree with read_fasta + encode on
    CRLF ends, trailing blanks and tabs, repeated carriage returns and empty
    lines: only newlines and carriage returns are dropped."""
    from sequence_aligner_tpu_torch.io.fasta import read_fasta

    raw = _mixed_reads()[:90]
    path = str(tmp_path / "ends.fasta")
    _write_with_line_ends(raw, path, end)
    want_b, want_l = encode_reads(read_fasta(path))
    n, l_max = fasta_scan(path)
    assert (n, l_max) == want_b.shape
    chunks = list(iter_encoded_chunks(path, 32, l_max))
    assert np.array_equal(np.concatenate([c[0] for c in chunks]), want_b)
    assert np.array_equal(np.concatenate([c[1] for c in chunks]), want_l)


@pytest.mark.parametrize("body", ["", "ACGT\n>r\nACGT\n", "\n>r\nACGT\n"])
def test_stream_rejects_invalid_files_as_the_jax_engine(tmp_path, body):
    """An empty file, or one that does not start with '>', is an invalid
    sequence file to both engines' run_stream_arrays and run_arrays."""
    path = tmp_path / "bad.fasta"
    path.write_text(body)
    for run in (Overlapper(S, device="cpu").run_stream_arrays,
                Overlapper(S, device="cpu").run_arrays,
                JOverlapper(JS).run_stream_arrays):
        with pytest.raises(ValueError, match="Invalid Sequence File"):
            run(str(path))
