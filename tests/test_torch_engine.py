"""Port parity for the whole slice: ``Overlapper.run_arrays`` and the
calc-overlaps CLI of ``sequence_aligner_tpu_torch`` (device="cpu", the
kernels' plain versions) against the JAX engine — equal canonical
(lead, trail, ahg, bhg) arrays and byte-identical OVL text."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py forces)
import pytest
import torch

from sequence_aligner_tpu.cli import main as j_cli_main
from sequence_aligner_tpu.core.records import Sequence as JSeq
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.models.overlapper import Overlapper as JOverlapper
from sequence_aligner_tpu.ops.encode import encode_reads as j_encode
from sequence_aligner_tpu.pipeline.datasets import simulated_reads as j_sim

from sequence_aligner_tpu_torch.cli import main as cli_main
from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import settings_from_jax
from sequence_aligner_tpu_torch.models.overlapper import Overlapper
from sequence_aligner_tpu_torch.pipeline.datasets import write_seq

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes, and
    the plain versions' many small ops only lose to thread hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _dataset(kind):
    if kind == "uniform":
        return j_sim(300, 100, coverage=20.0, error_rate=0.0, seed=3)
    if kind == "errors":
        return j_sim(300, 100, coverage=20.0, error_rate=0.01, seed=4)
    # mixed lengths 60..350 bp
    rng = np.random.RandomState(6)
    base = j_sim(160, 350, coverage=30.0, error_rate=0.01, seed=6)
    cut = rng.choice([60, 100, 150, 300, 350], len(base))
    return [JSeq(q.id, q.seq[: int(c)]) for q, c in zip(base, cut)]


_PROFILES = {
    "default": JSettings(),
    "amos_parity": JSettings.amos_parity(),
    # min_identity 0.96 widens the band with length: widths 12, 13 and 15
    # side by side in the mixed set
    "identity96": JSettings(min_identity=0.96),
}


@pytest.mark.parametrize("kind,profile", [
    ("uniform", "default"), ("uniform", "amos_parity"), ("errors", "default"),
    ("errors", "amos_parity"), ("mixed", "identity96"),
])
def test_run_arrays_matches_jax_engine(kind, profile):
    js = _PROFILES[profile]
    seqs = _dataset(kind)
    want = JOverlapper(js).run_arrays(seqs)
    ov = Overlapper(settings_from_jax(js), device="cpu")
    got = ov.run_arrays([Sequence(q.id, q.seq) for q in seqs])
    assert len(want[0]) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
    assert ov.stats.n_valid == len(want[0])
    assert ov.stats.n_candidate_pairs >= ov.stats.n_valid
    if kind == "mixed":
        widths = {js.band_width(len(q.seq)) for q in seqs}
        assert len(widths) > 1


def _align_device_vs_jax(n_pairs, cap, batch_size, seed=21):
    """The port's split-phase _align_device at an exact (n_pairs, capacity,
    batch) geometry against the JAX engine's host _align valid set."""
    rng = np.random.RandomState(seed)
    genome = "".join("ACTG"[i] for i in rng.randint(0, 4, 2000))
    seqs = []
    for i in range(40):
        st = rng.randint(0, 1900)
        body = list(genome[st : st + 100])
        body[rng.randint(0, 100)] = "ACTG"[rng.randint(0, 4)]
        seqs.append(JSeq(i + 1, "".join(body)))
    bases, lengths = j_encode(seqs)
    all_pairs = [(a, b) for a in range(1, 41) for b in range(1, 41) if a != b]
    rng.shuffle(all_pairs)
    pairs = (all_pairs * (n_pairs // len(all_pairs) + 1))[:n_pairs]
    lead = np.asarray([a for a, _ in pairs], np.int32)
    trail = np.asarray([b for _, b in pairs], np.int32)
    js = JSettings()
    ref = JOverlapper(js)._align(bases, lengths, lead, trail)
    vm = ref["valid"]
    want = sorted(zip(lead[vm].tolist(), trail[vm].tolist(),
                      ref["ahg"][vm].tolist(), ref["bhg"][vm].tolist()))
    ov = Overlapper(settings_from_jax(js), batch_size=batch_size, device="cpu")
    pad = lambda a: torch.from_numpy(np.pad(a, (0, cap - n_pairs)))  # noqa: E731
    got = ov._align_device(torch.from_numpy(bases), lengths, pad(lead), pad(trail), n_pairs)
    assert sorted(zip(*(c.tolist() for c in got))) == want
    assert len(want) > 0


@pytest.mark.parametrize("n_pairs,cap,batch_size", [
    (768, 768, 512),   # pairs just over a batch multiple, capacity below the grid
    (512, 512, 512),   # n_pairs == cap == batch_size
    (257, 1024, 256),  # one over a batch with ample capacity
])
def test_align_device_chunk_grid_edges(n_pairs, cap, batch_size):
    _align_device_vs_jax(n_pairs, cap, batch_size)


def test_cli_writes_the_jax_cli_output(tmp_path):
    seqs = j_sim(240, 100, coverage=15.0, error_rate=0.01, seed=12)
    fasta = tmp_path / "reads.fasta"
    write_seq([Sequence(q.id, q.seq) for q in seqs], str(fasta))
    want, got = tmp_path / "jax.ovl", tmp_path / "torch.ovl"
    j_cli_main(["-i", str(fasta), "-o", str(want), "--amos-parity"])
    assert cli_main(["-i", str(fasta), "-o", str(got), "--amos-parity",
                     "--device", "cpu"]) == 0
    assert want.read_bytes() and got.read_bytes() == want.read_bytes()
    # the module entry point, as a user runs it
    via_m = tmp_path / "m.ovl"
    r = subprocess.run(
        [sys.executable, "-m", "sequence_aligner_tpu_torch.cli", "-i", str(fasta),
         "-o", str(via_m), "--amos-parity", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert via_m.read_bytes() == want.read_bytes()


def test_cli_refuses_modes_not_ported(tmp_path):
    """No input is refused; ``--pipeline`` without the AMOS binaries exits
    as the JAX CLI's does, on the missing ``toAmos_new``."""
    with pytest.raises(SystemExit):
        cli_main(["--device", "cpu"])  # no input
    fasta = tmp_path / "reads.fasta"
    write_seq([Sequence(q.id, q.seq) for q in j_sim(20, 100, coverage=8.0, seed=1)], str(fasta))
    env = dict(os.environ, SEQALIGN_REFERENCE=str(tmp_path / "absent"))
    for mod, extra in (("sequence_aligner_tpu.cli", []),
                       ("sequence_aligner_tpu_torch.cli", ["--device", "cpu"])):
        r = subprocess.run(
            [sys.executable, "-m", mod, "-i", str(fasta), "--pipeline", "--workdir",
             str(tmp_path / mod), *extra],
            cwd=Path(__file__).resolve().parents[1], env=env, capture_output=True, text=True,
            timeout=300,
        )
        last = r.stderr.strip().splitlines()[-1]
        assert r.returncode == 1 and r.stdout == "", (mod, r.stdout, r.stderr[-2000:])
        assert last.startswith("FileNotFoundError") and "toAmos_new" in last, (mod, last)


def test_run_arrays_takes_65536_reads_on_the_general_path():
    """65,536 reads were refused before the general-id pair path existed;
    now they are taken, on that path (tests/test_torch_pairgen_general.py
    holds its records against the JAX engine)."""
    seqs = [Sequence(i + 1, "ACGT") for i in range(1 << 16)]
    ov = Overlapper(settings_from_jax(JSettings()), device="cpu")
    assert all(len(a) == 0 for a in ov.run_arrays(seqs))
    assert ov.stats.n_reads == 1 << 16 and not ov._packed_ids


def test_run_records_and_empty_input():
    s = settings_from_jax(JSettings())
    seqs = [Sequence(q.id, q.seq) for q in j_sim(120, 100, coverage=20.0, seed=2)]
    ov = Overlapper(s, device="cpu")
    arrs = ov.run_arrays(seqs)
    recs = ov.run(seqs)
    assert [(r.id_a, r.id_b, r.ahg, r.bhg) for r in recs] == list(zip(*(a.tolist() for a in arrs)))
    short = [Sequence(1, "ACGT"), Sequence(2, "ACG")]  # no k-mers at all
    assert all(len(a) == 0 for a in Overlapper(s, device="cpu").run_arrays(short))
