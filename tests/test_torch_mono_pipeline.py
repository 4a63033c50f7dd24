"""Port parity against the JAX package (CPU, the kernels' plain versions;
tolerance 0) for the align routes and the engine's environment switches,
the helpers of ``core``, ``ops.encode``, ``io`` and ``pipeline.datasets``,
the AMOS message reader and the AMOS pipeline driver.

The driver runs against stand-in AMOS executables
(``pipeline.standins``): both drivers must run the same commands, hand
the bank the same reads and OVL bytes, and return the same contigs."""

import dataclasses
import json
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
from sequence_aligner_tpu.io import amos as j_amos
from sequence_aligner_tpu.io import ovl as j_ovl
from sequence_aligner_tpu.models.overlapper import Overlapper as JOverlapper
from sequence_aligner_tpu.models.overlapper import OverlapStats as JStats
from sequence_aligner_tpu.ops import encode as j_encode
from sequence_aligner_tpu.pipeline import datasets as j_datasets
from sequence_aligner_tpu.pipeline import driver as j_driver
from sequence_aligner_tpu.pipeline.datasets import simulated_reads as j_sim

from sequence_aligner_tpu_torch.cli import main as cli_main
from sequence_aligner_tpu_torch.core.records import OverlapRecord, Sequence
from sequence_aligner_tpu_torch.core.settings import AlignSettings, settings_from_jax
from sequence_aligner_tpu_torch.io import amos
from sequence_aligner_tpu_torch.io import ovl
from sequence_aligner_tpu_torch.models.overlapper import Overlapper
from sequence_aligner_tpu_torch.ops import align_lax, encode
from sequence_aligner_tpu_torch.pipeline import datasets, driver
from sequence_aligner_tpu_torch.pipeline.datasets import planted_repeat_reads, write_seq
from sequence_aligner_tpu_torch.pipeline.standins import write_standins

ROOT = Path(__file__).resolve().parents[1]
ENV_SWITCHES = ("SEQALIGN_ALIGN_MONO", "SEQALIGN_ADAPTIVE_TIERS", "SEQALIGN_PRESCREEN",
                "SEQALIGN_PRESCREEN_W")
JAX_STATS = tuple(f.name for f in dataclasses.fields(JStats))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """No engine switch leaks in from the environment or between tests;
    one torch thread (the suite runs in several worker processes)."""
    for k in ENV_SWITCHES:
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(seqs):
    return [Sequence(q.id, q.seq) for q in seqs]


def _datasets(kind):
    """(reads, JAX settings): 600 x 100 bp reads with 1% errors at coverage
    10 (one band width), or 160 reads of 60-350 bp at min_identity 0.96
    (band widths 12, 13 and 15)."""
    if kind == "sim600":
        return j_sim(600, 100, coverage=10, error_rate=0.01, seed=0), JSettings()
    rng = np.random.RandomState(6)
    base = j_sim(160, 350, coverage=30.0, error_rate=0.01, seed=6)
    cut = rng.choice([60, 100, 150, 300, 350], len(base))
    return [JSeq(q.id, q.seq[: int(c)]) for q, c in zip(base, cut)], JSettings(min_identity=0.96)


_ROUTES = {
    "default": {},
    "mono0": {"SEQALIGN_ALIGN_MONO": "0"},
    "mono1": {"SEQALIGN_ALIGN_MONO": "1"},
    "static_tiers": {"SEQALIGN_ALIGN_MONO": "0", "SEQALIGN_ADAPTIVE_TIERS": "0"},
}


def _run_both(seqs, js, **kw):
    jov = JOverlapper(js, **kw)
    want = jov.run_arrays(seqs)
    ov = Overlapper(settings_from_jax(js), device="cpu", **kw)
    got = ov.run_arrays(_port(seqs))
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
    return jov, ov


@pytest.mark.parametrize("route", sorted(_ROUTES))
@pytest.mark.parametrize("kind", ["sim600", "two_widths"])
def test_stats_and_records_equal_the_jax_engine(kind, route, monkeypatch):
    """Every JAX field of ``OverlapStats`` and the records equal the JAX
    engine's under each routing switch."""
    for k, v in _ROUTES[route].items():
        monkeypatch.setenv(k, v)
    seqs, js = _datasets(kind)
    jov, ov = _run_both(seqs, js)
    want = dataclasses.asdict(jov.stats)
    assert {k: getattr(ov.stats, k) for k in JAX_STATS} == want
    assert want["n_valid"] > 0
    if kind == "two_widths":
        assert len({js.band_width(len(q.seq)) for q in seqs}) > 1
    mono = route in ("default", "mono1")  # every group is below 2^21 pairs
    assert (want["n_phase2_pairs"] == want["n_candidate_pairs"]) == mono
    if (kind, route) == ("sim600", "default"):
        assert (want["dp_cells"], want["n_phase2_pairs"]) == (7_804_472, 2_972)
        assert want["n_valid"] == 2_055


@pytest.mark.parametrize("entry", ["run_arrays", "run_stream_arrays"])
def test_quadratic_stats_and_records_equal_the_jax_engine(entry, tmp_path):
    """The quadratic path (``fast_dovetail=False``): every JAX field of
    ``OverlapStats``, ``dp_cells`` and ``dp_cells_raw`` included (0: the JAX
    engine counts no quadratic cells), and the records equal the JAX
    engine's, over several chunks: 128-pair align chunks for ``run_arrays``,
    64-read file chunks for ``run_stream_arrays``."""
    seqs = j_sim(120, 100, coverage=20.0, error_rate=0.02, seed=5)
    js = JSettings()
    if entry == "run_arrays":
        jov = JOverlapper(js, fast_dovetail=False, batch_size=1)
        ov = Overlapper(settings_from_jax(js), fast_dovetail=False, batch_size=1, device="cpu")
        calls0 = align_lax.calls
        want, got = jov.run_arrays(seqs), ov.run_arrays(_port(seqs))
        assert align_lax.calls - calls0 == -(-ov.stats.n_candidate_pairs // 128) > 1
    else:
        path = str(tmp_path / "r.fasta")
        write_seq(_port(seqs), path)
        jov = JOverlapper(js, fast_dovetail=False)
        ov = Overlapper(settings_from_jax(js), fast_dovetail=False, device="cpu")
        want = jov.run_stream_arrays(path, chunk_reads=64)
        got = ov.run_stream_arrays(path, chunk_reads=64)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
    stats = dataclasses.asdict(jov.stats)
    assert {k: getattr(ov.stats, k) for k in JAX_STATS} == stats
    assert stats["dp_cells"] == stats["dp_cells_raw"] == 0
    assert stats["n_candidate_pairs"] == 1_430 and stats["n_valid"] > 0


def test_static_tiers_loop_more_cells_than_planned_tiers(monkeypatch):
    """The tier switch is live: on the split route the static tiers and the
    planned ones loop over different cell counts, each the JAX engine's."""
    monkeypatch.setenv("SEQALIGN_ALIGN_MONO", "0")
    seqs, js = _datasets("sim600")
    cells = {}
    for adaptive in ("1", "0"):
        monkeypatch.setenv("SEQALIGN_ADAPTIVE_TIERS", adaptive)
        jov, ov = _run_both(seqs, js)
        assert ov.stats.dp_cells == jov.stats.dp_cells
        cells[adaptive] = ov.stats.dp_cells
    assert cells["0"] > cells["1"]


def test_prescreen_switches_give_the_jax_candidates(monkeypatch):
    """``SEQALIGN_PRESCREEN=1`` turns the screen on where ``prescreen`` is
    not passed, ``SEQALIGN_PRESCREEN_W`` sets its window; an explicit
    ``prescreen=False`` (the CLI's) wins over the environment."""
    seqs = [JSeq(q.id, q.seq) for q in planted_repeat_reads(300, 100, seed=2)]
    js = JSettings.amos_parity()
    n = {}
    for screen, window in ((None, None), ("1", None), ("1", "3"), ("1", "30")):
        for k, v in (("SEQALIGN_PRESCREEN", screen), ("SEQALIGN_PRESCREEN_W", window)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        jov, ov = _run_both(seqs, js)
        assert ov.stats.n_candidate_pairs == jov.stats.n_candidate_pairs
        assert ov.prescreen == (screen == "1")
        n[screen, window] = ov.stats.n_candidate_pairs
    # the default window is 2 at 100 bp; wider windows keep more candidates
    assert n["1", None] < n["1", "3"] < n["1", "30"] < n[None, None]
    jov, ov = _run_both(seqs, js, prescreen=False)  # SEQALIGN_PRESCREEN=1 still set
    assert not ov.prescreen and ov.stats.n_candidate_pairs == n[None, None]


def test_band_widths_and_score_match():
    for js in (JSettings(), JSettings(min_identity=0.96), JSettings(kmer_size=16)):
        s = settings_from_jax(js)
        lens = np.arange(0, 3000, dtype=np.int32)
        got, want = s.band_widths(lens), js.band_widths(lens)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert got.tolist() == [s.band_width(int(n)) for n in lens]
        for a in "ACGTacgt":
            for b in "ACGTacgt":
                assert s.score(a, b) == js.score(a, b)


@pytest.mark.parametrize("length", [1, 15, 16, 17, 100, 333])
def test_pack_unpack_decode_match(length):
    bases = np.random.RandomState(length).randint(0, 4, (7, length)).astype(np.int8)
    words = encode.pack_2bit(bases)
    want = j_encode.pack_2bit(bases)
    assert words.dtype == want.dtype == np.int32 and np.array_equal(words, want)
    assert np.array_equal(encode.unpack_2bit(words, length), bases)
    assert np.array_equal(encode.unpack_2bit(words, length), j_encode.unpack_2bit(want, length))
    for row in bases:
        assert encode.decode_read(row, length - 1) == j_encode.decode_read(row, length - 1)


def test_parse_sort_and_compare_ovl_match(tmp_path, capsys):
    rng = np.random.RandomState(3)
    rows = [(int(a), int(b), int(h), int(g)) for a, b, h, g in
            zip(rng.randint(1, 50, 40), rng.randint(1, 50, 40), rng.randint(-89, 90, 40),
                rng.randint(-89, 90, 40))]
    text = "".join(OverlapRecord(*r).render() + "\n" for r in rows)
    text += "{OVL\nadj:I\nrds:3,4\nscr:7\nahg:5\nbhg:-6\n}\n"  # fields off their defaults
    p = tmp_path / "x.ovl"
    p.write_text(text)
    got, want = ovl.parse_ovl(str(p)), j_ovl.parse_ovl(str(p))
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert got == ovl.parse_ovl(text, is_text=True)
    assert [dataclasses.astuple(r) for r in ovl.canonical_sort(got)] == \
        [dataclasses.astuple(r) for r in j_ovl.canonical_sort(want)]
    assert ovl.records_equal(got[::-1], got)
    assert not ovl.records_equal(got[1:], got, verbose=True)
    assert "missing" in capsys.readouterr().err
    assert j_ovl.records_equal(want[::-1], want) and not j_ovl.records_equal(want[1:], want)


def test_load_genome_and_c_ruddii_reads_match(tmp_path, monkeypatch):
    genome = "".join("ACTG"[i] for i in np.random.RandomState(9).randint(0, 4, 5000))
    p = tmp_path / "genome.fasta"
    p.write_text(">c1 contig\n" + "\n".join(genome[i : i + 60] for i in range(0, 3000, 60))
                 + "\n>c2\n" + genome[3000:].lower() + "\n")
    assert datasets.load_genome(str(p)) == j_datasets.load_genome(str(p)) == genome
    j_load = j_datasets.load_genome
    monkeypatch.setattr(j_datasets, "load_genome", lambda: j_load(str(p)))
    want = j_datasets.c_ruddii_reads(300, 100, error_rate=0.01, seed=5)
    got = datasets.c_ruddii_reads(300, 100, genome=str(p), error_rate=0.01, seed=5)
    assert [(q.id, q.seq) for q in got] == [(q.id, q.seq) for q in want]
    monkeypatch.setattr(datasets, "C_RUDDII_FASTA", str(p))  # the default genome
    assert [q.seq for q in datasets.c_ruddii_reads(300, 100, error_rate=0.01, seed=5)] == \
        [q.seq for q in want]
    assert datasets.AMOS_BIN == f"{datasets.REFERENCE}/bin"
    assert datasets.CRP_SEQ.endswith("amos/small/crp177.seq")


def test_run_and_run_stream_records_match(tmp_path):
    seqs = j_sim(300, 100, coverage=15.0, error_rate=0.01, seed=12)
    want = JOverlapper(JSettings()).run(seqs)
    ov = Overlapper(settings_from_jax(JSettings()), device="cpu")
    got = ov.run(_port(seqs))
    assert "emit.records" in ov.stage_s
    fasta = tmp_path / "r.fasta"
    write_seq(_port(seqs), str(fasta))
    j_stream = JOverlapper(JSettings()).run_stream(str(fasta), chunk_reads=77)
    stream = ov.run_stream(str(fasta), chunk_reads=77)
    assert len(want) > 0
    for recs in (got, stream):
        assert all(type(r) is OverlapRecord for r in recs)
        assert [dataclasses.astuple(r) for r in recs] == [dataclasses.astuple(r) for r in want]
    assert [dataclasses.astuple(r) for r in j_stream] == [dataclasses.astuple(r) for r in want]


AMOS_TEXT = """{RED
iid:1
eid:read1
seq:
ACGTACGT
TTGA
.
qlt:
IIIIIIII
IIII
.
}
{CTG
iid:7
eid:contig7
{TLE
src:1
off:0
clr:0,12
}
{TLE
src:2
off:5
clr:12,0
}
len:abc
}
{OVL
adj:N
rds:1,2
scr:0
ahg:5
bhg:7
}
"""


def _msgs(ms):
    return [(m.type, m.fields, _msgs(m.children)) for m in ms]


def test_amos_messages_nested_and_multi_line(tmp_path):
    p = tmp_path / "bank.afg"
    p.write_text(AMOS_TEXT)
    got = list(amos.iter_amos_messages(str(p)))
    assert _msgs(got) == _msgs(j_amos.iter_amos_messages(str(p)))
    assert _msgs(got) == _msgs(amos.iter_amos_messages(AMOS_TEXT, is_text=True))
    assert [m.type for m in got] == ["RED", "CTG", "OVL"]
    assert got[0].fields["seq"] == "ACGTACGTTTGA" and got[0].fields["qlt"] == "I" * 12
    assert [c.fields["clr"] for c in got[1].children] == ["0,12", "12,0"]
    assert got[1].get_int("iid") == 7 and got[1].get_int("len", -1) == -1
    assert got[1].get_int("absent") == 0
    assert _msgs(amos.read_amos_messages(str(p), "OVL")) == \
        _msgs(j_amos.read_amos_messages(str(p), "OVL"))
    assert len(amos.read_amos_messages(str(p))) == 3


def test_unlock_bank_matches(tmp_path):
    for name, unlock in (("port", driver.unlock_bank), ("jax", j_driver.unlock_bank)):
        bnk = tmp_path / name / "x.bnk"
        bnk.mkdir(parents=True)
        (bnk / "RED.lck").write_text("pid 1234")
        (bnk / "OVL.lck").write_text("pid 1234")
        (bnk / "RED.ifo").write_text("____RED BANK____\nlocks = r 1234\nfoo\n")
        (bnk / "CTG.ifo").write_text("____CTG BANK____\nlocks = \nfoo\n")
        assert unlock(str(bnk)) == 3
        assert sorted(p.name for p in bnk.iterdir()) == ["CTG.ifo", "RED.ifo"]
        assert (bnk / "RED.ifo").read_text() == "____RED BANK____\nlocks = \nfoo\n"
        assert unlock(str(bnk)) == 0


def _drive(run, seqs, settings, tmp, backend, **kw):
    """One driver on stand-ins in ``tmp``: (result, argv lines with the
    workdir normalised, the bank's reads and OVL bytes)."""
    bins = write_standins(str(tmp / "bin"), fail=kw.pop("fail", ()))
    work = tmp / "work"
    res = run(seqs, settings, str(work), overlapper=backend, amos_bin=bins, **kw)
    argv = (Path(bins) / "argv.log").read_text().replace(str(work), "WORK")
    bank = work / "input.bnk"
    return res, argv, (bank / "reads.seq").read_bytes(), \
        (bank / "overlaps.ovl").read_bytes() if (bank / "overlaps.ovl").exists() else None


@pytest.mark.parametrize("backend,n_reads", [("device", 300), ("oracle", 30), ("sharded", 120),
                                             ("amos", 30)])
def test_pipeline_driver_matches_the_jax_driver(tmp_path, backend, n_reads):
    seqs = j_sim(n_reads, 100, coverage=12.0, error_rate=0.01, seed=4)
    js = JSettings.amos_parity()
    want, j_argv, j_reads, j_ovl_bytes = _drive(j_driver.run_amos_pipeline, seqs, js,
                                                tmp_path / "jax", backend)
    got, argv, reads, ovl_bytes = _drive(driver.run_amos_pipeline, _port(seqs),
                                         settings_from_jax(js), tmp_path / "port", backend,
                                         device="cpu")
    assert argv == j_argv and reads == j_reads and ovl_bytes == j_ovl_bytes
    names = [json.loads(ln)[0] for ln in argv.splitlines()]
    assert names == (["toAmos_new", "hash-overlap"] if backend == "amos" else
                     ["toAmos_new", "bank-transact"]) + ["tigger", "make-consensus", "bank2fasta"]
    assert [(c.id, c.seq) for c in got.contigs] == [(c.id, c.seq) for c in want.contigs]
    assert got.n_contigs == want.n_contigs == 1
    assert list(got.timings) == list(want.timings)
    assert got.n_overlaps == want.n_overlaps
    assert (got.n_overlaps > 0) == (backend != "amos")
    if ovl_bytes is not None:
        assert ovl_bytes.count(b"{OVL") == got.n_overlaps
        assert ovl.parse_ovl(ovl_bytes.decode(), is_text=True) == \
            Overlapper(settings_from_jax(js), device="cpu").run(_port(seqs))


@pytest.mark.parametrize("stage", ["toAmos_new", "bank-transact", "tigger"])
def test_pipeline_stage_failure_raises_as_the_jax_driver(tmp_path, stage):
    seqs = j_sim(40, 100, coverage=10.0, seed=1)
    heads = []
    for name, run, reads, s, kw in (
            ("jax", j_driver.run_amos_pipeline, seqs, JSettings(), {}),
            ("port", driver.run_amos_pipeline, _port(seqs), AlignSettings(), {"device": "cpu"})):
        with pytest.raises(RuntimeError) as e:
            _drive(run, reads, s, tmp_path / name, "device", fail=(stage,), **kw)
        msg = str(e.value).replace(str(tmp_path / name), "TMP")
        heads.append(msg.splitlines()[:2])
    assert heads[0] == heads[1]
    assert heads[0][0].startswith(f"pipeline stage failed (TMP/bin/{stage} ")
    assert heads[0][1] == f"{stage}: stand-in exits 1 as asked"


def test_pipeline_driver_refuses_unknown_backends_and_no_card(tmp_path, monkeypatch, capsys):
    with pytest.raises(ValueError, match="overlapper"):
        driver.run_amos_pipeline([], AlignSettings(), str(tmp_path), overlapper="gpu")
    with pytest.raises(SystemExit):  # hash-overlap is an overlap stage of --pipeline only
        cli_main(["-i", "r.fasta", "--engine", "amos", "--device", "cpu"])
    assert "--pipeline" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bins = write_standins(str(tmp_path / "bin"))
    for backend in ("device", "sharded"):  # the card is checked before any stage runs
        with pytest.raises(RuntimeError, match="device='cpu'"):
            driver.run_amos_pipeline([Sequence(1, "ACGT")], AlignSettings(),
                                     str(tmp_path / "w"), overlapper=backend, amos_bin=bins)
    assert not (Path(bins) / "argv.log").exists()


def test_cli_pipeline_prints_the_jax_cli_block(tmp_path, monkeypatch, capsys):
    """``--pipeline --workdir`` on stand-ins: the port's CLI (through
    ``SEQALIGN_REFERENCE``, in a process of its own) and the JAX CLI (its
    driver's default binaries pointed at the stand-ins) print the same
    ``Time Taken`` keys and ``contigs:`` line."""
    seqs = _port(j_sim(200, 100, coverage=12.0, error_rate=0.01, seed=7))
    fasta = tmp_path / "r.fasta"
    write_seq(seqs, str(fasta))
    ref = tmp_path / "reference"
    write_standins(str(ref / "bin"))
    monkeypatch.setitem(j_driver.run_amos_pipeline.__kwdefaults__, "amos_bin", str(ref / "bin"))
    assert j_cli_main(["-i", str(fasta), "--pipeline", "--workdir", str(tmp_path / "jw"),
                       "--amos-parity"]) == 0
    want = capsys.readouterr().out
    r = subprocess.run(
        [sys.executable, "-m", "sequence_aligner_tpu_torch.cli", "-i", str(fasta), "--pipeline",
         "--workdir", str(tmp_path / "pw"), "--amos-parity", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "SEQALIGN_REFERENCE": str(ref)})
    assert r.returncode == 0, r.stderr

    def shape(out):
        lines = out.splitlines()
        return lines[0], [ln.split(":")[0] for ln in lines[1:-1]], lines[-1]

    assert shape(r.stdout) == shape(want)
    assert shape(want)[0] == "============ Time Taken ============="
    assert shape(want)[2] == f"contigs: 1 lengths: [{len(seqs[0].seq)}]"
    assert (tmp_path / "pw" / "input.ovl").read_bytes() == \
        (tmp_path / "jw" / "input.ovl").read_bytes()
    assert [json.loads(ln)[0] for ln in (ref / "bin" / "argv.log").read_text().splitlines()] \
        == 2 * ["toAmos_new", "bank-transact", "tigger", "make-consensus", "bank2fasta"]
