"""Port parity for the HOXD reader, the CPU oracle engine and every CLI mode
of ``sequence_aligner_tpu_torch`` against the JAX package (CPU; the port's
engine with ``--device cpu``).  Both CLIs run in-process through their
``main``: stdout must be equal with millisecond figures masked, ``-o`` files
byte-equal.  Inputs are made with numpy from a seed; the tolerance is 0.
The oracle aligns one pair at a time in numpy, so its inputs stay at 30
reads or fewer."""

import dataclasses
import re
import time

import numpy as np
import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py forces)
import pytest
import torch

from sequence_aligner_tpu.cli import main as j_main
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.io.hoxd import read_hoxd as j_read_hoxd
from sequence_aligner_tpu.oracle.overlap import (
    oracle_alignments as j_oracle_alignments, oracle_overlaps as j_oracle_overlaps,
)
from sequence_aligner_tpu.pipeline.datasets import simulated_reads as j_sim
from sequence_aligner_tpu.pipeline.datasets import write_seq as j_write_seq

from sequence_aligner_tpu_torch.cli import main as p_main
from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import settings_from_jax
from sequence_aligner_tpu_torch.io.hoxd import read_hoxd
from sequence_aligner_tpu_torch.oracle.overlap import oracle_alignments, oracle_overlaps
from sequence_aligner_tpu_torch.utils import debug


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _debug_off():
    """Both CLIs switch their module's debug flag on for --debug."""
    from sequence_aligner_tpu.utils import debug as j_debug

    yield
    j_debug.set_debug(False)
    debug.set_debug(False)


WIDE = "HOXD wide\n-,A,C,G,T\nA,91,-114,-31,-123\nC,-114,100,-125,-31\n" \
       "G,-31,-125,100,-114\nT,-123,-31,-114,91\n"
# pair format, lower case and blanks, with half the off-diagonal entries
# left for the reader to mirror
PAIRS = "HOXD pairs\nA,A=67\nc, c = 100\nG,G=100\nT,T=67\nA,C=-96\nA,G=-31\n" \
        "A,T=-117\nC,G=-125\nC,T=-31\nG,T=-96\nG,A=-40\n"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    reads = d / "r12.fasta"
    j_write_seq(j_sim(12, 100, coverage=8.0, error_rate=0.01, seed=2), str(reads))
    wide, pairs = d / "wide.txt", d / "pairs.txt"
    wide.write_text(WIDE)
    pairs.write_text(PAIRS)
    return dict(reads=str(reads), wide=str(wide), pairs=str(pairs), dir=d)


@pytest.mark.parametrize("fmt", ["wide", "pairs"])
def test_read_hoxd_equals_jax(files, fmt):
    got = read_hoxd(files[fmt])
    assert got.dtype == np.int32 and np.array_equal(got, j_read_hoxd(files[fmt]))
    if fmt == "pairs":  # mirrored where absent, kept where both are given
        assert got[1, 0] == got[0, 1] == -96 and (got[3, 0], got[0, 3]) == (-40, -31)


def _seqs30():
    return j_sim(30, 100, coverage=6.0, error_rate=0.01, seed=4)


@pytest.mark.parametrize("fast_dovetail", [True, False])
def test_oracle_equals_jax(fast_dovetail):
    """oracle_alignments (every pair, valid or not, gapped strings included)
    and oracle_overlaps on 30 reads equal the JAX oracle's."""
    js = JSettings.amos_parity()
    s = settings_from_jax(js)
    seqs = _seqs30()
    mine = [Sequence(q.id, q.seq) for q in seqs]
    want = j_oracle_alignments(seqs, js, fast_dovetail=fast_dovetail, filter_valid=False)
    got = oracle_alignments(mine, s, fast_dovetail=fast_dovetail, filter_valid=False)
    assert len(want) > 0
    assert [dataclasses.astuple(a) for a in got] == [dataclasses.astuple(a) for a in want]
    assert [a.valid(s) for a in got] == [a.valid(js) for a in want]
    recs = oracle_overlaps(mine, s, fast_dovetail=fast_dovetail)
    want_recs = j_oracle_overlaps(seqs, js, fast_dovetail=fast_dovetail)
    assert 0 < len(recs) < len(want)
    assert [dataclasses.astuple(r) for r in recs] == [dataclasses.astuple(r) for r in want_recs]


_MS = re.compile(r"\d+ milliseconds")


def _run(main, args, capsys):
    """(exit code, stdout with millisecond figures masked, stderr)."""
    try:
        rc = main(args)
    except SystemExit as e:
        rc = e.code
    out, err = capsys.readouterr()
    return rc, _MS.sub("N milliseconds", out), err


def _both(files, args, capsys):
    """Each CLI on the reads; the port on the CPU.  Returns both stdouts."""
    jr, jo, _ = _run(j_main, ["-i", files["reads"], *args], capsys)
    pr, po, _ = _run(p_main, ["-i", files["reads"], *args, "--device", "cpu"], capsys)
    assert (jr, pr) == (0, 0)
    return jo, po


@pytest.mark.parametrize("mode", [
    ["--test-fasta-read"], ["--bench-fasta-read"], ["--test-kmer-cover"],
    ["--test-dispatch-collisions", "--min-collisions", "2"],
    ["--test-block-dispatch", "--min-collisions", "2"],
    ["--test-alignment"], ["--test-alignment", "--quadratic-align", "-H", "pairs"],
    ["--test-overlaps"], ["--test-overlaps", "--quadratic-align"],
    ["--bench-kmer-gen"], ["--bench-kmer-analysis"], ["--bench-align-quick"],
    ["--bench-align"],
], ids=lambda m: " ".join(m))
def test_cli_mode_prints_the_jax_cli_bytes(files, mode, capsys):
    args = [files.get(a, a) for a in mode]
    jo, po = _both(files, args, capsys)
    assert jo and po == jo
    if mode[0].startswith("--bench-align"):  # all eight configurations ran
        assert po.count("Calculated ") == 8 and "Failed" not in po


@pytest.mark.parametrize("flags", [
    [], ["-H", "pairs"], ["-m", "wide"], ["--matrix", "pairs", "--quadratic-align"],
    ["--HOXD-matrix", "wide", "--engine", "oracle"],
    ["--engine", "oracle"], ["--engine", "device"], ["--st-align"], ["--mt-align"],
    ["--st-align", "--quadratic-align"], ["--quadratic-align"], ["--linear-align"],
    ["--single-align"], ["--single-align", "--quadratic-align"], ["--block-align"],
    ["--st-hash", "--mt-hash", "--amos-parity"],
], ids=lambda m: " ".join(m) or "default")
def test_cli_calc_overlaps_writes_the_jax_cli_file(files, flags, capsys, tmp_path):
    args = [files.get(a, a) for a in flags]
    want, got = tmp_path / "jax.ovl", tmp_path / "torch.ovl"
    assert _run(j_main, ["-i", files["reads"], *args, "-o", str(want)], capsys)[:2] == (0, "")
    assert _run(p_main, ["-i", files["reads"], *args, "-o", str(got), "--device", "cpu"],
                capsys)[:2] == (0, "")
    assert want.read_bytes() and got.read_bytes() == want.read_bytes()


def test_cli_calc_overlaps_on_stdout(files, capsys):
    jo, po = _both(files, ["--quadratic-align"], capsys)
    assert jo.startswith("{OVL") and po == jo


@pytest.mark.parametrize("engine", ["device", "oracle"])
def test_cli_debug_prints_the_jax_cli_lines(files, engine, capsys):
    """--debug: the engine's printdb lines and the oracle's heartbeat, on
    stderr, equal the JAX CLI's with the timer values masked."""
    timer = re.compile(r"\d+h:\d+m:\d+s:\d+ms")
    _, jo, je = _run(j_main, ["-i", files["reads"], "--debug", "--engine", engine], capsys)
    _, po, pe = _run(p_main, ["-i", files["reads"], "--debug", "--engine", engine,
                              "--device", "cpu"], capsys)
    assert po == jo and timer.sub("T", pe) == timer.sub("T", je)
    assert ("pairgen plan: h_total=" in pe) == (engine == "device")
    assert ("Aligned 0 pairs..." in pe) == (engine == "oracle")
    assert "# wrote" in pe


def test_cli_profile_writes_a_trace(files, capsys, tmp_path):
    out, want = tmp_path / "o.ovl", tmp_path / "w.ovl"
    prof = tmp_path / "prof"
    assert _run(p_main, ["-i", files["reads"], "-o", str(out), "--profile", str(prof),
                         "--device", "cpu"], capsys)[0] == 0
    assert (prof / "trace.json").stat().st_size > 0
    _run(j_main, ["-i", files["reads"], "-o", str(want)], capsys)
    assert out.read_bytes() == want.read_bytes()


def test_cli_sleep_for_debug(files, capsys, monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    jo, po = _both(files, ["--sleep-for-debug", "--bench-fasta-read"], capsys)
    assert po == jo and po.startswith("Sleeping so debugger can connect.\n")
    assert slept == [30, 30]


@pytest.mark.parametrize("args,names", [(["--pipeline"], "--pipeline")])
def test_cli_refuses_what_is_not_ported(files, args, names, monkeypatch):
    """No mode is refused any longer: ``names`` without the AMOS binaries
    raises in both CLIs alike, on the missing ``toAmos_new``."""
    from sequence_aligner_tpu.pipeline import driver as j_driver
    from sequence_aligner_tpu_torch.pipeline import driver as p_driver

    absent = str(files["dir"] / "no_amos_bin")
    for drv in (j_driver, p_driver):
        monkeypatch.setitem(drv.run_amos_pipeline.__kwdefaults__, "amos_bin", absent)
    for main, extra in ((j_main, []), (p_main, ["--device", "cpu"])):
        with pytest.raises(FileNotFoundError, match=f"{absent}/toAmos_new"):
            main(["-i", files["reads"], *args, "--workdir", str(files["dir"] / names[2:]),
                  *extra])
