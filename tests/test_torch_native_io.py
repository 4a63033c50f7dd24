"""Port parity for the native IO layer (``sequence_aligner_tpu_torch/native``)
against the JAX package's (``sequence_aligner_tpu/native``): the FASTA scan,
encode and chunked encode, the OVL writer, and the engine reading a file
through it (``Overlapper.run_arrays(path)``) against the JAX engine.  Inputs
are made with numpy from a seed; the tolerance is 0."""

import numpy as np
import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py forces)
import pytest
import torch

from sequence_aligner_tpu.core.records import OverlapRecord as JRecord
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.io.ovl import write_ovl as j_write_ovl
from sequence_aligner_tpu.io.ovl import write_ovl_arrays as j_write_ovl_arrays
from sequence_aligner_tpu.models.overlapper import Overlapper as JOverlapper
from sequence_aligner_tpu.native import (
    fasta_encode_chunks_native as j_chunks, fasta_encode_native as j_encode_native,
    fasta_scan_native as j_scan,
)
from sequence_aligner_tpu.pipeline.datasets import simulated_reads as j_sim

from sequence_aligner_tpu_torch import _build, native
from sequence_aligner_tpu_torch.cli import main as cli_main
from sequence_aligner_tpu_torch.core.records import OverlapRecord
from sequence_aligner_tpu_torch.core.settings import settings_from_jax
from sequence_aligner_tpu_torch.io.ovl import write_ovl, write_ovl_arrays
from sequence_aligner_tpu_torch.models.overlapper import Overlapper


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JS = JSettings()
S = settings_from_jax(JS)

# the four layouts on which the native reader and the Python text reader
# disagree: '\r>' does not start a record; a header ended by '\r' swallows
# its line; a 0xFF byte and a UTF-8 letter are bases of code 0
LAYOUTS = {
    "cr_gt": b">a\nACGT\r>b\nGGGG\n",
    "cr_header": b">a\rACGT\n>b\nGG\rGG\n",
    "byte_ff": b">a\nAC\xffGT\n>b\nGGGG\n",
    "utf8": ">a\nACéGT\n>b\nGGGG\n".encode(),
}
# the layouts of tests/test_torch_stream_prescreen.py, in small
STREAM_LAYOUTS = {
    "trailing_blanks": b">r1\nACGTAC  \nGTTA  \n>r2\nCCGGA  \n",
    "crlf": b">r1\r\nACGTAC\r\nGTTA\r\n>r2\r\nCCGGA\r\n",
    "tab_blanks": b">r1\nACGTAC \t\nGTTA \t\n>r2\nCCGGA \t\n",
    "double_cr": b">r1\nACGTAC\r\r\nGTTA\r\r\n>r2\nCCGGA\r\r\n",
    "empty_lines": b">r1\nACGTAC\n\nGTTA\n\n>r2\nCCGGA\n\n",
    "no_final_newline": b">r1\nacgtNNac\n>r2\n>r3\nCCGGA",
    "header_only": b">only\n",
}
INVALID = {"empty": b"", "no_header": b"ACGT\n>r\nACGT\n", "blank_first": b"\n>r\nACGT\n"}


def _write(tmp_path, name, data: bytes) -> str:
    p = tmp_path / f"{name}.fasta"
    p.write_bytes(data)
    return str(p)


def _sim_fasta(tmp_path, n, seed=0, name="sim", tweak=None) -> str:
    """A FASTA of n simulated 100 bp reads (1% errors), 60 bases a line;
    ``tweak(list of record bytes)`` may edit records before writing."""
    recs = []
    for q in j_sim(n, 100, coverage=20.0, error_rate=0.01, seed=seed):
        body = b"\n".join(q.seq[i : i + 60].encode() for i in range(0, len(q.seq), 60))
        recs.append(b">r%d desc\n" % q.id + body + b"\n")
    if tweak:
        tweak(recs)
    return _write(tmp_path, name, b"".join(recs))


def _assert_reader_equal(path):
    assert native.fasta_scan_native(path) == j_scan(path)
    got, want = native.fasta_encode_native(path), j_encode_native(path)
    assert got[0].dtype == np.int8 and got[1].dtype == np.int32
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    n, l_max = j_scan(path)
    for chunk in (1, 3, 64):
        g = list(native.fasta_encode_chunks_native(path, chunk, l_max))
        w = list(j_chunks(path, chunk, l_max))
        assert [c[0].shape for c in g] == [c[0].shape for c in w]
        assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(g, w))
    return got


@pytest.mark.parametrize("name", sorted(LAYOUTS) + sorted(STREAM_LAYOUTS))
def test_native_reader_equals_the_jax_reader(tmp_path, name):
    data = {**LAYOUTS, **STREAM_LAYOUTS}[name]
    _assert_reader_equal(_write(tmp_path, name, data))


def test_native_reader_on_the_four_layouts_reads_what_the_jax_engine_reads(tmp_path):
    """The read lengths the JAX engine's reader gives on the four layouts."""
    want = {"cr_gt": [10], "cr_header": [0, 4], "byte_ff": [5, 4], "utf8": [6, 4]}
    for name, data in LAYOUTS.items():
        bases, lengths = native.fasta_encode_native(_write(tmp_path, name, data))
        assert lengths.tolist() == want[name], name


def test_native_reader_on_2000_simulated_reads(tmp_path):
    bases, lengths = _assert_reader_equal(_sim_fasta(tmp_path, 2000, seed=5))
    assert bases.shape == (2000, 100) and (lengths == 100).all()


@pytest.mark.parametrize("name", sorted(INVALID))
def test_native_reader_rejects_invalid_files(tmp_path, name):
    """An empty file or one not starting with '>' is an invalid sequence file
    to the native scan, encode and the engines' run_arrays(path)."""
    path = _write(tmp_path, name, INVALID[name])
    for fn in (native.fasta_scan_native, native.fasta_encode_native,
               Overlapper(S, device="cpu").run_arrays,
               Overlapper(S, device="cpu").run_stream_arrays,
               JOverlapper(JS).run_arrays):
        with pytest.raises(ValueError, match="Invalid Sequence File"):
            fn(path)
    with pytest.raises(FileNotFoundError):
        native.fasta_scan_native(str(tmp_path / "missing.fasta"))


def test_ovl_writers_equal_the_jax_writers(tmp_path):
    rng = np.random.RandomState(3)
    n = 5000
    arrs = (rng.randint(1, 10**6, n).astype(np.int32), rng.randint(1, 10**6, n).astype(np.int32),
            rng.randint(-89, 90, n).astype(np.int32), rng.randint(-89, 90, n).astype(np.int32))
    want = tmp_path / "jax.ovl"
    j_write_ovl_arrays(arrs, str(want))
    got = tmp_path / "native.ovl"
    assert native.ovl_write_native(str(got), *arrs) == want.stat().st_size
    assert got.read_bytes() == want.read_bytes()
    got2 = tmp_path / "arrays.ovl"
    assert write_ovl_arrays(arrs, str(got2)) == n
    assert got2.read_bytes() == want.read_bytes()
    recs = OverlapRecord.bulk_build(*(a.tolist() for a in arrs))
    got3, want3 = tmp_path / "recs.ovl", tmp_path / "jrecs.ovl"
    assert write_ovl(recs, str(got3)) == n
    j_write_ovl(JRecord.bulk_build(*(a.tolist() for a in arrs)), str(want3))
    assert got3.read_bytes() == want3.read_bytes() == want.read_bytes()
    # no records: an empty file, as the JAX writer leaves
    for w in (write_ovl_arrays, j_write_ovl_arrays):
        e = tmp_path / f"empty_{w.__module__.split('.')[0]}.ovl"
        assert w(tuple(a[:0] for a in arrs), str(e)) == 0 and e.read_bytes() == b""


def _cr_gt(recs):  # '\r>' joins record 8 onto record 7
    recs[6] = recs[6][:-1] + b"\r"


def _cr_header(recs):  # record 12's header line runs into its first bases
    recs[11] = recs[11].replace(b" desc\n", b" desc\r", 1)


def _byte_ff(recs):
    recs[20] = recs[20][:40] + b"\xff" + recs[20][41:]


def _utf8(recs):
    recs[30] = recs[30][:45] + "é".encode() + recs[30][46:]


def _ff_and_cr_gt(recs):
    _byte_ff(recs)
    _cr_gt(recs)


@pytest.mark.parametrize("tweak", [_cr_gt, _cr_header, _byte_ff, _utf8, _ff_and_cr_gt],
                         ids=lambda f: f.__name__.strip("_"))
def test_run_arrays_path_equals_the_jax_engine(tmp_path, tweak):
    """Overlapper.run_arrays(path) on 300 simulated reads with one of the four
    layouts planted (and with a 0xFF byte and a '\\r>' pair together) equals
    the JAX engine's run_arrays(path), which reads with its native reader."""
    path = _sim_fasta(tmp_path, 300, seed=9, tweak=tweak)
    want = JOverlapper(JS).run_arrays(path)
    ov = Overlapper(S, device="cpu")
    got = ov.run_arrays(path)
    assert len(want[0]) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
    assert ov.stats.n_reads == native.fasta_scan_native(path)[0]
    stream = Overlapper(S, device="cpu").run_stream_arrays(path, chunk_reads=64)
    assert all(np.array_equal(a, b) for a, b in zip(stream, got))


def test_cli_reads_with_read_fasta_as_the_jax_cli(tmp_path):
    """The CLI parses with read_fasta, as the JAX CLI does: a 0xFF byte is a
    UnicodeDecodeError there, not a base."""
    path = _write(tmp_path, "ff", LAYOUTS["byte_ff"])
    with pytest.raises(UnicodeDecodeError):
        cli_main(["-i", path, "--device", "cpu"])


def test_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A native build that fails raises with what the compiler printed; the
    engine does not fall back to the Python reader."""
    path = _write(tmp_path, "ok", b">a\nACGTACGTACGTACGT\n")
    script = "echo 'fastio.cpp:1: error: no compiler here' >&2; exit 1"
    for cmd, shows in ((("false",), r"false failed \(exit 1\)"),
                       (("sh", "-c", script, "sh"), "no compiler here")):
        monkeypatch.setattr(_build, "CXX", cmd)
        _build.load_host.cache_clear()
        native.lib.cache_clear()
        try:
            with pytest.raises(RuntimeError, match=shows):
                Overlapper(S, device="cpu").run_arrays(path)
            with pytest.raises(RuntimeError, match=shows):
                write_ovl_arrays(([1], [2], [0], [0]), str(tmp_path / "o.ovl"))
        finally:
            monkeypatch.undo()
            _build.load_host.cache_clear()
            native.lib.cache_clear()
    assert native.fasta_scan_native(path) == (1, 16)
