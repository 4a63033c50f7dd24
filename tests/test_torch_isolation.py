"""The port stands alone: no module of ``sequence_aligner_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points
refuse the card when there is none instead of falling back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax  # noqa: F401  (imported like every port test; the checks below are static or in a subprocess)
import pytest
import torch

from sequence_aligner_tpu_torch import cli
from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import AlignSettings
from sequence_aligner_tpu_torch.device import resolve_device
from sequence_aligner_tpu_torch.dist import worker
from sequence_aligner_tpu_torch.models.overlapper import Overlapper
from sequence_aligner_tpu_torch.parallel.shard import sharded_overlap
from sequence_aligner_tpu_torch.pipeline.driver import run_amos_pipeline

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "sequence_aligner_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sequence_aligner_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func  # __import__("x") and importlib.import_module("x")
            if getattr(fn, "id", None) == "__import__" or getattr(fn, "attr", None) == "import_module":
                names.add(node.args[0].value)
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert path.is_file()
    bad = sorted(n for n in _imported(path) if _forbidden(n))
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sequence_aligner_tpu' or m.startswith('sequence_aligner_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_refuse_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Overlapper(AlignSettings())  # the default device is the card
    fasta = tmp_path / "r.fasta"
    fasta.write_text(">a\nACGTACGTACGTACGT\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-i", str(fasta), "-o", str(tmp_path / "o.ovl")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-i", str(fasta), "-o", str(tmp_path / "o.ovl"), "--engine", "sharded"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded_overlap([Sequence(1, "ACGTACGTACGTACGT")], AlignSettings())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker.main(["-i", str(fasta), "-o", str(tmp_path / "o.ovl")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_amos_pipeline(str(fasta), AlignSettings(), str(tmp_path / "pipe"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["-i", str(fasta), "--pipeline", "--workdir", str(tmp_path / "pipe")])
    assert not torch.distributed.is_initialized()  # no group was left behind
    assert resolve_device("cpu").type == "cpu"
    assert np.array_equal(
        Overlapper(AlignSettings(), device="cpu").run_arrays(str(fasta))[0], [])


def test_chip_smoke_refuses_without_a_card_and_alone(tmp_path):
    """chip_smoke.py fails, printing no result line, where there is no card
    and where it stands alone without the repository."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=120,
                           env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
