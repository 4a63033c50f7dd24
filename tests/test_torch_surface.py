"""The port does all that the JAX package does, name for name.

The JAX package is read by ``ast`` only (no JAX module is imported here).
Every name a JAX subpackage exports must be importable from the port's
counterpart subpackage, every public top-level function and class of every
JAX module must have a counterpart in the port module of the same path, and
every public method of a JAX class one on the port's class of that name.  A
counterpart under another name stands in ``RENAMED``; a name the port has
no use for stands in ``NO_COUNTERPART`` with the reason.  A JAX public name
added later with neither fails here.

Keys are dotted paths below the package: ``module.name`` or
``module.Class.method`` (``native`` is ``native/__init__.py``)."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "sequence_aligner_tpu"
PORT = "sequence_aligner_tpu_torch"

# JAX name -> the port's counterpart
RENAMED = {
    "native.get_lib": "native.lib",
    # the Pallas wrappers over transposed reads -> the kernels' plain versions
    "ops.align_fused.phase1_fused": "ops.align_fused.phase1_plain",
    "ops.align_fused.phase2_fused": "ops.align_fused.phase2_plain",
    # the Pallas wrappers over the packed read table -> the CUDA kernels' wrappers
    "ops.align_fused.phase1_fused_packed": "ops.align_fused.phase1_indexed",
    "ops.align_fused.phase2_fused_packed": "ops.align_fused.phase2_indexed",
    "ops.align_fused.fast_dovetail_batch_fused": "ops.align_fused.fast_dovetail_batch",
    # jitted sorts -> one torch sort of the valid rows (no packed payload)
    "ops.pairgen.sort_occurrences_jit": "ops.pairgen.sort_occurrences",
    "ops.pairgen.sort_occurrences_packed_jit": "ops.pairgen.sort_occurrences",
    # device partial sums -> int64 device sums returned as Python ints
    "ops.pairgen.plan_totals_device": "ops.pairgen.plan_totals",
    # the collision band's compaction by sort -> by boolean mask
    "ops.pairgen.compact_pairs": "ops.pairgen.band_pairs",
    # a JAX mesh -> a torch.distributed process group
    "parallel.mesh.make_mesh": "parallel.mesh.make_group",
    "dist.init.distributed_mesh": "dist.init.distributed_group",
    # factories of jitted shard_map steps -> the steps, run on a process group
    "parallel.shard.make_sharded_plan_step": "parallel.shard.sharded_plan_step",
    "parallel.shard.make_sharded_pairs_step": "parallel.shard.sharded_pairs_step",
    "parallel.shard.make_sharded_align_step": "parallel.shard.sharded_align_step",
    "utils.timing.format_duration": "utils.debug.format_duration",
}

# JAX name -> why the port has no counterpart
NO_COUNTERPART = {
    "ops.align_fused.kernel_interpret":
        "Pallas interpret mode; a port wrapper runs its plain version on a CPU tensor",
    "ops.pairgen.aggregate_pairs":
        "no caller in the JAX package; the port counts pairs by one sort of int64 keys",
    "utils.timing.StageTimer":
        "the port's stage clock is Overlapper.stage_s with utils.debug.time_report",
    "utils.profiling.ensure_compile_cache":
        "the JAX compile cache; the port's kernels are cached by _build.py",
}


def _module(path: Path) -> str:
    """Dotted path below the package of a JAX file."""
    parts = path.relative_to(JAX_PKG).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


JAX_FILES = sorted(JAX_PKG.rglob("*.py"))
JAX_INITS = [p for p in JAX_FILES if p.name == "__init__.py"]


def _public_defs(tree: ast.Module):
    return [n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _jax_defs() -> dict[str, ast.AST]:
    """Every public top-level function and class and every public method of
    a public class, by key."""
    out = {}
    for path in JAX_FILES:
        mod = _module(path)
        for node in _public_defs(ast.parse(path.read_text())):
            key = f"{mod}.{node.name}".lstrip(".")
            out[key] = node
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, ast.FunctionDef) and not m.name.startswith("_"):
                        out[f"{key}.{m.name}"] = m
    return out


def _resolve(key: str):
    """The port object at a dotted key, or None."""
    parts = key.split(".")
    for cut in range(len(parts), -1, -1):
        name = ".".join([PORT, *parts[:cut]])
        try:
            obj = importlib.import_module(name)
        except ModuleNotFoundError as e:
            if e.name is not None and not name.startswith(e.name):
                raise  # a module the port imports is missing, not this one
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr, None)
            if obj is None:
                return None
        return obj
    return None


def _counterpart(key: str):
    """The port's counterpart of a JAX key, under its own or its new name."""
    return _resolve(RENAMED.get(key, key))


def _exports(path: Path) -> tuple[dict[str, str], bool]:
    """({exported name: key of its definition}, whether ``__all__`` lists
    them) of a JAX ``__init__``: its ``__all__``, else what it imports from
    the package."""
    tree = ast.parse(path.read_text())
    origin, listed = {}, None
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(JAX_PKG.name):
            mod = node.module.removeprefix(JAX_PKG.name).lstrip(".")
            for a in node.names:
                origin[a.asname or a.name] = f"{mod}.{a.name}".lstrip(".")
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            listed = ast.literal_eval(node.value)
    return {n: origin[n] for n in (origin if listed is None else listed)}, listed is not None


@pytest.mark.parametrize("path", JAX_INITS, ids=lambda p: _module(p) or "top")
def test_every_exported_name_imports_from_the_port(path):
    pkg = ".".join(filter(None, [PORT, _module(path)]))
    port = importlib.import_module(pkg)
    exports, listed = _exports(path)
    for name, key in exports.items():
        if key in NO_COUNTERPART:
            continue
        target = RENAMED.get(key, key)
        port_name = target.rsplit(".", 1)[-1]
        # `from <port pkg> import <name>` gives the object the module defines
        got = getattr(port, port_name, None)
        assert got is not None, f"{pkg} does not export {port_name} (JAX {name})"
        assert got is _resolve(target), f"{pkg}.{port_name} is not {target}"
        if listed:
            assert port_name in port.__all__, f"{port_name} not in {pkg}.__all__"


@pytest.mark.parametrize("path", JAX_FILES, ids=lambda p: str(p.relative_to(JAX_PKG)))
def test_every_public_function_and_class_has_a_counterpart(path):
    mod = _module(path)
    missing = []
    for node in _public_defs(ast.parse(path.read_text())):
        key = f"{mod}.{node.name}".lstrip(".")
        if key not in NO_COUNTERPART and _counterpart(key) is None:
            missing.append(key)
    assert not missing, f"no port counterpart, rename or reason for {missing}"


JAX_CLASSES = sorted(k for k, n in _jax_defs().items()
                     if isinstance(n, ast.ClassDef) and k not in NO_COUNTERPART)


@pytest.mark.parametrize("key", JAX_CLASSES)
def test_every_public_method_has_a_counterpart(key):
    cls = _counterpart(key)
    assert isinstance(cls, type), key
    methods = [k for k in _jax_defs() if k.startswith(key + ".") and k not in NO_COUNTERPART]
    missing = [k for k in methods if not hasattr(cls, RENAMED.get(k, k).rsplit(".", 1)[-1])]
    assert not missing, f"no port method for {missing}"


@pytest.mark.parametrize("table", ["RENAMED", "NO_COUNTERPART"])
def test_maps_name_jax_definitions_without_a_namesake(table):
    """Each entry names a public JAX definition whose namesake the port does
    not have (else the entry is stale); each rename's target exists, and
    each reason is one line."""
    defs = _jax_defs()
    for key, value in globals()[table].items():
        assert key in defs, f"{table}: {key} is no public JAX definition"
        assert _resolve(key) is None, f"{table}: the port has {key} under its own name"
        if table == "RENAMED":
            assert _resolve(value) is not None, f"RENAMED: {value} is not in the port"
        else:
            assert value and "\n" not in value


def test_importing_a_subpackage_builds_and_loads_nothing():
    """Importing every port module compiles nothing (no g++, no nvcc),
    loads no shared library of the port's and loads no JAX."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / PORT).rglob("*.py")
    )
    code = (
        "import ctypes, subprocess, sys\n"
        "import numpy, torch, torch.distributed\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'built or loaded at import: {a[:2]}')\n"
        "subprocess.Popen.__init__ = refuse\n"
        "ctypes.CDLL.__init__ = refuse\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'sequence_aligner_tpu'))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
