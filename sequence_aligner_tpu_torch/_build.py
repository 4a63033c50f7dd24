"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` becomes ``build/torch_kernels/lib<name>-<hash>.so``
at the repository root, compiled by ``nvcc`` for ``sm_90a`` with a plain C
interface and loaded with ``ctypes``: no PyTorch or CUTLASS headers, so a
build takes seconds.  The host library ``native/<name>.cpp`` (the FASTA
reader and OVL writer) takes the same route with ``g++`` (``load_host``),
built with ``-O3`` and no ``-march=native``: the hash names the sources,
the compiler and its flags, never the machine, so a library carried to
another host runs there.  The file name carries a hash of the sources and
flags, so a changed source never loads a stale library.  The library is
written under a temporary name and ``os.replace``d into place: parallel test
workers never see half a file, and no lock file exists that could be left
behind.

If a compiler is missing or a build fails, loading raises with the
compiler's output: nothing falls back.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
NATIVE = _PKG / "native"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
BUILD_TIMEOUT_S = 300
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the host compiler command and its flags (no -march=native: see above)
CXX = ("g++",)
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def _sources(name: str) -> list[Path]:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    # every header is hashed too: any of them may be included
    return [src, *sorted(CSRC.glob("*.cuh"))]


def _hashed(name: str, flags, sources: list[Path]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    return _hashed(name, NVCC_FLAGS, _sources(name))


def _spawn(out: Path, cmd_head: list[str], src: Path):
    """Start ``cmd_head -o <temporary> src``; returns (out, temporary, Popen)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    proc = subprocess.Popen(
        [*cmd_head, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, tmp, proc


def start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists.
    Returns (final path, temporary path, Popen) or (final path, None, None)."""
    out = library_path(name)
    if out.is_file():
        return out, None, None
    return _spawn(out, [find_nvcc(), *NVCC_FLAGS], CSRC / f"{name}.cu")


def finish_build(out: Path, tmp: Path | None, proc) -> str:
    """Wait for a build from ``start_build`` (or ``load_host``); returns the
    compiler's output (for nvcc the ``-Xptxas -v`` register and spill
    lines), raises with it if the build failed."""
    if proc is None:
        log = out.with_suffix(".log")
        return log.read_text() if log.is_file() else ""
    compiler = Path(proc.args[0]).name
    try:
        text, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} took more than {BUILD_TIMEOUT_S} s building {out.name}")
    if proc.returncode != 0 or not tmp.is_file():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{compiler} failed (exit {proc.returncode}) building {out.name}:\n{text}"
        )
    out.with_suffix(".log").write_text(text)
    os.replace(tmp, out)
    return text


def build_all(names: list[str]) -> dict[str, str]:
    """Build several sources at once, one nvcc each, all started together.
    Returns each source's compiler output."""
    started = {n: start_build(n) for n in names}
    return {n: finish_build(*started[n]) for n in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    out, tmp, proc = start_build(name)
    finish_build(out, tmp, proc)
    return ctypes.CDLL(str(out))


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of ``native/<name>.cpp``, built with ``CXX``
    at first use."""
    src = NATIVE / f"{name}.cpp"
    out = _hashed(name, (*CXX, *CXX_FLAGS), [src])
    if not out.is_file():
        finish_build(*_spawn(out, [*CXX, *CXX_FLAGS], src))
    return ctypes.CDLL(str(out))
