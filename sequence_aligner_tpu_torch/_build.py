"""Build the CUDA sources in ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` becomes ``build/torch_kernels/lib<name>-<hash>.so``
at the repository root, compiled by ``nvcc`` for ``sm_90a`` with a plain C
interface and loaded with ``ctypes``: no PyTorch or CUTLASS headers, so a
build takes seconds.  The file name carries a hash of the sources and flags,
so a changed source never loads a stale library.  The library is written
under a temporary name and ``os.replace``d into place: parallel test workers
never see half a file, and no lock file exists that could be left behind.

If ``nvcc`` is missing or the build fails, loading raises with the
compiler's output.  Nothing here runs at import time.
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
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_TIMEOUT_S = 300
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists.
    Returns (final path, temporary path, Popen) or (final path, None, None)."""
    out = library_path(name)
    if out.is_file():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return out, tmp, proc


def finish_build(out: Path, tmp: Path | None, proc) -> str:
    """Wait for a build from ``start_build``; returns the compiler's output
    (the ``-Xptxas -v`` register and spill lines), raises if it failed."""
    if proc is None:
        log = out.with_suffix(".log")
        return log.read_text() if log.is_file() else ""
    try:
        text, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc took more than {NVCC_TIMEOUT_S} s building {out.name}")
    if proc.returncode != 0 or not tmp.is_file():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {out.name}:\n{text}"
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
