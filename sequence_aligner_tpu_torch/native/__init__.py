"""ctypes bindings of the native IO layer (``fastio.cpp``).

The port's copy of the JAX package's reader and writer, with the same C ABI:
the engine reads FASTA files with it (``Overlapper.run_arrays(path)`` and
``run_stream_arrays``) and writes OVL files with it (``io.ovl``), so both
engines take the same bytes as the same reads.  The library is built with
g++ at first use (``_build.load_host``); where the build fails, the first
call raises with the compiler's output.  Nothing falls back to the Python
readers of ``io/fasta.py`` and ``io/stream.py``, which stay as the plain
versions the tests use.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from sequence_aligner_tpu_torch import _build

_I8P = ctypes.POINTER(ctypes.c_int8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded library with its functions' signatures declared."""
    so = _build.load_host("fastio")
    so.fasta_scan.restype = ctypes.c_int
    so.fasta_scan.argtypes = [ctypes.c_char_p, _I64P, _I64P]
    so.fasta_encode.restype = ctypes.c_int64
    so.fasta_encode.argtypes = [ctypes.c_char_p, _I8P, _I32P, ctypes.c_int64,
                                ctypes.c_int64]
    so.fasta_encode_chunk.restype = ctypes.c_int64
    so.fasta_encode_chunk.argtypes = [ctypes.c_char_p, _I64P, _I8P, _I32P,
                                      ctypes.c_int64, ctypes.c_int64]
    so.ovl_write.restype = ctypes.c_int64
    so.ovl_write.argtypes = [ctypes.c_char_p, _I32P, _I32P, _I32P, _I32P, ctypes.c_int64]
    return so


def _invalid(path) -> ValueError:
    return ValueError(f"Invalid Sequence File: {path}")


def fasta_scan_native(path) -> tuple[int, int]:
    """(n_reads, max_len) of a FASTA file.  Raises ValueError on an invalid
    sequence file (empty, or not starting with '>') and OSError where the
    file cannot be read."""
    n = ctypes.c_int64()
    mx = ctypes.c_int64()
    rc = lib().fasta_scan(os.fsencode(path), ctypes.byref(n), ctypes.byref(mx))
    if rc == -2:
        raise _invalid(path)
    if rc != 0:
        # the reader maps no empty file; a missing one raises FileNotFoundError here
        if os.path.getsize(path) == 0:
            raise _invalid(path)
        raise OSError(f"cannot map {path}")
    return int(n.value), int(mx.value)


def fasta_encode_native(path) -> tuple[np.ndarray, np.ndarray]:
    """(bases int8 [N, Lmax] zero-padded, lengths int32 [N]) of a FASTA file."""
    n, mx = fasta_scan_native(path)
    bases = np.zeros((n, mx), dtype=np.int8)
    lengths = np.zeros(n, dtype=np.int32)
    got = lib().fasta_encode(os.fsencode(path), bases.ctypes.data_as(_I8P),
                             lengths.ctypes.data_as(_I32P), n, mx)
    if got != n:
        raise RuntimeError(f"{path}: scanned {n} reads, encoded {got} (file changed?)")
    return bases, lengths


def fasta_encode_chunks_native(path, chunk_reads: int, l_max: int):
    """Generator of (bases int8 [m, l_max], lengths int32 [m]) chunks in file
    order, m == chunk_reads except possibly the last; host memory
    O(chunk_reads * l_max)."""
    if chunk_reads < 1:
        raise ValueError("chunk_reads must be >= 1")
    off = ctypes.c_int64(0)
    name = os.fsencode(path)
    while True:
        bases = np.zeros((chunk_reads, l_max), dtype=np.int8)
        lengths = np.zeros(chunk_reads, dtype=np.int32)
        got = lib().fasta_encode_chunk(name, ctypes.byref(off), bases.ctypes.data_as(_I8P),
                                       lengths.ctypes.data_as(_I32P), chunk_reads, l_max)
        if got < 0:
            raise _invalid(path)
        if got == 0:
            return
        yield bases[:got], lengths[:got]
        if got < chunk_reads:
            return


def ovl_write_native(path, ida, idb, ahg, bhg) -> int:
    """Write {OVL} records (src/ObjectStore.scala:127-135) to ``path``;
    returns the bytes written."""
    arrs = [np.ascontiguousarray(a, dtype=np.int32) for a in (ida, idb, ahg, bhg)]
    n = len(arrs[0])
    if any(len(a) != n for a in arrs):
        raise ValueError("ovl_write_native: columns of different lengths")
    rc = lib().ovl_write(os.fsencode(path), *(a.ctypes.data_as(_I32P) for a in arrs), n)
    if rc < 0:
        raise OSError(f"cannot write {path}")
    return int(rc)
