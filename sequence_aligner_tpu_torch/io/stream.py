"""Streamed FASTA input in Python: chunked scan and encode with O(chunk)
host memory.

The plain version of the native chunk reader (``native/fastio.cpp``'s
``fasta_scan`` and ``fasta_encode_chunk``, which ``Overlapper.run_stream_arrays``
reads with), with its semantics: the file must start with ``>``, a record
starts at a ``>`` that begins a line, and a sequence line loses its newline
and every carriage return but keeps any other byte (trailing blanks are
bases, encoded as code 0):

  * ``fasta_scan``          — one cheap pass -> (n_reads, max_len);
  * ``iter_encoded_chunks`` — generator of ([m, l_max] int8 code matrix,
                              [m] int32 lengths) chunks in file order.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from sequence_aligner_tpu_torch.ops.encode import _LUT


def _body(line: bytes) -> bytes:
    """A sequence line without its newline and without any carriage return."""
    return line.rstrip(b"\n").replace(b"\r", b"")


def fasta_scan(path: str) -> tuple[int, int]:
    """(n_reads, max_body_len) in one pass; raises ValueError on a file
    that is empty or does not start with ``>``."""
    n = 0
    cur = 0
    mx = 0
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                n += 1
                mx = max(mx, cur)
                cur = 0
            else:
                if n == 0:
                    raise ValueError(f"Invalid Sequence File: {path}")
                cur += len(_body(line))
    if n == 0:
        raise ValueError(f"Invalid Sequence File: {path}")
    return n, max(mx, cur)


def iter_encoded_chunks(
    path: str, chunk_reads: int, l_max: int
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (bases [m, l_max] int8, lengths [m] int32) chunks in file
    order, m == chunk_reads except possibly the last."""
    bases = np.zeros((chunk_reads, l_max), dtype=np.int8)
    lengths = np.zeros(chunk_reads, dtype=np.int32)
    m = -1  # current record index within the chunk
    cur = 0
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if m >= 0:
                    lengths[m] = cur
                if m + 1 == chunk_reads:
                    yield bases, lengths
                    bases = np.zeros((chunk_reads, l_max), dtype=np.int8)
                    lengths = np.zeros(chunk_reads, dtype=np.int32)
                    m = -1
                m += 1
                cur = 0
            else:
                if m < 0:
                    raise ValueError(f"Invalid Sequence File: {path}")
                body = np.frombuffer(_body(line), dtype=np.uint8)
                take = body[: max(l_max - cur, 0)]
                bases[m, cur : cur + len(take)] = _LUT[take]
                cur += len(body)
    if m >= 0:
        lengths[m] = cur
        yield bases[: m + 1], lengths[: m + 1]
