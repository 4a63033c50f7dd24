"""Alignment configuration.

A copy of ``sequence_aligner_tpu/core/settings.py`` (the port imports nothing
of the JAX package): the reference's immutable settings blob
(``src/ObjectStore.scala:17-36``) with the CLI defaults of its argument
parser (``src/Project4.scala:41,101-114``), as a frozen dataclass.

The engine has no learned parameters; these settings are its whole state.
``settings_from_jax`` carries a JAX-side ``AlignSettings`` (or a dict of its
fields) across, so both engines run one configuration.

The substitution score is a 4x4 int32 matrix indexed by the 2-bit base codes
(A=0, C=1, T=2, G=3 — the ``seqHash`` packing order of
``src/ObjectStore.scala:56-59``) so that device code never touches strings.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# 2-bit base encoding, matching the reference k-mer hash packing
# (src/ObjectStore.scala:56-59): A=00, C=01, T=10, G=11.
BASE_CODE = {"A": 0, "C": 1, "T": 2, "G": 3}
CODE_BASE = "ACTG"

# HOXD70 substitution scores (src/BioLibs.scala:119-161), laid out in the
# A,C,T,G base-code order.
_HOXD70 = {
    ("A", "A"): 91, ("A", "C"): -114, ("A", "G"): -31, ("A", "T"): -123,
    ("C", "A"): -114, ("C", "C"): 100, ("C", "G"): -125, ("C", "T"): -31,
    ("G", "A"): -31, ("G", "C"): -125, ("G", "G"): 100, ("G", "T"): -114,
    ("T", "A"): -123, ("T", "C"): -31, ("T", "G"): -114, ("T", "T"): 91,
}


def default_hoxd_matrix() -> np.ndarray:
    """4x4 int32 HOXD70 matrix in base-code (A,C,T,G) order."""
    m = np.zeros((4, 4), dtype=np.int32)
    for (a, b), v in _HOXD70.items():
        m[BASE_CODE[a], BASE_CODE[b]] = v
    return m


def simple_match_matrix(match: int, mismatch: int) -> np.ndarray:
    """Flat match/mismatch cost matrix (src/BioLibs.scala:165-167)."""
    m = np.full((4, 4), int(mismatch), dtype=np.int32)
    np.fill_diagonal(m, int(match))
    return m


@dataclasses.dataclass(frozen=True)
class AlignSettings:
    """Immutable alignment settings (``src/Project4.scala:104-114``)."""

    # 4x4 int32 substitution matrix in base-code order (A,C,T,G).
    cost_matrix: np.ndarray = dataclasses.field(default_factory=default_hoxd_matrix)
    gap_open: int = -200
    gap_extend: int = -20
    min_overlap: int = 40
    min_identity: float = 0.98
    max_ignore: int = 90
    kmer_size: int = 12
    min_collisions: int = 7
    max_collisions: int = 222
    kmer_edge: float = 0.4
    kmer_center: float = 0.4

    def __post_init__(self):
        # float32 thresholds, so comparisons match the reference's Float
        # arithmetic exactly
        object.__setattr__(self, "min_identity", np.float32(self.min_identity))
        object.__setattr__(self, "kmer_edge", np.float32(self.kmer_edge))
        object.__setattr__(self, "kmer_center", np.float32(self.kmer_center))
        cm = np.asarray(self.cost_matrix, dtype=np.int32)
        if cm.shape != (4, 4):
            raise ValueError("cost_matrix must be 4x4")
        object.__setattr__(self, "cost_matrix", cm)

    # Positional-class geometry (src/ObjectStore.scala:32-35).
    @property
    def kmer_head_edge(self) -> np.float32:
        return np.float32(self.kmer_edge)

    @property
    def kmer_tail_edge(self) -> np.float32:
        return np.float32(np.float32(1.0) - np.float32(self.kmer_edge))

    @property
    def kmer_mid_lead_edge(self) -> np.float32:
        return np.float32(np.float32(0.5) - np.float32(self.kmer_center) * np.float32(0.5))

    @property
    def kmer_mid_tail_edge(self) -> np.float32:
        return np.float32(np.float32(0.5) + np.float32(self.kmer_center) * np.float32(0.5))

    def band_width(self, len_a: int) -> int:
        """Dovetail DP band width (src/BioLibs.scala:389-390):
        max(kmer_size, floor(|A| * (1 - min_identity)) + 1), with the
        product in float32 like the reference's ``Int * Float``."""
        frac = np.float32(np.float32(1.0) - np.float32(self.min_identity))
        return max(
            self.kmer_size,
            int(math.floor(float(np.float32(len_a) * frac))) + 1,
        )

    def band_widths(self, len_a: np.ndarray) -> np.ndarray:
        """``band_width`` over an int array of lead lengths, int32."""
        frac = np.float32(np.float32(1.0) - np.float32(self.min_identity))
        w = np.floor(
            (len_a.astype(np.float32) * frac).astype(np.float64)
        ).astype(np.int32) + 1
        return np.maximum(w, np.int32(self.kmer_size))

    def score(self, a: str, b: str) -> int:
        """The substitution score of two bases given as characters."""
        return int(self.cost_matrix[BASE_CODE[a.upper()], BASE_CODE[b.upper()]])

    def cm_tuple(self) -> tuple[int, ...]:
        """The cost matrix as 16 Python ints, row-major (a * 4 + b)."""
        return tuple(int(x) for x in self.cost_matrix.reshape(-1))

    def replace(self, **kw) -> "AlignSettings":
        return dataclasses.replace(self, **kw)

    @classmethod
    def amos_parity(cls, **kw) -> "AlignSettings":
        """Collision band [2, 222] that reproduces AMOS ``hash-overlap -B
        -x 0.04 -o 40`` output on the golden data (see the JAX package)."""
        kw.setdefault("min_collisions", 2)
        return cls(**kw)


_FIELDS = tuple(f.name for f in dataclasses.fields(AlignSettings))


def settings_from_jax(obj_or_dict) -> AlignSettings:
    """Build the port's settings from the JAX package's ``AlignSettings``
    (any object with its field attributes) or from a dict of its fields.

    Values are plain Python or numpy scalars and a 4x4 array; float fields
    go through float32 exactly as the JAX dataclass stores them, so
    ``band_width`` and the identity threshold agree bit for bit."""
    if isinstance(obj_or_dict, dict):
        get = obj_or_dict.__getitem__
        missing = [f for f in _FIELDS if f not in obj_or_dict]
        unknown = sorted(set(obj_or_dict) - set(_FIELDS))
        if unknown:
            raise ValueError(f"unknown AlignSettings fields: {unknown}")
    else:
        get = lambda f: getattr(obj_or_dict, f)  # noqa: E731
        missing = [f for f in _FIELDS if not hasattr(obj_or_dict, f)]
    if missing:
        raise ValueError(f"missing AlignSettings fields: {missing}")
    kw = {}
    for f in _FIELDS:
        v = get(f)
        if f == "cost_matrix":
            kw[f] = np.array(v, dtype=np.int32)
        elif f in ("min_identity", "kmer_edge", "kmer_center"):
            kw[f] = np.float32(v)
        else:
            kw[f] = int(v)
    return AlignSettings(**kw)
