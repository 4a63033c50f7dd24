"""The overlap engine."""

from sequence_aligner_tpu_torch.models.overlapper import Overlapper

__all__ = ["Overlapper"]
