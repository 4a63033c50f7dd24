"""Settings and result records (host)."""

from sequence_aligner_tpu_torch.core.settings import AlignSettings
from sequence_aligner_tpu_torch.core.records import Sequence, AlignmentResult, OverlapRecord

__all__ = ["AlignSettings", "Sequence", "AlignmentResult", "OverlapRecord"]
