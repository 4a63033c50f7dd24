"""Dataset paths, simulated read sets and the AMOS assembly pipeline."""

from sequence_aligner_tpu_torch.pipeline.datasets import shred_genome, c_ruddii_reads
from sequence_aligner_tpu_torch.pipeline.driver import run_amos_pipeline, PipelineResult

__all__ = [
    "shred_genome", "c_ruddii_reads", "run_amos_pipeline", "PipelineResult",
]
