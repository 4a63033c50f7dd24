from sequence_aligner_tpu_torch.parallel.mesh import make_group
from sequence_aligner_tpu_torch.parallel.shard import (
    sharded_align_step, sharded_overlap, sharded_overlap_arrays, sharded_pairs_step,
    sharded_plan_step,
)

__all__ = [
    "make_group", "sharded_plan_step", "sharded_pairs_step", "sharded_align_step",
    "sharded_overlap", "sharded_overlap_arrays",
]
