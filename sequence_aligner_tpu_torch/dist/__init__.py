from sequence_aligner_tpu_torch.dist.init import distributed_group, initialize_distributed

__all__ = ["initialize_distributed", "distributed_group"]
