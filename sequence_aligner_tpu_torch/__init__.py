"""sequence_aligner_tpu_torch — the overlap engine in PyTorch and CUDA.

A port of ``sequence_aligner_tpu`` (JAX on a TPU) to PyTorch on NVIDIA
H100s.  The JAX package stays the reference; this package imports nothing of
it and keeps its own copies of the host-side layers it needs.

Layer map (the JAX package's layout, so each counterpart is easy to find):

  core/      settings and result records (host)
  io/        FASTA readers (Python, the plain versions), OVL writer, HOXD
             matrix files (host)
  native/    the C++ FASTA reader and OVL writer the engine uses, built with
             g++ at first use (_build.py)
  ops/       encode (host), k-mer scan, pair generation, the dovetail aligner
             with its two CUDA kernels and their plain PyTorch versions, the
             quadratic Smith-Waterman in torch ops
  models/    the Overlapper engine
  parallel/  the sharded engine on torch.distributed: reads split over the
             ranks, the k-mer table by hash, pair counts by pair owner
  dist/      joining a multi-process group, and the multi-process worker
  oracle/    the CPU oracle engine (numpy, one pair at a time)
  utils/     --debug output and --profile traces
  pipeline/  simulated read sets
  csrc/      CUDA sources, built with nvcc at first use (_build.py)
  cli.py     ``python -m sequence_aligner_tpu_torch.cli``
"""

__version__ = "0.1.0"

from sequence_aligner_tpu_torch.core.settings import AlignSettings  # noqa: F401
