"""The CPU oracle engine in numpy (copied from ``sequence_aligner_tpu/oracle``):
the reference's aligners, k-mer table and end-to-end overlap path, one pair
at a time.  It backs the CLI's ``--engine oracle`` / ``--st-align`` and its
``--test-*`` modes."""
