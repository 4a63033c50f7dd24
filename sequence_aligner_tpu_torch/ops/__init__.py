"""Tensor ops: encode (host), k-mer scan, pair generation, dovetail alignment."""
