"""The overlap engine."""
