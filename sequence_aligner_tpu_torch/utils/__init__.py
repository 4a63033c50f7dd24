"""Debug output and profiling (host)."""
