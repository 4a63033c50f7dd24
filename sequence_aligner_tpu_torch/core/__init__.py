"""Settings and result records (host)."""
