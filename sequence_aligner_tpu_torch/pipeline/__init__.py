"""Dataset paths, simulated read sets and the AMOS assembly pipeline."""
