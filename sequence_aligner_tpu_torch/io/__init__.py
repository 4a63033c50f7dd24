"""FASTA reading, OVL writing and parsing, and AMOS messages (host)."""
