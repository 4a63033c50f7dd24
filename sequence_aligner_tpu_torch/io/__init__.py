"""FASTA reading and OVL writing (host)."""
