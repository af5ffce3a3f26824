"""Drafter training and inference, speculative verification, COD sampling,
MTP masks, Algorithm-1 partitioning, training attention and losses."""
