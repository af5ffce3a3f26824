"""Training corpora and MTP batches."""
from repro_torch.data.pipeline import (MTPBatch, MTPPipeline, markov_corpus,
                                       self_generated_corpus)

__all__ = ["MTPBatch", "MTPPipeline", "markov_corpus", "self_generated_corpus"]
