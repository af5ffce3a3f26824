"""Hand-written CUDA attention kernels, their plain PyTorch versions and
the dispatch between them (``ops``)."""
