"""Torch's CPU thread count for the port's tests under pytest-xdist.

Every xdist worker would start torch's intra-op pool at the machine's core
count, so six workers run six pools on the same cores; their spinning
threads slow the port's CPU tests more than tenfold. Under xdist each
worker gets its share of the cores (at least one thread); run alone, torch
keeps its default. The port's test modules import this module first."""
import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _workers > 0:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _workers))
