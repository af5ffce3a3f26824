"""draft_device_ms_per_iteration: the card's busy time inside the
program's ``step.draft`` and ``step.extend`` spans (the P-EAGLE drafter's
forward and its cache extension) in the traced stretch, over its
iterations, in ms."""
from bench.lib import spans as S


def read(rec):
    if rec.trace is None:
        return None
    return S.draft_device_ms_per_iteration(S.program_spans(),
                                           rec.trace.kernels)
