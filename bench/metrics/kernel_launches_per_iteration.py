"""kernel_launches_per_iteration: kernels the card ran in the traced
stretch over the scheduler iterations dispatched in it (admissions'
kernels included)."""
from bench.lib import trace as T


def read(rec):
    tr = rec.trace
    if tr is None or not tr.iterations or not tr.kernels:
        return None
    return T.launches(tr.kernels) / tr.iterations
