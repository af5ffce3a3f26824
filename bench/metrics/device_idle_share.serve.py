"""device_idle_share.serve: the share of the traced stretch in which
nothing ran on the card (the union of kernels, copies and sets against
the stretch's host length), in percent."""
from bench.lib import trace as T


def read(rec):
    tr = rec.trace
    if tr is None or not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - T.busy_seconds(tr.kernels) / tr.window_s)
