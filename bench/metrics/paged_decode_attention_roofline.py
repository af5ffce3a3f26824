"""paged_decode_attention_roofline: the paged decode kernel's calls in
the traced stretch, their least time at the card's peaks (FLOPs and bytes
from each call's shapes and live keys, ``bench/lib/counts.py``) over the
kernel's device time by name, in percent."""
from bench.lib import trace as T


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    return T.roofline_share(tr.kernels, tr.calls, "paged_decode_attention")
