"""ttft_p50_ms: the median, over every request due in the window, of the
time from its due time (open loop) to its first streamed token. A request
with no first token by the window's end, or whose stream failed, counts at
its age at the window's end."""
from bench.lib.common import percentile


def read(rec):
    w0, w1 = rec.window
    ttft = []
    for r in rec.requests:
        if not w0 <= r.due < w1:
            continue
        ok = r.error is None and r.t_first is not None and r.t_first <= w1
        ttft.append((r.t_first if ok else w1) - r.due)
    p = percentile(ttft, 50)
    return None if p is None else 1e3 * p
