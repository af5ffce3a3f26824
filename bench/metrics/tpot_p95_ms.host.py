"""tpot_p95_ms.host: the 95th percentile, over requests with at least two
tokens inside the window, of (last - first token time) / (n - 1), their
tokens inside the window only."""
from bench.lib.common import percentile


def read(rec):
    w0, w1 = rec.window
    tpot = []
    for r in rec.requests:
        ts = [t for t in r.times if w0 <= t <= w1]
        if len(ts) >= 2:
            tpot.append((ts[-1] - ts[0]) / (len(ts) - 1))
    p = percentile(tpot, 95)
    return None if p is None else 1e3 * p
