"""admission_wait_p50_ms: the median, over requests the scheduler
admitted inside the window, of its admission stamp (``Request.t_admit``,
taken once the admission prefill's first token is read back) minus the
request's due time: the queue's wait and the prefill itself."""
from bench.lib.common import percentile


def read(rec):
    w0, w1 = rec.window
    waits = [r.t_admit - r.due for r in rec.requests
             if r.t_admit and w0 <= r.t_admit <= w1]
    p = percentile(waits, 50)
    return None if p is None else 1e3 * p
