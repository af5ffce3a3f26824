"""step_mfu.serve: the model's FLOPs over the window (counted from the
shapes of every admission and step, ``counts.ServeFlops``), as seconds at
the card's bfloat16 peak, over the window's seconds, in percent."""
from bench.lib.counts import PEAK_FLOPS


def read(rec):
    w0, w1 = rec.window
    flops = sum(f for t, f in rec.flops if w0 <= t < w1)
    if not flops:
        return None
    return 100.0 * flops / PEAK_FLOPS["bfloat16"] / rec.window_s
