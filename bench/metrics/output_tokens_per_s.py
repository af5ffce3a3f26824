"""output_tokens_per_s: every token streamed to a client with a time
stamp inside the window, over the window's seconds."""


def read(rec):
    w0, w1 = rec.window
    n = sum(1 for r in rec.requests for t in r.times if w0 <= t <= w1)
    return n / rec.window_s
