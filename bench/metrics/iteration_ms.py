"""iteration_ms: the window's milliseconds over the scheduler iterations
(``Engine.step`` calls) dispatched inside it."""


def read(rec):
    n = rec.iterations()
    return 1e3 * rec.window_s / n if n else None
