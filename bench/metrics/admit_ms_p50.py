"""admit_ms_p50: the median duration of the program's ``engine.admit``
spans (one admission's work, without its wait in the queue) in the traced
stretch, in ms."""
from bench.lib import spans as S


def read(rec):
    return S.admit_ms_p50(S.program_spans())
