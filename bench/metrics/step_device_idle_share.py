"""step_device_idle_share: the share of the program's ``engine.step``
spans in the traced stretch in which nothing ran on the card (100 times
one less the busy union inside the spans over their summed duration), in
percent."""
from bench.lib import spans as S


def read(rec):
    if rec.trace is None:
        return None
    return S.step_device_idle_share(S.program_spans(), rec.trace.kernels)
