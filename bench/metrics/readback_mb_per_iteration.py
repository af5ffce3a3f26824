"""readback_mb_per_iteration: the bytes the program's ``sync`` spans read
back from the card (its ``readback_bytes`` counter) in the traced stretch,
over its iterations, in 10^6 bytes."""
from bench.lib import spans as S


def read(rec):
    return S.readback_mb_per_iteration(S.program_spans())
