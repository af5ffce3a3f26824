"""host_syncs_per_iteration: the program's device-to-host readbacks
(``sync`` spans, one for each count of its ``host_syncs`` counter) in the
traced stretch, over its iterations."""
from bench.lib import spans as S


def read(rec):
    return S.host_syncs_per_iteration(S.program_spans())
