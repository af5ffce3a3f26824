"""sched_self_ms_per_iteration: the self time of the scheduler's four
passes (``sched.admit_waiting``, ``sched.grow``, ``sched.dispatch``,
``sched.harvest``: each span's duration less its child ``engine.*`` and
``sync`` spans) in the traced stretch, over its iterations, in ms."""
from bench.lib import spans as S


def read(rec):
    return S.sched_self_ms_per_iteration(S.program_spans())
