"""verify_graph_share: the share of the program's ``engine.step`` spans in
the traced stretch whose verify forward replayed a captured CUDA graph (a
``verify.replay`` span inside the step), in percent. None where the program
records no spans, or has no verify graph to replay (its counters hold no
``verify_graph.replays``)."""
from bench.lib import spans as S


def share(spans):
    """Percent of the ``engine.step`` spans that hold a ``verify.replay``
    span at any depth; None without steps."""
    steps = {s.id for s in spans if s.name == "engine.step"}
    if not steps:
        return None
    parent = {s.id: s.parent for s in spans}
    replayed = set()
    for s in spans:
        if s.name == "verify.replay":
            p = s.parent
            while p is not None and p not in steps:
                p = parent.get(p)
            if p is not None:
                replayed.add(p)
    return 100.0 * len(replayed) / len(steps)


def _replays_verify() -> bool:
    try:
        from repro_torch import tracing
    except ImportError:
        return False
    return "verify_graph.replays" in tracing.counters()["serving"]


def read(rec):
    spans = S.program_spans()
    if spans is None or not _replays_verify():
        return None
    return share(spans)
