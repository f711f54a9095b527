"""Percent of the traced waves' decode steps replayed from a CUDA graph: the
``serve.decode`` spans whose ``graph`` field reads ``"replay"``, over all
their ``serve.decode`` spans. Read from the program's spans; none recorded,
nothing to read (a program whose spans carry no ``graph`` field replays
nothing)."""

from perfbench.yardstick import spans


def read(trace):
    steps = [s for w in spans.waves(trace) for s in w.get("serve.decode", [])]
    if not steps:
        return None
    return 100.0 * sum(s.fields.get("graph") == "replay" for s in steps) / len(steps)
