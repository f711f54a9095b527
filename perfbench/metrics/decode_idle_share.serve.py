"""Percent of decode in which the card ran nothing: over the traced waves,
the interval from the end of a wave's first ``serve.tokens`` span to the
end of its last, less the union of the trace's device operations inside it
(on the profiler's clock, which the spans share), over that interval. Every
decode step ends in the host's read of its tokens, so no step's device work
crosses into the next. Read from the program's spans; none recorded,
nothing to read."""

from perfbench.yardstick import spans


def read(trace):
    idle = total = 0.0
    for w in spans.waves(trace):
        ends = sorted(t.end_ns / 1e9 for t in w["serve.tokens"])
        lo, hi = ends[0], ends[-1]
        total += hi - lo
        idle += hi - lo - spans.busy_s(trace, lo, hi)
    return 100.0 * idle / total if total > 0 else None
