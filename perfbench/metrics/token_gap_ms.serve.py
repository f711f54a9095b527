"""The token gap of the traced waves: per wave, from the end of its first
``serve.tokens`` span to the end of its last, over the count of those spans
less one, in ms; the mean over the traced waves. Read from the program's
spans; none recorded, nothing to read."""

import statistics

from perfbench.yardstick import spans


def read(trace):
    gaps = []
    for w in spans.waves(trace):
        ends = sorted(t.end_ns for t in w["serve.tokens"])
        if len(ends) > 1:
            gaps.append((ends[-1] - ends[0]) / (len(ends) - 1))
    return statistics.fmean(gaps) / 1e6 if gaps else None
