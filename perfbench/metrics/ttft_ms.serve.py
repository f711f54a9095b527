"""Time to first token of the traced waves: from a ``serve.wave`` span's
start to the end of its first ``serve.tokens`` span (the first tokens read
on the host), in ms; the median over the traced waves. Read from the
program's spans; none recorded, nothing to read."""

import statistics

from perfbench.yardstick import spans


def read(trace):
    got = [min(t.end_ns for t in w["serve.tokens"]) - w["serve.wave"][0].start_ns
           for w in spans.waves(trace)]
    return statistics.median(got) / 1e6 if got else None
