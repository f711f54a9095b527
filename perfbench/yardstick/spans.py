"""The program's spans in a traced window, for the readers of the engine's
and the model step's per-layer metrics.

The program records its spans (``repro_torch.tracing``) while a profiler
session is on, on the clock the profiler stamps device operations with
(Unix-epoch nanoseconds). Of them the readers take those of the device-only
traced calls: the spans that began before the last device operation of the
captured trace ended; the host-recorded call comes after them. A program
that records no spans (one without ``repro_torch.tracing``) gives none, and
its readers read nothing.
"""

from __future__ import annotations

from typing import Dict, List


def recorded() -> list:
    """Every span the program kept, or none where it keeps none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def traced(trace) -> list:
    """The closed spans of the device-only traced calls."""
    if not trace.device:
        return []
    last = max(end for _, _, end in trace.device)
    return [s for s in recorded() if s.end_ns is not None and s.start_ns / 1e9 < last]


def waves(trace) -> List[Dict[str, list]]:
    """The traced waves, each as its spans by name (a wave whose
    ``serve.wave`` span was kept, with its first ``serve.tokens``)."""
    by_wave: Dict[int, Dict[str, list]] = {}
    for s in traced(trace):
        by_wave.setdefault(s.wave, {}).setdefault(s.name, []).append(s)
    return [w for w in by_wave.values() if "serve.wave" in w and "serve.tokens" in w]


def within(ancestor, wave: Dict[str, list], names) -> list:
    """The spans of ``wave`` named in ``names`` that lie inside
    ``ancestor``, by their parents."""
    spans = [s for group in wave.values() for s in group]
    parent = {s.id: s.parent for s in spans}
    out = []
    for s in spans:
        p = s.parent
        while p is not None and p != ancestor.id:
            p = parent.get(p)
        if p == ancestor.id and s.name in names:
            out.append(s)
    return out


def busy_s(trace, lo: float, hi: float) -> float:
    """Seconds in [lo, hi] (profiler clock, s) in which the device ran an
    operation: the union of the trace's device intervals, cut to it."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in trace.busy())
