"""A profiler trace of whole calls or steps, reduced to what the per-layer
readers take: the device's operations (kernels, copies, sets) with their
intervals, the host's operations, and the traced window.

The traced window wraps whole calls and ends after a synchronize; ``busy_s``
is the union of the device's operations in it. The device ops by name are
summed as ``chip_smoke.device_time`` sums them.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

OURS = "perfbench."  # the ranges the harness opens around its calls
WINDOW = OURS + "window"
Interval = Tuple[str, float, float]  # (name, start s, end s)


@dataclasses.dataclass
class Trace:
    device: List[Interval]  # kernels, copies and sets on the card
    host: List[Interval]  # host operations (recorded with ``host`` only)
    window: Optional[Tuple[float, float]]  # on the profiler's clock (with ``host``)
    window_s: float
    calls: list  # the records of the traced calls
    launches: Dict[str, int]  # ops.LAUNCHES over the traced calls
    cell: object
    gaps: Optional[list] = None  # idle_gaps of a host-recorded pass

    def kernels(self, *symbols: str) -> List[Interval]:
        return [e for e in self.device if any(s in e[0] for s in symbols)]

    def busy(self) -> List[Tuple[float, float]]:
        """Merged device intervals (inside the window, where it is known)."""
        lo, hi = self.window or (float("-inf"), float("inf"))
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        merged: List[Tuple[float, float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_ops(self, top: int = 10) -> List[list]:
        by_name: Dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name[:96]] = by_name.get(name[:96], 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time of the device inside the window, summed by the host
        operation that was running when each gap began (the innermost one
        open then), largest first; it needs the host's operations."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(hi)
        host = sorted((s, e, name) for name, s, e in self.host if not name.startswith(OURS))
        starts = [s for s, _, _ in host]
        by_label: Dict[str, float] = {}
        for start, end in zip(edges[::2], edges[1::2]):
            if end <= start:
                continue
            label = "host: between operations"
            # The op open at ``start`` that began last is the innermost;
            # look back over a bounded number of ops.
            last = bisect.bisect_right(starts, start) - 1
            for i in range(last, max(last - 256, -1), -1):
                if host[i][1] >= start:
                    label = host[i][2][:96]
                    break
            by_label[label] = by_label.get(label, 0.0) + (end - start)
        return [[k, v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]


def _events(prof):
    """(name, device type, start s, end s, is a range) of every event, from
    the profiler's raw results (``prof.events()`` builds a tree of them,
    which takes minutes on a train step)."""
    return [(e.name(), e.device_type(), e.start_ns() / 1e9,
             (e.start_ns() + e.duration_ns()) / 1e9, e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def capture(fn: Callable[[], list], launches: Dict[str, int], cell, host: bool = False) -> Trace:
    """Run ``fn`` (which makes the traced calls and returns their records)
    under the profiler. Without ``host`` only the device's activity is
    recorded, which costs the host least: the window is then the host's
    clock from before the first call to after the synchronize that ends
    the last, and every device operation lies inside it. With ``host`` the
    host's operations are recorded too (for ``idle_gaps``), and the window
    is the ``perfbench.window`` range on the profiler's clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    before = dict(launches)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            calls = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    delta = {k: launches[k] - before.get(k, 0) for k in launches}
    device, host_ops, window = [], [], None
    for name, kind, start, end, is_range in _events(prof):
        if kind == DeviceType.CUDA:
            if not is_range:  # a range's shadow on the device
                device.append((name, start, end))
        elif name == WINDOW:
            window = (start, end)
        elif not is_range:
            host_ops.append((name, start, end))
    if not device:
        raise RuntimeError("the profiler recorded no device activity in the traced window")
    if host and window is None:
        raise RuntimeError("the profiler recorded no window range")
    window_s = window[1] - window[0] if host else t1 - t0
    return Trace(device=device, host=host_ops, window=window if host else None,
                 window_s=window_s, calls=calls, launches=delta, cell=cell)
