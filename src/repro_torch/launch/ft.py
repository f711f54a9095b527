"""Fault tolerance: heartbeats, straggler detection, supervised restarts; a
copy of ``repro.launch.ft``, which uses the standard library only.

Cluster design: every host runs a heartbeat reporter; the supervisor
aggregates per-step durations, flags stragglers by robust z-score
(median/MAD), and on failure restarts the step loop from the last complete
checkpoint. ``repro_torch.launch.train`` wires the registry and the detector
into its loop; tests drive them with simulated workers.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class HeartbeatRegistry:
    """Host -> last-seen timestamp; dead = silent for *strictly more than*
    ``timeout_s`` (a beat exactly ``timeout_s`` old is still alive).

    Time is injectable: the registry never reads the wall clock directly —
    it calls ``clock`` (default ``time.monotonic``), so tests drive liveness
    transitions with a fake clock instead of sleeping.  Per-call ``now=``
    overrides remain for callers that already carry timestamps.
    """

    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic
    _beats: Dict[str, float] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def beat(self, host: str, now: Optional[float] = None) -> None:
        with self._lock:
            self._beats[host] = now if now is not None else self.clock()

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else self.clock()
        with self._lock:
            return [h for h, t in self._beats.items() if now - t > self.timeout_s]

    def alive_count(self, now: Optional[float] = None) -> int:
        return len(self._beats) - len(self.dead_hosts(now))


@dataclass
class StragglerDetector:
    """Flag hosts whose step duration deviates by > ``z_threshold`` robust
    z-scores from the fleet median (median/MAD — stable against the
    stragglers themselves)."""

    z_threshold: float = 4.0
    window: int = 32
    _durations: Dict[str, List[float]] = field(default_factory=dict)

    def record(self, host: str, duration_s: float) -> None:
        hist = self._durations.setdefault(host, [])
        hist.append(duration_s)
        if len(hist) > self.window:
            hist.pop(0)

    def stragglers(self) -> List[str]:
        latest = {h: d[-1] for h, d in self._durations.items() if d}
        if len(latest) < 3:
            return []
        vals = sorted(latest.values())
        median = vals[len(vals) // 2]
        mad = sorted(abs(v - median) for v in vals)[len(vals) // 2]
        scale = max(1.4826 * mad, 1e-3 * max(median, 1e-9), 1e-9)
        return [h for h, v in latest.items()
                if (v - median) / scale > self.z_threshold]


class Supervisor:
    """Run a step function under restart supervision.

    ``step_fn(state, step) -> state`` may raise; the supervisor restores from
    the last checkpoint (via ``restore_fn``) and resumes, up to
    ``max_restarts``.  This is the single-process stand-in for the cluster
    controller restarting failed jobs from the checkpoint store.
    """

    def __init__(self, step_fn: Callable, save_fn: Callable,
                 restore_fn: Callable, *, checkpoint_every: int = 50,
                 max_restarts: int = 3):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, state, start_step: int, num_steps: int):
        step = start_step
        while step < start_step + num_steps:
            try:
                state = self.step_fn(state, step)
                step += 1
                if step % self.checkpoint_every == 0:
                    self.save_fn(step, state)
            except Exception:  # noqa: BLE001
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state, step = self.restore_fn()
        return state, step
