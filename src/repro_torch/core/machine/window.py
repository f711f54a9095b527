"""Out-of-order *window* parameters for the point-prediction simulator.

The paper's port model is window-less: throughput assumes an infinite
scheduling window, the critical path assumes no resource limits at all.
Real cores sit between the two because the instruction window is finite.
:class:`WindowParams` captures the handful of capacities that bound it:

``issue_width``
    µ-ops renamed/dispatched into the backend per cycle (frontend width).
``rob_size``
    re-order buffer entries; an instruction holds one from dispatch until
    in-order retirement.
``sched_size``
    unified scheduler (reservation-station) entries; held from dispatch
    until the µ-op issues to a port.
``lsq_size``
    load/store-queue depth; loads and stores each hold an entry from
    dispatch until retirement (modeled as two queues of this depth).
``retire_width``
    µ-ops retired in order per cycle.

Values in the per-arch machine DBs are modeling parameters on the same
footing as the latency/pressure tables: they follow the vendor software
optimization guides at the resolution the simulator needs, not RTL truth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class WindowParams:
    issue_width: int
    rob_size: int
    sched_size: int
    lsq_size: int
    retire_width: int

    def validate(self) -> "WindowParams":
        """Enforce the sanity bounds every shipped arch must satisfy."""
        for name in ("issue_width", "rob_size", "sched_size", "lsq_size",
                     "retire_width"):
            value = getattr(self, name)
            if not isinstance(value, int) or value <= 0:
                raise ValueError(f"window.{name} must be a positive int, "
                                 f"got {value!r}")
        if not self.issue_width <= self.retire_width <= self.rob_size:
            raise ValueError(
                f"window requires issue_width <= retire_width <= rob_size, "
                f"got {self.issue_width} / {self.retire_width} / {self.rob_size}")
        if not self.lsq_size <= self.sched_size <= self.rob_size:
            raise ValueError(
                f"window requires lsq_size <= sched_size <= rob_size, "
                f"got {self.lsq_size} / {self.sched_size} / {self.rob_size}")
        return self

    def to_dict(self) -> Dict[str, int]:
        return {
            "issue_width": self.issue_width,
            "rob_size": self.rob_size,
            "sched_size": self.sched_size,
            "lsq_size": self.lsq_size,
            "retire_width": self.retire_width,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, int]) -> "WindowParams":
        return cls(**{k: int(data[k]) for k in (
            "issue_width", "rob_size", "sched_size", "lsq_size",
            "retire_width")})
