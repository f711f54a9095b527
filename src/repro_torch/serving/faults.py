"""Deterministic fault injection for the serving path.

A resilience layer is only trustworthy if every failure mode it claims to
handle can be *demonstrated* — repeatably, in CI, without flaky sleeps.  This
module provides the harness the chaos suites (``tests/test_resilience.py``
for the reference, ``tests/test_torch_resilience.py`` for this copy) drive;
it is the reference's ``repro.serving.faults``, carried over but for its
imports:

* :class:`FaultInjector` — seeded injection of faults at **named injection
  points** inside :class:`repro_torch.serving.analysis.AnalysisService`:

  ===================  ====================================================
  site                 effect when fired
  ===================  ====================================================
  ``parse``            parser raises (→ ``PARSE_ERROR`` envelope)
  ``stage:resolve``    transient fault before cost resolution
  ``stage:tp``         transient fault before the throughput stage
  ``stage:dag``        transient fault before the DAG build
  ``stage:cp``         transient fault before the critical-path sweep
  ``stage:lcd``        transient fault before the LCD sweep
  ``timeout:<stage>``  virtual clock jumps past the deadline at that stage
  ``cache``            the request's cache entry is evicted before lookup
  ===================  ====================================================

  Firing is deterministic two ways: a per-site Bernoulli ``rate`` drawn from
  a seeded per-site stream (statistical chaos, replayable bit-for-bit), or a
  ``script`` — an explicit set of 1-based call indices (exact choreography
  for unit tests).

* :class:`VirtualClock` — a manually advanced time source satisfying both
  the ``clock`` and ``sleep`` injection points of
  :class:`repro_torch.serving.resilience.ResilienceConfig`, so deadline expiry and
  backoff waits are simulated instead of slept.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional

from repro_torch.serving.resilience import ErrorCode, ServingError

__all__ = ["FaultInjector", "FaultSpec", "InjectedFault", "VirtualClock"]


class InjectedFault(ServingError):
    """Raised at an injection point; transient unless configured otherwise."""

    def __init__(self, site: str, call_index: int, *, transient: bool = True):
        code = ErrorCode.STAGE_TIMEOUT if site.startswith("timeout:") \
            else (ErrorCode.PARSE_ERROR if site == "parse"
                  else ErrorCode.INTERNAL)
        super().__init__(code,
                         f"injected fault at '{site}' (call #{call_index})",
                         retryable=transient, stage=site)
        self.site = site
        self.call_index = call_index


class VirtualClock:
    """Deterministic time: advances only when told (or slept on)."""

    def __init__(self, start: float = 0.0):
        self.now = start
        self.sleeps: list = []  # recorded backoff waits, for assertions

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt

    def sleep(self, dt: float) -> None:
        self.sleeps.append(dt)
        self.now += dt


@dataclass(frozen=True)
class FaultSpec:
    """How one injection site misbehaves."""

    site: str
    rate: float = 0.0  # Bernoulli firing probability per call
    script: FrozenSet[int] = frozenset()  # exact 1-based call indices
    transient: bool = True  # transient faults are retried; permanent aren't
    advance_s: float = 0.0  # for timeout:* sites — virtual-clock jump


class FaultInjector:
    """Seeded, countable fault injection at named sites.

    Each site keeps its own call counter and its own ``random.Random``
    stream seeded from ``(seed, site)``, so adding a new site (or reordering
    requests across sites) never perturbs another site's firing pattern.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 scripts: Optional[Dict[str, object]] = None,
                 transient: bool = True,
                 clock: Optional[VirtualClock] = None,
                 advance_s: float = 3600.0):
        self.seed = seed
        self.clock = clock
        self.specs: Dict[str, FaultSpec] = {}
        for site, rate in (rates or {}).items():
            self.specs[site] = FaultSpec(site=site, rate=float(rate),
                                         transient=transient,
                                         advance_s=advance_s)
        for site, calls in (scripts or {}).items():
            base = self.specs.get(site)
            self.specs[site] = FaultSpec(
                site=site, rate=base.rate if base else 0.0,
                script=frozenset(int(c) for c in calls),
                transient=transient, advance_s=advance_s)
        self._calls: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._rngs: Dict[str, random.Random] = {}

    # -- introspection (chaos-suite assertions) ----------------------------

    @property
    def calls(self) -> Dict[str, int]:
        return dict(self._calls)

    @property
    def fired(self) -> Dict[str, int]:
        return dict(self._fired)

    # -- firing ------------------------------------------------------------

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = random.Random(f"{self.seed}:{site}")
            self._rngs[site] = rng
        return rng

    def should_fire(self, site: str) -> bool:
        """Count a call at ``site`` and decide (deterministically) whether
        the configured fault fires.  Sites with no spec never fire but are
        still counted, so tests can assert reach."""
        count = self._calls.get(site, 0) + 1
        self._calls[site] = count
        spec = self.specs.get(site)
        if spec is None:
            return False
        fires = count in spec.script
        if spec.rate > 0.0:
            # Always draw, so firing at call N is independent of scripts.
            fires = self._rng(site).random() < spec.rate or fires
        if fires:
            self._fired[site] = self._fired.get(site, 0) + 1
        return fires

    def check(self, site: str) -> None:
        """Raise :class:`InjectedFault` if the site's fault fires.

        ``timeout:<stage>`` sites never raise directly — they advance the
        virtual clock past any live deadline instead, so the *real* deadline
        machinery (not the injector) produces the ``STAGE_TIMEOUT``.  With no
        virtual clock attached they fall back to raising.
        """
        if not self.should_fire(site):
            return
        if site.startswith("timeout:") and self.clock is not None:
            spec = self.specs[site]
            self.clock.advance(spec.advance_s)
            return
        spec = self.specs[site]
        raise InjectedFault(site, self._calls[site], transient=spec.transient)

    def evicts(self, site: str = "cache") -> bool:
        """Cache-eviction sites report a decision instead of raising."""
        return self.should_fire(site)
