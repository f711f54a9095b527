"""Resilience primitives for the serving path.

Production analysis serving cannot assume every request completes: a
pathological kernel can stall the exact port scheduler, a transient fault can
look identical to a permanent one, and an unbounded queue turns one slow wave
into unbounded latency for everyone behind it.  This module provides the
building blocks :class:`repro_torch.serving.analysis.AnalysisService` composes into
a resilient request path:

* a structured **error taxonomy** (:class:`ErrorCode`, :class:`ServingError`)
  replacing free-text error strings, with a transient/permanent split that
  drives retry decisions;
* **deadlines** (:class:`Deadline`) checked cooperatively at analysis stage
  boundaries, plus :func:`run_with_deadline` — a cancellable worker that
  bounds wall-clock time even when a stage blocks between checkpoints;
* **retry with exponential backoff and deterministic jitter**
  (:class:`RetryPolicy`) for faults classified as transient;
* a per-key **circuit breaker** (:class:`CircuitBreaker`):
  CLOSED → OPEN after consecutive failures, OPEN → HALF_OPEN on a timer,
  HALF_OPEN → CLOSED on a successful probe;
* **admission control** (:class:`AdmissionController`): a bounded queue depth
  that sheds excess load with ``OVERLOADED`` + ``retry_after_s`` instead of
  queueing unboundedly.

Every time-dependent component takes an injectable ``clock`` (and ``sleep``),
so the chaos suites (``tests/test_resilience.py`` for the reference,
``tests/test_torch_resilience.py`` for this copy) drive expiry, backoff, and
breaker timers with a virtual clock — deterministically, without sleeping.

This module is the reference's ``repro.serving.resilience``, carried over but
for its imports: no part of it touches a device.  A job that
:func:`run_with_deadline` abandons keeps running on its daemon thread, and
on the device it was handed, until its next checkpoint.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "AdmissionController",
    "CircuitBreaker",
    "Deadline",
    "ErrorCode",
    "ResilienceConfig",
    "RetryPolicy",
    "ServingError",
    "StageTimeout",
    "classify_exception",
    "run_with_deadline",
]


class ErrorCode:
    """Structured error codes carried by v2 response envelopes."""

    PARSE_ERROR = "PARSE_ERROR"  # malformed assembly (permanent)
    UNKNOWN_ARCH = "UNKNOWN_ARCH"  # arch/isa not in the registry (permanent)
    STAGE_TIMEOUT = "STAGE_TIMEOUT"  # deadline expired mid-pipeline (transient)
    OVERLOADED = "OVERLOADED"  # shed by admission control / open breaker
    DEGRADED = "DEGRADED"  # answered, but from a cheaper ladder rung
    INTERNAL = "INTERNAL"  # anything else (permanent by default)

    ALL = frozenset({PARSE_ERROR, UNKNOWN_ARCH, STAGE_TIMEOUT, OVERLOADED,
                     DEGRADED, INTERNAL})


class ServingError(Exception):
    """An error with a taxonomy code and a retry classification.

    ``retryable`` means *the same request may succeed if retried* (transient:
    timeouts, shed load); permanent errors (bad asm, unknown arch) never
    succeed on retry and are safe to negatively cache.
    """

    def __init__(self, code: str, message: str, *, retryable: bool = False,
                 retry_after_s: float = 0.0, stage: str = ""):
        super().__init__(message)
        self.code = code
        self.retryable = retryable
        self.retry_after_s = retry_after_s
        self.stage = stage


class StageTimeout(ServingError):
    """A deadline expired before (or during) the named pipeline stage."""

    def __init__(self, stage: str, budget_s: float = 0.0):
        detail = f" (budget {budget_s:.3f}s)" if budget_s else ""
        super().__init__(ErrorCode.STAGE_TIMEOUT,
                         f"deadline expired at stage '{stage}'{detail}",
                         retryable=True, stage=stage)
        self.budget_s = budget_s


def classify_exception(exc: BaseException) -> str:
    """Map an exception to its taxonomy code (free-text errors get a code
    instead of the other way around)."""
    if isinstance(exc, ServingError):
        return exc.code
    if isinstance(exc, ValueError):
        msg = str(exc)
        if msg.startswith("unknown arch") or msg.startswith("unknown isa"):
            return ErrorCode.UNKNOWN_ARCH
        return ErrorCode.PARSE_ERROR
    if isinstance(exc, (SyntaxError, KeyError)):
        return ErrorCode.PARSE_ERROR
    return ErrorCode.INTERNAL


def is_transient(exc: BaseException) -> bool:
    """Whether a retry of the same request could plausibly succeed."""
    return isinstance(exc, ServingError) and exc.retryable


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


@dataclass
class Deadline:
    """An absolute point on an injectable clock.

    ``check(stage)`` is the cooperative cancellation hook threaded through
    the analysis pipeline's stage boundaries: it raises :class:`StageTimeout`
    naming the stage that would have run past the deadline.
    """

    at: float
    clock: Callable[[], float] = time.monotonic
    budget_s: float = 0.0

    @classmethod
    def after(cls, timeout_s: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(at=clock() + timeout_s, clock=clock, budget_s=timeout_s)

    def remaining(self) -> float:
        return self.at - self.clock()

    @property
    def expired(self) -> bool:
        return self.clock() >= self.at

    def check(self, stage: str) -> None:
        if self.expired:
            raise StageTimeout(stage, self.budget_s)


def run_with_deadline(fn: Callable[[], object], timeout_s: Optional[float]):
    """Run ``fn`` on a cancellable worker thread, bounded by wall time.

    Cooperative deadline checks only fire *between* stages; a stage that
    blocks internally (or a hostile kernel inside one sweep) would still hang
    the caller.  This wrapper joins the worker for ``timeout_s`` and raises
    :class:`StageTimeout` if it has not finished — the worker itself is
    abandoned (daemonized) and exits at its next cooperative checkpoint.
    """
    if timeout_s is None or timeout_s <= 0:
        return fn()
    box: list = []
    done = threading.Event()

    def target():
        try:
            box.append(("ok", fn()))
        except BaseException as exc:  # noqa: BLE001 — relayed to caller
            box.append(("err", exc))
        finally:
            done.set()

    worker = threading.Thread(target=target, daemon=True,
                              name="analysis-deadline-worker")
    worker.start()
    done.wait(timeout_s)
    if not box:
        raise StageTimeout("worker", timeout_s)
    kind, value = box[0]
    if kind == "err":
        raise value
    return value


# ---------------------------------------------------------------------------
# retry with exponential backoff + jitter
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic, seeded jitter.

    ``backoff(attempt, rng)`` returns the delay before retry ``attempt``
    (0-based): ``base * multiplier**attempt``, clipped to ``max_delay_s``,
    then spread by ±``jitter`` fraction drawn from the caller's ``rng`` —
    a seeded :class:`random.Random`, so a chaos run replays bit-identically.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.01
    multiplier: float = 2.0
    max_delay_s: float = 1.0
    jitter: float = 0.5

    def backoff(self, attempt: int, rng: random.Random) -> float:
        delay = min(self.base_delay_s * self.multiplier ** attempt,
                    self.max_delay_s)
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(delay, 0.0)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a half-open probe.

    CLOSED: all requests pass; ``failure_threshold`` consecutive failures
    trip it OPEN.  OPEN: requests are rejected (``allow() == False``) until
    ``reset_timeout_s`` elapses on the injected clock, then the breaker
    half-opens.  HALF_OPEN: one probe request passes; success closes the
    breaker, failure re-opens it (and restarts the timer).
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int = 5, reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.clock = clock
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (self._state == self.OPEN
                and self.clock() - self._opened_at >= self.reset_timeout_s):
            self._state = self.HALF_OPEN
            self._probe_inflight = False

    def retry_after(self) -> float:
        """Seconds until the breaker half-opens (0 when not OPEN)."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(self.reset_timeout_s - (self.clock() - self._opened_at),
                       0.0)

    def allow(self) -> bool:
        """Admission decision; HALF_OPEN admits exactly one probe."""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open()
            if self._state == self.HALF_OPEN:
                self._trip()
                return
            self._failures += 1
            if self._state == self.CLOSED and \
                    self._failures >= self.failure_threshold:
                self._trip()

    def _trip(self) -> None:
        self._state = self.OPEN
        self._failures = 0
        self._opened_at = self.clock()
        self._probe_inflight = False


# ---------------------------------------------------------------------------
# admission control / backpressure
# ---------------------------------------------------------------------------


class AdmissionController:
    """Bounded admission: at most ``max_depth`` requests in flight.

    ``try_acquire(n)`` returns how many of ``n`` slots were granted (the
    rest must be shed with ``OVERLOADED`` + ``retry_after_s``); ``release``
    returns slots when their requests finish.  ``max_depth <= 0`` disables
    the bound (admit everything).
    """

    def __init__(self, max_depth: int = 0, retry_after_s: float = 0.05):
        self.max_depth = max_depth
        self.retry_after_s = retry_after_s
        self._depth = 0
        self._shed = 0
        self._lock = threading.Lock()

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    @property
    def shed_total(self) -> int:
        with self._lock:
            return self._shed

    def try_acquire(self, n: int = 1) -> int:
        with self._lock:
            if self.max_depth <= 0:
                self._depth += n
                return n
            granted = max(min(n, self.max_depth - self._depth), 0)
            self._depth += granted
            self._shed += n - granted
            return granted

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._depth = max(self._depth - n, 0)

    def overload_error(self) -> ServingError:
        return ServingError(
            ErrorCode.OVERLOADED,
            f"admission queue full (depth limit {self.max_depth}); "
            f"retry after {self.retry_after_s:.3f}s",
            retryable=True, retry_after_s=self.retry_after_s)


# ---------------------------------------------------------------------------
# service-level configuration
# ---------------------------------------------------------------------------


@dataclass
class ResilienceConfig:
    """Knobs for :class:`repro_torch.serving.analysis.AnalysisService`.

    With the service's default ``resilience=None`` the request path is the
    plain pipeline (no deadline checks, no breaker, unbounded
    admission) — zero overhead for callers that don't opt in.
    """

    #: Per-request wall/virtual budget; 0 disables deadlines.
    request_timeout_s: float = 0.0
    #: Optional tighter per-stage budget (<= request budget); 0 disables.
    stage_timeout_s: float = 0.0
    #: Retry transient faults (timeouts, injected transients) this way.
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    #: Bounded admission queue depth; 0 = unbounded (no shedding).
    max_queue_depth: int = 0
    #: Suggested client backoff attached to OVERLOADED responses.
    retry_after_s: float = 0.05
    #: Per-arch breaker: consecutive hard failures before tripping OPEN.
    breaker_failure_threshold: int = 5
    #: Seconds OPEN before the breaker half-opens a probe.
    breaker_reset_s: float = 30.0
    #: Allow falling down the degradation ladder (full → tp_only →
    #: parse_only) instead of erroring when retries are exhausted.
    degrade: bool = True
    #: Cheapest rung degradation may fall to ("full" disables the ladder).
    min_rung: str = "parse_only"
    #: Run each analysis job on a cancellable worker thread so a stage that
    #: blocks *between* checkpoints still respects the wall deadline.  Only
    #: meaningful with the real clock; virtual-clock tests use cooperative
    #: checkpoints alone.
    use_worker: bool = True
    #: Injectable time source shared by deadlines and breakers.
    clock: Callable[[], float] = time.monotonic
    #: Injectable backoff sleep (the chaos suite advances a virtual clock).
    sleep: Callable[[float], None] = time.sleep
    #: Seed for backoff jitter (deterministic retry schedules).
    seed: int = 0

    def jitter_rng(self) -> random.Random:
        return random.Random(self.seed)
