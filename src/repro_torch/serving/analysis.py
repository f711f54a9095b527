"""Kernel-analysis service for the serving path.

Request/response frontend over the ``repro_torch.api`` facade: callers submit raw
assembly text plus an architecture id (any registry alias — the arch →
parser/model tables live in :mod:`repro_torch.core.registry`, not here), the
service parses, analyzes, and answers with versioned
:class:`AnalysisResponse` envelopes carrying serializable
:class:`~repro_torch.core.analysis.report.AnalysisReport` payloads.

Failures are structured, not free text (wire contract v2): every error
envelope carries a taxonomy code (``PARSE_ERROR`` / ``UNKNOWN_ARCH`` /
``STAGE_TIMEOUT`` / ``OVERLOADED`` / ``DEGRADED`` / ``INTERNAL``), a
transient/permanent classification, and — for shed load — a ``retry_after_s``
hint.  v1 envelopes still parse; the new fields default.

With a :class:`~repro_torch.serving.resilience.ResilienceConfig` attached, the
request path becomes resilient:

* **admission control** — ``submit_batch`` admits at most
  ``max_queue_depth`` requests; the excess is shed immediately with
  ``OVERLOADED`` + ``retry_after_s`` instead of queueing unboundedly;
* **per-arch circuit breakers** — consecutive backend failures (timeouts,
  internal errors, forced degradations) trip an arch OPEN; its requests are
  rejected until the breaker half-opens on a timer and a probe succeeds;
* **deadlines** — each analysis job runs under a per-request budget,
  checked cooperatively at every pipeline stage boundary and (with the real
  clock) enforced by a cancellable worker thread;
* **retry with exponential backoff + deterministic jitter** for faults
  classified as transient;
* the **degradation ladder** — when retries are exhausted the job falls to
  a cheaper rung (full → bracket → tp_only → parse_only) so one
  pathological kernel yields a partial answer, not a stalled wave.  Degraded responses are
  marked (``degraded``, ``stages_completed``, code ``DEGRADED``) and are
  **never cached as full results**.

Amortization comes from warm per-arch models, the process LRU through
``analyze_kernels`` (whose misses run as one wave per group), and a
request-key cache here.  Fault injection
(:class:`repro_torch.serving.faults.FaultInjector`) hooks named points
(``parse``, ``stage:*``, ``timeout:*``, ``cache``) so the chaos suite can
prove every ladder rung and breaker transition deterministically.

This is ``repro.serving.analysis`` on the port's engine: the service takes a
``device`` (``None``: the CUDA device, see :func:`repro_torch.resolve_device`)
and runs every analysis's tensor passes there; its envelopes, counters and
error texts are the reference's, so ``to_dict()`` compares equal.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch import Device, resolve_device
from repro_torch.core.analysis import (Analysis, AnalysisReport,
                                       DEGRADATION_LADDER, analyze_kernel_rung,
                                       analyze_kernels, normalize_predictors)
from repro_torch.core.analysis.analyze import LRUCache, apply_measurement
from repro_torch.core.analysis.options import AnalyzeOptions
from repro_torch.core.calibration.corpus import MeasurementCorpus, load_corpus
from repro_torch.core.isa import parse_aarch64, parse_x86
from repro_torch.core.machine import MachineModel
from repro_torch.core.registry import ArchSpec, get_arch
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.resilience import (AdmissionController,
                                            CircuitBreaker, Deadline,
                                            ErrorCode, ResilienceConfig,
                                            ServingError, StageTimeout,
                                            classify_exception, is_transient,
                                            run_with_deadline)

#: Version of the request/response wire contract.  v2 adds structured error
#: codes, retry/backpressure hints, and degradation metadata — additively,
#: so v1 payloads still parse and v1 readers can ignore the new fields.
API_VERSION = 2

_PARSERS = {
    "aarch64": parse_aarch64,
    "x86": parse_x86,
}


@dataclass(frozen=True)
class AnalysisRequest:
    """One kernel-analysis request (v2 wire contract, v1-compatible).

    ``isa`` is optional: when empty it is resolved from the architecture
    registry.  ``arch`` accepts any registry id or alias.  ``timeout_s``
    overrides the service's per-request deadline (0 = use the service
    default; ignored when the service has no resilience config).
    ``predictors`` (additive, v2) selects a subset of
    ``("tp", "cp", "lcd", "sim")``; empty means all.  ``diagnose``
    (additive, v2) attaches the structured bottleneck findings to the
    report (schema v4 ``findings``).
    """

    asm: str
    arch: str = "tx2"
    isa: str = ""  # "aarch64" | "x86" | "" (resolve via registry)
    unroll: int = 1
    name: str = "kernel"
    timeout_s: float = 0.0
    predictors: Tuple[str, ...] = ()
    diagnose: bool = False
    version: int = API_VERSION

    def normalized_predictors(self) -> Tuple[str, ...]:
        """Canonical predictor subset (validated; empty = all)."""
        return normalize_predictors(tuple(self.predictors) or None)

    def options(self, measurements=None) -> AnalyzeOptions:
        """This request's analysis knobs as one :class:`AnalyzeOptions` —
        the bridge onto the unified predictor API.  ``timeout_s == 0``
        means "service default", which maps to ``None`` here (the service
        substitutes its configured deadline separately); the service passes
        the resolved arch's measured corpus via ``measurements``."""
        return AnalyzeOptions(
            unroll=self.unroll,
            predictors=tuple(self.predictors) or None,
            diagnose=bool(self.diagnose),
            timeout_s=self.timeout_s or None,
            measurements=measurements)

    @property
    def key(self) -> tuple:
        """Canonical cache identity: registry-resolved arch id + isa, so
        aliases (``cascadelake`` vs ``csx``) share one entry, plus the
        normalized predictor subset and the ``diagnose`` flag (a plain
        report must not satisfy a diagnose request).  Falls back to the raw
        fields when the arch (or predictor set) is unknown (the request then
        errors at analysis time anyway).  ``timeout_s`` is deliberately
        excluded: it shapes how long we try, not what the answer is."""
        try:
            preds = self.normalized_predictors()
        except ValueError:
            preds = tuple(self.predictors)
        diag = bool(self.diagnose)
        try:
            spec = get_arch(self.arch)
        except ValueError:
            return (self.arch, self.isa, self.asm, self.unroll, preds, diag)
        return (spec.id, self.isa or spec.isa, self.asm, self.unroll, preds,
                diag)

    def to_dict(self) -> Dict:
        return {"version": self.version, "asm": self.asm, "arch": self.arch,
                "isa": self.isa, "unroll": self.unroll, "name": self.name,
                "timeout_s": self.timeout_s,
                "predictors": list(self.predictors),
                "diagnose": self.diagnose}

    @classmethod
    def from_dict(cls, data: Dict) -> "AnalysisRequest":
        return cls(asm=data["asm"], arch=data.get("arch", "tx2"),
                   isa=data.get("isa", ""), unroll=data.get("unroll", 1),
                   name=data.get("name", "kernel"),
                   timeout_s=data.get("timeout_s", 0.0),
                   predictors=tuple(data.get("predictors", ())),
                   diagnose=data.get("diagnose", False),
                   version=data.get("version", API_VERSION))


@dataclass(frozen=True)
class AnalysisResponse:
    """Versioned per-request envelope: a report, or a structured error.

    ``ok`` keeps its v1 meaning (*there is a report*); a degraded answer is
    ``ok=True`` with ``degraded=True`` and ``error_code="DEGRADED"`` so v1
    readers still consume it while v2 readers can tell it apart.  Hard
    failures carry ``error_code`` plus ``retryable`` (is it worth retrying
    the same request?) and, for shed load, ``retry_after_s``.
    """

    ok: bool
    name: str
    arch: str = ""
    report: Optional[AnalysisReport] = None
    error: str = ""
    error_code: str = ""  # ErrorCode taxonomy; "" on full success
    retryable: bool = False
    retry_after_s: float = 0.0
    degraded: bool = False
    stages_completed: Tuple[str, ...] = ()
    attempts: int = 1
    version: int = API_VERSION

    def to_dict(self) -> Dict:
        return {
            "version": self.version,
            "ok": self.ok,
            "name": self.name,
            "arch": self.arch,
            "error": self.error,
            "error_code": self.error_code,
            "retryable": self.retryable,
            "retry_after_s": self.retry_after_s,
            "degraded": self.degraded,
            "stages_completed": list(self.stages_completed),
            "attempts": self.attempts,
            "report": self.report.to_dict() if self.report is not None else None,
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "AnalysisResponse":
        report = data.get("report")
        return cls(
            ok=data["ok"], name=data.get("name", ""),
            arch=data.get("arch", ""), error=data.get("error", ""),
            # v1 envelopes predate the taxonomy: errors get INTERNAL (the
            # free-text string is preserved verbatim), successes stay clean.
            error_code=data.get("error_code",
                                "" if data["ok"] else ErrorCode.INTERNAL),
            retryable=data.get("retryable", False),
            retry_after_s=data.get("retry_after_s", 0.0),
            degraded=data.get("degraded", False),
            stages_completed=tuple(data.get("stages_completed", ())),
            attempts=data.get("attempts", 1),
            report=AnalysisReport.from_dict(report) if report else None,
            version=data.get("version", API_VERSION),
        )


@dataclass
class _Outcome:
    """Internal per-job result: an analysis (possibly degraded) or an error."""

    analysis: Optional[Analysis] = None
    error: Optional[BaseException] = None
    attempts: int = 1
    retry_after_s: float = 0.0


@dataclass
class AnalysisService:
    """Long-lived analysis frontend with per-request LRU caching.

    ``resilience=None`` (the default) keeps the plain request path —
    no deadlines, no admission bound, no breakers, zero added overhead —
    while still answering with structured v2 envelopes.  Attach a
    :class:`ResilienceConfig` (and optionally a :class:`FaultInjector`) to
    turn on the resilient path.
    """

    max_cached: int = 256
    models: Dict[str, MachineModel] = field(default_factory=dict)
    resilience: Optional[ResilienceConfig] = None
    faults: Optional[FaultInjector] = None
    #: Measured-corpus join: explicit per-arch corpora, and/or a directory
    #: of recorded ``<arch>.json`` files probed lazily per arch.  The corpus
    #: digest participates in the request cache key, so reconfiguring the
    #: measurements can never serve a stale measured view.
    measurements: Dict[str, MeasurementCorpus] = field(default_factory=dict)
    measurements_dir: Optional[str] = None
    #: Where the analyses' tensor passes run (``None``: the CUDA device).
    device: Device = None
    _cache: LRUCache = field(init=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._cache = LRUCache(self.max_cached)
        self._corpus_cache: Dict[str, Optional[MeasurementCorpus]] = {}
        cfg = self.resilience
        self._admission = AdmissionController(
            max_depth=cfg.max_queue_depth if cfg else 0,
            retry_after_s=cfg.retry_after_s if cfg else 0.05)
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._jitter_rng = (cfg or ResilienceConfig()).jitter_rng()
        #: Resilience event counters (separate from cache hit/miss stats).
        self.counters: Dict[str, int] = {
            "shed": 0, "breaker_rejected": 0, "retries": 0,
            "degraded": 0, "timeouts": 0, "faults_injected": 0,
        }

    @property
    def stats(self) -> Dict[str, int]:
        return self._cache.stats

    def model_for(self, arch: str) -> MachineModel:
        """Warm model, resolved through the registry (aliases share one
        instance).  Backed by the facade's process-wide model cache so
        ``repro_torch.api.analyze`` callers and the service share one instruction-
        lookup memo per architecture."""
        spec = get_arch(arch)  # ValueError for unknown archs
        model = self.models.get(spec.id)
        if model is None:
            from repro_torch.api import model_for as shared_model_for
            model = shared_model_for(spec)
            self.models[spec.id] = model
        return model

    def corpus_for(self, arch_id: str) -> Optional[MeasurementCorpus]:
        """The measured corpus joined into this arch's analyses: explicit
        ``measurements`` entries win; otherwise ``measurements_dir`` is
        probed once per arch (missing file caches as None)."""
        corpus = self.measurements.get(arch_id)
        if corpus is not None:
            return corpus
        if self.measurements_dir is None:
            return None
        if arch_id not in self._corpus_cache:
            try:
                self._corpus_cache[arch_id] = load_corpus(
                    arch_id, self.measurements_dir)
            except (FileNotFoundError, ValueError):
                self._corpus_cache[arch_id] = None
        return self._corpus_cache[arch_id]

    def breaker_for(self, arch_id: str) -> CircuitBreaker:
        """The per-arch circuit breaker (created lazily)."""
        breaker = self._breakers.get(arch_id)
        if breaker is None:
            cfg = self.resilience or ResilienceConfig()
            breaker = CircuitBreaker(
                failure_threshold=cfg.breaker_failure_threshold,
                reset_timeout_s=cfg.breaker_reset_s, clock=cfg.clock)
            self._breakers[arch_id] = breaker
        return breaker

    # -- versioned request/response API ------------------------------------

    def submit(self, request: AnalysisRequest) -> AnalysisResponse:
        return self.submit_batch([request])[0]

    def submit_batch(
        self, requests: Sequence[AnalysisRequest]
    ) -> List[AnalysisResponse]:
        """Serve a wave; malformed requests become error responses while the
        rest of the wave is analyzed normally.  With resilience configured,
        load beyond the admission bound is shed up front (``OVERLOADED`` +
        ``retry_after_s``) and each analysis job runs under deadlines,
        retries, breakers, and the degradation ladder."""
        if self.resilience is None and self.faults is None:
            return [self._envelope(req, _Outcome(analysis=res)
                                   if not isinstance(res, BaseException)
                                   else _Outcome(error=res))
                    for req, res in zip(requests, self._analyze_batch(requests))]
        granted = self._admission.try_acquire(len(requests))
        admitted = list(requests)[:granted]
        try:
            outcomes = self._execute_resilient(admitted)
        finally:
            self._admission.release(granted)
        responses = [self._envelope(req, out)
                     for req, out in zip(admitted, outcomes)]
        overload = self._admission.overload_error()
        for req in list(requests)[granted:]:
            self.counters["shed"] += 1
            responses.append(AnalysisResponse(
                ok=False, name=req.name, arch=req.arch,
                error=str(overload), error_code=ErrorCode.OVERLOADED,
                retryable=True, retry_after_s=overload.retry_after_s,
                attempts=0))
        return responses

    def _envelope(self, req: AnalysisRequest,
                  outcome: _Outcome) -> AnalysisResponse:
        if outcome.analysis is not None:
            analysis = outcome.analysis
            report = analysis.to_report()
            degraded = analysis.degraded
            if degraded:
                self.counters["degraded"] += 1
            return AnalysisResponse(
                ok=True, name=req.name, arch=analysis.model.name,
                report=report,
                error_code=ErrorCode.DEGRADED if degraded else "",
                degraded=degraded,
                stages_completed=tuple(analysis.stages_completed),
                attempts=outcome.attempts)
        exc = outcome.error
        assert exc is not None
        code = classify_exception(exc)
        if code == ErrorCode.STAGE_TIMEOUT:
            self.counters["timeouts"] += 1
        return AnalysisResponse(
            ok=False, name=req.name, arch=req.arch,
            error=f"{type(exc).__name__}: {exc}", error_code=code,
            retryable=is_transient(exc),
            retry_after_s=outcome.retry_after_s
            or getattr(exc, "retry_after_s", 0.0),
            attempts=outcome.attempts)

    # -- legacy Analysis API (raises on the first bad request) -------------

    def analyze(self, request: AnalysisRequest) -> Analysis:
        return self.analyze_batch([request])[0]

    def analyze_batch(self, requests: Sequence[AnalysisRequest]) -> List[Analysis]:
        """Serve a wave of analysis requests, deduplicating shared kernels.

        Identical requests within the wave (and across waves, via the LRU)
        are parsed and analyzed once; per (arch, unroll) group the distinct
        kernels share one warm model through ``analyze_kernels``.  Always
        the plain path: no deadlines, no degradation (callers who want the
        resilient behavior use ``submit_batch``).
        """
        results = self._analyze_batch(requests)
        for result in results:
            if isinstance(result, Exception):
                # Raise a copy: raising the (possibly negatively cached,
                # shared) object would attach this frame's traceback to it,
                # pinning the request list for the LRU lifetime.
                raise copy.copy(result)
        return results  # type: ignore[return-value]

    # -- engine ------------------------------------------------------------

    def _resolve(
        self, req: AnalysisRequest
    ) -> Tuple[ArchSpec, object, tuple, AnalyzeOptions]:
        """Registry resolution: (spec, parser, cache key, options).  The
        cache key uses the canonical arch id, so aliases share entries; the
        options object carries the normalized knobs plus the arch's measured
        corpus, whose digest extends the key (reconfigured measurements must
        not share entries — their drift findings would differ)."""
        spec = get_arch(req.arch)
        if spec.is_hlo:
            # The reference's text, so that envelopes compare equal.
            raise ValueError(
                f"arch '{spec.id}' is an HLO target; the analysis service "
                f"serves assembly kernels (use repro.api.analyze for HLO)")
        isa = req.isa or spec.isa
        parser = _PARSERS.get(isa)
        if parser is None:
            raise ValueError(f"unknown isa '{isa}'")
        # ValueError on unroll < 1 / unknown predictor names.
        opts = req.options(self.corpus_for(spec.id)).normalized()
        # ``AnalysisRequest.key``'s shape plus the corpus digest, built from
        # the spec already in hand (the property would resolve the registry
        # a second time).
        key = (spec.id, isa, req.asm, opts.unroll, opts.predictors,
               opts.diagnose, opts.measurements_digest)
        return spec, parser, key, opts

    def _analyze_batch(
        self, requests: Sequence[AnalysisRequest]
    ) -> List[Union[Analysis, Exception]]:
        out: List[Optional[Union[Analysis, Exception]]] = [None] * len(requests)
        # One job per distinct uncached kernel in the wave.
        jobs: List[Tuple] = []
        pending: Dict[tuple, List[int]] = {}
        for pos, req in enumerate(requests):
            try:
                spec, parser, key, opts = self._resolve(req)
            except ValueError as exc:
                out[pos] = exc
                continue
            hit = self._cache.get(key)
            if hit is not None:
                # Errors are negatively cached: a hot malformed kernel is
                # parsed/analyzed once, not once per retry.  Measured ground
                # truth joins by the *requester's* name, so it is re-applied
                # on the per-request view.
                out[pos] = (hit if isinstance(hit, Exception)
                            else apply_measurement(hit, opts.measurements,
                                                   req.name))
                continue
            if key in pending:
                # In-wave duplicate: analyzed once, but still a served hit.
                pending[key].append(pos)
                self._cache.count_extra_hits()
                continue
            try:
                kernel = parser(req.asm, name=req.name)
            except Exception as exc:  # parser rejects malformed asm
                # Strip the traceback before caching: its frames would pin
                # parser locals (including the asm text) for the LRU lifetime.
                out[pos] = exc.with_traceback(None)
                self._cache.put(key, out[pos])
                continue
            pending[key] = [pos]
            jobs.append((pending[key], kernel, key, spec.id, opts))

        # Group the distinct-kernel jobs by analysis parameters — the key's
        # (unroll, predictors, diagnose, digest) tail plus arch and kernel
        # ISA: each group is one wave through the batched engine (a wave
        # stacks one port/graph layout, and ``analyze_kernels`` rejects
        # mixed-ISA batches).
        groups: Dict[tuple, List[Tuple]] = {}
        for job in jobs:
            gkey = (job[3], job[1].isa) + job[2][3:]
            groups.setdefault(gkey, []).append(job)

        for gkey, group in groups.items():
            arch_id = gkey[0]
            model = self.model_for(arch_id)  # memoized per service
            opts = group[0][4]  # identical across the group by construction
            kernels = [job[1] for job in group]
            analyses: Optional[List[Analysis]] = None
            if len(group) > 1:
                try:
                    analyses = analyze_kernels(kernels, model, options=opts,
                                               device=self.device)
                except Exception:
                    # One bad kernel must not take down the group's wave:
                    # fall through to the per-kernel loop below, which
                    # captures (and negatively caches) errors individually.
                    analyses = None
            if analyses is not None:
                for job, analysis in zip(group, analyses):
                    positions, key = job[0], job[2]
                    for pos in positions:
                        out[pos] = apply_measurement(analysis,
                                                     opts.measurements,
                                                     requests[pos].name)
                    self._cache.put(key, analysis)
                continue
            for positions, kernel, key, _arch, opts in group:
                try:
                    analysis = analyze_kernels([kernel], model,
                                               options=opts,
                                               device=self.device)[0]
                except Exception as exc:
                    exc = exc.with_traceback(None)
                    for pos in positions:
                        out[pos] = exc
                    self._cache.put(key, exc)
                    continue
                for pos in positions:
                    out[pos] = apply_measurement(analysis, opts.measurements,
                                                 requests[pos].name)
                self._cache.put(key, analysis)
        return out  # type: ignore[return-value]

    # -- resilient engine --------------------------------------------------

    def _execute_resilient(
        self, requests: Sequence[AnalysisRequest]
    ) -> List[_Outcome]:
        """The dedup/caching wave loop, with breakers, fault-injection
        points, and per-job deadlines/retries/degradation."""
        cfg = self.resilience or ResilienceConfig()
        out: List[Optional[_Outcome]] = [None] * len(requests)
        jobs: List[Tuple] = []
        pending: Dict[tuple, List[int]] = {}
        for pos, req in enumerate(requests):
            try:
                spec, parser, key, opts = self._resolve(req)
            except ValueError as exc:
                out[pos] = _Outcome(error=exc)
                continue
            breaker = self.breaker_for(spec.id)
            if not breaker.allow():
                self.counters["breaker_rejected"] += 1
                retry_after = breaker.retry_after()
                out[pos] = _Outcome(error=ServingError(
                    ErrorCode.OVERLOADED,
                    f"circuit breaker open for arch '{spec.id}'",
                    retryable=True, retry_after_s=retry_after),
                    retry_after_s=retry_after, attempts=0)
                continue
            if self.faults is not None and self.faults.evicts("cache"):
                self._cache.evict(key)
            hit = self._cache.get(key)
            if hit is not None:
                out[pos] = (_Outcome(error=hit)
                            if isinstance(hit, Exception)
                            else _Outcome(analysis=apply_measurement(
                                hit, opts.measurements, req.name)))
                continue
            if key in pending:
                pending[key].append(pos)
                self._cache.count_extra_hits()
                continue
            try:
                if self.faults is not None:
                    self.faults.check("parse")
                kernel = parser(req.asm, name=req.name)
            except Exception as exc:
                exc = exc.with_traceback(None)
                out[pos] = _Outcome(error=exc)
                # Negative-cache only permanent parse failures; a transient
                # injected fault must not poison future requests.
                if not is_transient(exc):
                    self._cache.put(key, exc)
                continue
            pending[key] = [pos]
            timeout_s = req.timeout_s or cfg.request_timeout_s
            jobs.append((pending[key], kernel, key, spec.id, timeout_s, opts))

        for positions, kernel, key, arch_id, timeout_s, opts in jobs:
            model = self.model_for(arch_id)
            outcome = self._run_job(kernel, model, opts.unroll, timeout_s,
                                    cfg, opts.predictors, opts.diagnose)
            breaker = self.breaker_for(arch_id)
            analysis = outcome.analysis
            if analysis is not None and not analysis.degraded:
                # Only full, undegraded successes enter the cache; a
                # degraded answer served from cache would silently demote
                # every future request for that kernel.  The ladder's result
                # is measurement-clean; ground truth joins per request view.
                breaker.record_success()
                self._cache.put(key, analysis)
                for pos in positions:
                    out[pos] = _Outcome(
                        analysis=apply_measurement(analysis,
                                                   opts.measurements,
                                                   requests[pos].name),
                        attempts=outcome.attempts)
                continue
            # Degraded answers and backend failures both count against the
            # breaker: either way the backend failed to produce a full
            # report for this arch.
            breaker.record_failure()
            if analysis is not None:
                for pos in positions:
                    out[pos] = _Outcome(
                        analysis=apply_measurement(analysis,
                                                   opts.measurements,
                                                   requests[pos].name),
                        attempts=outcome.attempts)
                continue
            exc = outcome.error
            assert exc is not None
            if isinstance(exc, Exception):
                exc = exc.with_traceback(None)
            if not is_transient(exc):
                self._cache.put(key, exc)
            for pos in positions:
                out[pos] = _Outcome(error=exc, attempts=outcome.attempts,
                                    retry_after_s=outcome.retry_after_s)
        return out  # type: ignore[return-value]

    def _run_job(self, kernel, model, unroll: int, timeout_s: float,
                 cfg: ResilienceConfig,
                 predictors: Optional[tuple] = None,
                 diagnose: bool = False) -> _Outcome:
        """One kernel through deadline + retry + degradation ladder."""
        deadline = (Deadline.after(timeout_s, cfg.clock)
                    if timeout_s > 0 else None)
        if cfg.degrade and cfg.min_rung != "full":
            floor = DEGRADATION_LADDER.index(cfg.min_rung)
            rungs = DEGRADATION_LADDER[:floor + 1]
        else:
            rungs = ("full",)
        attempts = 0
        last_exc: Optional[BaseException] = None
        for rung in rungs:
            checkpoint = (None if rung == "parse_only"
                          else self._make_checkpoint(deadline, cfg))
            max_attempts = max(cfg.retry.max_attempts, 1)
            for attempt in range(max_attempts):
                attempts += 1
                try:
                    analysis = self._run_rung(kernel, model, unroll, rung,
                                              checkpoint, deadline, cfg,
                                              predictors, diagnose)
                    return _Outcome(analysis=analysis, attempts=attempts)
                except Exception as exc:  # noqa: BLE001 — classified below
                    last_exc = exc
                    if not is_transient(exc):
                        break  # permanent: retries can't help, drop a rung
                    expired = deadline is not None and deadline.expired
                    if attempt + 1 < max_attempts and not expired:
                        self.counters["retries"] += 1
                        cfg.sleep(cfg.retry.backoff(attempt, self._jitter_rng))
                        continue
                    break  # retries/deadline exhausted: drop a rung
        assert last_exc is not None
        return _Outcome(error=last_exc, attempts=attempts)

    def _run_rung(self, kernel, model, unroll: int, rung: str, checkpoint,
                  deadline: Optional[Deadline], cfg: ResilienceConfig,
                  predictors: Optional[tuple] = None,
                  diagnose: bool = False):
        def run():
            # The worker thread is handed the service's device; it never
            # reads a per-thread current device.
            return analyze_kernel_rung(kernel, model, unroll, rung=rung,
                                       checkpoint=checkpoint,
                                       predictors=predictors,
                                       diagnose=diagnose, device=self.device)

        # The cancellable worker bounds wall time even when a stage blocks
        # between checkpoints; with a virtual clock (chaos tests) wall time
        # never advances on its own, so the cooperative checks suffice.
        if (cfg.use_worker and deadline is not None
                and cfg.clock is time.monotonic and rung != "parse_only"):
            return run_with_deadline(run, deadline.remaining())
        return run()

    def _make_checkpoint(self, deadline: Optional[Deadline],
                         cfg: ResilienceConfig):
        """The cooperative stage-boundary hook: fault injection first (a
        ``timeout:<stage>`` site advances the virtual clock so the *real*
        deadline machinery trips), then the request deadline, then the
        per-stage budget (detected at the next boundary)."""
        state = {"stage": "", "since": cfg.clock()}

        def checkpoint(stage: str) -> None:
            if self.faults is not None:
                try:
                    self.faults.check(f"timeout:{stage}")
                    self.faults.check(f"stage:{stage}")
                except ServingError:
                    self.counters["faults_injected"] += 1
                    raise
            now = cfg.clock()
            prev, prev_since = state["stage"], state["since"]
            state["stage"], state["since"] = stage, now
            if deadline is not None:
                deadline.check(stage)
            if cfg.stage_timeout_s > 0 and prev and \
                    now - prev_since > cfg.stage_timeout_s:
                raise StageTimeout(prev, cfg.stage_timeout_s)

        return checkpoint
