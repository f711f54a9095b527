"""`AnalyzeOptions`: the one knob object for every analysis entry point.

The analysis surface grew one kwarg at a time — ``unroll``, ``predictors``,
``diagnose``, ``timeout_s``, ``degrade``, and now ``measurements`` — and the
lists drifted independently across ``repro_torch.api.analyze`` →
``analyze_kernels`` → ``AnalysisService`` → ``_cache_key``.  This module is
the single normalization point: every entry point coerces its inputs into
one frozen :class:`AnalyzeOptions`, validates it once (:meth:`normalized`),
and derives cache identity from it (:meth:`key_parts`).

Legacy keyword arguments (``analyze(src, unroll=4, diagnose=True)``) keep
working through :meth:`AnalyzeOptions.coerce` with a ``DeprecationWarning``;
they normalize to the identical options object — and therefore the identical
cache key — as the ``options=AnalyzeOptions(...)`` form.

``PREDICTORS`` and :func:`normalize_predictors` live here (this is the leaf
module of the analysis package) and are re-exported from ``analyze`` for
backwards compatibility.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from repro_torch.core.calibration.corpus import resolve_measurements

#: Selectable predictors for ``analyze_kernel(..., predictors=...)``.
PREDICTORS: Tuple[str, ...] = ("tp", "cp", "lcd", "sim")


def normalize_predictors(predictors) -> Tuple[str, ...]:
    """Canonical predictor subset: validated, ordered, with implied members.

    ``None`` or an empty selection means *all* predictors.  ``tp`` is always
    included (the per-instruction rows and every rung need it) and ``sim``
    implies ``cp`` — the simulator's point prediction is clamped into the
    [TP, CP] bracket, so it needs the upper bound.
    """
    if predictors is None:
        return PREDICTORS
    requested = set(predictors)
    if not requested:
        return PREDICTORS
    unknown = requested - set(PREDICTORS)
    if unknown:
        raise ValueError(f"unknown predictors {sorted(unknown)}; "
                         f"known: {PREDICTORS}")
    requested.add("tp")
    if "sim" in requested:
        requested.add("cp")
    return tuple(p for p in PREDICTORS if p in requested)


#: The kwargs `coerce` accepts from the legacy surface, in declaration order.
_LEGACY_KWARGS: Tuple[str, ...] = ("model", "unroll", "predictors",
                                   "diagnose", "timeout_s", "degrade",
                                   "measurements")


@dataclass(frozen=True)
class AnalyzeOptions:
    """Every analysis knob in one immutable object.

    Fields:

    - ``model``: arch-id override for facade entry points (``None`` = the
      caller's ``arch`` argument / the service default).
    - ``unroll``: high-level loop unroll factor (>= 1).
    - ``predictors``: subset of :data:`PREDICTORS`; ``None``/empty = all.
    - ``diagnose``: run the bottleneck-diagnostics pass.
    - ``timeout_s``: deadline for resilient entry points (``None`` = none;
      ``0.0`` is a real — already expired — deadline).
    - ``degrade``: walk the degradation ladder instead of failing on error.
    - ``measurements``: measured-corpus join — ``None``, a
      ``MeasurementCorpus``, ``"auto"`` (recorded corpus for the arch, if
      any), or a corpus file/directory path.

    Only ``unroll``/``predictors``/``diagnose``/``measurements`` participate
    in cache identity (:meth:`key_parts`): ``timeout_s``/``degrade`` shape
    *how* an answer is produced, not *what* it is, and ``model`` is folded
    into the key separately as the resolved model name.
    """

    model: Optional[str] = None
    unroll: int = 1
    predictors: Optional[Tuple[str, ...]] = None
    diagnose: bool = False
    timeout_s: Optional[float] = None
    degrade: bool = False
    measurements: object = None

    def __post_init__(self):
        if self.predictors is not None:
            object.__setattr__(self, "predictors", tuple(self.predictors))

    # -- normalization -----------------------------------------------------

    def normalized(self) -> "AnalyzeOptions":
        """Validated options with the predictor subset in canonical form."""
        if self.unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {self.unroll}")
        return replace(self, predictors=normalize_predictors(self.predictors))

    def resolved(self, arch: str) -> "AnalyzeOptions":
        """:meth:`normalized` plus the ``measurements`` option resolved to a
        concrete ``MeasurementCorpus`` (or ``None``) for ``arch``."""
        opts = self.normalized()
        return replace(opts,
                       measurements=resolve_measurements(opts.measurements,
                                                         arch))

    # -- cache identity ----------------------------------------------------

    @property
    def measurements_digest(self) -> str:
        """Content hash of the resolved corpus; ``""`` when none joined.

        Unresolved forms (``"auto"``, paths) have no stable identity —
        resolve first (:meth:`resolved`) before deriving cache keys.
        """
        corpus = self.measurements
        if corpus is None:
            return ""
        digest = getattr(corpus, "digest", None)
        if digest is None:
            raise ValueError(
                f"measurements={self.measurements!r} is unresolved; call "
                f"options.resolved(arch) before deriving a cache key")
        return digest

    def key_parts(self) -> tuple:
        """The options' contribution to an analysis cache key."""
        opts = self.normalized()
        return (opts.unroll, opts.predictors, bool(opts.diagnose),
                opts.measurements_digest)

    # -- the one legacy-kwarg normalization point --------------------------

    @classmethod
    def coerce(cls, options: Optional["AnalyzeOptions"],
               legacy: Dict[str, object],
               where: str = "analyze") -> "AnalyzeOptions":
        """Normalize an ``options=`` object and/or legacy kwargs.

        Exactly one spelling may be used per call: passing both an options
        object and legacy kwargs is an error (which would win?).  Legacy
        kwargs emit one ``DeprecationWarning`` naming the entry point and
        construct the equivalent options object, so both spellings share
        every downstream code path — and the same cache key.
        """
        if legacy:
            unknown = set(legacy) - set(_LEGACY_KWARGS)
            if unknown:
                raise TypeError(
                    f"{where}() got an unexpected keyword argument "
                    f"'{sorted(unknown)[0]}'")
            if options is not None:
                raise TypeError(
                    f"{where}() takes options= or legacy keyword arguments "
                    f"({', '.join(sorted(legacy))}), not both")
            warnings.warn(
                f"{where}(**kwargs) with {', '.join(sorted(legacy))} is "
                f"deprecated; pass options=AnalyzeOptions(...) instead",
                DeprecationWarning, stacklevel=3)
            return cls(**legacy)  # type: ignore[arg-type]
        if options is None:
            return cls()
        if isinstance(options, cls):
            return options
        raise TypeError(
            f"{where}() options must be AnalyzeOptions, got "
            f"{type(options).__name__}")
