"""The calibration loop: score every predictor against measured corpora.

Joins a :class:`~repro_torch.core.calibration.corpus.MeasurementCorpus` against
the analysis pipeline and computes, per predictor, the error statistics that
uiCA (arXiv:2107.14210) and Ithemal (arXiv:1808.07412) made the standard
throughput-prediction eval:

- **MAPE** — mean absolute percentage error vs measured cy/it,
- **signed bias** — mean signed percentage error (negative = the predictor
  underestimates),
- **max APE** — the worst single kernel,

plus the paper's own headline claim as a rate: **bracket coverage**, the
fraction of measured kernels that land inside
``[TP(balanced), max(TP(balanced), CP)]``.  Kernels measured *outside* the
bracket surface as ``PREDICTION_DRIFT`` findings on their individual reports
(:mod:`repro_torch.core.analysis.diagnostics`); here they are counted.

The four calibrated predictors are ``optimistic`` (uniform-split TP),
``balanced`` (min-max optimal-assignment TP — the headline lower bound),
``cp`` (critical path upper bound), and ``sim`` (window-limited OoO point
prediction).  LCD is the paper's *expected* value for latency-bound loops,
not a standalone throughput predictor, and is not scored.

Heavy imports (registry, facade) happen lazily inside functions so this
module can be imported from the options layer without cycles.

Every entry point takes ``device``, where the analyses' tensor passes run
(``None``: the CUDA device, see :func:`repro_torch.resolve_device`); the
result is the same on every device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch import resolve_device
from repro_torch.core.calibration.corpus import (MeasurementCorpus,
                                                 MeasuredKernel, load_corpus)

#: Predictors scored by the calibration loop, display order.
CALIBRATED_PREDICTORS: Tuple[str, ...] = ("optimistic", "balanced", "cp",
                                          "sim")

#: Relative slack when deciding bracket membership (mirrors the
#: diagnostics tolerance: float noise must not flip coverage).
BRACKET_REL_TOL = 1e-6


@dataclass(frozen=True)
class KernelCalibration:
    """One corpus entry joined against its analysis."""

    name: str
    unroll: int
    measured_cy_per_it: float
    source: str = ""
    #: Per-iteration predictions keyed by predictor id; a predictor the
    #: analysis did not produce (e.g. sim on a window-less machine) is None.
    predictions: Dict[str, Optional[float]] = field(default_factory=dict)
    in_bracket: bool = False
    drift: bool = False  # the report carries a PREDICTION_DRIFT finding

    def ape(self, predictor: str) -> Optional[float]:
        """Absolute percentage error of one predictor on this kernel."""
        pred = self.predictions.get(predictor)
        if pred is None or self.measured_cy_per_it <= 0:
            return None
        return abs(pred - self.measured_cy_per_it) \
            / self.measured_cy_per_it * 100.0

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "unroll": self.unroll,
            "measured_cy_per_it": self.measured_cy_per_it,
            "source": self.source,
            "predictions": dict(self.predictions),
            "in_bracket": self.in_bracket,
            "drift": self.drift,
        }


@dataclass(frozen=True)
class PredictorError:
    """Aggregate error of one predictor over a corpus."""

    predictor: str
    n: int  # kernels where the predictor produced a value
    mape: float  # mean absolute percentage error, in %
    bias: float  # mean signed percentage error, in % (negative = under)
    max_ape: float

    def to_dict(self) -> Dict:
        return {
            "predictor": self.predictor,
            "n": self.n,
            "mape": round(self.mape, 4),
            "bias": round(self.bias, 4),
            "max_ape": round(self.max_ape, 4),
        }


@dataclass(frozen=True)
class CalibrationResult:
    """Per-arch calibration: every entry joined, every predictor scored."""

    arch: str
    corpus_digest: str
    kernels: Tuple[KernelCalibration, ...]
    errors: Dict[str, PredictorError]
    bracket_coverage: float  # fraction of measured kernels inside the bracket
    drift_count: int

    @property
    def n_kernels(self) -> int:
        return len(self.kernels)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "corpus_digest": self.corpus_digest,
            "n_kernels": self.n_kernels,
            "bracket_coverage": round(self.bracket_coverage, 4),
            "drift_count": self.drift_count,
            "errors": {p: e.to_dict() for p, e in self.errors.items()},
            "kernels": [k.to_dict() for k in self.kernels],
        }


def resolve_entry_asm(entry: MeasuredKernel, spec) -> str:
    """The kernel text an entry measures: inline ``asm`` or the registry's
    built-in sample kernel (``builtin="sample"``)."""
    if entry.asm:
        return entry.asm
    if entry.builtin == "sample":
        if not spec.sample_asm:
            raise ValueError(
                f"corpus entry '{entry.name}' references builtin 'sample' "
                f"but arch '{spec.id}' has no sample kernel")
        return spec.sample_asm
    raise ValueError(
        f"corpus entry '{entry.name}' carries neither inline asm nor a "
        f"known builtin (got builtin={entry.builtin!r})")


def _join_entry(entry: MeasuredKernel, spec, corpus: MeasurementCorpus,
                device) -> KernelCalibration:
    from repro_torch.api import analyze_raw
    from repro_torch.core.analysis.options import AnalyzeOptions

    unroll = max(entry.unroll, 1)
    analysis = analyze_raw(
        resolve_entry_asm(entry, spec), arch=spec.id, name=entry.name,
        options=AnalyzeOptions(unroll=unroll, diagnose=True,
                               measurements=corpus),
        device=device)
    predictions: Dict[str, Optional[float]] = {
        "optimistic": analysis.tp_per_it if analysis.tp else None,
        "balanced": analysis.tp_balanced_per_it if analysis.tp else None,
        "cp": analysis.cp_per_it if analysis.cp else None,
        "sim": analysis.sim_per_it if analysis.sim else None,
    }
    lo = predictions["balanced"]
    hi = max(lo, predictions["cp"]) if predictions["cp"] is not None else lo
    measured = entry.measured_cy_per_it
    in_bracket = (lo is not None
                  and lo * (1.0 - BRACKET_REL_TOL) <= measured
                  <= hi * (1.0 + BRACKET_REL_TOL))
    drift = any(f.code == "PREDICTION_DRIFT"
                for f in (analysis.findings or ()))
    return KernelCalibration(
        name=entry.name, unroll=unroll, measured_cy_per_it=measured,
        source=entry.source, predictions=predictions,
        in_bracket=in_bracket, drift=drift)


def _score(kernels: Tuple[KernelCalibration, ...],
           predictor: str) -> PredictorError:
    apes = []
    signed = []
    for k in kernels:
        ape = k.ape(predictor)
        if ape is None:
            continue
        apes.append(ape)
        signed.append((k.predictions[predictor] - k.measured_cy_per_it)
                      / k.measured_cy_per_it * 100.0)
    if not apes:
        return PredictorError(predictor=predictor, n=0, mape=0.0, bias=0.0,
                              max_ape=0.0)
    return PredictorError(predictor=predictor, n=len(apes),
                          mape=sum(apes) / len(apes),
                          bias=sum(signed) / len(signed),
                          max_ape=max(apes))


def calibrate_corpus(corpus: MeasurementCorpus,
                     device=None) -> CalibrationResult:
    """Join every corpus entry against the analysis pipeline and score the
    four predictors.  Deterministic: same corpus + same machine DBs → the
    same result, which is what makes MAPE a CI trajectory."""
    from repro_torch.core.registry import get_arch

    device = resolve_device(device)
    spec = get_arch(corpus.arch)
    kernels = tuple(_join_entry(entry, spec, corpus, device)
                    for entry in corpus.entries)
    errors = {p: _score(kernels, p) for p in CALIBRATED_PREDICTORS}
    covered = sum(1 for k in kernels if k.in_bracket)
    return CalibrationResult(
        arch=spec.id,
        corpus_digest=corpus.digest,
        kernels=kernels,
        errors=errors,
        bracket_coverage=covered / len(kernels) if kernels else 0.0,
        drift_count=sum(1 for k in kernels if k.drift),
    )


def calibrate(arch: str, directory=None, device=None) -> CalibrationResult:
    """Calibrate one architecture against its recorded corpus."""
    return calibrate_corpus(load_corpus(arch, directory), device=device)
