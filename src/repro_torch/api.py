"""One front door for kernel analysis: ``from repro_torch.api import analyze``.

The assembly branch of ``repro.api``.  The facade accepts raw assembly text,
a ``.s`` file path, or a parsed
:class:`~repro_torch.core.isa.instruction.Kernel`; the target is named by an
architecture id or alias resolved through the central registry
(:mod:`repro_torch.core.registry`), and the result is always a serializable
:class:`~repro_torch.core.analysis.report.AnalysisReport`::

    from repro_torch.api import AnalyzeOptions, analyze

    report = analyze("fadd d0, d0, d1", arch="tx2")     # asm text
    report = analyze("loop.s", arch="cascadelake")      # file path + alias
    report = analyze(asm, arch="tx2",                   # all other knobs
                     options=AnalyzeOptions(unroll=4, diagnose=True,
                                            measurements="auto"))
    report = analyze(asm, arch="tx2", device="cpu")     # on the host
    print(report.render("text"))                        # or "json"/"markdown"
    payload = report.to_dict()                          # stable JSON schema

Every analysis knob beyond ``source``/``arch``/``name``/``device`` travels in
one :class:`~repro_torch.core.analysis.options.AnalyzeOptions` object; the
legacy keyword spellings (``unroll=``, ``predictors=``, ``diagnose=``,
``timeout_s=``, ``degrade=``) still work with a ``DeprecationWarning`` and
normalize to the identical options — and cache identity — as the
``options=`` form.

``device`` is where the analysis's tensor passes run as float64 tensors: the
CUDA device unless the caller names another, and a call that names none
raises when there is no card.  The report is the same on every device, bit
for bit.

Not ported yet, and raising instead of running: HLO sources (an accelerator
target for this port replaces the TPU one, ROADMAP item 10).

Analyses share the process-level LRU and one warm :class:`MachineModel` per
architecture, so hot loops repeated across calls are analyzed once.  For
request/response serving (batching, per-request error envelopes), use
:class:`repro_torch.serving.analysis.AnalysisService` — it is built on this
facade.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

from repro_torch import resolve_device
from repro_torch.core.analysis import Analysis, AnalysisReport, analyze_kernels
from repro_torch.core.analysis.analyze import (analyze_kernel_ladder,
                                               apply_measurement)
from repro_torch.core.analysis.options import AnalyzeOptions
from repro_torch.core.isa.instruction import Kernel
from repro_torch.core.registry import (ArchSpec, asm_arch_ids, get_arch,
                                       list_arch_ids, register_arch)

__all__ = [
    "analyze",
    "analyze_raw",
    "AnalyzeOptions",
    "AnalysisReport",
    "ArchSpec",
    "get_arch",
    "register_arch",
    "list_arch_ids",
    "asm_arch_ids",
    "AnalysisService",
    "AnalysisRequest",
    "AnalysisResponse",
]

# One warm model per architecture for the process lifetime: its instruction-
# lookup memo then amortizes across every analyze() call.
_MODELS: Dict[str, object] = {}

_ASM_SUFFIXES = (".s", ".asm")
# Suffixes that mark a single-line string source as a file path.  An
# existence probe alone would be cwd-dependent: a one-line kernel text that
# happens to collide with a local filename must not silently become a read.
_PATH_SUFFIXES = _ASM_SUFFIXES + (".hlo", ".txt", ".dump")

_HLO_NOT_PORTED = (
    "HLO sources are not analyzed by repro_torch: ROADMAP item 10 replaces "
    "the TPU/HLO target of repro.api with an H100 one")


def model_for(arch: Union[str, ArchSpec]):
    """The process-wide warm machine model for ``arch``."""
    spec = arch if isinstance(arch, ArchSpec) else get_arch(arch)
    model = _MODELS.get(spec.id)
    if model is None:
        model = spec.model_factory()
        _MODELS[spec.id] = model
    return model


def _looks_like_path(text: str) -> bool:
    if "\n" in text:
        return False
    if text.strip().lower().endswith(_PATH_SUFFIXES):
        return True
    # Anything else must both contain a path separator and exist: plain
    # one-line instruction text never does, regardless of the caller's cwd.
    return os.sep in text and os.path.isfile(text)


def _read_if_path(source):
    """Read path-like sources into (text, basename); pass others through."""
    if isinstance(source, os.PathLike) or (
            isinstance(source, str) and _looks_like_path(source)):
        path = os.fspath(source)
        with open(path) as f:
            return f.read(), os.path.basename(path)
    return source, None


def _looks_like_hlo(source) -> bool:
    if hasattr(source, "computations") or hasattr(source, "as_text"):
        return True
    return isinstance(source, str) and source.lstrip().startswith("HloModule")


def _coerce_kernel(source, spec: ArchSpec, name: Optional[str]) -> Kernel:
    if isinstance(source, Kernel):
        if name is not None and source.name != name:
            from dataclasses import replace
            return replace(source, name=name)
        return source
    source, basename = _read_if_path(source)
    if basename is not None:
        return spec.parser(source, name=name or basename)
    if isinstance(source, (str, bytes)):
        text = source.decode() if isinstance(source, bytes) else source
        return spec.parser(text, name=name or "kernel")
    raise TypeError(
        f"cannot analyze {type(source).__name__}: expected asm text, a "
        f"{'/'.join(_ASM_SUFFIXES)} file path, or a parsed Kernel")


def analyze_raw(source, arch: str = "tx2", options=None,
                name: Optional[str] = None, device=None,
                **legacy) -> Analysis:
    """Like :func:`analyze` but returning the live assembly-pipeline
    :class:`Analysis` (kernel/model objects attached).

    All knobs travel in ``options=AnalyzeOptions(...)`` (legacy kwargs keep
    working with a DeprecationWarning; a bare int ``options`` is the old
    positional ``unroll``):

    ``timeout_s`` puts the analysis under a deadline checked at every stage
    boundary; with ``degrade=True`` an expired deadline (or a failed stage)
    falls down the degradation ladder — full → bracket (no simulator) →
    optimistic-TP-only → parse-only — instead of raising, and the returned
    analysis carries ``degradation`` / ``stages_completed`` saying which
    rung answered.  Without ``degrade``, a timeout raises
    :class:`repro_torch.serving.resilience.StageTimeout`.

    ``predictors`` selects a subset of ``("tp", "cp", "lcd", "sim")``;
    the default computes all four (see
    :func:`repro_torch.core.analysis.normalize_predictors` for the
    implication rules).

    ``diagnose=True`` attaches the structured bottleneck findings
    (:mod:`repro_torch.core.analysis.diagnostics`) to the analysis.

    ``measurements`` joins recorded ground truth: a
    :class:`~repro_torch.core.calibration.corpus.MeasurementCorpus`,
    ``"auto"`` (the arch's recorded corpus under ``data/measurements/``, if
    any), or a corpus path.  A matching entry fills ``measured_block`` and
    lets the diagnostics pass emit ``PREDICTION_DRIFT``.

    ``device`` is where the tensor passes run (``None``: the CUDA device,
    which raises when there is none).
    """
    device = resolve_device(device)
    if isinstance(options, int):  # legacy positional unroll
        legacy.setdefault("unroll", options)
        options = None
    opts = AnalyzeOptions.coerce(options, legacy, where="analyze_raw")
    spec = get_arch(opts.model or arch)
    if spec.is_hlo:
        raise ValueError(_HLO_NOT_PORTED)
    opts = opts.resolved(spec.id)  # validates unroll, loads the corpus
    kernel = _coerce_kernel(source, spec, name)
    if opts.timeout_s is None and not opts.degrade:
        return analyze_kernels([kernel], model_for(spec), options=opts,
                               device=device)[0]
    from repro_torch.serving.resilience import Deadline
    checkpoint = (Deadline.after(opts.timeout_s).check
                  if opts.timeout_s is not None else None)
    analysis = analyze_kernel_ladder(
        kernel, model_for(spec), opts.unroll, checkpoint=checkpoint,
        min_rung="parse_only" if opts.degrade else "full",
        predictors=opts.predictors, diagnose=opts.diagnose, device=device)
    return apply_measurement(analysis, opts.measurements)


def analyze(source, arch: str = "tx2", options=None,
            name: Optional[str] = None, device=None,
            **legacy) -> AnalysisReport:
    """Analyze a kernel and return the serializable :class:`AnalysisReport`.

    ``source`` may be assembly text, a ``.s``/``.asm`` file path, or a parsed
    ``Kernel``.  An HLO module (text starting with ``HloModule``, a parsed
    module, or a ``Compiled``, also read from a file) raises ``ValueError``:
    see the module docstring.

    All other knobs travel in one ``options=AnalyzeOptions(...)`` object
    (legacy ``unroll=``/``predictors=``/``diagnose=``/``degrade=`` kwargs
    keep working with a DeprecationWarning; a bare int ``options`` is the
    old positional ``unroll``); see :func:`analyze_raw`.  The report carries
    ``None``/zero for predictors that were not requested, ``findings`` only
    with ``diagnose=True``, and the schema-v5 ``measured_block`` /
    ``measured_source`` when ``measurements`` matched.

    ``device`` is where the tensor passes run (``None``: the CUDA device,
    which raises when there is none).
    """
    device = resolve_device(device)
    if isinstance(options, int):  # legacy positional unroll
        legacy.setdefault("unroll", options)
        options = None
    opts = AnalyzeOptions.coerce(options, legacy, where="analyze")
    spec = get_arch(opts.model or arch)
    # Read path sources up front so the HLO sniff sees file *contents*, not
    # the path string.
    source, basename = _read_if_path(source)
    if basename is not None:
        name = name or basename
    if spec.is_hlo or _looks_like_hlo(source):
        raise ValueError(_HLO_NOT_PORTED)
    return analyze_raw(source, arch=spec.id, options=opts, name=name,
                       device=device).to_report()


def __getattr__(attr):
    # Service classes are exposed lazily, as in ``repro.api``: plain
    # analyze() callers do not import the serving tier.
    if attr in ("AnalysisService", "AnalysisRequest", "AnalysisResponse"):
        from repro_torch.serving import analysis as _serving
        return getattr(_serving, attr)
    raise AttributeError(f"module 'repro_torch.api' has no attribute '{attr}'")
