"""Combined OSACA analysis: TP + CP + LCD + sim with a Table-II-style report.

Single-sweep pipeline: one ``resolve_kernel`` and one dual-writeback 2-copy
DAG build are shared across all analyses — TP accumulates pressure from the
resolved costs, LCD runs the batched all-sources sweep over the DAG's
split-writeback view, CP reuses the same DAG's copy-0 data-chained view, and
the window-limited OoO simulator (:mod:`repro_torch.core.sim`) replays the same
DAG as its replication template to close the [TP, CP] bracket with a point
prediction.

``predictors=`` selects a subset of ``("tp", "cp", "lcd", "sim")``: the DAG
is only built when a DAG-consuming predictor is requested, TP is always
computed (per-instruction rows need it), and ``sim`` implies ``cp`` (the
point prediction is clamped into the bracket).

``analyze_kernels`` is the batch entry point (one warm model cache across
kernels, process-level LRU keyed by kernel text + model name + unroll +
predictors + device type) for serving paths that analyze many — often
repeated — kernels concurrently.

Every entry point here that runs a tensor pass takes ``device``: the LCD
sweep of ``analyze_kernel``, and the CP and LCD passes of the wave engine
behind ``analyze_kernels``, run as float64 tensors there, and their results
leave it as Python floats and ints, so an ``Analysis`` holds no tensors.  The
other stages (cost resolution, the water-filling, the DAG, the per-kernel
CP, the simulator) run on the host, as in the reference.  ``device=None`` means the CUDA device, and
raises without one (:func:`repro_torch.resolve_device`); pass ``"cpu"`` to
run on the host.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch import resolve_device
from repro_torch.core.analysis.critical_path import (CriticalPathResult,
                                                     critical_path_from_dag)
from repro_torch.core.analysis.dag import build_dag
from repro_torch.core.analysis.diagnostics import Finding
from repro_torch.core.analysis.diagnostics import diagnose as diagnose_analysis
from repro_torch.core.analysis.lcd import LCDResult, lcd_from_dag
# PREDICTORS / normalize_predictors moved to the options leaf module;
# re-exported here for backwards compatibility.
from repro_torch.core.analysis.options import (PREDICTORS, AnalyzeOptions,
                                               normalize_predictors)
from repro_torch.core.analysis.report import AnalysisReport
from repro_torch.core.analysis.throughput import (ThroughputResult,
                                                  throughput_from_costs)
from repro_torch.core.isa.instruction import Kernel
from repro_torch.core.machine.model import MachineModel
from repro_torch.core.sim.engine import SimResult, simulate_from_dag


#: Pipeline stages in execution order; the degradation ladder cuts suffixes.
ANALYSIS_STAGES: Tuple[str, ...] = ("resolve", "tp", "dag", "cp", "lcd", "sim")

#: Degradation rungs, most complete first.  ``full`` is TP(both bounds) +
#: CP + LCD + the window-limited simulator; ``bracket`` drops the simulator
#: (the legacy [TP, CP] + LCD answer); ``tp_only`` is the optimistic
#: full-throughput model alone (no DAG, no scheduler); ``parse_only``
#: answers with parse-level facts only.
DEGRADATION_LADDER: Tuple[str, ...] = ("full", "bracket", "tp_only",
                                       "parse_only")

_RUNG_STAGES: Dict[str, Tuple[str, ...]] = {
    "full": ANALYSIS_STAGES,
    "bracket": ("resolve", "tp", "dag", "cp", "lcd"),
    "tp_only": ("resolve", "tp"),
    "parse_only": (),
}


@dataclass
class Analysis:
    kernel: Kernel
    model: MachineModel
    unroll: int
    # None below "full" on the degradation ladder: a tp_only analysis has no
    # cp/lcd, a parse_only analysis has none of the three.
    tp: Optional[ThroughputResult]
    cp: Optional[CriticalPathResult]
    lcd: Optional[LCDResult]
    # Window-limited OoO point prediction; ``None`` when not requested, when
    # the rung dropped it, or when the machine has no window parameters.
    sim: Optional[SimResult] = None
    # Structured bottleneck diagnostics (``diagnose=True``); ``None`` means
    # the pass did not run, ``()`` means it ran and found nothing.
    findings: Optional[Tuple[Finding, ...]] = None
    degradation: str = "full"  # ladder rung that produced this analysis
    stages_completed: Tuple[str, ...] = ANALYSIS_STAGES
    # Measured ground truth joined from a measurement corpus (cy per *block*,
    # like the predictor results); ``None`` when no corpus entry matched.
    # Attached per-request via ``analysis_view`` — cached analyses stay clean.
    measured_block: Optional[float] = None
    measured_source: str = ""

    @property
    def degraded(self) -> bool:
        return self.degradation != "full"

    # Per high-level (source) iteration numbers — the paper's Table I units.
    # Degraded analyses report 0.0 for the numbers their rung did not
    # compute; check ``degraded`` / ``stages_completed`` to tell them apart.
    @property
    def tp_per_it(self) -> float:
        return self.tp.per_iteration(self.unroll) if self.tp else 0.0

    @property
    def tp_balanced_per_it(self) -> float:
        """Min-max optimal-assignment throughput bound (cy per iteration)."""
        return self.tp.balanced_per_iteration(self.unroll) if self.tp else 0.0

    @property
    def cp_per_it(self) -> float:
        return self.cp.per_iteration(self.unroll) if self.cp else 0.0

    @property
    def lcd_per_it(self) -> float:
        return self.lcd.per_iteration(self.unroll) if self.lcd else 0.0

    @property
    def sim_per_it(self) -> float:
        return self.sim.per_iteration(self.unroll) if self.sim else 0.0

    @property
    def measured_per_it(self) -> float:
        return (self.measured_block / self.unroll
                if self.measured_block is not None else 0.0)

    def prediction_bracket(self) -> Dict[str, float]:
        """[TP, CP] runtime bracket with the LCD as the expected value.

        Since schema v5 the headline lower bound is the *balanced* (min-max
        optimal assignment) throughput — the tighter, calibrated bound; the
        key name ``lower_bound_tp`` is kept for wire compatibility.  On
        degraded rungs without a scheduler pass the balanced numbers mirror
        the optimistic ones, so the bracket stays well-defined.
        """
        return {
            "lower_bound_tp": self.tp_balanced_per_it,
            "expected_lcd": self.lcd_per_it,
            "upper_bound_cp": self.cp_per_it,
        }

    def to_report(self) -> "AnalysisReport":
        """Snapshot into the serializable public-API report (memoized: on a
        serving path the same cached analysis is reported many times)."""
        report = self.__dict__.get("_report_memo")
        if report is None:
            report = AnalysisReport.from_analysis(self)
            self.__dict__["_report_memo"] = report
        return report

    def report(self) -> str:
        """Render a condensed Table-II-style report."""
        return self.to_report().render("text")


def analyze_kernel(kernel: Kernel, model: MachineModel, unroll: int = 1,
                   checkpoint: Optional[Callable[[str], None]] = None,
                   predictors=None, diagnose: bool = False,
                   device=None) -> Analysis:
    """Full TP/CP/LCD/sim analysis: one cost resolution, one DAG build.

    ``checkpoint(stage)`` — when given — is called at every stage boundary
    (before the stage runs) and may raise to cancel the analysis: the serving
    path passes a deadline/fault-injection check so an expired request stops
    at the next boundary instead of finishing a report nobody is waiting for.
    The ``sim`` stage additionally re-checks once per simulated body copy, so
    a deadline can cancel *inside* the most expensive stage.

    ``predictors`` selects a subset of :data:`PREDICTORS`
    (see :func:`normalize_predictors`); the default runs everything.  The
    simulator is skipped — without error — on machines with no
    ``window`` parameters; ``stages_completed`` records what actually ran.

    ``diagnose=True`` runs the bottleneck-diagnostics pass
    (:mod:`repro_torch.core.analysis.diagnostics`) over the finished analysis and
    attaches its findings.

    ``device`` is where the LCD sweep runs (see the module docstring).
    """
    device = resolve_device(device)
    preds = normalize_predictors(predictors)
    check = checkpoint or _no_checkpoint
    stages: List[str] = []
    check("resolve")
    costs = model.resolve_kernel(kernel)
    stages.append("resolve")
    check("tp")
    tp = throughput_from_costs(costs, model)
    stages.append("tp")
    cp = lcd = sim = None
    dag = None
    if any(p in preds for p in ("cp", "lcd", "sim")):
        check("dag")
        dag = build_dag(kernel, model, copies=2, dual_writeback=True,
                        costs=costs)
        stages.append("dag")
    if "cp" in preds:
        check("cp")
        cp = critical_path_from_dag(dag)
        stages.append("cp")
    if "lcd" in preds:
        check("lcd")
        lcd = lcd_from_dag(dag, len(kernel), device=device)
        stages.append("lcd")
    if "sim" in preds and model.window is not None:
        check("sim")
        sim = simulate_from_dag(dag, model,
                                tp_block=tp.balanced_throughput,
                                cp_block=cp.length if cp is not None else None,
                                cancel=(lambda: check("sim"))
                                if checkpoint is not None else None)
        stages.append("sim")
    analysis = Analysis(kernel=kernel, model=model, unroll=unroll,
                        tp=tp, cp=cp, lcd=lcd, sim=sim,
                        stages_completed=tuple(stages))
    if diagnose:
        analysis.findings = diagnose_analysis(analysis)
    return analysis


def _no_checkpoint(stage: str) -> None:
    return None


# -- degradation ladder ------------------------------------------------------


def analyze_kernel_bracket(kernel: Kernel, model: MachineModel,
                           unroll: int = 1,
                           checkpoint: Optional[Callable[[str], None]] = None,
                           predictors=None, diagnose: bool = False,
                           device=None) -> Analysis:
    """Rung 2: the legacy [TP, CP] + LCD bracket without the simulator.

    Same single-sweep pipeline as ``full`` minus the ``sim`` stage — the
    fallback when the point prediction times out or faults.
    """
    preds = normalize_predictors(predictors)
    bracket_preds = tuple(p for p in preds if p != "sim") or ("tp",)
    analysis = analyze_kernel(kernel, model, unroll, checkpoint=checkpoint,
                              predictors=bracket_preds, diagnose=diagnose,
                              device=device)
    return replace(analysis, degradation="bracket")


def analyze_kernel_tp_only(kernel: Kernel, model: MachineModel,
                           unroll: int = 1,
                           checkpoint: Optional[Callable[[str], None]] = None,
                           diagnose: bool = False) -> Analysis:
    """Rung 2: optimistic throughput only (the full-throughput model).

    No DAG, no CP/LCD sweeps, and no min-max scheduler — just cost
    resolution and the uniform-split port accumulation, the cheapest answer
    that still says something about port pressure.
    """
    check = checkpoint or _no_checkpoint
    check("resolve")
    costs = model.resolve_kernel(kernel)
    check("tp")
    tp = throughput_from_costs(costs, model, balanced=False)
    analysis = Analysis(kernel=kernel, model=model, unroll=unroll,
                        tp=tp, cp=None, lcd=None,
                        degradation="tp_only",
                        stages_completed=_RUNG_STAGES["tp_only"])
    if diagnose:
        analysis.findings = diagnose_analysis(analysis)
    return analysis


def analyze_kernel_parse_only(kernel: Kernel, model: MachineModel,
                              unroll: int = 1,
                              diagnose: bool = False) -> Analysis:
    """Rung 3: parse-level summary only — always answers.

    The kernel is already parsed when this runs (parsing failures are their
    own error class), so this rung never touches the machine DB and cannot
    time out: the floor of the degradation ladder.
    """
    analysis = Analysis(kernel=kernel, model=model, unroll=unroll,
                        tp=None, cp=None, lcd=None,
                        degradation="parse_only",
                        stages_completed=_RUNG_STAGES["parse_only"])
    if diagnose:
        # Nothing resolved → every emitter guards to empty, but `()` still
        # distinguishes "pass ran" from "pass not requested".
        analysis.findings = diagnose_analysis(analysis)
    return analysis


def analyze_kernel_rung(kernel: Kernel, model: MachineModel, unroll: int = 1,
                        rung: str = "full",
                        checkpoint: Optional[Callable[[str], None]] = None,
                        predictors=None, diagnose: bool = False,
                        device=None) -> Analysis:
    """Run exactly one ladder rung (``full`` / ``bracket`` / ``tp_only`` /
    ``parse_only``).  ``predictors`` filters the ``full`` and ``bracket``
    rungs; the cheaper rungs are already fixed subsets, and run no tensor
    pass, so ``device`` reaches only the first two."""
    device = resolve_device(device)
    if rung == "full":
        return analyze_kernel(kernel, model, unroll, checkpoint=checkpoint,
                              predictors=predictors, diagnose=diagnose,
                              device=device)
    if rung == "bracket":
        return analyze_kernel_bracket(kernel, model, unroll,
                                      checkpoint=checkpoint,
                                      predictors=predictors,
                                      diagnose=diagnose, device=device)
    if rung == "tp_only":
        return analyze_kernel_tp_only(kernel, model, unroll,
                                      checkpoint=checkpoint,
                                      diagnose=diagnose)
    if rung == "parse_only":
        return analyze_kernel_parse_only(kernel, model, unroll,
                                         diagnose=diagnose)
    raise ValueError(
        f"unknown degradation rung '{rung}'; known: {DEGRADATION_LADDER}")


def analyze_kernel_ladder(kernel: Kernel, model: MachineModel, unroll: int = 1,
                          checkpoint: Optional[Callable[[str], None]] = None,
                          min_rung: str = "parse_only",
                          predictors=None, diagnose: bool = False,
                          device=None) -> Analysis:
    """Walk the degradation ladder: try each rung down to ``min_rung``.

    A rung that raises (deadline expiry at a stage boundary, injected fault,
    analysis error) falls through to the next cheaper rung; ``parse_only``
    runs without checkpoints and therefore always answers.  Raises the last
    rung's error only when ``min_rung`` cuts the ladder short.
    """
    if min_rung not in DEGRADATION_LADDER:
        raise ValueError(
            f"unknown degradation rung '{min_rung}'; known: "
            f"{DEGRADATION_LADDER}")
    # Resolved before the first rung: a missing card must raise, not send
    # the ladder down to the rungs that run no tensor pass.
    device = resolve_device(device)
    floor = DEGRADATION_LADDER.index(min_rung)
    last_error: Optional[BaseException] = None
    for rung in DEGRADATION_LADDER[:floor + 1]:
        try:
            return analyze_kernel_rung(kernel, model, unroll, rung=rung,
                                       checkpoint=checkpoint,
                                       predictors=predictors,
                                       diagnose=diagnose, device=device)
        except Exception as exc:  # noqa: BLE001 — fall one rung
            last_error = exc
    assert last_error is not None
    raise last_error


# -- batch API + process-level analysis cache --------------------------------


class LRUCache:
    """Small thread-safe LRU with hit/miss stats for the analysis cache
    (``repro.serving.analysis`` shares the reference's)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._data: "OrderedDict[tuple, Analysis]" = OrderedDict()
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0}

    def get(self, key):
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                self._data.move_to_end(key)
                self.stats["hits"] += 1
            return hit

    def put(self, key, value) -> None:
        """Record a miss and insert its result, evicting oldest entries."""
        with self._lock:
            self.stats["misses"] += 1
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)

    def count_extra_hits(self, n: int = 1) -> None:
        """Account for requests satisfied by in-flight dedup (no lookup)."""
        with self._lock:
            self.stats["hits"] += n

    def evict(self, key) -> bool:
        """Drop one entry (fault injection simulates cache loss this way)."""
        with self._lock:
            return self._data.pop(key, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.stats["hits"] = self.stats["misses"] = 0


_cache = LRUCache(512)


def _mem_sig(refs) -> str:
    # Address-register structure of load/store operands: build_dag derives
    # address dependencies and writeback defs from these, so they are part
    # of a form's analysis identity.
    return ";".join(
        f"{ref.base.name if ref.base else ''}+"
        f"{ref.index.name if ref.index else ''}*{ref.scale}+{ref.offset}"
        f":{int(ref.post_index)}{int(ref.pre_index)}"
        for ref in refs)


def _form_text(form) -> str:
    # Parsed kernels carry the assembly text; programmatically built forms
    # (empty ``raw``) need a descriptor covering everything the analyses
    # read, or distinct kernels would collide in the cache.
    if form.raw:
        return form.raw
    return (f"{form.mnemonic}:{form.operand_signature()}"
            f":{','.join(form.source_registers)}"
            f">{','.join(form.dest_registers)}"
            f":{int(form.is_branch)}{int(form.is_dep_breaking)}"
            f"|L{_mem_sig(form.loads)}|S{_mem_sig(form.stores)}")


def _cache_key(kernel: Kernel, model: MachineModel, unroll: int,
               predictors: Tuple[str, ...] = PREDICTORS,
               diagnose: bool = False, measurements=None,
               device_type: str = "cpu") -> tuple:
    # ``diagnose`` participates: a cached plain analysis must not satisfy a
    # diagnose=True request (its findings would be None, not computed).
    # ``measurements`` participates as the corpus content digest: the cached
    # object is measurement-clean, but drift findings on diagnose=True views
    # depend on which corpus was joined.  The device type participates so a
    # result computed on the host never answers a request for the card.
    text = "\n".join(_form_text(form) for form in kernel)
    digest = measurements.digest if measurements is not None else ""
    return (model.name, kernel.isa, unroll, predictors, bool(diagnose),
            digest, device_type, text)


def clear_analysis_cache() -> None:
    _cache.clear()


def analyze_kernels(
    kernels: Iterable[Kernel],
    model: MachineModel,
    options=None,
    use_cache: bool = True,
    device=None,
    **legacy,
) -> List[Analysis]:
    """Analyze a batch of kernels against one machine model on ``device``.

    Knobs arrive as one ``options=AnalyzeOptions(...)`` object (legacy
    ``unroll=``/``predictors=``/``diagnose=``/``measurements=`` kwargs keep
    working with a DeprecationWarning; a bare int ``options`` is treated as
    the old positional ``unroll``).

    Repeated kernel texts (the common case on a serving path: many requests
    for the same hot loop) hit a process-level LRU keyed by
    ``(model name, isa, unroll, predictors, diagnose, corpus digest, device
    type, kernel text)``; all misses share the model's warm
    instruction-lookup memo, so a batch of *n* distinct kernels pays the
    instruction-DB probing cost once per distinct instruction form, not once
    per occurrence.

    Cache-identity caveat: machine models are assumed immutable after
    construction and distinguished by ``model.name`` (mutating a model's DB
    in place after analyses have been cached serves stale results).  A cache
    hit returns a per-request *view* carrying the requester's ``kernel.name``
    (the underlying TP/CP/LCD results are shared).  Measured ground truth
    (``options.measurements``) is likewise applied per-request on the view —
    the corpus matches by kernel *name*, while the cache matches by kernel
    *text*, so the cached object itself stays measurement-clean.

    Cache misses are dispatched as one wave through the batched engine
    (:func:`repro_torch.core.analysis.batch.analyze_wave`) on ``device`` —
    bit-identical to a sequential ``analyze_kernel`` loop, including with
    ``use_cache=False``, where the whole batch is one wave.  A batch mixing
    ISAs is rejected: the wave engine stacks one model's port/graph layout,
    so callers must split per ISA (one model analyzes one ISA's kernels —
    cross-ISA *requests* are a serving-layer concern).
    """
    from repro_torch.core.analysis.batch import analyze_wave

    device = resolve_device(device)
    if isinstance(options, int):  # legacy positional unroll
        legacy.setdefault("unroll", options)
        options = None
    opts = AnalyzeOptions.coerce(options, legacy, where="analyze_kernels")
    opts = opts.resolved(model.name)
    unroll, preds, diagnose = opts.unroll, opts.predictors, opts.diagnose
    corpus = opts.measurements

    kernels = list(kernels)
    if not kernels:
        return []
    isas = {kernel.isa for kernel in kernels}
    if len(isas) > 1:
        raise ValueError(
            f"mixed-ISA batch: kernels span {sorted(isas)}; analyze_kernels "
            f"dispatches one wave per machine model — split the batch per "
            f"ISA")
    if not use_cache:
        wave = analyze_wave(kernels, model, unroll=unroll, predictors=preds,
                            diagnose=diagnose, device=device)
        if corpus is None:
            return wave
        return [apply_measurement(analysis, corpus)
                for analysis in wave]

    out: List[Optional[Analysis]] = [None] * len(kernels)
    pending: Dict[tuple, int] = {}  # key -> slot of first in-wave occurrence
    dup_of: Dict[int, int] = {}     # slot -> first-occurrence slot
    miss_ix: List[int] = []
    miss_keys: List[tuple] = []
    for i, kernel in enumerate(kernels):
        key = _cache_key(kernel, model, unroll, preds, diagnose, corpus,
                         device.type)
        p = pending.get(key)
        if p is not None:
            # Sequentially this would have been a cache hit on the result the
            # first occurrence just inserted; account for it as one.
            dup_of[i] = p
            _cache.count_extra_hits(1)
            continue
        hit = _cache.get(key)
        if hit is not None:
            out[i] = _requester_view(hit, kernel.name, corpus)
            continue
        pending[key] = i
        miss_ix.append(i)
        miss_keys.append(key)

    if miss_ix:
        wave = analyze_wave([kernels[i] for i in miss_ix], model,
                            unroll=unroll, predictors=preds,
                            diagnose=diagnose, device=device)
        for slot, key, analysis in zip(miss_ix, miss_keys, wave):
            _cache.put(key, analysis)  # measurement-clean
            out[slot] = _requester_view(analysis, kernels[slot].name, corpus)
    for i, p in dup_of.items():
        out[i] = _requester_view(out[p], kernels[i].name, corpus)
    return out  # type: ignore[return-value]


#: Sentinel for ``analysis_view(measured=...)``: keep the measured fields of
#: the underlying analysis as-is (``None`` is a real value — "clear them").
_KEEP = object()


def analysis_view(analysis: Analysis, name: str, measured=_KEEP,
                  measured_source: str = "") -> Analysis:
    """A shallow per-request view of a shared ``Analysis`` whose kernel
    carries the requester's name (results objects are shared, not copied).

    ``measured``/``measured_source`` attach (or, with ``None``, clear) the
    measured-corpus ground truth on the view.  When the measured value
    changes and the diagnostics pass ran on the underlying analysis, the
    findings are recomputed so ``PREDICTION_DRIFT`` reflects the view's own
    measurement — the cached analysis underneath stays untouched.
    """
    same_measured = (measured is _KEEP
                     or (measured == analysis.measured_block
                         and (measured_source or "") ==
                         analysis.measured_source))
    if analysis.kernel.name == name and same_measured:
        return analysis
    kernel = analysis.kernel if analysis.kernel.name == name \
        else replace(analysis.kernel, name=name)
    view = replace(analysis, kernel=kernel)
    if not same_measured:
        view.measured_block = measured
        view.measured_source = measured_source if measured is not None else ""
        if analysis.findings is not None:
            view.findings = diagnose_analysis(view)
        # No memo stamping: the view's report differs from the shared one.
        return view
    memo = analysis.__dict__.get("_report_memo")
    if memo is not None:
        # Stamp the shared report snapshot with the requester's name: rows
        # and chains are immutable tuples, so the view costs O(1).
        view.__dict__["_report_memo"] = replace(memo, kernel_name=name)
    return view


def apply_measurement(analysis: Analysis, corpus,
                      name: Optional[str] = None) -> Analysis:
    """Per-request view of ``analysis`` joined against ``corpus`` under the
    requester's ``name`` (default: the analysis' own kernel name).

    With no corpus this degrades to a plain rename view; with a corpus the
    measured value is looked up by ``(name, unroll)`` — a miss *clears* any
    measured fields (the view must reflect this corpus, not a previous one).
    """
    name = name if name is not None else analysis.kernel.name
    if corpus is None:
        return analysis_view(analysis, name)
    entry = corpus.lookup(name, analysis.unroll)
    if entry is None:
        return analysis_view(analysis, name, measured=None)
    return analysis_view(
        analysis, name,
        measured=entry.measured_cy_per_it * analysis.unroll,
        measured_source=entry.source or f"measured:{corpus.arch}")


def _requester_view(analysis: Analysis, name: str, corpus) -> Analysis:
    """Hit/miss/dup slots all leave the cache through this one gate."""
    return apply_measurement(analysis, corpus, name)
