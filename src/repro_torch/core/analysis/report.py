"""Serializable analysis report: the wire format of the public API.

:class:`AnalysisReport` is a plain-data snapshot of one TP/CP/LCD analysis —
per-instruction rows (port pressure, CP / LCD membership), the per-port
totals, and the [TP, LCD, CP] prediction bracket — detached from the live
``Kernel`` / ``MachineModel`` objects so it can round-trip through JSON
(``to_dict`` / ``from_dict``) and be rendered by any registered renderer
(``render("text" | "json" | "markdown")``, see ``repro_torch.core.analysis.render``).

Both front-ends produce it: :meth:`AnalysisReport.from_analysis` wraps the
assembly pipeline's ``Analysis`` (``kind="asm"``, cycles per iteration), and
:meth:`AnalysisReport.from_hlo` wraps the accelerator adaptation
(``kind="hlo"``, seconds per step, on the H100 engine model) — same schema,
same bracket keys, so a downstream tool can consume an HLO while-body and an
asm loop identically.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.core.analysis.diagnostics import Finding

#: v2 adds the balanced (min-max optimal port assignment) throughput bound:
#: ``tp_balanced_block``, ``balanced_port_load``, ``balanced_bottleneck``.
#: v1 payloads load with ``balanced == optimistic`` (v1 predates the
#: scheduler, when the uniform split was the only model).
#:
#: v2 additive (same version, defaulted on load): ``degraded``,
#: ``degradation``, ``stages_completed`` — the serving path's degradation
#: ladder marks partial answers (``tp_only`` / ``parse_only`` rungs) so a
#: caller can always tell a degraded report from a full one.
#:
#: v3 adds the window-limited OoO simulator's point prediction:
#: ``sim_block`` (clamped into the [TP, CP] bracket; ``None`` when the
#: simulator did not run), ``sim_raw_block`` (unclamped steady state),
#: ``sim_converged`` / ``sim_copies`` / ``sim_clamped`` / ``sim_limiter``,
#: and ``sim_window`` (the per-arch window parameters used).  v1/v2
#: payloads load with ``sim_block=None``.
#:
#: v4 adds ``findings`` — the structured bottleneck diagnostics
#: (:mod:`repro_torch.core.analysis.diagnostics`).  ``None`` means the diagnostics
#: pass did not run (absence ≠ zero findings: an empty list is a clean bill
#: of health, ``None`` says nobody looked); v1/v2/v3 payloads load with
#: ``findings=None``.
#:
#: v5 adds the measured-corpus join (``measured_block`` /
#: ``measured_source``; ``None``/``""`` when no corpus entry matched — v1–v4
#: payloads load that way), the uniform ``predictions`` mapping (serialized
#: derived, keyed by :data:`PREDICTOR_IDS`), and promotes the *balanced*
#: (min-max optimal assignment) throughput to the headline bracket lower
#: bound — ``prediction_bracket()["lower_bound_tp"]`` is now the balanced
#: per-iteration bound (key name kept for wire compatibility; the optimistic
#: bound stays available as ``tp_block`` / ``predictions["optimistic"]``).
SCHEMA_VERSION = 5

#: All pipeline stages, the ``stages_completed`` value of a full report.
FULL_STAGES = ("resolve", "tp", "dag", "cp", "lcd", "sim")

#: What a full report completed before the simulator existed (schema <= 2);
#: the ``stages_completed`` default for payloads that predate the field.
_LEGACY_FULL_STAGES = ("resolve", "tp", "dag", "cp", "lcd")

#: Bracket keys shared by both kinds — the paper's [TP, CP] runtime bracket
#: with the LCD as the expected value.
BRACKET_KEYS = ("lower_bound_tp", "expected_lcd", "upper_bound_cp")

#: Predictor ids of the uniform ``report.predictions`` mapping (schema v5),
#: display order.  ``measured`` is ground truth, not a predictor, but lives
#: in the mapping so renderers/consumers can iterate one surface.
PREDICTOR_IDS = ("optimistic", "balanced", "cp", "sim", "measured")


@dataclass(frozen=True)
class InstructionRow:
    """One analyzed instruction (asm) or critical-path op (hlo)."""

    index: int
    line_number: int
    asm: str  # raw assembly text / HLO op name
    mnemonic: str
    latency: float  # node latency in cycles (asm) or seconds (hlo)
    port_pressure: Dict[str, float]
    on_critical_path: bool
    on_lcd: bool


@dataclass(frozen=True)
class LCDChainRow:
    """One cyclic loop-carried chain (one period's length)."""

    length: float
    members: Tuple = ()  # instruction indices (asm) / op names (hlo)
    carried_by: object = None  # closing instr index (asm) / tuple index (hlo)


@dataclass(frozen=True)
class AnalysisReport:
    """Typed, JSON-stable result of one kernel analysis."""

    kind: str  # "asm" | "hlo"
    kernel_name: str
    arch: str
    isa: str
    unroll: int
    frequency_ghz: float
    unit: str  # "cy/it" (asm) | "s" (hlo)
    ports: Tuple[str, ...]
    rows: Tuple[InstructionRow, ...]
    port_pressure: Dict[str, float]  # per-block totals, model port order
    bottleneck_port: str
    tp_block: float  # optimistic bound, per assembly-block / per step
    cp_block: float
    lcd_block: float
    lcd_chains: Tuple[LCDChainRow, ...] = ()
    # Balanced bound: min-max optimal µ-op→port assignment (schema v2).
    tp_balanced_block: float = 0.0
    balanced_port_load: Dict[str, float] = field(default_factory=dict)
    balanced_bottleneck: str = ""
    # Degradation ladder (schema v2, additive): a degraded report carries
    # only the numbers its rung computed; the rest are 0.0.
    degraded: bool = False
    degradation: str = "full"  # "full" | "bracket" | "tp_only" | "parse_only"
    stages_completed: Tuple[str, ...] = FULL_STAGES
    # Window-limited OoO simulator point prediction (schema v3).  Unlike the
    # bounds, absence is meaningful (not requested / no window model / a
    # bracket-rung answer), so the headline value is Optional rather than 0.0.
    sim_block: Optional[float] = None
    sim_raw_block: Optional[float] = None  # unclamped steady-state measure
    sim_converged: bool = False
    sim_copies: int = 0
    sim_clamped: str = ""  # "" | "tp" | "cp"
    sim_limiter: str = ""  # dominant binding constraint at steady state
    sim_window: Dict[str, int] = field(default_factory=dict)
    # Structured bottleneck diagnostics (schema v4).  ``None`` = the
    # diagnostics pass did not run; ``()`` = it ran and found nothing.
    findings: Optional[Tuple[Finding, ...]] = None
    # Measured-corpus ground truth (schema v5): cy per block, like the
    # predictor blocks; ``None`` = no corpus entry matched this kernel.
    measured_block: Optional[float] = None
    measured_source: str = ""  # provenance, e.g. "paper-table1"
    schema_version: int = SCHEMA_VERSION

    # -- derived -----------------------------------------------------------

    @property
    def tp_per_it(self) -> float:
        return self.tp_block / self.unroll

    @property
    def cp_per_it(self) -> float:
        return self.cp_block / self.unroll

    @property
    def lcd_per_it(self) -> float:
        return self.lcd_block / self.unroll

    @property
    def tp_balanced_per_it(self) -> float:
        return self.tp_balanced_block / self.unroll

    @property
    def sim_per_it(self) -> Optional[float]:
        if self.sim_block is None:
            return None
        return self.sim_block / self.unroll

    @property
    def measured_per_it(self) -> Optional[float]:
        if self.measured_block is None:
            return None
        return self.measured_block / self.unroll

    @property
    def predictions(self) -> Dict[str, Optional[float]]:
        """Per-block predictor values keyed by :data:`PREDICTOR_IDS`.

        The uniform surface (schema v5) renderers and consumers iterate
        instead of hardcoding field names.  ``None`` marks a predictor that
        produced no value (sim not run, no measured corpus entry);
        the always-computed bounds are plain floats.
        """
        return {
            "optimistic": self.tp_block,
            "balanced": self.tp_balanced_block,
            "cp": self.cp_block,
            "sim": self.sim_block,
            "measured": self.measured_block,
        }

    def predictions_per_it(self) -> Dict[str, Optional[float]]:
        """:attr:`predictions` in per-high-level-iteration units."""
        return {pid: (block / self.unroll if block is not None else None)
                for pid, block in self.predictions.items()}

    def prediction_bracket(self) -> Dict[str, float]:
        """[TP, CP] runtime bracket with the LCD as the expected value.

        Since schema v5 the headline lower bound is the *balanced* TP (the
        tighter, calibrated bound); the ``lower_bound_tp`` key name is kept
        for wire compatibility.  Degraded rungs mirror optimistic into
        balanced, so the bracket stays well-defined everywhere.
        """
        return {
            "lower_bound_tp": self.tp_balanced_per_it,
            "expected_lcd": self.lcd_per_it,
            "upper_bound_cp": self.cp_per_it,
        }

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict:
        """Plain-JSON form; ``from_dict(to_dict())`` is bit-identical."""
        return {
            "schema_version": self.schema_version,
            "kind": self.kind,
            "kernel_name": self.kernel_name,
            "arch": self.arch,
            "isa": self.isa,
            "unroll": self.unroll,
            "frequency_ghz": self.frequency_ghz,
            "unit": self.unit,
            "ports": list(self.ports),
            "port_pressure": dict(self.port_pressure),
            "bottleneck_port": self.bottleneck_port,
            "tp_block": self.tp_block,
            "cp_block": self.cp_block,
            "lcd_block": self.lcd_block,
            "tp_balanced_block": self.tp_balanced_block,
            "balanced_port_load": dict(self.balanced_port_load),
            "balanced_bottleneck": self.balanced_bottleneck,
            "degraded": self.degraded,
            "degradation": self.degradation,
            "stages_completed": list(self.stages_completed),
            "sim_block": self.sim_block,
            "sim_raw_block": self.sim_raw_block,
            "sim_converged": self.sim_converged,
            "sim_copies": self.sim_copies,
            "sim_clamped": self.sim_clamped,
            "sim_limiter": self.sim_limiter,
            "sim_window": dict(self.sim_window),
            "findings": ([f.to_dict() for f in self.findings]
                         if self.findings is not None else None),
            "measured_block": self.measured_block,
            "measured_source": self.measured_source,
            # Derived views, serialized for consumers but not read back by
            # ``from_dict`` (the fields above are authoritative).
            "predictions": dict(self.predictions),
            "prediction_bracket": self.prediction_bracket(),
            "rows": [asdict(r) for r in self.rows],
            "lcd_chains": [
                {"length": c.length, "members": list(c.members),
                 "carried_by": c.carried_by}
                for c in self.lcd_chains
            ],
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "AnalysisReport":
        version = data.get("schema_version", SCHEMA_VERSION)
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"report schema v{version} is newer than supported "
                f"v{SCHEMA_VERSION}")
        rows = tuple(
            InstructionRow(
                index=r["index"], line_number=r["line_number"], asm=r["asm"],
                mnemonic=r["mnemonic"], latency=r["latency"],
                port_pressure=dict(r["port_pressure"]),
                on_critical_path=r["on_critical_path"], on_lcd=r["on_lcd"],
            ) for r in data["rows"])
        chains = tuple(
            LCDChainRow(length=c["length"], members=tuple(c["members"]),
                        carried_by=c["carried_by"])
            for c in data.get("lcd_chains", ()))
        return cls(
            kind=data["kind"], kernel_name=data["kernel_name"],
            arch=data["arch"], isa=data["isa"], unroll=data["unroll"],
            frequency_ghz=data["frequency_ghz"], unit=data["unit"],
            ports=tuple(data["ports"]),
            rows=rows, port_pressure=dict(data["port_pressure"]),
            bottleneck_port=data["bottleneck_port"],
            tp_block=data["tp_block"], cp_block=data["cp_block"],
            lcd_block=data["lcd_block"], lcd_chains=chains,
            # v1 compatibility: before the scheduler, the uniform split was
            # the only port model, so balanced defaults to optimistic.
            tp_balanced_block=data.get("tp_balanced_block",
                                       data["tp_block"]),
            balanced_port_load=dict(data.get("balanced_port_load",
                                             data["port_pressure"])),
            balanced_bottleneck=data.get("balanced_bottleneck",
                                         data["bottleneck_port"]),
            # Additive degradation fields: payloads written before the
            # ladder are, by construction, full reports.
            degraded=data.get("degraded", False),
            degradation=data.get("degradation", "full"),
            stages_completed=tuple(data.get("stages_completed",
                                            _LEGACY_FULL_STAGES)),
            # v3 simulator fields: pre-simulator payloads have no point
            # prediction, which None (not 0.0) states faithfully.
            sim_block=data.get("sim_block"),
            sim_raw_block=data.get("sim_raw_block"),
            sim_converged=data.get("sim_converged", False),
            sim_copies=data.get("sim_copies", 0),
            sim_clamped=data.get("sim_clamped", ""),
            sim_limiter=data.get("sim_limiter", ""),
            sim_window=dict(data.get("sim_window", {})),
            # v4 diagnostics: for older payloads, None states faithfully
            # that the pass never ran (absence ≠ zero findings).
            findings=(tuple(Finding.from_dict(f)
                            for f in data["findings"])
                      if data.get("findings") is not None else None),
            # v5 measured-corpus join: pre-calibration payloads simply had
            # no measurement attached.
            measured_block=data.get("measured_block"),
            measured_source=data.get("measured_source", ""),
            schema_version=version,
        )

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.to_dict(), **kwargs)

    @classmethod
    def from_json(cls, text: str) -> "AnalysisReport":
        return cls.from_dict(json.loads(text))

    def render(self, fmt: str = "text") -> str:
        from repro_torch.core.analysis.render import render
        return render(self, fmt)

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_analysis(cls, analysis) -> "AnalysisReport":
        """Snapshot an assembly-pipeline :class:`Analysis`.

        Degraded analyses (``tp_only`` / ``parse_only`` ladder rungs) carry
        only what their rung computed: a ``tp_only`` report has rows and
        optimistic port pressure but zero CP/LCD, a ``parse_only`` report
        has rows straight from the parsed forms with no pressure at all.
        """
        tp, cp, lcd = analysis.tp, analysis.cp, analysis.lcd
        cp_on = cp.on_path if cp is not None else frozenset()
        lcd_on = lcd.on_longest if lcd is not None else frozenset()
        rows = []
        if tp is not None:
            for idx, (cost, pressure) in enumerate(tp.per_instruction):
                rows.append(InstructionRow(
                    index=idx,
                    line_number=cost.form.line_number,
                    asm=cost.form.raw.strip(),
                    mnemonic=cost.form.mnemonic,
                    latency=cost.entry.latency,
                    port_pressure={p: cy for p, cy in pressure.items()},
                    on_critical_path=idx in cp_on,
                    on_lcd=idx in lcd_on,
                ))
        else:  # parse_only: rows from the parsed forms, no DB resolution
            for idx, form in enumerate(analysis.kernel):
                rows.append(InstructionRow(
                    index=idx,
                    line_number=form.line_number,
                    asm=form.raw.strip(),
                    mnemonic=form.mnemonic,
                    latency=0.0,
                    port_pressure={},
                    on_critical_path=False,
                    on_lcd=False,
                ))
        chains = tuple(
            LCDChainRow(length=c.length, members=tuple(c.instr_indices),
                        carried_by=c.carried_by)
            for c in lcd.chains) if lcd is not None else ()
        model = analysis.model
        sim = getattr(analysis, "sim", None)
        return cls(
            kind="asm",
            kernel_name=analysis.kernel.name,
            arch=model.name,
            isa=model.isa,
            unroll=analysis.unroll,
            frequency_ghz=model.frequency_ghz,
            unit="cy/it",
            ports=tuple(model.ports),
            rows=tuple(rows),
            port_pressure={p: tp.port_pressure.get(p, 0.0)
                           for p in model.ports} if tp is not None
            else {p: 0.0 for p in model.ports},
            bottleneck_port=tp.bottleneck_port if tp is not None else "",
            tp_block=tp.block_throughput if tp is not None else 0.0,
            cp_block=cp.length if cp is not None else 0.0,
            lcd_block=lcd.longest if lcd is not None else 0.0,
            lcd_chains=chains,
            tp_balanced_block=tp.balanced_throughput if tp is not None else 0.0,
            balanced_port_load={p: tp.balanced_port_load.get(p, 0.0)
                                for p in model.ports} if tp is not None
            else {p: 0.0 for p in model.ports},
            balanced_bottleneck=tp.balanced_bottleneck if tp is not None else "",
            degraded=analysis.degraded,
            degradation=analysis.degradation,
            stages_completed=tuple(analysis.stages_completed),
            sim_block=sim.cy_per_block if sim is not None else None,
            sim_raw_block=sim.raw_cy_per_block if sim is not None else None,
            sim_converged=sim.converged if sim is not None else False,
            sim_copies=sim.copies if sim is not None else 0,
            sim_clamped=sim.clamped_to if sim is not None else "",
            sim_limiter=sim.limiter if sim is not None else "",
            sim_window=(sim.window.to_dict()
                        if sim is not None and sim.window is not None else {}),
            findings=getattr(analysis, "findings", None),
            measured_block=getattr(analysis, "measured_block", None),
            measured_source=getattr(analysis, "measured_source", ""),
        )

    @classmethod
    def from_hlo(cls, source, chip=None, arch: str = "h100",
                 name: Optional[str] = None, device=None) -> "AnalysisReport":
        """Analyze an accelerator graph (HLO text, a parsed module, or a
        ``torch.export`` program) into the same report shape: roofline bound
        as TP, longest while-carried chain as LCD, def-use critical path as
        CP — all in seconds per step.  Only the LCD sweep runs on ``device``
        (``None``: the CUDA device, which raises when there is none)."""
        from repro_torch import resolve_device
        from repro_torch.core.hlo import (H100_SXM, hlo_critical_path,
                                          hlo_loop_carried)
        from repro_torch.core.hlo.costs import HLOCostModel
        from repro_torch.core.hlo.export import as_module
        from repro_torch.core.hlo.roofline import collective_stats

        device = resolve_device(device)
        chip = chip or H100_SXM
        module = as_module(source)
        if not module.computations or \
                module.entry_name not in module.computations:
            raise ValueError(
                f"not a valid HLO module: no entry computation parsed "
                f"(module name {module.name!r}) — is the dump truncated?")

        cost = HLOCostModel(module, chip)
        flops = cost.computation_flops(module.entry_name)
        hbm_bytes = sum(cost.op_bytes(op, module.entry)
                        for op in module.entry.ops)
        stats = collective_stats(module, chip)
        terms = chip.port_pressure(float(flops), float(hbm_bytes),
                                   stats.total_bytes)
        cp = hlo_critical_path(module, chip)
        lcd = hlo_loop_carried(module, chip, device=device)

        longest = lcd.longest
        lcd_ops = set(longest.ops) if longest is not None else set()
        rows = tuple(
            InstructionRow(
                index=i, line_number=-1, asm=node.op_name,
                mnemonic=node.opcode, latency=node.seconds, port_pressure={},
                on_critical_path=True, on_lcd=node.op_name in lcd_ops,
            ) for i, node in enumerate(cp.path))
        chains = tuple(
            LCDChainRow(length=c.total_seconds, members=tuple(c.ops),
                        carried_by=c.tuple_index)
            for c in lcd.chains)
        bottleneck = max(terms, key=lambda k: terms[k]) if terms else ""
        return cls(
            kind="hlo",
            kernel_name=name or module.name,
            arch=arch,
            isa="hlo",
            unroll=1,
            frequency_ghz=0.0,
            unit="s",
            ports=tuple(terms),
            rows=rows,
            port_pressure=dict(terms),
            bottleneck_port=bottleneck,
            tp_block=terms.get(bottleneck, 0.0),
            cp_block=cp.seconds,
            lcd_block=longest.total_seconds if longest is not None else 0.0,
            lcd_chains=chains,
            # Roofline terms are engine-pinned: no assignment freedom.
            tp_balanced_block=terms.get(bottleneck, 0.0),
            balanced_port_load=dict(terms),
            balanced_bottleneck=bottleneck,
            # The OoO simulator is an asm-pipeline concept; HLO reports
            # complete the legacy stage set and carry no point prediction.
            stages_completed=_LEGACY_FULL_STAGES,
        )
