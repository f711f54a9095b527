"""Bottleneck diagnostics: from numbers to explanations (ROADMAP north star).

The analyses bracket a kernel's steady-state cost, but a bare number does not
say *why* the kernel is slow or what to do about it.  This pass walks a
finished :class:`~repro_torch.core.analysis.analyze.Analysis` — the resolved costs,
the port-assignment solution, the LCD sweep, and the simulator trace — and
emits structured :class:`Finding` objects with a stable ``code``, a severity,
instruction-line anchors, a human-readable message, and a machine-readable
payload.  uiCA (arXiv:2107.14210) demonstrates the value of this kind of
sensitivity/bottleneck attribution for making throughput predictions
actionable; this is that layer over our bracket.

Finding codes (stable; new codes are additive):

``LCD_BOTTLENECK``
    The longest loop-carried dependency chain, naming its member
    instructions and each member's latency contribution to the cycle.
``PORT_HOTSPOT``
    The saturated port(s) under the optimal µ-op→port assignment, plus the
    eligibility classes whose work cannot escape them.
``DB_COVERAGE_GAP``
    Instruction forms that fell through every machine-DB probe to the
    default entry — their numbers are guesses, one finding per form.
``SIM_WINDOW_LIMITED``
    The window resource (frontend issue width / ROB / scheduler / LSQ) that
    bound the simulator's point prediction, with its capacity.
``SIM_CLAMPED``
    The simulator's raw steady state fell outside [TP, max(TP, CP)] and the
    headline prediction was clamped to a bracket edge.
``UNROLL_ADVICE``
    TP ⋘ CP: latency-bound code where unrolling would expose more
    independent work, with a suggested factor and the LCD floor.
``PREDICTION_DRIFT``
    Measured ground truth (joined from a measurement corpus) fell outside
    the [TP(balanced), max(TP, CP)] bracket, or the point prediction's
    error against it regressed past :data:`DRIFT_APE_THRESHOLD`.

Findings are deterministic for a given analysis (the ``DB_COVERAGE_GAP``
emitter reads the ``defaulted`` flags recorded on the resolved costs, not
the process-wide warn-once state) and ordered by (severity, code, first
anchor line).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.analysis.scheduler import gather_classes

#: Severity levels, most severe first (the report sort order).
SEVERITIES: Tuple[str, ...] = ("warning", "advice", "info")
_SEVERITY_RANK = {s: i for i, s in enumerate(SEVERITIES)}

#: Relative slack when comparing cycle quantities (water-filling levels are
#: exact up to float noise).
_REL_TOL = 1e-6

#: CP at least this multiple of the balanced TP marks latency-bound code
#: worth unrolling (the "TP ⋘ CP" trigger).
UNROLL_ADVICE_RATIO = 2.0

#: Cap on the suggested unroll factor: beyond this, register pressure and
#: frontend limits dominate anything the dependence structure promises.
MAX_SUGGESTED_UNROLL = 8

#: A point prediction whose absolute percentage error against the measured
#: value exceeds this fraction triggers PREDICTION_DRIFT even when the
#: measurement still sits inside the bracket.  25% is well past the MAPE
#: uiCA-class models report (single digits) — drift, not noise.
DRIFT_APE_THRESHOLD = 0.25

#: Simulator limiter values that name a finite window resource, mapped to
#: (human name, WindowParams field holding its capacity).
_WINDOW_RESOURCES: Dict[str, Tuple[str, str]] = {
    "frontend": ("frontend issue width", "issue_width"),
    "rob": ("re-order buffer", "rob_size"),
    "scheduler": ("scheduler queue", "sched_size"),
    "lsq": ("load/store queue", "lsq_size"),
}


@dataclass(frozen=True)
class Finding:
    """One structured diagnostic emitted by :func:`diagnose`.

    ``payload`` holds only plain JSON types (numbers, strings, bools, lists,
    dicts) so a finding round-trips bit-identically through the report's
    ``to_dict``/``from_dict``.
    """

    code: str
    severity: str  # one of SEVERITIES
    message: str
    lines: Tuple[int, ...] = ()  # source line-number anchors
    instrs: Tuple[int, ...] = ()  # kernel body instruction indices
    payload: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "lines": list(self.lines),
            "instrs": list(self.instrs),
            "payload": dict(self.payload),
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "Finding":
        return cls(
            code=data["code"], severity=data["severity"],
            message=data["message"], lines=tuple(data.get("lines", ())),
            instrs=tuple(data.get("instrs", ())),
            payload=dict(data.get("payload", {})),
        )


def diagnose(analysis) -> Tuple[Finding, ...]:
    """All findings for one analysis, ordered most severe first.

    Works on any degradation rung: emitters that need a stage the rung did
    not run simply contribute nothing (absence of a finding never means the
    stage proved its absence — check ``stages_completed``).
    """
    findings: List[Finding] = []
    findings.extend(_lcd_bottleneck(analysis))
    findings.extend(_port_hotspot(analysis))
    findings.extend(_db_coverage_gap(analysis))
    findings.extend(_sim_findings(analysis))
    findings.extend(_unroll_advice(analysis))
    findings.extend(_prediction_drift(analysis))
    findings.sort(key=lambda f: (_SEVERITY_RANK.get(f.severity, len(SEVERITIES)),
                                 f.code, f.lines[:1] or (1 << 30,)))
    return tuple(findings)


def _costs(analysis):
    """Resolved per-instruction costs, or ``None`` below the tp rung."""
    if analysis.tp is None:
        return None
    return [cost for cost, _ in analysis.tp.per_instruction]


# -- LCD_BOTTLENECK ----------------------------------------------------------


def _lcd_bottleneck(analysis) -> List[Finding]:
    lcd = analysis.lcd
    costs = _costs(analysis)
    if lcd is None or not lcd.chains or costs is None:
        return []
    chain = lcd.chains[0]  # longest period
    edges = []
    for idx in chain.instr_indices:
        cost = costs[idx]
        edges.append({
            "index": idx,
            "line": cost.form.line_number,
            "mnemonic": cost.form.mnemonic,
            "latency": cost.entry.latency,
        })
    contributed = sum(e["latency"] for e in edges)
    # Split-load µ-ops on the chain carry latency but are not body members;
    # the residual attributes what the member latencies alone don't cover.
    residual = chain.length - contributed
    if abs(residual) <= _REL_TOL * max(chain.length, 1.0):
        residual = 0.0
    per_it = chain.length / max(analysis.unroll, 1)
    dominates = (analysis.tp is not None
                 and chain.length > analysis.tp.balanced_throughput
                 * (1.0 + _REL_TOL))
    path = " -> ".join(e["mnemonic"] for e in edges)
    message = (
        f"loop-carried dependency chain of {chain.length:.2f} cy/block "
        f"({per_it:.2f} cy/it) through {path}, carried back by instruction "
        f"{chain.carried_by}"
    )
    if residual:
        message += f" (+{residual:.2f} cy from split load µ-ops on the chain)"
    message += ("; the chain, not port pressure, bounds the steady state"
                if dominates else
                "; port pressure still dominates this chain")
    return [Finding(
        code="LCD_BOTTLENECK",
        severity="warning" if dominates else "info",
        message=message,
        lines=tuple(e["line"] for e in edges),
        instrs=tuple(chain.instr_indices),
        payload={
            "chain_cycles": chain.length,
            "per_iteration": per_it,
            "carried_by": chain.carried_by,
            "edges": edges,
            "residual_cycles": residual,
            "dominates_throughput": dominates,
            "n_chains": len(lcd.chains),
        },
    )]


# -- PORT_HOTSPOT ------------------------------------------------------------


def _port_hotspot(analysis) -> List[Finding]:
    tp = analysis.tp
    costs = _costs(analysis)
    if tp is None or costs is None or tp.balanced_throughput <= 0.0:
        return []
    bound = tp.balanced_throughput
    load = tp.balanced_port_load
    ports = tuple(analysis.model.ports)
    hot = [p for p in ports
           if load.get(p, 0.0) >= bound * (1.0 - _REL_TOL)]
    if not hot:
        return []
    hot_set = frozenset(hot)
    # Eligibility classes whose work cannot escape the hot set — the demand
    # that pins the water level there.
    saturating = []
    for eligible, cycles in sorted(gather_classes(costs).items(),
                                   key=lambda kv: (-kv[1], sorted(kv[0]))):
        if eligible <= hot_set and cycles > 0.0:
            saturating.append({"ports": sorted(eligible), "cycles": cycles})
    anchors = [(i, cost.form.line_number) for i, cost in enumerate(costs)
               if any(p in hot_set for p in cost.total_pressure)]
    lcd_block = analysis.lcd.longest if analysis.lcd is not None else 0.0
    # Ports are *the* bottleneck only when no dependency chain is longer.
    dominates = bound >= lcd_block * (1.0 - _REL_TOL)
    message = (
        f"port{'s' if len(hot) > 1 else ''} {', '.join(hot)} saturated at "
        f"{bound:.2f} cy/block under the optimal µ-op assignment; "
        f"{sum(c['cycles'] for c in saturating):.2f} cy of work is pinned to "
        f"{{{', '.join(sorted(hot_set))}}}"
    )
    message += ("; this resource limit bounds the steady state" if dominates
                else "; a longer dependency chain still dominates")
    return [Finding(
        code="PORT_HOTSPOT",
        severity="warning" if dominates else "info",
        message=message,
        lines=tuple(line for _, line in anchors),
        instrs=tuple(i for i, _ in anchors),
        payload={
            "bound": bound,
            "hot_ports": hot,
            "port_load": {p: load.get(p, 0.0) for p in ports},
            "utilization": {p: load.get(p, 0.0) / bound for p in ports},
            "saturating_classes": saturating,
            "dominates": dominates,
        },
    )]


# -- DB_COVERAGE_GAP ---------------------------------------------------------


def _db_coverage_gap(analysis) -> List[Finding]:
    costs = _costs(analysis)
    if costs is None:
        return []
    by_form: Dict[str, List[Tuple[int, int]]] = {}
    for idx, cost in enumerate(costs):
        if cost.defaulted:
            key = f"{cost.form.mnemonic}:{cost.form.operand_signature()}"
            by_form.setdefault(key, []).append((idx, cost.form.line_number))
    findings = []
    model = analysis.model
    for form_key in sorted(by_form):
        sites = by_form[form_key]
        findings.append(Finding(
            code="DB_COVERAGE_GAP",
            severity="warning",
            message=(
                f"no {model.name} DB entry for '{form_key}': default cost "
                f"(latency {model.default_entry.latency:g}, no port "
                f"pressure) used for {len(sites)} instruction(s) — every "
                f"bound involving them is a guess"
            ),
            lines=tuple(line for _, line in sites),
            instrs=tuple(idx for idx, _ in sites),
            payload={
                "form": form_key,
                "arch": model.name,
                "count": len(sites),
                "default_latency": model.default_entry.latency,
            },
        ))
    return findings


# -- SIM_WINDOW_LIMITED / SIM_CLAMPED ----------------------------------------


def _sim_findings(analysis) -> List[Finding]:
    sim = analysis.sim
    if sim is None:
        return []
    findings = []
    resource = _WINDOW_RESOURCES.get(sim.limiter)
    if resource is not None and sim.window is not None:
        name, attr = resource
        capacity = getattr(sim.window, attr)
        findings.append(Finding(
            code="SIM_WINDOW_LIMITED",
            severity="info",
            message=(
                f"point prediction ({sim.cy_per_block:.2f} cy/block) is "
                f"limited by the {name} ({attr}={capacity}): the out-of-order "
                f"window, not ports or dependencies, binds the steady state"
            ),
            payload={
                "limiter": sim.limiter,
                "resource": name,
                "capacity_field": attr,
                "capacity": capacity,
                "cy_per_block": sim.cy_per_block,
                "window": sim.window.to_dict(),
            },
        ))
    if sim.clamped_to:
        edge = "TP lower bound" if sim.clamped_to == "tp" else "CP upper bound"
        findings.append(Finding(
            code="SIM_CLAMPED",
            severity="info",
            message=(
                f"simulator steady state measured {sim.raw_cy_per_block:.2f} "
                f"cy/block outside the bracket; headline prediction clamped "
                f"to the {edge} ({sim.cy_per_block:.2f} cy/block, "
                f"{sim.limiter or 'unknown'}-limited)"
            ),
            payload={
                "raw_block": sim.raw_cy_per_block,
                "clamped_block": sim.cy_per_block,
                "edge": sim.clamped_to,
                "limiter": sim.limiter,
                "converged": sim.converged,
            },
        ))
    return findings


# -- UNROLL_ADVICE -----------------------------------------------------------


def _unroll_advice(analysis) -> List[Finding]:
    tp, cp = analysis.tp, analysis.cp
    if tp is None or cp is None:
        return []
    unroll = max(analysis.unroll, 1)
    tp_it = tp.balanced_throughput / unroll
    cp_it = cp.length / unroll
    if tp_it <= 0.0 or cp_it < UNROLL_ADVICE_RATIO * tp_it:
        return []
    lcd_it = (analysis.lcd.longest / unroll
              if analysis.lcd is not None else 0.0)
    suggested = min(MAX_SUGGESTED_UNROLL,
                    max(2, math.ceil(cp_it / tp_it)))
    floor_it = max(tp_it, lcd_it)
    message = (
        f"latency-bound: CP {cp_it:.2f} cy/it is {cp_it / tp_it:.1f}x the "
        f"balanced TP bound {tp_it:.2f} cy/it — ports sit idle waiting on "
        f"dependencies; unrolling ~{suggested}x exposes more independent "
        f"work"
    )
    if lcd_it > tp_it * (1.0 + _REL_TOL):
        message += (f" (floor: the loop-carried chain still costs "
                    f"{lcd_it:.2f} cy/it)")
    return [Finding(
        code="UNROLL_ADVICE",
        severity="advice",
        message=message,
        payload={
            "tp_balanced_per_it": tp_it,
            "cp_per_it": cp_it,
            "ratio": cp_it / tp_it,
            "suggested_unroll": suggested,
            "floor_per_it": floor_it,
            "lcd_per_it": lcd_it,
        },
    )]


# -- PREDICTION_DRIFT --------------------------------------------------------


def _prediction_drift(analysis) -> List[Finding]:
    """Measured ground truth disagrees with the model.

    Fires when a measurement joined from a corpus falls outside the
    [TP(balanced), max(TP, CP)] bracket — the paper's headline claim is that
    measurements land inside it — or when the point prediction (sim when it
    ran, else LCD, else the balanced bound) misses the measurement by more
    than :data:`DRIFT_APE_THRESHOLD`.  Either way the *model* has drifted
    from the machine: a DB latency is stale, a port map is wrong, or the
    measurement itself deserves a second look.
    """
    measured = getattr(analysis, "measured_block", None)
    tp = analysis.tp
    if measured is None or measured <= 0.0 or tp is None:
        return []
    unroll = max(analysis.unroll, 1)
    lower = tp.balanced_throughput
    upper = max(lower, analysis.cp.length) if analysis.cp is not None else None
    if analysis.sim is not None:
        point_id, point = "sim", analysis.sim.cy_per_block
    elif analysis.lcd is not None and analysis.lcd.longest > 0.0:
        point_id, point = "lcd", analysis.lcd.longest
    else:
        point_id, point = "balanced", lower
    ape = abs(point - measured) / measured
    source = getattr(analysis, "measured_source", "") or "measured corpus"

    below = measured < lower * (1.0 - _REL_TOL)
    above = upper is not None and measured > upper * (1.0 + _REL_TOL)
    if below or above:
        bound = (f"below the TP(balanced) lower bound {lower:.2f}" if below
                 else f"above the max(TP, CP) upper bound {upper:.2f}")
        message = (
            f"measured {measured:.2f} cy/block "
            f"({measured / unroll:.2f} cy/it, {source}) falls {bound} "
            f"cy/block — the machine model has drifted from the hardware"
        )
    elif ape > DRIFT_APE_THRESHOLD:
        message = (
            f"point prediction ({point_id}) {point:.2f} cy/block misses the "
            f"measured {measured:.2f} cy/block ({source}) by "
            f"{ape * 100.0:.0f}% (threshold "
            f"{DRIFT_APE_THRESHOLD * 100.0:.0f}%) — inside the bracket, but "
            f"the calibrated accuracy has regressed"
        )
    else:
        return []
    return [Finding(
        code="PREDICTION_DRIFT",
        severity="warning",
        message=message,
        payload={
            "measured_block": measured,
            "measured_per_it": measured / unroll,
            "measured_source": source,
            "lower_bound_block": lower,
            "upper_bound_block": upper,
            "in_bracket": not (below or above),
            "point_predictor": point_id,
            "point_block": point,
            "ape": ape,
            "ape_threshold": DRIFT_APE_THRESHOLD,
        },
    )]
