"""Pluggable renderers for :class:`~repro_torch.core.analysis.report.AnalysisReport`.

Built-ins: ``text`` (the condensed Table-II-style report, byte-identical to
the legacy ``Analysis.report()`` output for assembly kernels), ``json`` (the
stable ``to_dict`` schema), and ``markdown``.  Register additional formats
with :func:`register_renderer`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

RENDERERS: Dict[str, Callable] = {}


def register_renderer(name: str, fn: Callable) -> None:
    RENDERERS[name] = fn


def render(report, fmt: str = "text") -> str:
    try:
        renderer = RENDERERS[fmt]
    except KeyError:
        raise ValueError(
            f"unknown report format '{fmt}'; known: {sorted(RENDERERS)}"
        ) from None
    return renderer(report)


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------


def _shown_ports(report) -> List[str]:
    return [p for p in report.ports
            if report.port_pressure.get(p, 0.0) > 0.0
            or report.balanced_port_load.get(p, 0.0) > 0.0]


def _sim_detail(report) -> str:
    conv = (f"steady after {report.sim_copies} copies"
            if report.sim_converged
            else f"unconverged at {report.sim_copies} copies")
    clamp = (f", clamped to {report.sim_clamped.upper()}"
             if report.sim_clamped else "")
    limiter = f", {report.sim_limiter}-limited" if report.sim_limiter else ""
    return f"point prediction ({conv}{limiter}{clamp})"


#: Fixed-width footer labels per predictor id (text renderer).
_TEXT_LABELS = {
    "optimistic": "TP  (optimistic) ",
    "balanced": "TP  (balanced)   ",
    "lcd": "LCD (expected)   ",
    "cp": "CP  (upper bound)",
    "sim": "sim (window OoO) ",
    "measured": "measured         ",
}


def _prediction_rows(report) -> List[Tuple[str, Optional[float], str]]:
    """Footer rows ``(predictor id, per-it value, detail)`` iterated off
    ``report.predictions`` — one surface for every renderer, with the LCD
    expected value spliced between the bracket bounds where it always sat.
    Bounds always render (0.0 on degraded rungs); the point predictions
    (``sim``, ``measured``) render only when they produced a value."""
    per_it = report.predictions_per_it()
    details = {
        "optimistic": (f"bottleneck port {report.bottleneck_port}  "
                       f"(uniform split)"),
        "balanced": (f"bottleneck port {report.balanced_bottleneck}  "
                     f"(min-max optimal assignment; headline lower bound)"),
        "lcd": f"{len(report.lcd_chains)} cyclic chain(s) found",
        "cp": "",
        "sim": _sim_detail(report),
        "measured": (f"ground truth "
                     f"({report.measured_source or 'measured corpus'})"),
    }
    rows: List[Tuple[str, Optional[float], str]] = []
    for pid in ("optimistic", "balanced", "lcd", "cp", "sim", "measured"):
        value = report.lcd_per_it if pid == "lcd" else per_it[pid]
        if value is None and pid in ("sim", "measured"):
            continue
        rows.append((pid, value, details[pid]))
    return rows


def _text_asm(report) -> str:
    shown_ports = _shown_ports(report)
    head = " ".join(f"{p:>5}" for p in shown_ports)
    lines: List[str] = []
    lines.append(f"OSACA analysis  kernel={report.kernel_name}  "
                 f"arch={report.arch}  unroll={report.unroll}x")
    lines.append(f"{head} | {'LCD':>5} {'CP':>5} | {'LN':>4} | assembly")
    lines.append("-" * (len(head) + 32))
    for row in report.rows:
        cells = " ".join(
            f"{row.port_pressure.get(p, 0.0):5.2f}"
            if row.port_pressure.get(p, 0.0) else "     "
            for p in shown_ports
        )
        lcd_mark = f"{row.latency:5.1f}" if row.on_lcd else "     "
        cp_mark = f"{row.latency:5.1f}" if row.on_critical_path else "     "
        lines.append(f"{cells} | {lcd_mark} {cp_mark} | {row.line_number:>4} | "
                     f"{row.asm}")
    lines.append("-" * (len(head) + 32))
    totals = " ".join(f"{report.port_pressure.get(p, 0.0):5.2f}"
                      for p in shown_ports)
    lines.append(f"{totals} | {report.lcd_block:5.1f} {report.cp_block:5.1f} | "
                 f"(per {report.unroll}x-unrolled block)")
    per_it = " ".join(
        f"{report.port_pressure.get(p, 0.0) / report.unroll:5.2f}"
        for p in shown_ports
    )
    lines.append(f"{per_it} | {report.lcd_per_it:5.1f} {report.cp_per_it:5.1f} | "
                 f"per high-level iteration")
    balanced = " ".join(f"{report.balanced_port_load.get(p, 0.0):5.2f}"
                        for p in shown_ports)
    lines.append(f"{balanced} | {'':5} {'':5} | "
                 f"balanced port load (optimal µ-op schedule, per block)")
    lines.append("")
    for pid, value, detail in _prediction_rows(report):
        suffix = f"   {detail}" if detail else ""
        lines.append(f"{_TEXT_LABELS[pid]}: {value:6.2f} cy/it{suffix}")
    if report.degraded:
        stages = ",".join(report.stages_completed) or "(parse only)"
        lines.append("")
        lines.append(f"DEGRADED answer: rung={report.degradation}  "
                     f"stages completed: {stages} — numbers above cover "
                     f"only those stages (the rest read 0)")
    if report.findings is not None:
        lines.append("")
        if report.findings:
            lines.append(f"Diagnostics ({len(report.findings)} finding(s)):")
            for f in report.findings:
                anchor = (f"  [lines {','.join(map(str, f.lines))}]"
                          if f.lines else "")
                lines.append(f"  [{f.severity}] {f.code}: {f.message}{anchor}")
        else:
            lines.append("Diagnostics: no findings")
    return "\n".join(lines)


def _text_hlo(report) -> str:
    lines: List[str] = []
    lines.append(f"OSACA analysis  module={report.kernel_name}  "
                 f"arch={report.arch}  (HLO)")
    lines.append("engine pressure (roofline terms):")
    for port in report.ports:
        lines.append(f"  {port:>4}: {report.port_pressure.get(port, 0.0) * 1e3:9.4f} ms")
    lines.append(f"critical path ({len(report.rows)} ops):")
    for row in sorted(report.rows, key=lambda r: -r.latency)[:8]:
        lcd_mark = " LCD" if row.on_lcd else "    "
        lines.append(f"  {row.latency * 1e3:9.4f} ms{lcd_mark}  "
                     f"{row.mnemonic:<22} {row.asm}")
    lines.append("")
    lines.append(f"TP  (roofline bound): {report.tp_block * 1e3:9.4f} ms/step  "
                 f"bottleneck engine {report.bottleneck_port}")
    lines.append(f"LCD (expected)     : {report.lcd_block * 1e3:9.4f} ms/step  "
                 f"{len(report.lcd_chains)} carried chain(s) found")
    lines.append(f"CP  (upper bound)  : {report.cp_block * 1e3:9.4f} ms/step")
    return "\n".join(lines)


def render_text(report) -> str:
    return _text_hlo(report) if report.kind == "hlo" else _text_asm(report)


# ---------------------------------------------------------------------------
# json / markdown
# ---------------------------------------------------------------------------


def render_json(report) -> str:
    return report.to_json(indent=2, sort_keys=True)


def render_markdown(report) -> str:
    unit = "ms" if report.kind == "hlo" else "cy"
    scale = 1e3 if report.kind == "hlo" else 1.0
    shown_ports = _shown_ports(report)
    lines: List[str] = []
    lines.append(f"### OSACA analysis — `{report.kernel_name}` on "
                 f"`{report.arch}` (unroll {report.unroll}x)")
    lines.append("")
    lines.append("| # | " + " | ".join(shown_ports) +
                 " | LCD | CP | assembly |")
    lines.append("|---|" + "---|" * (len(shown_ports) + 3))
    for row in report.rows:
        cells = " | ".join(
            f"{row.port_pressure.get(p, 0.0):.2f}"
            if row.port_pressure.get(p, 0.0) else ""
            for p in shown_ports
        )
        lcd = f"{row.latency * scale:.1f}" if row.on_lcd else ""
        cp = f"{row.latency * scale:.1f}" if row.on_critical_path else ""
        lines.append(f"| {row.index} | {cells} | {lcd} | {cp} | "
                     f"`{row.asm}` |")
    lines.append("")
    if report.kind == "hlo":
        bracket = report.prediction_bracket()
        lines.append(f"- **TP** (lower bound): "
                     f"{bracket['lower_bound_tp'] * scale:.2f} {unit}/it — "
                     f"bottleneck `{report.bottleneck_port}`")
        lines.append(f"- **LCD** (expected): "
                     f"{bracket['expected_lcd'] * scale:.2f} {unit}/it — "
                     f"{len(report.lcd_chains)} cyclic chain(s)")
        lines.append(f"- **CP** (upper bound): "
                     f"{bracket['upper_bound_cp'] * scale:.2f} {unit}/it")
    else:
        util = ", ".join(
            f"`{p}`={report.balanced_port_load.get(p, 0.0):.2f}"
            for p in shown_ports)
        md_lines = {
            "optimistic": (f"- **TP** (optimistic): "
                           f"{{v:.2f}} {unit}/it — uniform port split, "
                           f"bottleneck `{report.bottleneck_port}`"),
            "balanced": (f"- **TP** (balanced): "
                         f"{{v:.2f}} {unit}/it — optimal µ-op→port "
                         f"assignment (headline lower bound), bottleneck "
                         f"`{report.balanced_bottleneck}`; per-block port "
                         f"load: {util}"),
            "lcd": (f"- **LCD** (expected): {{v:.2f}} {unit}/it — "
                    f"{len(report.lcd_chains)} cyclic chain(s)"),
            "cp": f"- **CP** (upper bound): {{v:.2f}} {unit}/it",
            "sim": (f"- **sim** (point prediction): {{v:.2f}} {unit}/it — "
                    f"window-limited OoO simulation ("
                    + ("converged" if report.sim_converged else "unconverged")
                    + (f", {report.sim_limiter}-limited"
                       if report.sim_limiter else "")
                    + (f", clamped to {report.sim_clamped.upper()}"
                       if report.sim_clamped else "") + ")"),
            "measured": (f"- **measured**: {{v:.2f}} {unit}/it — ground "
                         f"truth "
                         f"({report.measured_source or 'measured corpus'})"),
        }
        for pid, value, _ in _prediction_rows(report):
            lines.append(md_lines[pid].format(v=value * scale))
    if report.degraded:
        stages = ", ".join(report.stages_completed) or "parse only"
        lines.append(f"- **DEGRADED** — rung `{report.degradation}`; "
                     f"stages completed: {stages}")
    if report.findings is not None:
        lines.append("")
        lines.append(f"#### Diagnostics ({len(report.findings)} finding(s))")
        if report.findings:
            for f in report.findings:
                anchor = (f" _(lines {', '.join(map(str, f.lines))})_"
                          if f.lines else "")
                lines.append(f"- **{f.severity}** `{f.code}` — "
                             f"{f.message}{anchor}")
        else:
            lines.append("- no findings")
    return "\n".join(lines)


register_renderer("text", render_text)
register_renderer("json", render_json)
register_renderer("markdown", render_markdown)
