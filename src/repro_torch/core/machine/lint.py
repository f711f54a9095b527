"""Machine-DB / ISA consistency linter (``python -m repro_torch.core.machine.lint``).

Every prediction this repo makes is driven by hand-maintained machine
description tables — latencies, µ-op port sets, window capacities, the arch
registry's alias map.  Kerncraft (arXiv:1509.03778) treats machine-description
validation as a first-class pass for exactly this reason: a typo'd port name
or a negative latency does not crash anything, it silently corrupts every
bound downstream.  This module cross-checks the tables statically:

Per machine model (:func:`lint_model`):

``UNDECLARED_PORT``      a µ-op port set or pressure entry names a port the
                         model never declared (work charged to nowhere).
``DUPLICATE_PORT``       the declared port tuple repeats a name.
``NEGATIVE_LATENCY``     an entry's latency is negative or NaN.
``IMPLAUSIBLE_LATENCY``  latency above :data:`MAX_PLAUSIBLE_LATENCY` cycles
                         (warning — nothing on a real core is that slow
                         short of a page walk).
``NEGATIVE_PRESSURE``    a per-port pressure value is negative or NaN.
``EMPTY_UOP_PORTS``      a µ-op with no eligible port (unschedulable work).
``UOP_PRESSURE_MISMATCH``the stored uniform-split pressure disagrees with
                         what the entry's µ-ops derive (the two models the
                         analyses read would disagree with each other).
``THROUGHPUT_INCONSISTENT`` an explicit inverse throughput below what the
                         entry's own µ-ops can sustain (or negative).
``WINDOW_BOUNDS``        ``WindowParams`` violates its validated ordering
                         (a constructor bypass — the simulator would model
                         nonsense capacities).
``NO_WINDOW``            no window parameters (warning: the simulator is
                         skipped for this machine).
``FUSION_NO_PRESSURE``   macro fusion enabled but no fused-branch pressure
                         (fused pairs would execute for free).
``BAD_FREQUENCY``        non-positive clock frequency.

Registry (:func:`lint_registry`):

``ALIAS_CYCLE``          alias resolution loops without reaching a
                         registered id.
``DANGLING_ALIAS``       an alias maps to an id the registry doesn't hold.
``SELF_RESOLUTION``      a registered id whose own normalized name resolves
                         to a different id.
``NO_PARSER``            a non-HLO spec without a parser.
``MODEL_MISMATCH``       the spec's isa/id disagree with the model its
                         factory builds.

Run as a CI gate::

    python -m repro_torch.core.machine.lint --strict

``--strict`` fails on warnings too; the default fails only on errors.
"""

from __future__ import annotations

import argparse
import math
import sys
from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.core.machine.model import DBEntry, MachineModel

#: Per-entry latencies above this many cycles are flagged as implausible
#: (warning).  The slowest shipped entry is a 23-cycle divide; a hundred-
#: cycle-plus "latency" is almost always a typo'd extra digit.
MAX_PLAUSIBLE_LATENCY = 128.0

#: Tolerance when comparing derived vs stored pressure (both come from the
#: same float arithmetic, so exact-ish agreement is expected).
_TOL = 1e-9


@dataclass(frozen=True)
class LintIssue:
    """One linter diagnostic."""

    severity: str  # "error" | "warning"
    arch: str  # model name or "registry"
    code: str
    subject: str  # DB key / alias / field the issue anchors to
    message: str

    def __str__(self) -> str:
        return (f"[{self.severity}] {self.arch}: {self.code} ({self.subject}) "
                f"— {self.message}")


def _bad_number(value) -> bool:
    try:
        return math.isnan(float(value))
    except (TypeError, ValueError):
        return True


def _entry_min_throughput(entry: DBEntry) -> float:
    """The fastest inverse throughput the entry's own work allows: the
    min-max makespan of its µ-ops considered alone."""
    from repro_torch.core.analysis.scheduler import min_max_load
    classes: Dict[frozenset, float] = {}
    if entry.uops is not None:
        pairs = [(cy, tuple(ports)) for cy, ports in entry.uops]
    else:
        pairs = [(cy, (port,)) for port, cy in entry.pressure.items()]
    for cycles, ports in pairs:
        if not ports or not cycles:
            continue
        key = frozenset(ports)
        classes[key] = classes.get(key, 0.0) + float(cycles)
    if not classes:
        return 0.0
    return min_max_load(classes).bound


def _lint_entry(arch: str, key: str, entry: DBEntry,
                declared: frozenset) -> List[LintIssue]:
    issues: List[LintIssue] = []

    def err(code: str, message: str) -> None:
        issues.append(LintIssue("error", arch, code, key, message))

    def warn(code: str, message: str) -> None:
        issues.append(LintIssue("warning", arch, code, key, message))

    if _bad_number(entry.latency) or entry.latency < 0:
        err("NEGATIVE_LATENCY", f"latency {entry.latency!r} is not a "
            f"non-negative number")
    elif entry.latency > MAX_PLAUSIBLE_LATENCY:
        warn("IMPLAUSIBLE_LATENCY",
             f"latency {entry.latency:g} cy exceeds the plausibility cap "
             f"{MAX_PLAUSIBLE_LATENCY:g} — typo'd digit?")

    for port, cy in entry.pressure.items():
        if port not in declared:
            err("UNDECLARED_PORT",
                f"pressure names undeclared port '{port}' "
                f"(declared: {', '.join(sorted(declared))})")
        if _bad_number(cy) or cy < 0:
            err("NEGATIVE_PRESSURE",
                f"pressure on '{port}' is {cy!r}, not a non-negative number")

    if entry.uops is not None:
        derived: Dict[str, float] = {}
        for cycles, ports in entry.uops:
            if not ports:
                err("EMPTY_UOP_PORTS",
                    f"µ-op of {cycles!r} cy has an empty eligible port set "
                    f"(unschedulable work)")
                continue
            if _bad_number(cycles) or cycles < 0:
                err("NEGATIVE_PRESSURE",
                    f"µ-op cycles {cycles!r} is not a non-negative number")
                continue
            share = float(cycles) / len(ports)
            for port in ports:
                if port not in declared:
                    err("UNDECLARED_PORT",
                        f"µ-op names undeclared port '{port}' "
                        f"(declared: {', '.join(sorted(declared))})")
                derived[port] = derived.get(port, 0.0) + share
        stored = {p: cy for p, cy in entry.pressure.items() if cy}
        derived = {p: cy for p, cy in derived.items() if cy}
        if set(stored) != set(derived) or any(
                abs(stored[p] - derived[p]) > _TOL for p in stored):
            err("UOP_PRESSURE_MISMATCH",
                f"stored uniform-split pressure {stored} disagrees with the "
                f"µ-op derivation {derived}; the optimistic and balanced "
                f"bounds would read different machines")

    if entry.throughput is not None:
        if _bad_number(entry.throughput) or entry.throughput < 0:
            err("THROUGHPUT_INCONSISTENT",
                f"explicit inverse throughput {entry.throughput!r} is not a "
                f"non-negative number")
        else:
            floor = _entry_min_throughput(entry)
            if entry.throughput < floor - _TOL:
                err("THROUGHPUT_INCONSISTENT",
                    f"explicit inverse throughput {entry.throughput:g} cy is "
                    f"below the {floor:g} cy its own µ-ops sustain at best")
    return issues


def lint_model(model: MachineModel) -> List[LintIssue]:
    """All issues for one machine model (DB entries + window + structure)."""
    issues: List[LintIssue] = []
    arch = model.name

    def err(code: str, subject: str, message: str) -> None:
        issues.append(LintIssue("error", arch, code, subject, message))

    def warn(code: str, subject: str, message: str) -> None:
        issues.append(LintIssue("warning", arch, code, subject, message))

    declared = frozenset(model.ports)
    if len(model.ports) != len(declared):
        dupes = sorted({p for p in model.ports if model.ports.count(p) > 1})
        err("DUPLICATE_PORT", "ports",
            f"port tuple repeats {', '.join(dupes)}")
    if not declared:
        err("DUPLICATE_PORT", "ports", "model declares no ports")

    entries: List[Tuple[str, Optional[DBEntry]]] = list(model.db.items())
    entries += [("<load_entry>", model.load_entry),
                ("<store_entry>", model.store_entry),
                ("<default_entry>", model.default_entry)]
    for key, entry in entries:
        if entry is None:
            err("MISSING_ENTRY", key, "entry is None")
            continue
        issues.extend(_lint_entry(arch, key, entry, declared))

    for port, cy in dict(model.fused_branch_pressure).items():
        if port not in declared:
            err("UNDECLARED_PORT", "<fused_branch_pressure>",
                f"names undeclared port '{port}'")
        if _bad_number(cy) or cy < 0:
            err("NEGATIVE_PRESSURE", "<fused_branch_pressure>",
                f"pressure on '{port}' is {cy!r}")
    if model.macro_fusion and not any(model.fused_branch_pressure.values()):
        warn("FUSION_NO_PRESSURE", "<fused_branch_pressure>",
             "macro fusion enabled but fused branches carry no port "
             "pressure — fused pairs would execute for free")

    if _bad_number(model.frequency_ghz) or model.frequency_ghz <= 0:
        err("BAD_FREQUENCY", "frequency_ghz",
            f"clock frequency {model.frequency_ghz!r} GHz is not positive")

    if model.window is None:
        warn("NO_WINDOW", "window",
             "no window parameters — the OoO simulator is skipped for this "
             "machine")
    else:
        try:
            model.window.validate()
        except ValueError as exc:
            err("WINDOW_BOUNDS", "window", str(exc))
    return issues


def lint_registry(names: Optional[Mapping[str, str]] = None,
                  registry: Optional[Mapping] = None) -> List[LintIssue]:
    """Consistency of the arch registry's alias table.

    ``names`` / ``registry`` default to live snapshots
    (:func:`repro_torch.core.registry.registry_snapshot`); tests inject corrupted
    tables to prove each check fires.
    """
    from repro_torch.core.registry import _normalize, registry_snapshot
    if names is None or registry is None:
        live_names, live_registry = registry_snapshot()
        names = live_names if names is None else names
        registry = live_registry if registry is None else registry
    issues: List[LintIssue] = []

    def err(code: str, subject: str, message: str) -> None:
        issues.append(LintIssue("error", "registry", code, subject, message))

    for alias, target in sorted(names.items()):
        # Follow the resolution chain: alias → id; a healthy table reaches a
        # registered id whose own normalized name maps to itself in one hop.
        seen = []
        current = alias
        while True:
            if current in seen:
                err("ALIAS_CYCLE", alias,
                    f"resolution loops: {' -> '.join(seen + [current])}")
                break
            seen.append(current)
            target_id = names.get(current)
            if target_id is None:
                err("DANGLING_ALIAS", alias,
                    f"chain reaches '{current}', which is not in the alias "
                    f"table")
                break
            if target_id in registry:
                break
            current = _normalize(target_id)

    for arch_id, spec in sorted(registry.items()):
        normalized = _normalize(arch_id)
        if names.get(normalized) != arch_id:
            err("SELF_RESOLUTION", arch_id,
                f"id normalizes to '{normalized}', which resolves to "
                f"{names.get(normalized)!r} instead of itself")
        if not getattr(spec, "is_hlo", False) and spec.parser is None:
            err("NO_PARSER", arch_id, "non-HLO spec has no parser")
    return issues


def lint_arch(spec) -> List[LintIssue]:
    """Lint one registry spec: build its model and cross-check spec ↔ model."""
    issues: List[LintIssue] = []
    model = spec.model_factory()
    if not isinstance(model, MachineModel):
        issues.append(LintIssue(
            "error", spec.id, "MODEL_MISMATCH", "model_factory",
            f"factory produced {type(model).__name__}, not a MachineModel"))
        return issues
    if model.isa != spec.isa:
        issues.append(LintIssue(
            "error", spec.id, "MODEL_MISMATCH", "isa",
            f"spec isa '{spec.isa}' but model isa '{model.isa}'"))
    if model.name != spec.id:
        issues.append(LintIssue(
            "error", spec.id, "MODEL_MISMATCH", "name",
            f"spec id '{spec.id}' but model name '{model.name}'"))
    issues.extend(lint_model(model))
    return issues


def lint_all(arch_ids: Optional[Iterable[str]] = None) -> List[LintIssue]:
    """Registry table + every (requested) asm machine model."""
    from repro_torch.core.registry import asm_arch_ids, get_arch
    issues = lint_registry()
    for arch_id in (arch_ids if arch_ids is not None else asm_arch_ids()):
        issues.extend(lint_arch(get_arch(arch_id)))
    return issues


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.machine.lint",
        description="Statically cross-check the machine DBs and the arch "
                    "registry for consistency.")
    ap.add_argument("archs", nargs="*",
                    help="arch ids/aliases to lint (default: all asm archs)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings too, not only errors")
    args = ap.parse_args(argv)

    issues = lint_all(args.archs or None)
    errors = [i for i in issues if i.severity == "error"]
    warnings_ = [i for i in issues if i.severity == "warning"]
    for issue in issues:
        print(issue)
    from repro_torch.core.registry import asm_arch_ids
    checked = args.archs or asm_arch_ids()
    print(f"lint: {len(checked)} machine DB(s) + registry checked — "
          f"{len(errors)} error(s), {len(warnings_)} warning(s)")
    failed = bool(errors) or (args.strict and bool(warnings_))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
