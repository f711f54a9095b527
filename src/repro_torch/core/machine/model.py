"""Declarative out-of-order port model (paper §II).

A :class:`MachineModel` is a set of named issue ports plus an instruction
database mapping instruction forms to ``(latency, port pressure)``.  Port
pressure follows the paper's fixed-probability rule: an instruction form that
may execute on *n* equivalent ports with inverse throughput *t* contributes
``t/n`` cycles to each of them (helper :func:`uniform`); forms with known
µ-op→port mappings carry explicit per-port cycles instead.

Memory-operand splitting (paper §II): an arithmetic instruction with a memory
source/destination is decomposed into its arithmetic part plus the machine's
generic load/store part; pressures add, and the load becomes a separate DAG
vertex carrying the load latency (§II-C rule 4).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.isa.instruction import InstructionForm
from repro_torch.core.machine.window import WindowParams

# Unknown (model name, mnemonic:signature) pairs already warned about, so a
# missing entry is reported once per process instead of per occurrence.
_WARNED_DEFAULTS: set = set()


def uniform(ports: Tuple[str, ...], inverse_throughput: float = 1.0) -> Dict[str, float]:
    """Fixed-probability pressure: spread ``inverse_throughput`` cycles evenly."""
    share = inverse_throughput / len(ports)
    return {p: share for p in ports}


#: One µ-op: ``(cycles, eligible ports)`` — ``cycles`` of work that may be
#: scheduled fractionally across any of the named ports.
Uop = Tuple[float, Tuple[str, ...]]


@dataclass(frozen=True)
class DBEntry:
    """Instruction-database record for one instruction form.

    ``pressure`` is the paper's fixed-probability per-port split (the
    *optimistic* uniform model).  ``uops``, when present, is the richer form:
    the instruction's µ-ops with their *eligible port sets*, which the
    min-max scheduler (:mod:`repro_torch.core.analysis.scheduler`) assigns
    kernel-globally.  Entries without ``uops`` (pre-baked per-port floats)
    are treated as already assigned: each ``pressure`` item is pinned to its
    port, so the balanced bound degenerates to the optimistic one.
    """

    latency: float
    pressure: Mapping[str, float]
    # Inverse throughput in cycles (informational; the pressure already
    # encodes it).  Defaults to the pressure sum.
    throughput: Optional[float] = None
    note: str = ""
    uops: Optional[Tuple[Uop, ...]] = None

    @property
    def inverse_throughput(self) -> float:
        if self.throughput is not None:
            return self.throughput
        return max(self.pressure.values()) if self.pressure else 0.0

    def combined_with(self, other: "DBEntry", note: str = "") -> "DBEntry":
        pressure = dict(self.pressure)
        for port, cy in other.pressure.items():
            pressure[port] = pressure.get(port, 0.0) + cy
        uops = None
        if self.uops is not None or other.uops is not None:
            uops = (pressure_uops(self.pressure) if self.uops is None
                    else self.uops)
            uops += (pressure_uops(other.pressure) if other.uops is None
                     else other.uops)
        return DBEntry(latency=self.latency, pressure=pressure, note=note,
                       uops=uops)


def pressure_uops(pressure: Mapping[str, float]) -> Tuple[Uop, ...]:
    """Pre-baked per-port floats as already-assigned (single-port) µ-ops."""
    return tuple((cy, (port,)) for port, cy in pressure.items() if cy)


def uops_entry(latency: float, uops, throughput: Optional[float] = None,
               note: str = "") -> DBEntry:
    """Build a :class:`DBEntry` from µ-ops with eligible port sets.

    The uniform-split ``pressure`` is derived (``cycles / len(ports)`` on each
    eligible port), so an entry converted from ``uniform()`` form keeps its
    optimistic per-port numbers bit-identical.
    """
    norm: list = []
    pressure: Dict[str, float] = {}
    for cycles, ports in uops:
        ports = tuple(ports)
        if not ports:
            raise ValueError("µ-op with empty eligible port set")
        norm.append((float(cycles), ports))
        share = float(cycles) / len(ports)
        for p in ports:
            pressure[p] = pressure.get(p, 0.0) + share
    return DBEntry(latency=latency, pressure=pressure, throughput=throughput,
                   note=note, uops=tuple(norm))


@dataclass
class InstructionCost:
    """Resolved cost of one parsed instruction, after memory splitting."""

    form: InstructionForm
    entry: DBEntry  # arithmetic/primary part (node latency for CP/LCD)
    load: Optional[DBEntry] = None  # split-off load part, if any
    store: Optional[DBEntry] = None  # split-off store part, if any
    fused_away: bool = False  # macro-fused compare: contributes no pressure
    # True when no DB entry matched and the machine default was used: every
    # number derived from this cost is a guess, which the diagnostics pass
    # surfaces as a DB_COVERAGE_GAP finding.
    defaulted: bool = False
    # Memo for ``total_pressure``: costs are immutable after resolution and
    # shared across kernels by the model's lookup memo, so the combined
    # pressure dict is built once per distinct cost.  Callers treat the dict
    # as read-only.
    _pressure_memo: Optional[Dict[str, float]] = field(
        default=None, repr=False, compare=False)

    @property
    def total_pressure(self) -> Dict[str, float]:
        memo = self._pressure_memo
        if memo is not None:
            return memo
        if self.fused_away:
            pressure: Dict[str, float] = {}
        else:
            pressure = dict(self.entry.pressure)
            for part in (self.load, self.store):
                if part is not None:
                    for port, cy in part.pressure.items():
                        pressure[port] = pressure.get(port, 0.0) + cy
        self._pressure_memo = pressure
        return pressure


@dataclass
class MachineModel:
    name: str
    isa: str  # "x86" | "aarch64"
    ports: Tuple[str, ...]
    db: Dict[str, DBEntry]
    # Generic split parts for memory operands embedded in arithmetic forms.
    load_entry: DBEntry = None  # type: ignore[assignment]
    store_entry: DBEntry = None  # type: ignore[assignment]
    # cmp/test + conditional-jump macro fusion (Intel/AMD x86 cores).
    macro_fusion: bool = False
    fused_branch_pressure: Mapping[str, float] = field(default_factory=dict)
    default_entry: DBEntry = field(
        default_factory=lambda: DBEntry(latency=1.0, pressure={}, note="default")
    )
    frequency_ghz: float = 2.5
    # Out-of-order window capacities for the point-prediction simulator
    # (repro_torch.core.sim).  ``None`` means "no window model": the simulator is
    # skipped for this machine and analyses fall back to the [TP, CP] bracket.
    window: Optional[WindowParams] = None
    # Memoized lookup results keyed by (mnemonic, signature, has_loads,
    # has_stores): repeated instruction forms (every copy of every unrolled
    # instance) resolve to the same (entry, load, store, defaulted) parts,
    # so probing the DB once per distinct form is enough.
    _lookup_cache: Dict[tuple, tuple] = field(
        default_factory=dict, repr=False, compare=False)
    # Running count of default-entry fallbacks per ``mnemonic:signature``
    # form, bumped on *every* lookup (memo hits included) so callers can
    # diff the counter around a resolve and attribute gaps per analysis.
    fallbacks: Dict[str, int] = field(
        default_factory=dict, repr=False, compare=False)

    # -- lookup ------------------------------------------------------------

    def lookup(self, form: InstructionForm) -> InstructionCost:
        """Resolve a parsed instruction form to its cost record.

        Lookup order: exact ``mnemonic:signature``; the signature with memory
        operands substituted by their register class (plus generic load/store
        split); bare ``mnemonic``; machine default (with a warning, once per
        unknown ``(model, mnemonic:signature)`` pair).
        """
        sig = form.operand_signature()
        cache_key = (form.mnemonic, sig, bool(form.loads), bool(form.stores))
        parts = self._lookup_cache.get(cache_key)
        if parts is None:
            entry, load, store, defaulted = self._lookup_parts(form, sig)
            # Precompute the combined pressure once per distinct parts entry
            # (same construction order as ``total_pressure``); every cost
            # built from this entry shares the dict read-only.
            pressure = dict(entry.pressure)
            for part in (load, store):
                if part is not None:
                    for port, cy in part.pressure.items():
                        pressure[port] = pressure.get(port, 0.0) + cy
            parts = (entry, load, store, defaulted, pressure)
            # Crude bound for long-lived serving processes fed caller-
            # controlled asm: distinct unknown forms must not grow the memo
            # (and the warn-once set below) without limit.
            if len(self._lookup_cache) >= 1 << 16:
                self._lookup_cache.clear()
            self._lookup_cache[cache_key] = parts
        entry, load, store, defaulted, pressure = parts
        if defaulted:
            form_key = f"{form.mnemonic}:{sig}"
            if len(self.fallbacks) >= 1 << 16:
                self.fallbacks.clear()
            self.fallbacks[form_key] = self.fallbacks.get(form_key, 0) + 1
        return InstructionCost(form=form, entry=entry, load=load, store=store,
                               defaulted=defaulted, _pressure_memo=pressure)

    def _lookup_parts(self, form: InstructionForm, sig: str):
        """Uncached DB probe; returns ``(entry, load, store, defaulted)``."""
        key = f"{form.mnemonic}:{sig}"
        if key in self.db:
            return self.db[key], None, None, False

        if "m" in sig:
            # Try register-form entry + split load/store µ-ops.
            for repl in ("f", "r", "v"):
                reg_key = f"{form.mnemonic}:{sig.replace('m', repl)}"
                if reg_key in self.db:
                    return (self.db[reg_key],
                            self.load_entry if form.loads else None,
                            self.store_entry if form.stores else None,
                            False)

        if form.mnemonic in self.db:
            return self.db[form.mnemonic], None, None, False

        # Mnemonic-family fallback (e.g. ``b.ne`` -> ``b``).
        family = form.mnemonic.split(".")[0]
        if family in self.db:
            return self.db[family], None, None, False

        if (self.name, key) not in _WARNED_DEFAULTS:
            if len(_WARNED_DEFAULTS) >= 1 << 16:
                _WARNED_DEFAULTS.clear()
            _WARNED_DEFAULTS.add((self.name, key))
            warnings.warn(
                f"[{self.name}] no DB entry for '{key}'; using default "
                f"(latency={self.default_entry.latency})",
                stacklevel=3,
            )
        return self.default_entry, None, None, True

    def resolve_kernel(self, kernel) -> Tuple[InstructionCost, ...]:
        """Resolve all instructions, applying macro fusion peepholes."""
        costs = [self.lookup(form) for form in kernel]
        if self.macro_fusion:
            for i in range(len(costs) - 1):
                a, b = costs[i], costs[i + 1]
                if a.form.mnemonic.startswith(("cmp", "test")) and b.form.is_branch:
                    costs[i] = InstructionCost(form=a.form, entry=a.entry,
                                               fused_away=True,
                                               defaulted=a.defaulted)
                    costs[i + 1] = InstructionCost(
                        form=b.form,
                        entry=DBEntry(
                            latency=b.entry.latency,
                            pressure=dict(self.fused_branch_pressure),
                            note="macro-fused cmp+jcc",
                        ),
                        defaulted=b.defaulted,
                    )
        return tuple(costs)
