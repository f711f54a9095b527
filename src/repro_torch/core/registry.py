"""Central architecture / ISA registry: the single source of truth that maps
an architecture id (or alias) to its ISA, parser, machine-model factory,
clock frequency, and built-in sample kernel.

Everything that needs to turn an ``--arch`` string into an analysis pipeline
(the ``repro_torch.api`` facade first of all) resolves through
:func:`get_arch`.

Alias matching is case-insensitive and ignores ``-``/``_``/spaces, so
``csx``, ``CLX``, ``cascadelake``, and ``cascade-lake`` all name the Cascade
Lake model.  Out-of-tree machines can be added at runtime with
:func:`register_arch`.

The five assembly targets of ``repro.core.registry`` are registered here.
Its ``tpu-v5e`` HLO entry is not: the port's accelerator target is ``h100``
(an engine model of the NVIDIA H100 SXM5, ``repro_torch.core.hlo``), which
takes HLO text and ``torch.export`` programs.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.isa import parse_aarch64, parse_x86
from repro_torch.core.machine import (cascade_lake, neoverse_n1, thunderx2, zen,
                                      zen2)
from repro_torch.core.validation import GS_CLX_ASM, GS_TX2_ASM, GS_ZEN_ASM

#: ISA id used by HLO-module entries (the accelerator adaptation of the
#: paper).
HLO_ISA = "hlo"


@dataclass(frozen=True)
class ArchSpec:
    """Everything needed to analyze a kernel for one target architecture."""

    id: str
    isa: str  # "x86" | "aarch64" | "hlo"
    model_factory: Callable[[], object]  # MachineModel (asm) or GPUChip (hlo)
    frequency_ghz: float
    parser: Optional[Callable] = None  # (text, name=...) -> Kernel
    aliases: Tuple[str, ...] = ()
    description: str = ""
    sample_asm: Optional[str] = None  # built-in demo kernel (validation suite)

    @property
    def is_hlo(self) -> bool:
        return self.isa == HLO_ISA


_REGISTRY: Dict[str, ArchSpec] = {}
# normalized name (id or alias) -> canonical id
_NAMES: Dict[str, str] = {}


def _normalize(name: str) -> str:
    return re.sub(r"[-_ .]", "", name.strip().lower())


def register_arch(spec: ArchSpec, overwrite: bool = False) -> ArchSpec:
    """Add an architecture to the registry (id + all aliases resolvable).

    Atomic: all names are validated before any registry state changes, so a
    conflicting alias leaves the registry untouched.
    """
    keys = [_normalize(alias) for alias in (spec.id,) + spec.aliases]
    if not overwrite:
        for alias, key in zip((spec.id,) + spec.aliases, keys):
            owner = _NAMES.get(key)
            if owner is not None and owner != spec.id:
                raise ValueError(
                    f"arch name '{alias}' already registered for '{owner}'")
    for key in keys:
        _NAMES[key] = spec.id
    _REGISTRY[spec.id] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    """Resolve an architecture id or alias to its :class:`ArchSpec`."""
    arch_id = _NAMES.get(_normalize(str(name)))
    if arch_id is None:
        known = ", ".join(
            f"{s.id} ({'/'.join(s.aliases)})" if s.aliases else s.id
            for s in sorted(_REGISTRY.values(), key=lambda s: s.id))
        raise ValueError(f"unknown arch '{name}'; known: {known}")
    return _REGISTRY[arch_id]


def list_arch_ids(isa: Optional[str] = None) -> List[str]:
    """Canonical architecture ids, optionally filtered by ISA."""
    return sorted(s.id for s in _REGISTRY.values()
                  if isa is None or s.isa == isa)


def asm_arch_ids() -> List[str]:
    """Ids of the assembly (non-HLO) targets — the CLI-facing set."""
    return sorted(s.id for s in _REGISTRY.values() if not s.is_hlo)


def registry_snapshot() -> Tuple[Dict[str, str], Dict[str, ArchSpec]]:
    """Copies of the (alias → id, id → spec) tables, for consistency checks.

    The machine-model linter (``repro.core.machine.lint``) walks these to
    find dangling aliases and resolution cycles without reaching into the
    module privates; mutating the returned dicts does not affect the
    registry.
    """
    return dict(_NAMES), dict(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-in targets (the paper's machines)
# ---------------------------------------------------------------------------

register_arch(ArchSpec(
    id="tx2", isa="aarch64", model_factory=thunderx2, frequency_ghz=2.2,
    parser=parse_aarch64, aliases=("thunderx2",),
    description="Marvell ThunderX2 (ARMv8.1)", sample_asm=GS_TX2_ASM,
))
register_arch(ArchSpec(
    id="csx", isa="x86", model_factory=cascade_lake, frequency_ghz=2.5,
    parser=parse_x86, aliases=("clx", "cascadelake", "cascade-lake"),
    description="Intel Cascade Lake SP", sample_asm=GS_CLX_ASM,
))
register_arch(ArchSpec(
    id="zen", isa="x86", model_factory=zen, frequency_ghz=2.3,
    parser=parse_x86, aliases=("zen1", "epyc"),
    description="AMD Zen (EPYC 7451)", sample_asm=GS_ZEN_ASM,
))
register_arch(ArchSpec(
    id="zen2", isa="x86", model_factory=zen2, frequency_ghz=3.4,
    parser=parse_x86, aliases=("rome",),
    description="AMD Zen 2 (Rome)", sample_asm=GS_ZEN_ASM,
))
register_arch(ArchSpec(
    id="n1", isa="aarch64", model_factory=neoverse_n1, frequency_ghz=2.5,
    parser=parse_aarch64, aliases=("neoverse-n1", "graviton2"),
    description="Arm Neoverse N1", sample_asm=GS_TX2_ASM,
))


def _h100():
    from repro_torch.core.hlo import H100_SXM
    return H100_SXM


register_arch(ArchSpec(
    id="h100", isa=HLO_ISA, model_factory=_h100, frequency_ghz=0.0,
    aliases=("h100-sxm", "hopper", "sm90"),
    description="NVIDIA H100 SXM5 80GB",
))
