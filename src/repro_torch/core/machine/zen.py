"""AMD Zen (EPYC 7451, Zen 1) machine model.

Zen 1 back end: four integer ALUs, two AGUs shared between loads and stores,
four FP pipes (FADD on FP2/FP3 latency 3, FMUL on FP0/FP1 latency 4 — Agner
Fog's Zen tables), a store-data path (SD), and a branch unit.  FP-domain
load-to-use is 7 cy; the store node latency is the Zen store-forward latency
(4 cy).  cmp+Jcc fusion is supported on Zen.

Entries carry µ-ops with *eligible port sets* (``uops_entry``); the derived
``pressure`` keeps the uniform split bit-identical while the min-max
scheduler assigns loads/stores across the shared AGU pair optimally.
"""

from __future__ import annotations

from repro_torch.core.machine.model import MachineModel, uops_entry
from repro_torch.core.machine.window import WindowParams

_FADD = [(1.0, ("FP2", "FP3"))]
_FMUL = [(1.0, ("FP0", "FP1"))]
_FMOV = [(1.0, ("FP0", "FP1", "FP2", "FP3"))]
_ALU4 = [(1.0, ("ALU0", "ALU1", "ALU2", "ALU3"))]
_AGU = [(1.0, ("AGU0", "AGU1"))]
_ST = [(1.0, ("AGU0", "AGU1")), (1.0, ("SD",))]  # store AGU + store data
_BR = [(1.0, ("B",))]

_DB = {
    "vaddsd:fff": uops_entry(3.0, _FADD),
    "vsubsd:fff": uops_entry(3.0, _FADD),
    "vmulsd:fff": uops_entry(4.0, _FMUL),
    "addsd:ff": uops_entry(3.0, _FADD),
    "mulsd:ff": uops_entry(4.0, _FMUL),
    "vfmadd231sd:fff": uops_entry(5.0, _FMUL),
    "vfmadd213sd:fff": uops_entry(5.0, _FMUL),
    "vdivsd:fff": uops_entry(13.0, [(1.0, ("FP3",)), (4.0, ("DIV",))]),
    # Memory.
    "movsd:mf": uops_entry(7.0, _AGU),
    "vmovsd:mf": uops_entry(7.0, _AGU),
    "movsd:fm": uops_entry(4.0, _ST),
    "vmovsd:fm": uops_entry(4.0, _ST),
    "movq:mr": uops_entry(4.0, _AGU),
    "movq:rm": uops_entry(4.0, _ST),
    "movsd:ff": uops_entry(1.0, _FMOV),
    "movq:rr": uops_entry(1.0, _ALU4),
    "movq:ir": uops_entry(1.0, _ALU4),
    # Integer ALU.
    "addq:ir": uops_entry(1.0, _ALU4),
    "addq:rr": uops_entry(1.0, _ALU4),
    "subq:ir": uops_entry(1.0, _ALU4),
    "leaq:mr": uops_entry(1.0, _ALU4),
    "cmpq:rr": uops_entry(1.0, _ALU4),
    "cmpq:ir": uops_entry(1.0, _ALU4),
    "jne": uops_entry(1.0, _BR),
    "je": uops_entry(1.0, _BR),
    "jmp": uops_entry(1.0, _BR),
    "nop": uops_entry(0.0, []),
}


def zen() -> MachineModel:
    return MachineModel(
        name="zen",
        isa="x86",
        ports=("ALU0", "ALU1", "ALU2", "ALU3", "AGU0", "AGU1",
               "FP0", "FP1", "FP2", "FP3", "SD", "DIV", "B"),
        db=dict(_DB),
        load_entry=uops_entry(7.0, _AGU, note="split load µ-op"),
        store_entry=uops_entry(4.0, _ST, note="split store µ-op"),
        macro_fusion=True,
        fused_branch_pressure={"B": 1.0},
        frequency_ghz=2.3,
        # Zen 1 (AMD SOG 55723): 6-wide dispatch, 8-wide retire, 192-entry
        # retire queue, ~84 scheduler entries (ALU+AGU+FP), 44-entry SQ.
        window=WindowParams(issue_width=6, rob_size=192, sched_size=84,
                            lsq_size=44, retire_width=8).validate(),
    )
