"""AMD Zen 2 machine model (the paper's §IV-B planned target).

Zen 2 vs Zen 1 (Agner Fog's tables / AMD SOG): 256-bit FP datapaths, FADD
latency 3 on FP2/FP3, FMUL/FMA latency 3 on FP0/FP1 (down from 4/5), three
AGUs (two loads + one store per cycle), FP load-to-use 7, store-forward 4.

Entries carry µ-ops with *eligible port sets* (``uops_entry``); the derived
``pressure`` keeps the uniform split bit-identical.
"""

from __future__ import annotations

from repro_torch.core.machine.model import MachineModel, uops_entry
from repro_torch.core.machine.window import WindowParams

_FADD = [(1.0, ("FP2", "FP3"))]
_FMUL = [(1.0, ("FP0", "FP1"))]
_FMOV = [(1.0, ("FP0", "FP1", "FP2", "FP3"))]
_ALU4 = [(1.0, ("ALU0", "ALU1", "ALU2", "ALU3"))]
_LD = [(1.0, ("AGU0", "AGU1"))]
_ST = [(1.0, ("AGU2",)), (1.0, ("SD",))]  # dedicated store AGU + store data
_BR = [(1.0, ("B",))]

_DB = {
    "vaddsd:fff": uops_entry(3.0, _FADD),
    "vsubsd:fff": uops_entry(3.0, _FADD),
    "vmulsd:fff": uops_entry(3.0, _FMUL),
    "vfmadd231sd:fff": uops_entry(5.0, _FMUL),
    "vfmadd213sd:fff": uops_entry(5.0, _FMUL),
    "vaddpd:fff": uops_entry(3.0, _FADD),
    "vmulpd:fff": uops_entry(3.0, _FMUL),
    "vfmadd231pd:fff": uops_entry(5.0, _FMUL),
    "vdivsd:fff": uops_entry(13.0, [(1.0, ("FP3",)), (4.0, ("DIV",))]),
    "movsd:mf": uops_entry(7.0, _LD),
    "vmovsd:mf": uops_entry(7.0, _LD),
    "vmovupd:mf": uops_entry(7.0, _LD),
    "movsd:fm": uops_entry(4.0, _ST),
    "vmovsd:fm": uops_entry(4.0, _ST),
    "vmovupd:fm": uops_entry(4.0, _ST),
    "movq:mr": uops_entry(4.0, _LD),
    "movq:rm": uops_entry(4.0, _ST),
    "movsd:ff": uops_entry(1.0, _FMOV),
    "movq:rr": uops_entry(1.0, _ALU4),
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


def zen2() -> MachineModel:
    return MachineModel(
        name="zen2",
        isa="x86",
        ports=("ALU0", "ALU1", "ALU2", "ALU3", "AGU0", "AGU1", "AGU2",
               "FP0", "FP1", "FP2", "FP3", "SD", "DIV", "B"),
        db=dict(_DB),
        load_entry=uops_entry(7.0, _LD, note="split load µ-op"),
        store_entry=uops_entry(4.0, _ST, note="split store µ-op"),
        macro_fusion=True,
        fused_branch_pressure={"B": 1.0},
        frequency_ghz=3.4,
        # Zen 2: 6-wide dispatch, 8-wide retire, 224-entry ROB, ~92
        # scheduler entries, 48-entry store queue.
        window=WindowParams(issue_width=6, rob_size=224, sched_size=92,
                            lsq_size=48, retire_width=8).validate(),
    )
