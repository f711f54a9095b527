"""Arm Neoverse N1 (AWS Graviton2) machine model.

From the Arm Neoverse N1 Software Optimization Guide: two FP/ASIMD pipes
(V0/V1), FADD latency 2, FMUL latency 3, FMADD 4; three integer ALUs (one
branch+ALU); two load/store pipes, load-to-use 4, store-forward 4.
Demonstrates the declarative machine-model claim on a post-paper core.

Entries carry µ-ops with *eligible port sets* (``uops_entry``); the derived
``pressure`` keeps the uniform split bit-identical.
"""

from __future__ import annotations

from repro_torch.core.machine.model import MachineModel, uops_entry
from repro_torch.core.machine.window import WindowParams

_FP2 = [(1.0, ("V0", "V1"))]
_ALU3 = [(1.0, ("I0", "I1", "I2"))]
_LD = [(1.0, ("L0", "L1"))]
_ST = [(1.0, ("L0", "L1")), (1.0, ("SD",))]  # store AGU + store data
_BR = [(1.0, ("B",))]

_DB = {
    "fadd:fff": uops_entry(2.0, _FP2),
    "fsub:fff": uops_entry(2.0, _FP2),
    "fmul:fff": uops_entry(3.0, _FP2),
    "fmadd:ffff": uops_entry(4.0, _FP2),
    "fmov:ff": uops_entry(1.0, _FP2),
    "fdiv:fff": uops_entry(15.0, [(1.0, ("V0",)), (7.0, ("DIV",))]),
    "ldr:fm": uops_entry(4.0, _LD),
    "ldr:rm": uops_entry(4.0, _LD),
    "ldp:ffm": uops_entry(4.0, _LD),
    "str:fm": uops_entry(4.0, _ST),
    "str:rm": uops_entry(4.0, _ST),
    "add:rri": uops_entry(1.0, _ALU3),
    "add:rrr": uops_entry(1.0, _ALU3),
    "sub:rri": uops_entry(1.0, _ALU3),
    "subs:rri": uops_entry(1.0, _ALU3),
    "adds:rri": uops_entry(1.0, _ALU3),
    "mov:rr": uops_entry(1.0, _ALU3),
    "mov:ri": uops_entry(1.0, _ALU3),
    "cmp:rr": uops_entry(1.0, _ALU3),
    "cmp:ri": uops_entry(1.0, _ALU3),
    "eor:rrr": uops_entry(1.0, _ALU3),
    "b": uops_entry(1.0, _BR),
    "bne": uops_entry(1.0, _BR),
    "beq": uops_entry(1.0, _BR),
    "cbnz": uops_entry(1.0, _BR),
    "nop": uops_entry(0.0, []),
}


def neoverse_n1() -> MachineModel:
    return MachineModel(
        name="n1",
        isa="aarch64",
        ports=("I0", "I1", "I2", "V0", "V1", "L0", "L1", "SD", "DIV", "B"),
        db=dict(_DB),
        load_entry=uops_entry(4.0, _LD, note="split load µ-op"),
        store_entry=uops_entry(4.0, _ST, note="split store µ-op"),
        macro_fusion=False,
        frequency_ghz=2.5,
        # Neoverse N1 SOG: 4-wide front end, 8-wide retire, 128-entry ROB,
        # distributed issue queues totalling ~64, 46-entry load queue side.
        window=WindowParams(issue_width=4, rob_size=128, sched_size=64,
                            lsq_size=46, retire_width=8).validate(),
    )
