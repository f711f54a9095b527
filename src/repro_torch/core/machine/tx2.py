"""Marvell ThunderX2 (Vulcan) machine model.

Port layout follows the paper's Table II: six numbered ports P0-P5 plus a
branch unit.  P0/P1 carry the FP pipes (FP latency 6 cy — the documented
Vulcan FP add/mul latency), P0-P2 are the integer ALUs, P3/P4 are the
load/store AGUs (load-to-use 4 cy), and stores additionally occupy the store
buffer port P5 for one cycle.  Values from the Vulcan micro-architecture
disclosures and the OSACA instruction database (semi-automatic ibench runs in
the paper's artifact).

Entries carry µ-ops with *eligible port sets* (``uops_entry``): the derived
``pressure`` keeps the paper's uniform split bit-identical (Table II), while
the min-max scheduler may e.g. push all integer ALU work onto P2 when P0/P1
are saturated by FP.
"""

from __future__ import annotations

from repro_torch.core.machine.model import MachineModel, uops_entry
from repro_torch.core.machine.window import WindowParams

_FP2 = [(1.0, ("P0", "P1"))]
_ALU3 = [(1.0, ("P0", "P1", "P2"))]
_LD = [(1.0, ("P3", "P4"))]
_ST = [(1.0, ("P3", "P4")), (1.0, ("P5",))]  # store AGU + store buffer
_BR = [(1.0, ("B",))]

_DB = {
    # Scalar FP (d-form NEON scalar): latency 6, tput 0.5/port over P0,P1.
    "fadd:fff": uops_entry(6.0, _FP2),
    "fsub:fff": uops_entry(6.0, _FP2),
    "fmul:fff": uops_entry(6.0, _FP2),
    "fmadd:ffff": uops_entry(6.0, _FP2),
    "fmov:ff": uops_entry(1.0, _FP2),
    "fdiv:fff": uops_entry(23.0, [(1.0, ("P0",)), (16.0, ("DIV",))]),
    # Loads/stores: load-to-use 4 cy, AGUs on P3/P4; store data port P5.
    "ldr:fm": uops_entry(4.0, _LD),
    "ldr:rm": uops_entry(4.0, _LD),
    "ldp:ffm": uops_entry(4.0, _LD),
    "str:fm": uops_entry(4.0, _ST),
    "str:rm": uops_entry(4.0, _ST),
    # Integer ALU.
    "add:rri": uops_entry(1.0, _ALU3),
    "add:rrr": uops_entry(1.0, _ALU3),
    "sub:rri": uops_entry(1.0, _ALU3),
    "sub:rrr": uops_entry(1.0, _ALU3),
    "mov:rr": uops_entry(1.0, _FP2),
    "mov:ri": uops_entry(1.0, _FP2),
    "cmp:rr": uops_entry(1.0, _ALU3),
    "cmp:ri": uops_entry(1.0, _ALU3),
    "eor:rrr": uops_entry(1.0, _ALU3),
    "orr:rrr": uops_entry(1.0, _ALU3),
    "and:rrr": uops_entry(1.0, _ALU3),
    "lsl:rri": uops_entry(1.0, _ALU3),
    "madd:rrrr": uops_entry(3.0, [(1.0, ("P0",))]),
    # Branch unit.
    "b": uops_entry(1.0, _BR),
    "bne": uops_entry(1.0, _BR),
    "beq": uops_entry(1.0, _BR),
    "cbnz": uops_entry(1.0, _BR),
    "nop": uops_entry(0.0, []),
}


def thunderx2() -> MachineModel:
    return MachineModel(
        name="tx2",
        isa="aarch64",
        ports=("P0", "P1", "P2", "P3", "P4", "P5", "DIV", "B"),
        db=dict(_DB),
        load_entry=uops_entry(4.0, _LD, note="split load µ-op"),
        store_entry=uops_entry(4.0, _ST, note="split store µ-op"),
        macro_fusion=False,
        frequency_ghz=2.2,
        # Vulcan-class window: 4-wide dispatch/retire, 180-entry ROB,
        # 60 scheduler entries across the issue queues, 36-entry LSQ side.
        window=WindowParams(issue_width=4, rob_size=180, sched_size=60,
                            lsq_size=36, retire_width=4).validate(),
    )
