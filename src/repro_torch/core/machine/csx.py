"""Intel Cascade Lake X (Skylake-SP port model) machine model.

Eight issue ports P0-P7 plus the divider pipe, per the paper's §II: FP
add/mul/FMA on P0/P1 (latency 4, tput 0.5/cy each), integer ALU on P0/P1/P5/P6,
loads on the P2/P3 AGUs (FP-domain load-to-use 6 cy for indexed addressing,
uops.info), store data on P4 with the store AGU spread over P2/P3/P7.  The
store node latency is the SKX store-forward latency (6 cy).  cmp/test+Jcc
macro-fusion is modeled (fused branch issues on P6).

Entries carry µ-ops with *eligible port sets* (``uops_entry``): one FP µ-op
that may issue on P0 or P1, an ALU µ-op on any of P0/P1/P5/P6, a store split
into its data µ-op (P4) plus its AGU µ-op (P2/P3/P7), and so on.  The derived
``pressure`` keeps the paper's uniform split bit-identical; the min-max
scheduler uses the port sets directly.

Sources: uops.info SKX tables; Intel SOM; OSACA DB.
"""

from __future__ import annotations

from repro_torch.core.machine.model import MachineModel, uops_entry
from repro_torch.core.machine.window import WindowParams

_FP2 = [(1.0, ("P0", "P1"))]
_ALU4 = [(1.0, ("P0", "P1", "P5", "P6"))]
_LD = [(1.0, ("P2", "P3"))]
_ST = [(1.0, ("P4",)), (1.0, ("P2", "P3", "P7"))]  # store data + store AGU
_LEA = [(1.0, ("P1", "P5"))]
_BR = [(1.0, ("P6",))]

_DB = {
    # AVX scalar FP: latency 4 on SKX/CLX for add/mul/FMA.
    "vaddsd:fff": uops_entry(4.0, _FP2),
    "vsubsd:fff": uops_entry(4.0, _FP2),
    "vmulsd:fff": uops_entry(4.0, _FP2),
    "addsd:ff": uops_entry(4.0, _FP2),
    "mulsd:ff": uops_entry(4.0, _FP2),
    "vfmadd231sd:fff": uops_entry(4.0, _FP2),
    "vfmadd213sd:fff": uops_entry(4.0, _FP2),
    "vfmadd132sd:fff": uops_entry(4.0, _FP2),
    "vdivsd:fff": uops_entry(14.0, [(1.0, ("P0",)), (4.0, ("DIV",))]),
    # Moves/loads/stores.  Load-to-use 6 cy (FP domain, indexed addressing);
    # store node latency = store-forward latency 6 cy.
    "movsd:mf": uops_entry(6.0, _LD),
    "vmovsd:mf": uops_entry(6.0, _LD),
    "movsd:fm": uops_entry(6.0, _ST),
    "vmovsd:fm": uops_entry(6.0, _ST),
    "movq:mr": uops_entry(5.0, _LD),
    "movq:rm": uops_entry(6.0, _ST),
    "movsd:ff": uops_entry(1.0, _FP2),
    "vmovsd:ff": uops_entry(1.0, _FP2),
    "movq:rr": uops_entry(1.0, _ALU4),
    "movl:rr": uops_entry(1.0, _ALU4),
    "movq:ir": uops_entry(1.0, _ALU4),
    "movl:ir": uops_entry(1.0, _ALU4),
    # Integer ALU.
    "addq:ir": uops_entry(1.0, _ALU4),
    "addq:rr": uops_entry(1.0, _ALU4),
    "subq:ir": uops_entry(1.0, _ALU4),
    "incq:r": uops_entry(1.0, _ALU4),
    "leaq:mr": uops_entry(1.0, _LEA),
    "cmpq:rr": uops_entry(1.0, _ALU4),
    "cmpq:ir": uops_entry(1.0, _ALU4),
    "testq:rr": uops_entry(1.0, _ALU4),
    # Branches (unfused; the fused path is modeled via macro_fusion).
    "jne": uops_entry(1.0, _BR),
    "je": uops_entry(1.0, _BR),
    "jb": uops_entry(1.0, _BR),
    "jmp": uops_entry(1.0, _BR),
    "nop": uops_entry(0.0, []),
}


def cascade_lake() -> MachineModel:
    return MachineModel(
        name="csx",
        isa="x86",
        ports=("P0", "P1", "P2", "P3", "P4", "P5", "P6", "P7", "DIV"),
        db=dict(_DB),
        load_entry=uops_entry(6.0, _LD, note="split load µ-op"),
        store_entry=uops_entry(6.0, _ST, note="split store µ-op"),
        macro_fusion=True,
        fused_branch_pressure={"P6": 1.0},
        frequency_ghz=2.5,
        # Skylake-SP class window (Intel SOG): 4-wide rename/retire,
        # 224-entry ROB, 97-entry unified RS, 56-entry store queue.
        window=WindowParams(issue_width=4, rob_size=224, sched_size=97,
                            lsq_size=56, retire_width=4).validate(),
    )
