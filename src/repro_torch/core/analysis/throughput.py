"""Block throughput analysis (paper §II-B) — two bounds per kernel.

*Optimistic* (the paper's model): every instruction's port pressure (after
memory-operand splitting and macro fusion) is accumulated per port with the
fixed ``t/n`` uniform split; the block reciprocal throughput is the maximum
accumulated pressure over all ports.  Kept bit-identical to the published
Table I/II numbers.

*Balanced* (the headline bound): the same µ-ops assigned kernel-globally by
the min-max scheduler (:mod:`repro_torch.core.analysis.scheduler`) — the optimal
fractional µ-op→port assignment, which is what a perfect out-of-order
scheduler actually achieves.  ``balanced <= optimistic`` always; they are
equal when every DB entry pins its µ-ops to explicit ports.

Both assume perfect scheduling and no dependencies — *lower bounds* on the
runtime of one loop iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from repro_torch.core.analysis.scheduler import balance_from_costs
from repro_torch.core.isa.instruction import Kernel
from repro_torch.core.machine.model import InstructionCost, MachineModel


@dataclass
class ThroughputResult:
    port_pressure: Dict[str, float]  # accumulated cycles per port (per block)
    per_instruction: Tuple[Tuple[InstructionCost, Dict[str, float]], ...]
    block_throughput: float  # optimistic bound, cycles per block iteration
    bottleneck_port: str
    # Min-max optimal µ-op→port assignment (kernel-global water filling).
    balanced_throughput: float = 0.0  # balanced bound, cycles per block
    balanced_port_load: Dict[str, float] = field(default_factory=dict)
    balanced_bottleneck: str = ""

    def per_iteration(self, unroll: int) -> float:
        return self.block_throughput / unroll

    def balanced_per_iteration(self, unroll: int) -> float:
        return self.balanced_throughput / unroll


def throughput_analysis(kernel: Kernel, model: MachineModel,
                        costs=None) -> ThroughputResult:
    if costs is None:
        costs = model.resolve_kernel(kernel)
    return throughput_from_costs(costs, model)


def throughput_from_costs(costs, model: MachineModel,
                          balanced: bool = True) -> ThroughputResult:
    """Accumulate port pressure from already-resolved instruction costs.

    ``balanced=False`` skips the min-max scheduler and mirrors the optimistic
    numbers into the balanced fields — the pure full-throughput model, used
    by the serving path's ``tp_only`` degradation rung where the point is to
    still answer after the expensive stages were cut.
    """
    totals: Dict[str, float] = {p: 0.0 for p in model.ports}
    per_instruction = []
    for cost in costs:
        pressure = cost.total_pressure
        for port, cy in pressure.items():
            totals[port] = totals.get(port, 0.0) + cy
        per_instruction.append((cost, pressure))
    bottleneck = max(totals, key=lambda p: totals[p]) if totals else ""
    if balanced:
        schedule = balance_from_costs(costs, model.ports)
        bal_bound = schedule.bound
        bal_load = schedule.port_load
        bal_port = schedule.bottleneck_port
    else:
        bal_bound = totals.get(bottleneck, 0.0)
        bal_load = dict(totals)
        bal_port = bottleneck
    return ThroughputResult(
        port_pressure=totals,
        per_instruction=tuple(per_instruction),
        block_throughput=totals.get(bottleneck, 0.0),
        bottleneck_port=bottleneck,
        balanced_throughput=bal_bound,
        balanced_port_load=bal_load,
        balanced_bottleneck=bal_port,
    )
