"""Critical path over the HLO def-use DAG (paper §II-C on an accelerator).

Node weights are per-op bottleneck-engine times from the cost model; the
longest path is the serialization bound of the step — what limits runtime
even with infinite parallel resources.  ``while`` ops contribute their body's
critical path times the inferred trip count (the scan-over-layers chain, the
decode loop), which is how the paper's LCD insight shows up at module scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.core.hlo.costs import HLOCostModel
from repro_torch.core.hlo.export import as_module
from repro_torch.core.hlo.machine import GPUChip, H100_SXM
from repro_torch.core.hlo.parser import HLOModule


@dataclass
class HLOPathNode:
    op_name: str
    opcode: str
    seconds: float


@dataclass
class HLOCriticalPath:
    seconds: float
    path: Tuple[HLOPathNode, ...]

    def top_contributors(self, k: int = 10) -> List[HLOPathNode]:
        return sorted(self.path, key=lambda n: -n.seconds)[:k]

    def render(self) -> str:
        lines = [f"HLO critical path: {self.seconds * 1e3:.3f} ms "
                 f"({len(self.path)} ops)"]
        for node in self.top_contributors(8):
            lines.append(f"  {node.seconds * 1e3:9.4f} ms  {node.opcode:<22} {node.op_name}")
        return "\n".join(lines)


def _computation_cp(
    module: HLOModule, comp_name: str, cost: HLOCostModel,
    memo: Dict[str, Tuple[float, Tuple[HLOPathNode, ...]]],
) -> Tuple[float, Tuple[HLOPathNode, ...]]:
    if comp_name in memo:
        return memo[comp_name]
    memo[comp_name] = (0.0, ())  # cycle guard
    comp = module.computations.get(comp_name)
    if comp is None:
        return 0.0, ()

    index = {op.name: i for i, op in enumerate(comp.ops)}
    n = len(comp.ops)
    dist = [0.0] * n
    parent = [-1] * n

    weights: List[float] = []
    for op in comp.ops:
        if op.opcode == "while":
            trips = cost.while_trip_count(op)
            body = op.body_computation
            body_cp, _ = _computation_cp(module, body, cost, memo) if body else (0.0, ())
            weights.append(trips * body_cp)
        elif op.opcode in ("fusion", "call"):
            inner = max(
                (_computation_cp(module, c, cost, memo)[0]
                 for c in op.called_computations), default=0.0,
            )
            weights.append(max(cost.op_seconds(op, comp), inner))
        else:
            weights.append(cost.op_seconds(op, comp))

    # Same forward sweep as the assembly engine, over resolved predecessor
    # lists (every node may start a path at floor 0: a zero-time pred never
    # becomes a parent, matching the batched sweep's path-through rule).
    preds = [
        [j for operand in op.operands
         if (j := index.get(operand)) is not None and j < i]
        for i, op in enumerate(comp.ops)
    ]
    for i in range(n):
        best, best_p = 0.0, -1
        for j in preds[i]:
            if dist[j] > best:
                best, best_p = dist[j], j
        dist[i] = best + weights[i]
        parent[i] = best_p

    if not comp.ops:
        return 0.0, ()
    end = max(range(n), key=lambda i: dist[i])
    path: List[HLOPathNode] = []
    v = end
    while v != -1:
        op = comp.ops[v]
        path.append(HLOPathNode(op_name=op.name, opcode=op.opcode, seconds=weights[v]))
        v = parent[v]
    path.reverse()
    memo[comp_name] = (dist[end], tuple(path))
    return memo[comp_name]


def hlo_critical_path(
    source, chip: GPUChip = H100_SXM, default_while_trips: int = 1,
) -> HLOCriticalPath:
    """``source`` is HLO text, a parsed module, or an ExportedProgram.  The
    sweep runs on the host, as in the reference."""
    module = as_module(source)
    cost = HLOCostModel(module, chip, default_while_trips=default_while_trips)
    memo: Dict[str, Tuple[float, Tuple[HLOPathNode, ...]]] = {}
    seconds, path = _computation_cp(module, module.entry_name, cost, memo)
    return HLOCriticalPath(seconds=seconds, path=path)
