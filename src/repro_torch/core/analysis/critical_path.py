"""Critical-path extraction: longest node-weighted path in the dependency DAG
via weighted topological DP (Manber).  An upper bound on the runtime of one
instance of the loop body (paper §II-C).

``critical_path_from_dag`` also accepts a shared dual-writeback 2-copy DAG
(from ``build_dag(..., dual_writeback=True)``): it then runs over the
data-chained CP view (``cp_preds``) and restricts path endpoints to copy-0
non-writeback nodes, which is exactly the 1-copy CP — so ``analyze_kernel``
can reuse the LCD's DAG instead of building a second one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Set, Tuple

from repro_torch.core.analysis.dag import DependencyDAG, Node, build_dag
from repro_torch.core.analysis.sweep import NEG_INF, backtrack, single_longest_path
from repro_torch.core.isa.instruction import Kernel
from repro_torch.core.machine.model import InstructionCost, MachineModel


@dataclass
class CriticalPathResult:
    length: float  # cycles per assembly-block iteration
    path: Tuple[Node, ...]
    # Set of instruction indices (within the kernel body) on the CP, for
    # Table-II-style per-line reporting.
    on_path: Set[int]

    def per_iteration(self, unroll: int) -> float:
        return self.length / unroll


def critical_path_from_dag(dag: DependencyDAG) -> CriticalPathResult:
    """Longest path over the CP view, ending in a copy-0 non-writeback node."""
    if not dag.nodes:
        return CriticalPathResult(length=0.0, path=(), on_path=set())
    # Copy-0 nodes are an id prefix and have no incoming edges from later
    # copies, so the DP can stop at the copy boundary of a multi-copy DAG.
    n0 = len(dag.nodes)
    for v, node in enumerate(dag.nodes):
        if node.copy != 0:
            n0 = v
            break
    preds = dag.cp_preds if dag.cp_preds is not None else dag.preds
    weights = [n.latency for n in dag.nodes[:n0]]
    dist, parent = single_longest_path(preds[:n0], weights)
    end, best = -1, NEG_INF
    for v in range(n0):
        if dag.nodes[v].is_wb:
            continue
        if dist[v] > best:
            best, end = dist[v], v
    if end == -1:
        return CriticalPathResult(length=0.0, path=(), on_path=set())
    path_ids = backtrack(parent, end)
    path = tuple(dag.nodes[v] for v in path_ids)
    return CriticalPathResult(
        length=dist[end],
        path=path,
        on_path={n.instr_index for n in path if n.kind == "instr"},
    )


def critical_path(
    kernel: Kernel,
    model: MachineModel,
    costs: Optional[Tuple[InstructionCost, ...]] = None,
) -> CriticalPathResult:
    dag = build_dag(kernel, model, copies=1, costs=costs)
    return critical_path_from_dag(dag)
