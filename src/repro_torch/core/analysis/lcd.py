"""Loop-carried dependency detection (paper §II-D), batched single sweep.

Two back-to-back copies of the loop body are analyzed with the same DAG
construction as the critical path; a dependency chain from an instruction form
in copy 0 to its own duplicate in copy 1 is a cyclic loop-carried dependency.
The longest such chain (one period's node-latency sum) bounds the achievable
overlap of successive iterations from below — the *expected* runtime for
dependency-bound kernels.

Engine: instead of one longest-path DP per body instruction (the seed's
O(n·(V+E)) loop, quadratic in kernel size), all n copy-0 source candidates
are swept at once.  A ``(n × V)`` float64 distance matrix on the chosen
device walks the 2-copy DAG in one topological pass (node ids are already
topological), each node reducing over its predecessors with a tensor
``max`` — O(V) sweep steps of O(n · indeg) tensor work.  The distance and
parent matrices then come to the host once, for one O(path) backtrack per
source that actually reaches its duplicate.  Results are bit-identical to
``repro.core.analysis.lcd`` and to the per-source engine of
``repro_torch.core.analysis.reference``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from repro_torch import resolve_device
from repro_torch.core.analysis.dag import DependencyDAG, build_dag
from repro_torch.core.analysis.sweep import (backtrack, batched_longest_paths,
                                             is_reached)
from repro_torch.core.isa.instruction import Kernel
from repro_torch.core.machine.model import InstructionCost, MachineModel


@dataclass
class LCDChain:
    length: float  # cycles per assembly-block iteration (one period)
    instr_indices: Tuple[int, ...]  # chain members (kernel body indices)
    carried_by: int  # the instruction index whose duplicate closes the cycle


@dataclass
class LCDResult:
    chains: Tuple[LCDChain, ...]
    longest: float  # cycles per assembly-block iteration (0 if no LCD)
    on_longest: Set[int]

    def per_iteration(self, unroll: int) -> float:
        return self.longest / unroll


def lcd_from_dag(dag: DependencyDAG, n_body: int, device=None) -> LCDResult:
    """Batched LCD over an already-built 2-copy DAG (its default adjacency
    must be the split-writeback LCD view).  The sweep runs on ``device``
    (``None``: the CUDA device, see :func:`repro_torch.resolve_device`)."""
    device = resolve_device(device)
    sources = []  # (body idx, copy-0 node, copy-1 node)
    for idx in range(n_body):
        src = dag.instr_node.get((idx, 0))
        dst = dag.instr_node.get((idx, 1))
        if src is None or dst is None:
            continue
        # A source with no consumers (or a duplicate nothing feeds) can never
        # close a cycle — don't spend a matrix row on it.
        if not dag.succs[src] or not dag.preds[dst]:
            continue
        sources.append((idx, src, dst))
    if not sources:
        return LCDResult(chains=(), longest=0.0, on_longest=set())

    ptr, idx_arr = dag.pred_csr()
    weights = dag.latency_vector()
    D, P = batched_longest_paths(ptr, idx_arr, weights,
                                 [[s] for _, s, _ in sources], device=device)
    # One copy each to the host, row-major for the per-source backtracks.
    D = D.cpu().numpy()
    P = P.contiguous().cpu().numpy()

    # body instr index per node for chain membership (-1 for load µ-ops).
    member_index = [n.instr_index if n.kind == "instr" else -1
                    for n in dag.nodes]
    seen: Dict[frozenset, LCDChain] = {}
    for row, (idx, src, dst) in enumerate(sources):
        if not is_reached(D[row, dst]):
            continue
        path_ids = backtrack(P[row], dst)
        if not path_ids or path_ids[0] != src:
            continue
        # One period: exclude the duplicate endpoint's latency.
        period = float(D[row, dst]) - dag.nodes[dst].latency
        members = tuple(member_index[v] for v in path_ids[:-1]
                        if member_index[v] >= 0)
        key = frozenset(members)
        if key not in seen or seen[key].length < period:
            seen[key] = LCDChain(length=period, instr_indices=members, carried_by=idx)

    chains = tuple(sorted(seen.values(), key=lambda c: -c.length))
    if chains:
        return LCDResult(chains=chains, longest=chains[0].length,
                         on_longest=set(chains[0].instr_indices))
    return LCDResult(chains=(), longest=0.0, on_longest=set())


def loop_carried_dependencies(
    kernel: Kernel,
    model: MachineModel,
    costs: Optional[Tuple[InstructionCost, ...]] = None,
    device=None,
) -> LCDResult:
    # Writeback address updates are independent µ-ops here (see dag.py): a
    # store's data register must not chain into later address uses, or the
    # steady-state cycle is overestimated (paper Table II LCD column).
    dag = build_dag(kernel, model, copies=2, writeback_chains_data=False,
                    costs=costs)
    return lcd_from_dag(dag, len(kernel), device=device)
