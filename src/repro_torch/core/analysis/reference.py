"""Retained pure-Python reference engine (the seed implementation).

This module preserves the original per-source analysis algorithms exactly as
they shipped in the seed tree, so the batched array engine in
:mod:`repro_torch.core.analysis.lcd` / :mod:`repro_torch.core.analysis.critical_path` can
be differential-tested against them (``tests/test_engine_equivalence.py``):

* :func:`reference_critical_path` — one node-weighted longest-path DP over a
  1-copy DAG (``DependencyDAG.longest_paths``).
* :func:`reference_loop_carried_dependencies` — one full longest-path DP *per
  body instruction* over a 2-copy DAG: the O(n·(V+E)) loop the batched
  single-sweep engine replaces.

Do not optimize this module; its value is being the slow, obviously-correct
oracle.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.core.analysis.critical_path import CriticalPathResult
from repro_torch.core.analysis.dag import build_dag
from repro_torch.core.analysis.lcd import LCDChain, LCDResult
from repro_torch.core.isa.instruction import Kernel
from repro_torch.core.machine.model import MachineModel


def reference_critical_path(kernel: Kernel, model: MachineModel) -> CriticalPathResult:
    dag = build_dag(kernel, model, copies=1)
    if not dag.nodes:
        return CriticalPathResult(length=0.0, path=(), on_path=set())
    dist, parent = dag.longest_paths()
    end = max(range(len(dag.nodes)), key=lambda v: dist[v])
    path_ids = dag.path_to(end, parent)
    path = tuple(dag.nodes[v] for v in path_ids)
    return CriticalPathResult(
        length=dist[end],
        path=path,
        on_path={n.instr_index for n in path if n.kind == "instr"},
    )


def reference_loop_carried_dependencies(
    kernel: Kernel, model: MachineModel
) -> LCDResult:
    dag = build_dag(kernel, model, copies=2, writeback_chains_data=False)
    n_body = len(kernel)
    seen: Dict[frozenset, LCDChain] = {}

    for idx in range(n_body):
        src = dag.instr_node.get((idx, 0))
        dst = dag.instr_node.get((idx, 1))
        if src is None or dst is None:
            continue
        dist, parent = dag.longest_paths(sources=[src])
        if dist[dst] == float("-inf"):
            continue
        path_ids = dag.path_to(dst, parent)
        if not path_ids or path_ids[0] != src:
            continue
        # One period: exclude the duplicate endpoint's latency.
        period = dist[dst] - dag.nodes[dst].latency
        members = tuple(
            dag.nodes[v].instr_index for v in path_ids[:-1]
            if dag.nodes[v].kind == "instr"
        )
        key = frozenset(members)
        if key not in seen or seen[key].length < period:
            seen[key] = LCDChain(length=period, instr_indices=members, carried_by=idx)

    chains = tuple(sorted(seen.values(), key=lambda c: -c.length))
    if chains:
        return LCDResult(chains=chains, longest=chains[0].length,
                         on_longest=set(chains[0].instr_indices))
    return LCDResult(chains=(), longest=0.0, on_longest=set())
