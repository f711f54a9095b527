"""Loop-carried dependency detection for HLO ``while`` loops (paper §II-D on
an accelerator).

A ``while`` body maps a state tuple to a state tuple.  For each tuple element
we search the longest time-weighted path from the element's
``get-tuple-element`` reads to the value stored back at the same tuple index
in the root — a cyclic chain across iterations, exactly the paper's 2-copy
construction specialised to HLO's explicit loop-carry structure.  This is
what exposes the sequential SSM state chain in Mamba-2, the KV-cache update
chain in decode, and optimizer-state serialization in training steps.

All tuple indices of a body are searched in one batched topological sweep
(:func:`repro_torch.core.analysis.sweep.batched_longest_paths`): one row of
the distance matrix per loop-state element, each row's allowed starts being
that element's ``get-tuple-element`` reads — the same all-sources engine the
assembly LCD uses, instead of one DP per tuple index.  The sweep's distance
matrix is a float64 tensor on ``device``; the rest runs on the host.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.analysis.sweep import (backtrack, batched_longest_paths,
                                             is_reached, pred_csr_from_lists)
from repro_torch.core.hlo.costs import HLOCostModel
from repro_torch.core.hlo.export import as_module
from repro_torch.core.hlo.machine import GPUChip, H100_SXM
from repro_torch.core.hlo.parser import HLOModule, HLOOp


@dataclass
class CarriedChain:
    while_op: str
    body: str
    tuple_index: int
    seconds: float  # one period of the carried chain
    ops: Tuple[str, ...]
    trip_count: int

    @property
    def total_seconds(self) -> float:
        return self.seconds * self.trip_count


@dataclass
class HLOLCDResult:
    chains: Tuple[CarriedChain, ...]

    @property
    def longest(self) -> Optional[CarriedChain]:
        return max(self.chains, key=lambda c: c.total_seconds, default=None)

    def render(self) -> str:
        if not self.chains:
            return "HLO LCD: no while-loop carried chains found"
        lines = ["HLO loop-carried dependency chains:"]
        for c in sorted(self.chains, key=lambda c: -c.total_seconds)[:8]:
            lines.append(
                f"  while={c.while_op} state[{c.tuple_index}] "
                f"period {c.seconds * 1e6:.2f} us x {c.trip_count} trips = "
                f"{c.total_seconds * 1e3:.3f} ms  ({len(c.ops)} ops)"
            )
        return "\n".join(lines)


_INDEX_RE = re.compile(r"index=(\d+)")


def _body_chains(
    module: HLOModule, while_op: HLOOp, body_name: str, cost: HLOCostModel,
    device: torch.device,
) -> List[CarriedChain]:
    comp = module.computations.get(body_name)
    if comp is None or comp.root is None or comp.root.opcode != "tuple":
        return []
    index = {op.name: i for i, op in enumerate(comp.ops)}
    weights = [cost.op_seconds(op, comp) for op in comp.ops]

    # get-tuple-element reads of the loop state, by tuple index.
    gte_by_index: Dict[int, List[int]] = {}
    param_names = {p.name for p in comp.params}
    for i, op in enumerate(comp.ops):
        if op.opcode == "get-tuple-element" and op.operands and \
                op.operands[0] in param_names:
            m = _INDEX_RE.search(op.attrs)
            if m:
                gte_by_index.setdefault(int(m.group(1)), []).append(i)

    trips = cost.while_trip_count(while_op)
    chains: List[CarriedChain] = []
    root_operands = comp.root.operands

    # One matrix row per loop-state element; its allowed path starts are the
    # element's GTE reads.  All rows share one topological sweep.
    rows: List[Tuple[int, int, List[int]]] = []  # (tuple idx, target, starts)
    for tuple_idx, starts in gte_by_index.items():
        if tuple_idx >= len(root_operands):
            continue
        target = index.get(root_operands[tuple_idx])
        if target is None:
            continue
        rows.append((tuple_idx, target, starts))
    if not rows:
        return chains

    preds = [
        [j for operand in op.operands
         if (j := index.get(operand)) is not None and j < i]
        for i, op in enumerate(comp.ops)
    ]
    ptr, idx = pred_csr_from_lists(preds)
    D, P = batched_longest_paths(ptr, idx, np.asarray(weights, dtype=float),
                                 [starts for _, _, starts in rows], device=device)
    # One copy each to the host, row-major for the per-row backtracks.
    D = D.cpu().numpy()
    P = P.contiguous().cpu().numpy()

    for row, (tuple_idx, target, _) in enumerate(rows):
        if not is_reached(D[row, target]):
            continue
        path_ids = backtrack(P[row], target)
        if len(path_ids) <= 1:
            continue  # pass-through state (e.g. untouched weights)
        chains.append(CarriedChain(
            while_op=while_op.name, body=body_name, tuple_index=tuple_idx,
            seconds=float(D[row, target]), ops=tuple(comp.ops[v].name
                                                     for v in path_ids),
            trip_count=trips,
        ))
    return chains


def hlo_loop_carried(source, chip: GPUChip = H100_SXM,
                     device=None) -> HLOLCDResult:
    """``source`` is HLO text, a parsed module, or an ExportedProgram.  Each
    while body's sweep runs on ``device`` (``None``: the CUDA device, which
    raises when there is none)."""
    device = resolve_device(device)
    module = as_module(source)
    cost = HLOCostModel(module, chip)
    chains: List[CarriedChain] = []
    for comp in module.computations.values():
        for op in comp.ops:
            if op.opcode != "while":
                continue
            body = op.body_computation
            if body is not None:
                chains.extend(_body_chains(module, op, body, cost, device))
    return HLOLCDResult(chains=tuple(chains))
