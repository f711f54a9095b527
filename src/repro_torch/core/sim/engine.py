"""Window-limited out-of-order simulator (ROADMAP open item 1).

The paper's analyses bracket a kernel's steady-state cost: the port-pressure
throughput bound assumes an *infinite* scheduling window, the critical path
assumes *no* resource limits.  Real cores sit between the two because the
out-of-order window is finite — uiCA (arXiv:2107.14210) demonstrates that
modeling the frontend width, ROB/scheduler/LSQ capacities, and in-order
retirement is what turns the bracket into a point prediction.  This module
is that model at the resolution of our machine DBs.

Mechanics
---------
The simulator replays the kernel's dependency DAG over ``K`` back-to-back
body copies.  Because every copy redefines the same registers, a cross-copy
dependency always spans exactly one copy, so the 2-copy dual-writeback DAG
built by :func:`repro_torch.core.analysis.analyze.analyze_kernel` is a complete
template: copy-1's predecessor lists split into *intra* edges (distance 0)
and *cross* edges (distance 1), and copy-0's lists are exactly the intra
subset.  :func:`template_from_dag` extracts this once; the event-driven
sweep then computes, for every replicated node in program order,

``dispatch``
    bounded by program order, the frontend issue width, a free ROB slot
    (FIFO: the slot of the node ``rob_size`` back frees at its retirement),
    a free scheduler slot (a min-heap over occupants' issue times — pop the
    earliest-freeing slot when full), and a free load/store-queue slot
    (FIFO on retirement, loads and stores in separate queues).
``issue``
    when dispatched, all register inputs are complete, and a port from each
    µ-op's eligible set is free; µ-ops greedily take the earliest-available
    eligible port (oldest-first, no backfilling — an age-ordered scheduler).
``complete``
    issue of the last µ-op plus the node's DB latency.
``retire``
    in order, ``retire_width`` per cycle, never before completion.

Per-copy retire-time deltas converge geometrically to the steady-state
cycles per block; the sweep stops at the first stable window.

The per-node state recurrence is inherently sequential, so the inner sweep
is a tight scalar loop; the *static* per-node data (latencies, CSR
predecessor offsets, µ-op port sets), the convergence detection, and the
:func:`simulate_kernels` batch API are NumPy-vectorized.

Bracket closure
---------------
Greedy integral scheduling can only do worse than the fractional min-max
bound, so the measured steady state satisfies ``raw >= TP(balanced)`` up to
convergence tolerance; it can exceed CP when port contention or window
stalls dominate (and for resource-bound kernels ``TP > CP`` makes the
bracket empty).  The headline prediction is therefore clamped into
``[TP, max(TP, CP)]`` — the differential invariant ``TP(balanced) <= sim
<= CP`` holds on every kernel whose bracket is well-formed, and ``sim ==
TP`` on resource-pinned kernels.  The unclamped measurement is kept in
:attr:`SimResult.raw_cy_per_block`.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analysis.dag import DependencyDAG, build_dag
from repro_torch.core.machine.model import MachineModel, pressure_uops
from repro_torch.core.machine.window import WindowParams

#: |delta_c - delta_{c-1}| below this counts as a converged steady state.
CONVERGENCE_TOL = 1e-9


@dataclass(frozen=True)
class KernelTemplate:
    """Static per-copy node data extracted from a 2-copy dual-writeback DAG."""

    n_nodes: int  # nodes per body copy
    latency: np.ndarray  # (n_nodes,) float64
    # CSR predecessor offsets: intra-copy (distance 0) and cross-copy
    # (distance 1, offsets into the *previous* copy).
    intra_ptr: np.ndarray
    intra_idx: np.ndarray
    cross_ptr: np.ndarray
    cross_idx: np.ndarray
    # Per node: tuple of (cycles, eligible port indices) µ-ops.
    uops: Tuple[Tuple[Tuple[float, Tuple[int, ...]], ...], ...]
    is_load: np.ndarray  # (n_nodes,) bool — occupies a load-queue entry
    is_store: np.ndarray  # (n_nodes,) bool — occupies a store-queue entry
    ports: Tuple[str, ...]


@dataclass(frozen=True)
class SimResult:
    """Steady-state point prediction for one kernel block."""

    cy_per_block: float  # headline prediction, clamped into [TP, max(TP, CP)]
    raw_cy_per_block: float  # unclamped measured steady-state delta
    copies: int  # body copies simulated before convergence (or the cap)
    converged: bool
    clamped_to: str  # "" | "tp" | "cp" — which bracket edge clipped raw
    limiter: str  # dominant binding constraint in the last simulated copy
    window: Optional[WindowParams] = None
    port_busy: Dict[str, float] = None  # type: ignore[assignment]

    def per_iteration(self, unroll: int) -> float:
        return self.cy_per_block / max(unroll, 1)


def uops_for_cost(cost, kind: str, is_wb: bool, port_index: Dict[str, int]):
    """Eligible-port µ-ops for one DAG node, as port *indices*.

    Split-load nodes carry the machine's load part; instruction nodes carry
    the primary entry plus any split-store part (stores get no separate DAG
    node).  Writeback address-update nodes and macro-fused-away compares
    occupy frontend/ROB slots but no execution port, matching the throughput
    analysis, which charges them no pressure either.

    Shared by the per-kernel DAG path (:func:`template_from_dag`) and, in
    the reference, the batched array engine (``repro.core.analysis.batch``),
    which carries node kinds in parallel lists instead of ``Node`` objects.
    """
    if cost is None or is_wb or cost.fused_away:
        return ()
    if kind == "load":
        entries = (cost.load,)
    else:
        entries = (cost.entry, cost.store)
    uops = []
    for entry in entries:
        if entry is None:
            continue
        for cycles, ports in (entry.uops if entry.uops is not None
                              else pressure_uops(entry.pressure)):
            if cycles <= 0.0 or not ports:
                continue
            uops.append((float(cycles), tuple(port_index[p] for p in ports)))
    return tuple(uops)


def _node_uops(node, port_index: Dict[str, int]):
    return uops_for_cost(node.cost, node.kind, node.is_wb, port_index)


def _csr(lists: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    ptr = np.zeros(len(lists) + 1, dtype=np.int64)
    for i, row in enumerate(lists):
        ptr[i + 1] = ptr[i] + len(row)
    idx = np.fromiter((p for row in lists for p in row), dtype=np.int64,
                      count=int(ptr[-1]))
    return ptr, idx


def template_from_parts(
    latencies: Sequence[float],
    preds_copy1: Sequence[Sequence[int]],
    kinds: Sequence[str],
    is_wb_flags: Sequence[bool],
    costs_per_node: Sequence,
    model: MachineModel,
) -> KernelTemplate:
    """Build a :class:`KernelTemplate` from per-copy parallel arrays.

    ``preds_copy1[j]`` are the *global* 2-copy-DAG predecessor ids of copy-1
    node ``j`` (ids ``>= n`` are intra-copy, ``< n`` cross-copy);
    ``latencies``/``kinds``/``is_wb_flags``/``costs_per_node`` describe the
    ``n`` copy-0 nodes.  This is the assembly path of :func:`template_from_dag`
    without the ``Node`` objects, used by the batched analysis engine.
    """
    n = len(latencies)
    port_index = {p: i for i, p in enumerate(model.ports)}
    intra: List[List[int]] = []
    cross: List[List[int]] = []
    for j in range(n):
        row_i: List[int] = []
        row_c: List[int] = []
        for p in preds_copy1[j]:
            (row_i if p >= n else row_c).append(p - n if p >= n else p)
        intra.append(row_i)
        cross.append(row_c)
    intra_ptr, intra_idx = _csr(intra)
    cross_ptr, cross_idx = _csr(cross)

    is_load = np.zeros(n, dtype=bool)
    is_store = np.zeros(n, dtype=bool)
    uops = []
    for j in range(n):
        cost = costs_per_node[j]
        wb = is_wb_flags[j]
        kind = kinds[j]
        uops.append(uops_for_cost(cost, kind, wb, port_index))
        if cost is not None and not wb:
            if kind == "load":
                is_load[j] = True
            else:
                if cost.form.loads and cost.load is None:
                    is_load[j] = True  # pure load: the instr is the access
                if cost.form.stores:
                    is_store[j] = True
    return KernelTemplate(
        n_nodes=n,
        latency=np.asarray(latencies[:n], dtype=np.float64),
        intra_ptr=intra_ptr, intra_idx=intra_idx,
        cross_ptr=cross_ptr, cross_idx=cross_idx,
        uops=tuple(uops), is_load=is_load, is_store=is_store,
        ports=tuple(model.ports),
    )


def template_from_dag(dag: DependencyDAG, model: MachineModel) -> KernelTemplate:
    """Extract the replication template from a ``copies=2`` DAG build.

    Uses the default (``preds``) adjacency — the split-writeback view, which
    is the hardware-true µ-op structure.
    """
    total = len(dag.nodes)
    if total % 2 != 0:
        raise ValueError("simulator template needs a copies=2 DAG build")
    n = total // 2
    for j in range(n):  # cheap structural check of copy alignment
        a, b = dag.nodes[j], dag.nodes[n + j]
        if (a.instr_index, a.kind, a.is_wb) != (b.instr_index, b.kind, b.is_wb):
            raise ValueError("DAG copies are not structurally aligned")
    return template_from_parts(
        latencies=[dag.nodes[j].latency for j in range(n)],
        preds_copy1=[dag.preds[n + j] for j in range(n)],
        kinds=[dag.nodes[j].kind for j in range(n)],
        is_wb_flags=[dag.nodes[j].is_wb for j in range(n)],
        costs_per_node=[dag.nodes[j].cost for j in range(n)],
        model=model,
    )


def _classify(d_terms: Dict[str, float], dispatch: float, ready: float,
              exec_start: float) -> str:
    if exec_start > max(dispatch, ready):
        return "ports"
    if ready > dispatch:
        return "dependencies"
    # Dispatch-bound: name a window constraint only if it was binding.
    for name, t in d_terms.items():
        if t == dispatch and name != "frontend":
            return name
    return "frontend"


def simulate_template(
    template: KernelTemplate,
    window: WindowParams,
    *,
    max_copies: int = 48,
    warmup_copies: int = 2,
    tol: float = CONVERGENCE_TOL,
    cancel: Optional[Callable[[], None]] = None,
) -> Tuple[float, int, bool, str, Dict[str, float]]:
    """Run the sweep; returns ``(cy/block, copies, converged, limiter,
    port_busy)``."""
    n = template.n_nodes
    if n == 0:
        return 0.0, 0, True, "", {}
    lat = template.latency.tolist()
    ip, ii = template.intra_ptr.tolist(), template.intra_idx.tolist()
    cp_, ci = template.cross_ptr.tolist(), template.cross_idx.tolist()
    uops = template.uops
    is_load = template.is_load.tolist()
    is_store = template.is_store.tolist()
    width = window.issue_width
    rob = window.rob_size
    retire_w = window.retire_width
    lsq = window.lsq_size

    disp: List[float] = []
    comp: List[float] = []
    ret: List[float] = []
    sched_heap: List[float] = []
    sched_cap = window.sched_size
    lq: List[int] = []  # global ids of load-queue occupants, dispatch order
    sq: List[int] = []
    port_free = [0.0] * len(template.ports)
    port_busy = [0.0] * len(template.ports)

    deltas = np.zeros(max_copies, dtype=np.float64)
    copies = 0
    converged = False
    limiter_votes: Dict[str, int] = {}
    cy_block = 0.0
    # Bodies narrower than the frontend/retire width retire several copies
    # per cycle, so per-copy retire deltas are *periodic* (e.g. 0,0,0,1 for
    # a 1-µ-op body on a width-4 machine), not constant.  Convergence must
    # therefore compare span-aligned windowed means; span degenerates to 1
    # (plain adjacent deltas) whenever the body fills the machine width.
    span = max(1, -(-width // n), -(-retire_w // n))

    for c in range(max_copies):
        if cancel is not None:
            cancel()
        base = c * n
        if c == max_copies - 1 or c >= warmup_copies:
            limiter_votes = {}
        for p in range(len(port_busy)):
            port_busy[p] = 0.0
        for j in range(n):
            k = base + j
            # -- dispatch ---------------------------------------------------
            d_terms: Dict[str, float] = {}
            d = disp[k - 1] if k else 0.0
            if k >= width:
                d_terms["frontend"] = disp[k - width] + 1.0
            if k >= rob:
                d_terms["rob"] = ret[k - rob]
            if is_load[j]:
                lq.append(k)
                if len(lq) > lsq:
                    d_terms["lsq"] = ret[lq[-1 - lsq]]
            if is_store[j]:
                sq.append(k)
                if len(sq) > lsq:
                    d_terms["lsq"] = max(d_terms.get("lsq", 0.0),
                                         ret[sq[-1 - lsq]])
            if len(sched_heap) >= sched_cap:
                d_terms["scheduler"] = heapq.heappop(sched_heap)
            for t in d_terms.values():
                if t > d:
                    d = t
            # -- ready ------------------------------------------------------
            r = 0.0
            for q in range(ip[j], ip[j + 1]):
                t = comp[base + ii[q]]
                if t > r:
                    r = t
            if c:
                prev = base - n
                for q in range(cp_[j], cp_[j + 1]):
                    t = comp[prev + ci[q]]
                    if t > r:
                        r = t
            t0 = d if d > r else r
            # -- issue: greedy earliest eligible port -----------------------
            exec_start = t0
            for cycles, ports in uops[j]:
                best_p = ports[0]
                best_t = port_free[best_p]
                if len(ports) > 1:
                    for p in ports[1:]:
                        t = port_free[p]
                        if t < best_t:
                            best_t, best_p = t, p
                        if t <= t0:
                            break
                start = best_t if best_t > t0 else t0
                port_free[best_p] = start + cycles
                port_busy[best_p] += cycles
                if start > exec_start:
                    exec_start = start
            heapq.heappush(sched_heap, exec_start)
            comp.append(exec_start + lat[j])
            # -- retire -----------------------------------------------------
            t = comp[k]
            if k and ret[k - 1] > t:
                t = ret[k - 1]
            if k >= retire_w and ret[k - retire_w] + 1.0 > t:
                t = ret[k - retire_w] + 1.0
            ret.append(t)
            disp.append(d)
            if c >= warmup_copies:
                label = _classify(d_terms, d, r, exec_start)
                limiter_votes[label] = limiter_votes.get(label, 0) + 1
        copies = c + 1
        if c == 0:
            deltas[0] = ret[-1]
        else:
            deltas[c] = ret[-1] - ret[base - 1]
        if c >= warmup_copies + 2 * span - 1:
            last = deltas[c - span + 1:c + 1]
            prev = deltas[c - 2 * span + 1:c - span + 1]
            if abs(float(last.mean()) - float(prev.mean())) <= tol:
                cy_block = float(last.mean())
                converged = True
                break
            if c >= warmup_copies + 4 * span - 1:
                # Period-2 oscillation on top of the span: accept a stable
                # double-width windowed mean.
                w4 = deltas[c - 4 * span + 1:c + 1]
                half = 2 * span
                if abs(float(w4[:half].mean()) -
                       float(w4[half:].mean())) <= max(tol, 1e-6):
                    cy_block = float(w4.mean())
                    converged = True
                    break
    if not converged:
        tail = deltas[max(copies - 8, 1):copies]
        cy_block = float(tail.mean()) if tail.size else float(deltas[0])
    limiter = max(limiter_votes, key=limiter_votes.get) if limiter_votes else ""
    busy = {template.ports[p]: port_busy[p]
            for p in range(len(port_busy)) if port_busy[p] > 0.0}
    return cy_block, copies, converged, limiter, busy


def simulate_from_dag(
    dag: DependencyDAG,
    model: MachineModel,
    *,
    window: Optional[WindowParams] = None,
    tp_block: Optional[float] = None,
    cp_block: Optional[float] = None,
    max_copies: int = 48,
    cancel: Optional[Callable[[], None]] = None,
) -> SimResult:
    """Simulate a kernel from its 2-copy DAG and clamp into the bracket.

    ``tp_block``/``cp_block`` are the balanced-throughput and critical-path
    predictions in cycles per *block* (not per iteration); either may be
    ``None``, in which case that side of the clamp is skipped.
    """
    params = window if window is not None else model.window
    if params is None:
        raise ValueError(f"machine '{model.name}' has no window parameters; "
                         f"pass window= explicitly")
    template = template_from_dag(dag, model)
    raw, copies, converged, limiter, busy = simulate_template(
        template, params, max_copies=max_copies, cancel=cancel)
    value = raw
    clamped = ""
    if tp_block is not None and value < tp_block:
        value = tp_block
        clamped = "tp"
    ceiling = cp_block
    if ceiling is not None and tp_block is not None and tp_block > ceiling:
        ceiling = tp_block  # resource-pinned kernel: empty bracket
    if ceiling is not None and value > ceiling:
        value = ceiling
        clamped = "cp"
    return SimResult(cy_per_block=value, raw_cy_per_block=raw, copies=copies,
                     converged=converged, clamped_to=clamped, limiter=limiter,
                     window=params, port_busy=busy)


def simulate_kernel(kernel, model: MachineModel, *,
                    window: Optional[WindowParams] = None,
                    max_copies: int = 48) -> SimResult:
    """Standalone entry point: resolve, build the DAG, bracket, simulate."""
    from repro_torch.core.analysis.critical_path import critical_path_from_dag
    from repro_torch.core.analysis.throughput import throughput_from_costs

    costs = model.resolve_kernel(kernel)
    tp = throughput_from_costs(costs, model)
    dag = build_dag(kernel, model, copies=2, costs=costs, dual_writeback=True)
    cp = critical_path_from_dag(dag)
    return simulate_from_dag(dag, model, window=window,
                             tp_block=tp.balanced_throughput,
                             cp_block=cp.length, max_copies=max_copies)


def simulate_kernels(kernels, model: MachineModel, *,
                     window: Optional[WindowParams] = None,
                     max_copies: int = 48) -> List[SimResult]:
    """Batched convenience wrapper over :func:`simulate_kernel`."""
    return [simulate_kernel(k, model, window=window, max_copies=max_copies)
            for k in kernels]
