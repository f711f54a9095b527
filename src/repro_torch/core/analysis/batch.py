"""Batched multi-kernel analysis: one wave of kernels, one pass per stage.

``analyze_wave`` analyzes N kernels against one machine model with the wave's
TP/CP/LCD work padded and stacked into rank-3 arrays instead of N independent
per-kernel calls, as ``repro.core.analysis.batch`` does:

* **TP** (host, NumPy) — every kernel's per-instruction port pressures go
  into one ``(K, I_max, P)`` array; the per-port accumulation adds one
  instruction slot at a time, which fixes the bits, and the bottleneck argmax
  runs once across the wave.  The balanced (min-max water-filling) bound
  stays per kernel through ``min_max_load``, whose demand product takes the
  host BLAS's summation order (``scheduler.py``).
* **CP** (``device``) — the copy-0 data-chained views are slot-aligned into a
  padded predecessor matrix and the node-weighted longest-path DP advances
  every kernel one topological level per step.
* **LCD** (``device``) — the all-sources sweep over the 2-copy
  split-writeback views: distances ``(K, V_max + 1, S_max)``, every source
  column of every kernel advanced one level per step, in chunks under
  :data:`_CHUNK_BYTES`.

CP and LCD share one level-synchronous pass (:func:`_wavefront`): ``dist``
and ``parent`` are float64 / int64 tensors on ``device``; the predecessor
blocks, write indices and start triples reach it in one copy per dtype; the
level bookkeeping stays in host lists, so the level loop never reads the
device; ``dist`` and ``parent`` come back in one copy each for the
per-kernel tails, which run the reference's NumPy code.  Every device op is
a gather, a max, an add, a compare or a scatter of float64 values, so the
results are those of the reference bit for bit on every device.

Bit-identity with :func:`repro_torch.core.analysis.analyze.analyze_kernel`
(and with the reference) pins three design points:

* The graph compiler (:func:`_compile_graph`) replays ``build_dag``'s edge
  emission sequence exactly — same set/dict insertion orders, same global
  ``(src, dst)`` dedup — so every predecessor list is in the same insertion
  order and the sweeps' first-max tie-breaks resolve identically.
* Padding predecessor slots point at a dummy node pinned to ``_PAD_VALUE``,
  strictly below every value a real node can hold (reached values are
  ``>= 0``; unreachable values sit near :data:`UNREACHABLE`), and padding is
  appended *after* real predecessors, so a first-max reduction (``torch.max``
  over a dimension returns the first maximal index on the CPU and on CUDA)
  can never select padding over a real candidate and never reorders real
  ties.
* Vectorized accumulations replicate the scalar operation order: per-slot
  adds with identical operands, plus the fact that ``x + 0.0 == x`` bitwise
  for the non-negative pressures involved, keep every float transcript
  identical to the scalar engine's.

Kernels the tensor layout cannot represent exactly (no instructions, or DB
pressure on ports outside ``model.ports``) fall back to the per-kernel
engine on the same device.
"""

from __future__ import annotations

from itertools import chain
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

from repro_torch.core.analysis.critical_path import CriticalPathResult
from repro_torch.core.analysis.dag import Node
from repro_torch.core.analysis.lcd import LCDChain, LCDResult
from repro_torch.core.analysis.scheduler import gather_classes, min_max_load
from repro_torch.core.analysis.sweep import UNREACHABLE, backtrack, is_reached
from repro_torch.core.analysis.throughput import ThroughputResult
from repro_torch.core.isa.instruction import Kernel
from repro_torch.core.machine.model import InstructionCost, MachineModel
from repro_torch.core.sim.engine import (SimResult, simulate_template,
                                   template_from_parts)

#: Distance pinned on the dummy padding node: strictly below every value a
#: real node can carry (reached sums are >= 0, unreachable entries stay near
#: ``UNREACHABLE`` = -1e18 — see sweep.py), so padded predecessor slots never
#: win an argmax against a real candidate.
_PAD_VALUE = -1.0e30

#: Per-chunk budget for the LCD distance + parent tensors (bytes).  Waves
#: whose padded (K × V_max × S_max) tensors would exceed it are split into
#: size-sorted chunks; chunking is invisible in the results (padding is
#: proven inert), it only bounds peak memory.
_CHUNK_BYTES = 32 * 1024 * 1024

#: CP and LCD chunk passes run, by the device type their tensors lived on.
WAVE_PASSES: Dict[str, int] = {"cpu": 0, "cuda": 0}


def reset_wave_passes() -> None:
    for name in WAVE_PASSES:
        WAVE_PASSES[name] = 0


class _Graph:
    """Lean 2-copy dual-writeback dependency graph for one kernel.

    The same node/edge structure ``build_dag(kernel, model, copies=2,
    dual_writeback=True)`` produces, held as parallel lists instead of
    ``Node`` objects: ``preds`` is the split-writeback (LCD) view over both
    copies, ``cp_preds`` the data-chained (CP) view over copy 0 only — the
    only part of the CP view the analysis reads.
    """

    __slots__ = ("n", "total", "kind", "instr_index", "is_wb", "lat",
                 "member", "cost", "preds", "cp_preds", "outdeg", "instr0",
                 "lvl", "cp_lvl")

    def __init__(self):
        self.kind: List[str] = []
        self.instr_index: List[int] = []
        self.is_wb: List[bool] = []
        self.lat: List[float] = []
        self.member: List[int] = []  # instr_index for "instr" nodes, else -1
        self.cost: List[InstructionCost] = []
        self.preds: List[List[int]] = []
        self.cp_preds: List[List[int]] = []
        self.outdeg: List[int] = []  # LCD-view out-degree
        self.instr0: List[int] = []  # body idx -> copy-0 instruction node id
        self.lvl: List[int] = []     # LCD-view topological level per node
        self.cp_lvl: List[int] = []  # CP-view level per copy-0 node
        self.n = 0       # nodes per copy
        self.total = 0   # 2 * n


def _compile_graph(costs: Sequence[InstructionCost]) -> _Graph:
    """Compile one kernel's 2-copy dual-writeback graph.

    Mirrors ``build_dag``'s emission sequence statement for statement (same
    per-form set construction, same edge order, same global ``(src, dst)``
    dedup) so predecessor insertion orders — which carry the sweeps'
    tie-breaking — are identical.  Compilation is split into a copy-invariant
    node-sequence pass (kinds, latencies, members — identical in both copies,
    so built once and duplicated by list concatenation) and the per-copy edge
    emission, which replays ``build_dag``'s register tracking; set iteration
    order is a property of the insertion sequence, so the shared static data
    preserves the order ``build_dag`` sees in each copy.
    """
    g = _Graph()

    # Phase A - copy-invariant node sequence + per-instruction emission plan.
    seq_kind: List[str] = []
    seq_ii: List[int] = []
    seq_wb: List[bool] = []
    seq_lat: List[float] = []
    seq_mem: List[int] = []
    seq_cost: List[InstructionCost] = []
    plan: List[tuple] = []
    off = 0
    for idx, cost in enumerate(costs):
        form = cost.form
        addr_regs = {
            r.name
            for mem in (*form.loads, *form.stores)
            for r in mem.address_registers
        }
        writeback_regs = {
            mem.base.name
            for mem in (*form.loads, *form.stores)
            if (mem.post_index or mem.pre_index) and mem.base is not None
        }
        addr = tuple(addr_regs)
        data = (tuple(s for s in form.source_registers if s not in addr_regs)
                if not form.is_dep_breaking else ())
        dests = tuple((r, r in writeback_regs) for r in form.dest_registers)
        load_off = None
        if cost.load is not None:
            load_off = off
            off += 1
            seq_kind.append("load")
            seq_ii.append(idx)
            seq_wb.append(False)
            seq_lat.append(cost.load.latency)
            seq_mem.append(-1)
            seq_cost.append(cost)
        nid_off = off
        off += 1
        seq_kind.append("instr")
        seq_ii.append(idx)
        seq_wb.append(False)
        seq_lat.append(cost.entry.latency)
        seq_mem.append(idx)
        seq_cost.append(cost)
        wb_off = None
        if writeback_regs:
            # Separate address-update µ-op, LCD view only (no CP edges).
            wb_off = off
            off += 1
            seq_kind.append("instr")
            seq_ii.append(idx)
            seq_wb.append(True)
            seq_lat.append(1.0)
            seq_mem.append(idx)
            seq_cost.append(cost)
        plan.append((load_off, nid_off, wb_off, addr, data, dests))
    n = off
    g.n = n
    g.total = 2 * n
    g.kind = seq_kind + seq_kind
    g.instr_index = seq_ii + seq_ii
    g.is_wb = seq_wb + seq_wb
    g.lat = seq_lat + seq_lat
    g.member = seq_mem + seq_mem
    g.cost = seq_cost + seq_cost
    g.instr0 = [p[1] for p in plan]

    # Phase B - per-copy edge emission.  Edge dedup is by (src, dst); dst is
    # fixed within each emission block, so the global ``(src, dst) in edges``
    # test ``build_dag`` uses is exactly ``src in preds[dst]`` — a short-list
    # scan with no tuple allocation.
    preds: List[List[int]] = []
    cp_preds: List[List[int]] = []
    outdeg = [0] * (2 * n)
    lvl: List[int] = []
    cp_lvl: List[int] = []
    g.preds, g.cp_preds, g.outdeg = preds, cp_preds, outdeg
    g.lvl, g.cp_lvl = lvl, cp_lvl
    preds_ap, cpp_ap = preds.append, cp_preds.append
    lvl_ap, cplvl_ap = lvl.append, cp_lvl.append
    last_def: Dict[str, int] = {}
    cp_last_def: Dict[str, int] = {}
    ld_get = last_def.get
    cp_get = cp_last_def.get

    for base in (0, n):
        cp_active = base == 0  # the CP analysis only reads the copy-0 prefix
        for load_off, nid_off, wb_off, addr, data, dests in plan:
            load_id = None
            if load_off is not None:
                load_id = load_off + base
                pl: List[int] = []
                cpl: List[int] = []
                preds_ap(pl)
                cpp_ap(cpl)
                for r in addr:
                    src = ld_get(r)
                    if src is not None and src not in pl:
                        pl.append(src)
                        outdeg[src] += 1
                    if cp_active:
                        src = cp_get(r)
                        if src is not None and src not in cpl:
                            cpl.append(src)
                m = -1
                for p in pl:
                    if lvl[p] > m:
                        m = lvl[p]
                lvl_ap(m + 1)
                if cp_active:
                    m = -1
                    for p in cpl:
                        if cp_lvl[p] > m:
                            m = cp_lvl[p]
                    cplvl_ap(m + 1)

            nid = nid_off + base
            pl = []
            cpl = []
            preds_ap(pl)
            cpp_ap(cpl)

            if load_id is not None:
                # _shared_edge: structurally present in both views.
                pl.append(load_id)
                outdeg[load_id] += 1
                if cp_active:
                    cpl.append(load_id)
            else:
                for r in addr:
                    src = ld_get(r)
                    if src is not None and src != nid and src not in pl:
                        pl.append(src)
                        outdeg[src] += 1
                    if cp_active:
                        src = cp_get(r)
                        if src is not None and src != nid \
                                and src not in cpl:
                            cpl.append(src)
            for r in data:
                src = ld_get(r)
                if src is not None and src != nid and src not in pl:
                    pl.append(src)
                    outdeg[src] += 1
                if cp_active:
                    src = cp_get(r)
                    if src is not None and src != nid and src not in cpl:
                        cpl.append(src)
            m = -1
            for p in pl:
                if lvl[p] > m:
                    m = lvl[p]
            lvl_ap(m + 1)
            if cp_active:
                m = -1
                for p in cpl:
                    if cp_lvl[p] > m:
                        m = cp_lvl[p]
                cplvl_ap(m + 1)

            wb_id = None
            if wb_off is not None:
                wb_id = wb_off + base
                pl = []
                preds_ap(pl)
                cpp_ap([])
                for r in addr:
                    src = ld_get(r)
                    if src is not None and src not in pl:
                        pl.append(src)
                        outdeg[src] += 1
                m = -1
                for p in pl:
                    if lvl[p] > m:
                        m = lvl[p]
                lvl_ap(m + 1)
                if cp_active:
                    cplvl_ap(0)  # wb nodes have no CP edges

            for r, routes_to_wb in dests:
                last_def[r] = wb_id if (routes_to_wb and wb_id is not None) \
                    else nid
                if cp_active:
                    cp_last_def[r] = nid
    return g


# -- batched throughput -------------------------------------------------------


def _batched_tp(costs_list: Sequence[Sequence[InstructionCost]],
                model: MachineModel) -> List[Optional[ThroughputResult]]:
    """One masked pressure-tensor pass for the whole wave.

    Returns one ``ThroughputResult`` per kernel, or ``None`` for kernels the
    dense layout cannot represent bit-exactly (pressure on a port outside
    ``model.ports``, or a negative pressure) — those fall back to the
    per-kernel engine.
    """
    ports = model.ports
    port_ix = {p: i for i, p in enumerate(ports)}
    n_ports = len(ports)
    k_total = len(costs_list)
    if n_ports == 0:
        return [None] * k_total

    rows_list: List[Optional[list]] = [None] * k_total
    # Pressure dicts are shared across costs resolved from the same DB parts
    # (the model's lookup memo injects one dict per distinct entry), so the
    # port-index/value decomposition is memoized per dict for the wave.
    items_memo: Dict[int, Tuple[List[int], List[float], bool]] = {}
    cell_k: List[int] = []   # per-instruction kernel row
    cell_i: List[int] = []   # per-instruction slot
    cell_n: List[int] = []   # per-instruction pressure-item count
    flat_p: List[int] = []
    flat_v: List[float] = []
    i_max = 0
    for k, costs in enumerate(costs_list):
        if not costs:
            continue  # empty kernel: handled by the per-kernel fallback
        rows = []
        ok = True
        mark_c, mark_f = len(cell_k), len(flat_p)
        for i, cost in enumerate(costs):
            pressure = cost.total_pressure
            rows.append((cost, pressure))
            ent = items_memo.get(id(pressure))
            if ent is None:
                ixs: List[int] = []
                vals: List[float] = []
                good = True
                for port, cy in pressure.items():
                    ix = port_ix.get(port)
                    if ix is None or cy < 0.0:
                        good = False
                        break
                    ixs.append(ix)
                    vals.append(cy)
                ent = (ixs, vals, good)
                items_memo[id(pressure)] = ent
            ixs, vals, good = ent
            if not good:
                ok = False
                break
            cell_k.append(k)
            cell_i.append(i)
            cell_n.append(len(ixs))
            flat_p.extend(ixs)
            flat_v.extend(vals)
        if not ok:
            # Drop the partial row so a rejected kernel can never widen or
            # pollute the tensor.
            del cell_k[mark_c:], cell_i[mark_c:], cell_n[mark_c:]
            del flat_p[mark_f:], flat_v[mark_f:]
            continue
        rows_list[k] = rows
        if len(rows) > i_max:
            i_max = len(rows)

    out: List[Optional[ThroughputResult]] = [None] * k_total
    live = [k for k in range(k_total) if rows_list[k] is not None]
    if not live:
        return out

    tensor = np.zeros((k_total, i_max, n_ports), dtype=np.float64)
    if flat_v:
        flat_k = np.repeat(np.asarray(cell_k, dtype=np.int64), cell_n)
        flat_i = np.repeat(np.asarray(cell_i, dtype=np.int64), cell_n)
        tensor[flat_k, flat_i, flat_p] = flat_v
    # Slot-loop accumulation: per port, the adds happen in instruction order
    # with +0.0 identities interleaved — bit-identical to the scalar
    # per-kernel accumulation over non-negative pressures.
    totals = np.zeros((k_total, n_ports), dtype=np.float64)
    for i in range(i_max):
        totals += tensor[:, i, :]
    bottleneck_ix = totals.argmax(axis=1)  # first max == scalar dict-order max

    # Cross-wave dedup of the water-filling solve: ``min_max_load`` is a pure
    # function of the (insertion-ordered) eligibility classes, so kernels with
    # identical class transcripts — common in unrolled / structurally repeated
    # waves — share one bit-identical solve.  The signature keys on the items
    # *in order* because dict iteration order carries the solver's float-op
    # order.
    totals_rows = totals.tolist()  # bit-identical Python floats, one pass
    bn_ix = bottleneck_ix.tolist()
    balance_memo: Dict[tuple, object] = {}
    for k in live:
        rows = rows_list[k]
        port_pressure = dict(zip(ports, totals_rows[k]))
        bn = ports[bn_ix[k]] if n_ports else ""
        classes = gather_classes(costs_list[k])
        sig = tuple(classes.items())
        schedule = balance_memo.get(sig)
        if schedule is None:
            schedule = min_max_load(classes, ports)
            balance_memo[sig] = schedule
            port_load = schedule.port_load
        else:
            port_load = dict(schedule.port_load)  # don't share the mutable dict
        out[k] = ThroughputResult(
            port_pressure=port_pressure,
            per_instruction=tuple(rows),
            block_throughput=port_pressure.get(bn, 0.0),
            bottleneck_port=bn,
            balanced_throughput=schedule.bound,
            balanced_port_load=port_load,
            balanced_bottleneck=schedule.bottleneck_port,
        )
    return out


# -- the level-synchronous pass on the device ---------------------------------


def _chunk_indices(order: Sequence[int], sizes: Dict[int, Tuple[int, int]],
                   budget: int) -> List[List[int]]:
    """Greedy size-sorted chunking under a padded-tensor byte budget."""
    chunks: List[List[int]] = []
    cur: List[int] = []
    v_max = s_max = 0
    for k in sorted(order, key=lambda k: -sizes[k][0]):
        v, s = sizes[k]
        nv, ns = max(v_max, v), max(s_max, s)
        if cur and (len(cur) + 1) * (nv + 1) * max(ns, 1) * 16 > budget:
            chunks.append(cur)
            cur, v_max, s_max = [], 0, 0
            nv, ns = v, s
        cur.append(k)
        v_max, s_max = nv, ns
    if cur:
        chunks.append(cur)
    return chunks


def _wavefront(k_n: int, v_max: int, s_max: int, fill: float,
               totals: Sequence[int], lat_n: np.ndarray, lens_n: np.ndarray,
               lvl_n: np.ndarray, pred_e: np.ndarray,
               starts: Tuple[np.ndarray, ...],
               device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """Longest node-weighted paths of ``k_n`` stacked graphs, one
    topological level per step, every one of ``s_max`` columns at once.

    Row ``r`` holds the nodes ``0 .. totals[r] - 1`` of one graph; the
    per-node arrays (latency, in-degree, level) and the predecessor ids
    ``pred_e`` are concatenated over the rows in node order.  ``starts`` is
    ``(row, node, column, weight, level)`` per path start: after its node's
    own update, a start raises ``dist`` to its weight unless a longer or
    equal path already reaches it (path-through wins ties), and cuts the
    parent chain there.  Real nodes start at ``fill``, the dummy padding node
    ``v_max`` at :data:`_PAD_VALUE`.

    Returns ``dist`` ``(k_n, v_max + 1, s_max)`` and ``parent``
    ``(k_n, v_max, s_max)`` as host arrays, with the values the reference's
    NumPy passes give.
    """
    # Host: padded predecessor matrix and wavefront order, as the reference.
    row_n = np.repeat(np.arange(k_n), totals)
    node_n = np.concatenate([np.arange(t) for t in totals])
    n_nodes = row_n.size
    n_edges = pred_e.size
    node_pos_e = np.repeat(np.arange(n_nodes), lens_n)
    slot_e = np.arange(n_edges) - np.repeat(np.cumsum(lens_n) - lens_n,
                                            lens_n)
    d_max = max(int(lens_n.max()) if n_nodes else 0, 1)
    pred_mat = np.full((n_nodes, d_max), v_max, dtype=np.int64)  # dummy node
    pred_mat[node_pos_e, slot_e] = pred_e
    roff = row_n * (v_max + 1)

    # Same-level nodes have no mutual edges, so their updates read only
    # finished levels, and one step per level replicates the per-node
    # recurrence operand for operand.
    order = np.argsort(lvl_n, kind="stable")
    counts = np.bincount(lvl_n)                    # levels are contiguous
    n_levels = len(counts)
    bounds = np.concatenate(([0], np.cumsum(counts)))
    dmax_lvl = np.maximum.reduceat(lens_n[order], bounds[:-1])
    pm_srt = pred_mat[order]
    # Each level's (nodes x its widest in-degree) predecessor block, stored
    # back to back so that every step reads one contiguous slice.
    blocks = [pm_srt[a:b, :d] for a, b, d in
              zip(bounds[:-1], bounds[1:], dmax_lvl) if d]
    pred_raw = (np.concatenate([blk.ravel() for blk in blocks]) if blocks
                else np.zeros(0, dtype=np.int64))
    roff_blocks = [np.repeat(roff[order][a:b], d) for a, b, d in
                   zip(bounds[:-1], bounds[1:], dmax_lvl) if d]
    pred_row = pred_raw + (np.concatenate(roff_blocks) if roff_blocks
                           else np.zeros(0, dtype=np.int64))
    fidx = (roff + node_n)[order]               # write row of dist
    pidx = (row_n * v_max + node_n)[order]      # write row of parent

    st_row, st_src, st_col, st_w, st_lvl = starts
    st_order = np.argsort(st_lvl, kind="stable")
    st_row, st_src = st_row[st_order], st_src[st_order]
    st_col, st_w = st_col[st_order], st_w[st_order]
    st_bounds = np.concatenate(
        ([0], np.cumsum(np.bincount(st_lvl, minlength=n_levels))))
    # Each (row, node, column) start triple is unique, so the masked writes
    # below never race.
    st_d = (st_row * (v_max + 1) + st_src) * s_max + st_col
    st_p = (st_row * v_max + st_src) * s_max + st_col

    # Device: one copy per dtype of everything the level loop reads.
    sizes = (pred_row.size, pred_raw.size, n_nodes, n_nodes, st_d.size)
    ints = torch.from_numpy(np.concatenate(
        (pred_row, pred_raw, fidx, pidx, st_d, st_p))).to(device)
    pred_row_d, pred_raw_d, fidx_d, pidx_d, st_d_d, st_p_d = \
        ints.split(sizes + (st_p.size,))
    floats = torch.from_numpy(np.concatenate(
        (lat_n[order], st_w.astype(np.float64)))).to(device)
    lat_d, st_w_d = floats.split((n_nodes, st_w.size))

    dist = torch.full((k_n, v_max + 1, s_max), fill, dtype=torch.float64,
                      device=device)
    dist[:, v_max, :] = _PAD_VALUE  # dummy padding node
    parent = torch.full((k_n, v_max, s_max), -1, dtype=torch.int64,
                        device=device)
    rows = dist.view(k_n * (v_max + 1), s_max)
    parent_rows = parent.view(k_n * v_max, s_max)
    dist_1d, parent_1d = dist.view(-1), parent.view(-1)

    # The loop's bounds are host ints: no step waits for the device.
    bounds_l, dmax_l = bounds.tolist(), dmax_lvl.tolist()
    st_bounds_l = st_bounds.tolist()
    off = 0
    for lv in range(n_levels):
        a, b, d = bounds_l[lv], bounds_l[lv + 1], dmax_l[lv]
        m = b - a
        if d:
            pv = pred_row_d[off:off + m * d]
            raw = pred_raw_d[off:off + m * d]
            off += m * d
            sub = rows.index_select(0, pv)
            if d == 1:
                best = sub.add_(lat_d[a:b, None])
                arg_parent = raw[:, None].expand(m, s_max)
            else:
                best, arg = sub.view(m, d, s_max).max(dim=1)  # first max
                best.add_(lat_d[a:b, None])
                arg_parent = raw.view(m, d).gather(1, arg)
            rows.index_copy_(0, fidx_d[a:b], best)
            parent_rows.index_copy_(0, pidx_d[a:b], arg_parent)
        sa, sb = st_bounds_l[lv], st_bounds_l[lv + 1]
        if sb > sa:
            sd, sp, wv = st_d_d[sa:sb], st_p_d[sa:sb], st_w_d[sa:sb]
            cur = dist_1d.index_select(0, sd)
            take = cur < wv  # path-through wins ties, as in the scalar sweep
            dist_1d.index_copy_(0, sd, torch.where(take, wv, cur))
            parent_1d.index_copy_(
                0, sp, torch.where(take, -1, parent_1d.index_select(0, sp)))
    WAVE_PASSES[device.type] = WAVE_PASSES.get(device.type, 0) + 1
    return dist.cpu().numpy(), parent.cpu().numpy()


# -- batched critical path ----------------------------------------------------


def _batched_cp(graphs: Dict[int, _Graph],
                device: torch.device) -> Dict[int, CriticalPathResult]:
    """Copy-0 longest paths for every kernel, one level per step.

    Replicates ``critical_path_from_dag``: the DP runs over the data-chained
    CP view, tie-breaks on the first maximal predecessor, and the path
    endpoint is the first strict maximum over non-writeback copy-0 nodes.
    It is the one-column case of :func:`_wavefront` whose starts are the
    source nodes at their own weight: a node at level 0 has no predecessor,
    its ``dist`` goes from ``_PAD_VALUE`` to its latency and its parent stays
    ``-1``, which is what the reference writes there.
    """
    out: Dict[int, CriticalPathResult] = {}
    live = [k for k, g in graphs.items() if g.n > 0]
    if not live:
        return out
    k_n = len(live)
    ns = [graphs[k].n for k in live]
    v_max = max(ns)

    n_nodes = sum(ns)
    lat_n = np.fromiter(
        chain.from_iterable(graphs[k].lat[:graphs[k].n] for k in live),
        np.float64, count=n_nodes)
    wb_n = np.fromiter(
        chain.from_iterable(graphs[k].is_wb[:graphs[k].n] for k in live),
        bool, count=n_nodes)
    lens_n = np.fromiter(
        chain.from_iterable(map(len, graphs[k].cp_preds[:graphs[k].n])
                            for k in live),
        np.int64, count=n_nodes)
    lvl_n = np.fromiter(
        chain.from_iterable(graphs[k].cp_lvl for k in live),
        np.int64, count=n_nodes)
    n_edges = int(lens_n.sum())
    pred_e = np.fromiter(
        chain.from_iterable(
            chain.from_iterable(graphs[k].cp_preds[:graphs[k].n])
            for k in live),
        np.int64, count=n_edges)
    row_n = np.repeat(np.arange(k_n), ns)
    node_n = np.concatenate([np.arange(n) for n in ns])
    src = lvl_n == 0
    starts = (row_n[src], node_n[src], np.zeros(int(src.sum()), np.int64),
              lat_n[src], lvl_n[src])
    dist3, parent3 = _wavefront(k_n, v_max, 1, _PAD_VALUE, ns, lat_n, lens_n,
                                lvl_n, pred_e, starts, device)
    dist, parent = dist3[:, :, 0], parent3[:, :, 0]

    end_mask = np.zeros((k_n, v_max), dtype=bool)  # eligible path endpoints
    end_mask[row_n, node_n] = ~wb_n
    ends_scores = np.where(end_mask, dist[:, :v_max], -np.inf)
    ends = ends_scores.argmax(axis=1)  # first max == scalar strict-> scan
    for row, k in enumerate(live):
        g = graphs[k]
        end = int(ends[row])
        if not end_mask[row, end]:
            out[k] = CriticalPathResult(length=0.0, path=(), on_path=set())
            continue
        path_ids = backtrack(parent[row], end)
        path = tuple(
            Node(nid=v, kind=g.kind[v], instr_index=g.instr_index[v],
                 copy=0, latency=g.lat[v], cost=g.cost[v], is_wb=g.is_wb[v])
            for v in path_ids)
        out[k] = CriticalPathResult(
            length=float(dist[row, end]),
            path=path,
            on_path={n.instr_index for n in path if n.kind == "instr"},
        )
    return out


# -- batched LCD --------------------------------------------------------------


def _lcd_sources(g: _Graph) -> List[Tuple[int, int, int]]:
    """(body idx, copy-0 node, copy-1 node) source candidates, as in
    ``lcd_from_dag`` (cycle-incapable candidates pruned)."""
    sources = []
    n = g.n
    for idx, src in enumerate(g.instr0):
        dst = src + n
        if not g.outdeg[src] or not g.preds[dst]:
            continue
        sources.append((idx, src, dst))
    return sources


def _batched_lcd(graphs: Dict[int, _Graph],
                 device: torch.device) -> Dict[int, LCDResult]:
    """All kernels' all-sources LCD sweeps as rank-3 chunk passes.

    Each chunk holds a ``(K, V_max + 1, S_max)`` distance tensor: every
    source column of every kernel advances one level per step.  Source
    columns are independent (every operation is elementwise per column), so
    padded columns and padded node slots can never leak into a real member's
    result; the per-kernel tail (backtrack, period, chain dedup) replicates
    ``lcd_from_dag`` exactly.
    """
    out: Dict[int, LCDResult] = {}
    sources_by_k: Dict[int, List[Tuple[int, int, int]]] = {}
    sizes: Dict[int, Tuple[int, int]] = {}
    for k, g in graphs.items():
        sources = _lcd_sources(g)
        if not sources:
            out[k] = LCDResult(chains=(), longest=0.0, on_longest=set())
            continue
        sources_by_k[k] = sources
        sizes[k] = (g.total, len(sources))

    for chunk in _chunk_indices(list(sources_by_k), sizes, _CHUNK_BYTES):
        _lcd_chunk(graphs, sources_by_k, chunk, out, device)
    return out


def _lcd_chunk(graphs: Dict[int, _Graph],
               sources_by_k: Dict[int, List[Tuple[int, int, int]]],
               chunk: List[int], out: Dict[int, LCDResult],
               device: torch.device) -> None:
    k_n = len(chunk)
    totals = [graphs[k].total for k in chunk]
    v_max = max(totals)
    s_max = max(len(sources_by_k[k]) for k in chunk)

    n_nodes = sum(totals)
    lat_n = np.fromiter(chain.from_iterable(graphs[k].lat for k in chunk),
                        np.float64, count=n_nodes)
    lens_n = np.fromiter(
        chain.from_iterable(map(len, graphs[k].preds) for k in chunk),
        np.int64, count=n_nodes)
    lvl_n = np.fromiter(chain.from_iterable(graphs[k].lvl for k in chunk),
                        np.int64, count=n_nodes)
    n_edges = int(lens_n.sum())
    pred_e = np.fromiter(
        chain.from_iterable(chain.from_iterable(graphs[k].preds)
                            for k in chunk),
        np.int64, count=n_edges)

    # Source starts at their node's level: the start update runs after the
    # node's own DP update (path-through wins ties) and before any consumer
    # level — exactly the per-slot ordering the scalar sweep uses.  Level-0
    # nodes stay UNREACHABLE but for their starts, as in the per-slot sweep.
    st_row: List[int] = []
    st_src: List[int] = []
    st_col: List[int] = []
    st_w: List[float] = []
    st_lvl: List[int] = []
    for row, k in enumerate(chunk):
        g = graphs[k]
        for s, (_, src, _) in enumerate(sources_by_k[k]):
            st_row.append(row)
            st_src.append(src)
            st_col.append(s)
            st_w.append(g.lat[src])
            st_lvl.append(g.lvl[src])
    starts = (np.asarray(st_row, dtype=np.int64),
              np.asarray(st_src, dtype=np.int64),
              np.asarray(st_col, dtype=np.int64),
              np.asarray(st_w, dtype=np.float64),
              np.asarray(st_lvl, dtype=np.int64))
    dist, parent = _wavefront(k_n, v_max, s_max, UNREACHABLE, totals, lat_n,
                              lens_n, lvl_n, pred_e, starts, device)

    for row, k in enumerate(chunk):
        g = graphs[k]
        member = g.member
        lat = g.lat
        seen: Dict[frozenset, LCDChain] = {}
        for s, (idx, src, dst) in enumerate(sources_by_k[k]):
            if not is_reached(dist[row, dst, s]):
                continue
            path_ids = backtrack(parent[row, :, s], dst)
            if not path_ids or path_ids[0] != src:
                continue
            # One period: exclude the duplicate endpoint's latency.
            period = float(dist[row, dst, s]) - lat[dst]
            members = tuple(member[v] for v in path_ids[:-1]
                            if member[v] >= 0)
            key = frozenset(members)
            if key not in seen or seen[key].length < period:
                seen[key] = LCDChain(length=period, instr_indices=members,
                                     carried_by=idx)
        chains = tuple(sorted(seen.values(), key=lambda c: -c.length))
        if chains:
            out[k] = LCDResult(chains=chains, longest=chains[0].length,
                               on_longest=set(chains[0].instr_indices))
        else:
            out[k] = LCDResult(chains=(), longest=0.0, on_longest=set())


# -- per-kernel simulator over batched inputs ---------------------------------


def _simulate_graph(g: _Graph, model: MachineModel,
                    tp_block: Optional[float],
                    cp_block: Optional[float]) -> SimResult:
    """Per-kernel window simulation from a compiled graph, with the same
    bracket clamp as ``simulate_from_dag``."""
    n = g.n
    template = template_from_parts(
        latencies=g.lat[:n],
        preds_copy1=[g.preds[n + j] for j in range(n)],
        kinds=g.kind[:n],
        is_wb_flags=g.is_wb[:n],
        costs_per_node=g.cost[:n],
        model=model,
    )
    raw, copies, converged, limiter, busy = simulate_template(
        template, model.window)
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
                     window=model.window, port_busy=busy)


# -- wave entry point ---------------------------------------------------------


def _wave_key(kernel: Kernel) -> Optional[tuple]:
    """Structural identity of a kernel for in-wave dedup.

    Two kernels with the same ISA and the same per-instruction (mnemonic,
    raw text, line number) transcript parse to identical forms, so every
    downstream stage — all deterministic — produces identical results.
    Kernels holding synthetic forms without raw text are never deduped.
    """
    parts = []
    for form in kernel.instructions:
        if not form.raw:
            return None
        parts.append((form.mnemonic, form.raw, form.line_number))
    return (kernel.isa, tuple(parts))


def analyze_wave(kernels: Sequence[Kernel], model: MachineModel,
                 unroll: int = 1, predictors=None,
                 diagnose: bool = False, device=None) -> List["Analysis"]:
    """Analyze a wave of kernels with the batched engine.

    The cache-free counterpart of ``analyze_kernels``: no LRU interaction —
    the wave's TP/CP/LCD work is stacked into the vectorized passes above and
    the simulator/diagnostics run per kernel over the batched results.
    Identical kernels in one wave (same ISA, instruction text, and line
    numbers) are analyzed once and fanned back out per slot; the engine is
    deterministic, so dedup is invisible in the results.  Results are
    bit-identical to a per-kernel ``analyze_kernel`` loop.

    The CP and LCD passes run on ``device`` (``None``: the CUDA device, see
    :func:`repro_torch.resolve_device`); an ``Analysis`` holds no tensors.
    """
    from repro_torch.core.analysis.analyze import (Analysis, analyze_kernel,
                                                   normalize_predictors)
    from repro_torch.core.analysis.diagnostics import \
        diagnose as diagnose_analysis

    device = resolve_device(device)
    kernels = list(kernels)
    if not kernels:
        return []
    preds = normalize_predictors(predictors)
    need_dag = any(p in preds for p in ("cp", "lcd", "sim"))

    # In-wave dedup: one analysis per distinct kernel, fanned out below.
    rep_of: List[int] = []
    first: Dict[tuple, int] = {}
    for i, kernel in enumerate(kernels):
        key = _wave_key(kernel)
        rep_of.append(i if key is None else first.setdefault(key, i))
    reps = [i for i in range(len(kernels)) if rep_of[i] == i]
    rep_slot = {i: p for p, i in enumerate(reps)}

    costs_list = [model.resolve_kernel(kernels[i]) for i in reps]
    tp_results = _batched_tp(costs_list, model)

    rep_results: List[Optional[Analysis]] = [None] * len(reps)
    batch_ix: List[int] = []
    for p, i in enumerate(reps):
        if not costs_list[p] or tp_results[p] is None:
            # Empty or tensor-unrepresentable kernel: per-kernel engine.
            rep_results[p] = analyze_kernel(kernels[i], model, unroll=unroll,
                                            predictors=preds,
                                            diagnose=diagnose, device=device)
        else:
            batch_ix.append(p)

    graphs: Dict[int, _Graph] = {}
    if need_dag:
        for p in batch_ix:
            graphs[p] = _compile_graph(costs_list[p])
    cp_results = _batched_cp(graphs, device) if "cp" in preds else {}
    lcd_results = _batched_lcd(graphs, device) if "lcd" in preds else {}

    run_sim = "sim" in preds and model.window is not None
    stages = ["resolve", "tp"]
    if need_dag:
        stages.append("dag")
    if "cp" in preds:
        stages.append("cp")
    if "lcd" in preds:
        stages.append("lcd")
    if run_sim:
        stages.append("sim")
    stages = tuple(stages)

    for p in batch_ix:
        tp = tp_results[p]
        cp = cp_results.get(p)
        lcd = lcd_results.get(p)
        sim = None
        if run_sim:
            sim = _simulate_graph(
                graphs[p], model,
                tp_block=tp.balanced_throughput,
                cp_block=cp.length if cp is not None else None)
        analysis = Analysis(kernel=kernels[reps[p]], model=model,
                            unroll=unroll, tp=tp, cp=cp, lcd=lcd, sim=sim,
                            stages_completed=stages)
        if diagnose:
            analysis.findings = diagnose_analysis(analysis)
        rep_results[p] = analysis

    results: List[Analysis] = []
    for i, kernel in enumerate(kernels):
        base = rep_results[rep_slot[rep_of[i]]]
        if rep_of[i] == i:
            results.append(base)
            continue
        # Duplicate slot: share the deterministic per-stage results, keep the
        # request's own kernel object (name/source metadata stay per slot).
        dup = Analysis(kernel=kernel, model=model, unroll=unroll,
                       tp=base.tp, cp=base.cp, lcd=base.lcd, sim=base.sim,
                       degradation=base.degradation,
                       stages_completed=base.stages_completed)
        if diagnose:
            dup.findings = diagnose_analysis(dup)
        results.append(dup)
    return results
