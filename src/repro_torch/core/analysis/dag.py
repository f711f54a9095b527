"""Register-dependency DAG construction (paper §II-C rules 1-4).

1. A vertex per instruction form in the marked code.
2. From each destination register, edges to every later instruction reading it
   until the register is redefined (or a dependency break, e.g. zero idiom).
3. Path weights are the source instruction latencies; OSACA's reported CP
   totals additionally include the terminal vertex latency, so we equivalently
   treat the DAG as *node-weighted* (longest path = sum of node latencies).
4. A source memory reference whose address has a register dependency gets an
   intermediate load vertex carrying the load latency (memory-operand
   splitting); pure load instructions are themselves the load vertex.

AArch64 writeback forms (``str d5, [x14], 8``) write their base register, so
they appear as defs like any other — this is how the store→address→load chain
of the paper's Table II ends up on the critical path.  For the *LCD* analysis
the writeback is modeled as the separate address-update µ-op it really is
(depending only on the address registers, not the store data): this matches
both the hardware behaviour and OSACA's published Table II, whose CP column
includes the str→ldr segment while its LCD chain carries the pure FP
dependency (``writeback_chains_data`` selects between the two).

Array engine notes
------------------
Node ids are assigned in program order, and every dependency edge points
forward (a def strictly precedes its uses), so the id order *is* a topological
order.  The longest-path analyses therefore never need an explicit toposort:
they run a single forward sweep over ids, reducing over each node's
predecessor list.  :meth:`DependencyDAG.pred_csr` exports the predecessor
lists as a NumPy CSR pair ``(ptr, idx)`` (plus a contiguous per-node latency
vector via :meth:`DependencyDAG.latency_vector`), which is what
:func:`repro_torch.core.analysis.sweep.batched_longest_paths` consumes to compute
longest paths from *all* LCD source candidates in one vectorized sweep — a
(sources × nodes) distance matrix updated with a ``max``-over-predecessors
reduction per node, O(V + S·E) vectorized work instead of S independent
Python DPs.

Edge insertion is O(1): a parallel set of ``(src, dst)`` pairs backs the
duplicate check instead of a linear scan of the successor list.

``build_dag(..., dual_writeback=True)`` builds *both* writeback models over a
single node list in one pass: the default ``succs``/``preds`` adjacency is the
LCD view (writeback split into its own address-update µ-op) while ``cp_preds``
holds the CP view (store data chains through the writeback def).  That is what
lets :func:`repro_torch.core.analysis.analyze.analyze_kernel` share one
``resolve_kernel`` and one DAG build across the TP/CP/LCD analyses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.analysis.sweep import pred_csr_from_lists
from repro_torch.core.isa.instruction import Kernel
from repro_torch.core.machine.model import InstructionCost, MachineModel


@dataclass
class Node:
    nid: int
    kind: str  # "instr" | "load"
    instr_index: int  # index within the *original* kernel body
    copy: int  # which duplicated copy of the body (0 for plain CP analysis)
    latency: float
    cost: Optional[InstructionCost] = None
    # Writeback address-update µ-op marker.  These nodes only exist for the
    # LCD view; the CP end-node scan skips them.  (They keep kind="instr" so
    # LCD chain membership is unchanged from the seed engine.)
    is_wb: bool = False

    @property
    def line_number(self) -> int:
        return self.cost.form.line_number if self.cost is not None else -1


@dataclass
class DependencyDAG:
    nodes: List[Node]
    succs: List[List[int]]
    preds: List[List[int]]
    # instruction node id for (instr_index, copy)
    instr_node: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # CP-view predecessor lists (dual-writeback builds only); ``None`` means
    # the default adjacency doubles as the CP view.
    cp_preds: Optional[List[List[int]]] = None
    # O(1) duplicate-edge checks (parallel to succs/preds and cp_preds).
    _edges: Set[Tuple[int, int]] = field(default_factory=set, repr=False)
    _cp_edges: Set[Tuple[int, int]] = field(default_factory=set, repr=False)

    def add_node(self, node: Node) -> int:
        node.nid = len(self.nodes)
        self.nodes.append(node)
        self.succs.append([])
        self.preds.append([])
        if self.cp_preds is not None:
            self.cp_preds.append([])
        return node.nid

    def add_edge(self, src: int, dst: int) -> None:
        if src == dst:
            return
        if (src, dst) not in self._edges:
            self._edges.add((src, dst))
            self.succs[src].append(dst)
            self.preds[dst].append(src)

    def add_cp_edge(self, src: int, dst: int) -> None:
        """Add an edge to the CP view of a dual-writeback build."""
        if src == dst or self.cp_preds is None:
            return
        if (src, dst) not in self._cp_edges:
            self._cp_edges.add((src, dst))
            self.cp_preds[dst].append(src)

    # -- array export ------------------------------------------------------

    def pred_csr(self, preds: Optional[List[List[int]]] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Predecessor lists as a CSR pair ``(ptr, idx)``.

        ``idx[ptr[v]:ptr[v+1]]`` are the predecessors of ``v`` in insertion
        order (which the sweeps rely on for seed-identical tie-breaking).
        """
        return pred_csr_from_lists(self.preds if preds is None else preds)

    def latency_vector(self) -> np.ndarray:
        return np.array([n.latency for n in self.nodes], dtype=np.float64)

    # -- reference longest path (kept for the oracle implementation) -------

    def longest_paths(self, sources: Optional[List[int]] = None) -> Tuple[List[float], List[int]]:
        """Node-weighted longest path DP over the (already topological) ids.

        Returns ``(dist, parent)`` where ``dist[v]`` is the maximum node-
        latency sum over paths ending at ``v``.  If ``sources`` is given, only
        paths starting in ``sources`` count (others get ``-inf``).
        """
        n = len(self.nodes)
        neg = float("-inf")
        dist = [neg] * n
        parent = [-1] * n
        allowed_start = set(sources) if sources is not None else None
        for v in range(n):
            best_pred = -1
            best = neg
            for u in self.preds[v]:
                if dist[u] > best:
                    best = dist[u]
                    best_pred = u
            if best == neg:
                if allowed_start is None or v in allowed_start:
                    dist[v] = self.nodes[v].latency
            else:
                dist[v] = best + self.nodes[v].latency
                parent[v] = best_pred
            if allowed_start is not None and v in allowed_start and dist[v] < self.nodes[v].latency:
                dist[v] = self.nodes[v].latency
                parent[v] = -1
        return dist, parent

    def path_to(self, v: int, parent: List[int]) -> List[int]:
        path = []
        while v != -1:
            path.append(v)
            v = parent[v]
        path.reverse()
        return path


# x86 mnemonic families that write / read the status flags (hidden deps,
# paper §IV-B "future work"); AArch64 writes flags only via the -s forms.
_X86_FLAG_WRITERS = ("add", "sub", "inc", "dec", "neg", "and", "or", "xor",
                     "test", "cmp", "shl", "shr", "sar", "sal", "bt", "adc",
                     "sbb")
_X86_FLAG_READERS = ("j", "set", "cmov", "adc", "sbb")
_A64_FLAG_READERS = ("b.", "bne", "beq", "bgt", "blt", "bge", "ble", "bhi",
                     "bls", "csel", "csinc", "cset", "ccmp", "adc", "sbc")


def _writes_flags(form, isa: str) -> bool:
    m = form.mnemonic
    if isa == "x86":
        return any(m.startswith(p) for p in _X86_FLAG_WRITERS) and not m.startswith("jmp")
    return m in ("cmp", "cmn", "tst", "ccmp") or m.endswith("s") and m in (
        "adds", "subs", "ands", "bics")


def _reads_flags(form, isa: str) -> bool:
    m = form.mnemonic
    if isa == "x86":
        return any(m.startswith(p) for p in _X86_FLAG_READERS) and m != "jmp"
    return any(m.startswith(p) for p in _A64_FLAG_READERS)


def build_dag(
    kernel: Kernel,
    model: MachineModel,
    copies: int = 1,
    writeback_chains_data: bool = True,
    model_flags: bool = False,
    model_store_forwarding: bool = False,
    costs: Optional[Tuple[InstructionCost, ...]] = None,
    dual_writeback: bool = False,
) -> DependencyDAG:
    """Build the dependency DAG over ``copies`` back-to-back body copies.

    ``writeback_chains_data=False`` splits pre-/post-index writeback into its
    own address-update µ-op node (latency 1, integer ALU) so store data does
    not chain into later address uses — used by the LCD analysis.

    ``dual_writeback=True`` builds both writeback models at once over one node
    list: ``succs``/``preds`` carry the split-µ-op (LCD) view and ``cp_preds``
    the data-chained (CP) view.  ``writeback_chains_data`` is ignored then.

    ``costs`` reuses an already-resolved kernel (``model.resolve_kernel``)
    instead of resolving again.

    Beyond-paper extensions (the paper's §IV-B future-work list), both off by
    default to preserve the published semantics:

    * ``model_flags`` — hidden status-flag dependencies: flag-writers define
      a pseudo-register ``%flags`` consumed by conditional ops.
    * ``model_store_forwarding`` — load-after-store: a load whose memory
      reference is syntactically identical to an earlier store's depends on
      it (store-forward latency = the store's DB latency).
    """
    if costs is None:
        costs = model.resolve_kernel(kernel)
    dag = DependencyDAG(nodes=[], succs=[], preds=[],
                        cp_preds=[] if dual_writeback else None)
    split_writeback = dual_writeback or not writeback_chains_data
    # Def maps: reg -> node id.  In dual mode the two views may disagree on
    # who defines a writeback base register (the µ-op vs. the store itself).
    last_def: Dict[str, int] = {}
    cp_last_def: Dict[str, int] = last_def if not dual_writeback else {}
    last_store: Dict[tuple, int] = {}  # memory-ref signature -> store node

    def _mem_key(mem):
        return (mem.base.name if mem.base else None,
                mem.index.name if mem.index else None,
                mem.scale, mem.offset)

    def _dep_edge(reg: str, dst: int) -> None:
        """Edge from the latest def of ``reg`` to ``dst``, in both views."""
        src = last_def.get(reg)
        if src is not None:
            dag.add_edge(src, dst)
        if dual_writeback:
            cp_src = cp_last_def.get(reg)
            if cp_src is not None:
                dag.add_cp_edge(cp_src, dst)

    def _shared_edge(src: int, dst: int) -> None:
        """Structural edge present identically in both views."""
        dag.add_edge(src, dst)
        dag.add_cp_edge(src, dst)

    for copy in range(copies):
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
            data_sources = [s for s in form.source_registers if s not in addr_regs]

            load_node_id = None
            if cost.load is not None:
                # Split-off load µ-op: address regs feed the load vertex.
                load_node_id = dag.add_node(
                    Node(nid=-1, kind="load", instr_index=idx, copy=copy,
                         latency=cost.load.latency, cost=cost)
                )
                for r in addr_regs:
                    _dep_edge(r, load_node_id)

            nid = dag.add_node(
                Node(nid=-1, kind="instr", instr_index=idx, copy=copy,
                     latency=cost.entry.latency, cost=cost)
            )
            dag.instr_node[(idx, copy)] = nid
            if load_node_id is not None:
                _shared_edge(load_node_id, nid)
            else:
                # Pure loads/stores: address regs feed the instruction itself.
                for r in addr_regs:
                    _dep_edge(r, nid)
            if not form.is_dep_breaking:
                for r in data_sources:
                    _dep_edge(r, nid)

            if model_flags:
                if _reads_flags(form, kernel.isa):
                    _dep_edge("%flags", nid)
                if _writes_flags(form, kernel.isa):
                    last_def["%flags"] = nid
                    if dual_writeback:
                        cp_last_def["%flags"] = nid

            if model_store_forwarding:
                read_node = load_node_id if load_node_id is not None else nid
                for mem in form.loads:
                    key = _mem_key(mem)
                    if key in last_store:
                        _shared_edge(last_store[key], read_node)
                for mem in form.stores:
                    last_store[_mem_key(mem)] = nid

            wb_node_id = None
            if writeback_regs and split_writeback:
                # Separate address-update µ-op: depends only on address regs.
                # In dual mode it exists only in the LCD view (no CP edges),
                # so the CP sweep never sees it.
                wb_node_id = dag.add_node(
                    Node(nid=-1, kind="instr", instr_index=idx, copy=copy,
                         latency=1.0, cost=cost, is_wb=True)
                )
                for r in addr_regs:
                    src = last_def.get(r)
                    if src is not None:
                        dag.add_edge(src, wb_node_id)

            for r in form.dest_registers:
                if r in writeback_regs and wb_node_id is not None:
                    last_def[r] = wb_node_id
                else:
                    last_def[r] = nid
                if dual_writeback:
                    cp_last_def[r] = nid
    return dag
