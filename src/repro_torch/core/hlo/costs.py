"""Per-op FLOP/byte/time estimation over parsed HLO.

This is the "instruction database" role for the GPU port model: where the
x86/ARM DBs store measured latencies, HLO op costs are derived from shapes
(the op's semantics fix its arithmetic and data volume).  The opcode sets
and rules are those of ``repro.core.hlo.costs``, so the same module costs the
same on both packages; the per-op estimates weight the critical-path / LCD
graphs.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core.hlo.machine import GPUChip
from repro_torch.core.hlo.parser import HLOComputation, HLOModule, HLOOp

_ELEMENTWISE = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "abs",
    "negate", "sign", "compare", "select", "and", "or", "xor", "not",
    "clamp", "floor", "ceil", "round-nearest-afz", "power", "remainder",
}
_TRANSCENDENTAL = {"exp", "expm1", "log", "log1p", "tanh", "rsqrt", "sqrt",
                   "logistic", "sin", "cos", "atan2", "erf", "cbrt"}
_FREE = {"parameter", "constant", "tuple", "get-tuple-element", "bitcast",
         "bitcast-convert", "reshape", "after-all", "partition-id", "replica-id",
         "opt-barrier", "custom-call", "rng-bit-generator", "iota"}


@dataclass
class OpCost:
    flops: float
    bytes: float
    seconds: float


class HLOCostModel:
    def __init__(self, module: HLOModule, chip: GPUChip,
                 default_while_trips: int = 1,
                 count_while_trips: bool = True):
        self.module = module
        self.chip = chip
        self.default_while_trips = default_while_trips
        self.count_while_trips = count_while_trips
        self._comp_flops: Dict[str, float] = {}
        self._comp_bytes: Dict[str, float] = {}
        self._const_ints: Dict[str, int] = {}
        self._index_constants()

    # -- helpers -------------------------------------------------------------

    def _index_constants(self) -> None:
        pat = re.compile(r"constant\((\d+)\)")
        for comp in self.module.computations.values():
            for op in comp.ops:
                if op.opcode == "constant":
                    m = pat.search(op.raw)
                    if m:
                        self._const_ints[f"{comp.name}/{op.name}"] = int(m.group(1))

    def while_trip_count(self, op: HLOOp) -> int:
        """Trip count: XLA's backend_config when present, else inferred from
        ``compare(induction, constant)`` in the cond."""
        known = op.known_trip_count
        if known is not None:
            return max(known, 1)
        cname = op.condition_computation
        comp = self.module.computations.get(cname) if cname else None
        if comp is not None and comp.root is not None:
            root = comp.root
            compare = root
            if root.opcode != "compare":
                # Root may be a fusion over the compare; look for any compare.
                compare = next((o for o in comp.ops if o.opcode == "compare"), root)
            for operand in compare.operands:
                val = self._const_ints.get(f"{comp.name}/{operand}")
                if val is not None:
                    return max(val, 1)
        return self.default_while_trips

    # -- FLOPs ---------------------------------------------------------------

    def op_flops(self, op: HLOOp, comp: HLOComputation) -> float:
        opc = op.opcode
        if opc in _FREE or opc == "parameter":
            return 0.0
        if opc == "dot":
            lhs = comp.op_by_name(op.operands[0]) if op.operands else None
            lhs_shape = lhs.shapes[0] if lhs and lhs.shapes else None
            k = op.dot_contracting(lhs_shape)
            out = sum(s.elements for s in op.shapes)
            return 2.0 * out * max(k, 1)
        if opc == "convolution":
            out = sum(s.elements for s in op.shapes)
            m = re.search(r"window=\{size=([\dx]+)", op.attrs)
            k = 1
            if m:
                for d in m.group(1).split("x"):
                    k *= int(d)
            return 2.0 * out * k
        if opc in ("fusion", "call"):
            total = 0.0
            for cname in op.called_computations:
                total += self.computation_flops(cname)
            return total
        if opc == "while":
            trips = self.while_trip_count(op) if self.count_while_trips else 1
            body = op.body_computation
            return trips * (self.computation_flops(body) if body else 0.0)
        if opc == "conditional":
            return max((self.computation_flops(c) for c in op.called_computations),
                       default=0.0)
        if opc in ("reduce", "reduce-window"):
            operand = comp.op_by_name(op.operands[0]) if op.operands else None
            return float(operand.shapes[0].elements) if operand and operand.shapes else 0.0
        out = sum(s.elements for s in op.shapes)
        if opc in _TRANSCENDENTAL:
            return 4.0 * out
        if opc in _ELEMENTWISE:
            return float(out)
        if opc in ("scatter", "gather", "dynamic-slice", "dynamic-update-slice",
                   "sort", "map", "select-and-scatter"):
            return float(out)
        return 0.0

    def computation_flops(self, name: Optional[str]) -> float:
        if name is None or name not in self.module.computations:
            return 0.0
        if name in self._comp_flops:
            return self._comp_flops[name]
        self._comp_flops[name] = 0.0  # cycle guard
        comp = self.module.computations[name]
        total = sum(self.op_flops(op, comp) for op in comp.ops)
        self._comp_flops[name] = total
        return total

    # -- execution counts ------------------------------------------------------

    def execution_counts(self, scheduled_only: bool = False) -> Dict[str, float]:
        """How many times each computation executes per entry invocation.

        Needed because post-optimization HLO text contains while bodies once:
        collectives (and flops/bytes) inside them run trip-count times.
        ``scheduled_only`` restricts the walk to computations whose ops are
        actually scheduled against HBM (entry, while bodies/conds,
        conditional branches, calls) — fusion/reducer bodies execute in
        registers/on-chip memory and must not contribute HBM-byte estimates.
        """
        counts: Dict[str, float] = {}

        def visit(name: str, mult: float, depth: int = 0) -> None:
            if depth > 32 or name not in self.module.computations:
                return
            counts[name] = counts.get(name, 0.0) + mult
            comp = self.module.computations[name]
            for op in comp.ops:
                if op.opcode == "while":
                    trips = self.while_trip_count(op) if self.count_while_trips else 1
                    if op.body_computation:
                        visit(op.body_computation, mult * trips, depth + 1)
                    if op.condition_computation:
                        visit(op.condition_computation, mult * (trips + 1), depth + 1)
                elif op.opcode in ("call", "conditional"):
                    for cname in op.called_computations:
                        visit(cname, mult, depth + 1)
                elif not scheduled_only and op.opcode in (
                        "fusion", "reduce", "reduce-window", "scatter",
                        "sort", "map"):
                    for cname in op.called_computations:
                        visit(cname, mult, depth + 1)

        visit(self.module.entry_name, 1.0)
        return counts

    def module_bytes(self) -> float:
        """Trip-aware HBM-traffic estimate: scheduled computations only, with
        fusion ops contributing their operand+result bytes (their bodies run
        out of on-chip memory).  ``convert``/``copy``-only dtype plumbing is
        excluded, by the reference's rule (there: bf16<->f32 converts that
        XLA's CPU lowering hoists, absent on the accelerator)."""
        counts = self.execution_counts(scheduled_only=True)
        total = 0.0
        for name, mult in counts.items():
            comp = self.module.computations[name]
            for op in comp.ops:
                if op.opcode in ("while", "conditional", "call", "convert",
                                 "bitcast", "copy"):
                    continue  # callees via their own computations; converts
                              # and copies are dtype/layout plumbing
                if op.opcode == "fusion" and self._is_dtype_plumbing(op):
                    continue
                total += mult * self.op_bytes(op, comp)
        return total

    def _fusion_bytes(self, op: HLOOp) -> Optional[float]:
        """Body-aware HBM traffic of a fusion.

        Reads: per fused parameter, bytes actually touched — a parameter
        consumed only through dynamic-slice (possibly via transparent
        convert/bitcast) is read slice-sized; a dynamic-update-slice target
        is aliased (no read).  Write: the DUS update size when the root is a
        DUS (in-place), else the result.  This models the accelerator's buffer
        aliasing where XLA's CPU text shows hoisted f32 copies.
        """
        called = None
        for cname in op.called_computations:
            called = self.module.computations.get(cname)
            if called is not None:
                break
        if called is None or called.root is None:
            return None

        index = {o.name: o for o in called.ops}
        consumers: Dict[str, list] = {}
        for o in called.ops:
            for operand in o.operands:
                consumers.setdefault(operand, []).append(o)
        transparent = {"convert", "bitcast"}

        def touched(param: HLOOp) -> float:
            size = float(param.result_bytes)
            total_t = 0.0
            frontier = [param.name]
            seen = set()
            while frontier:
                nm = frontier.pop()
                if nm in seen:
                    continue
                seen.add(nm)
                for c in consumers.get(nm, []):
                    if c.opcode in transparent:
                        frontier.append(c.name)
                    elif c.opcode == "dynamic-slice":
                        total_t += float(c.result_bytes)
                    elif c.opcode == "dynamic-update-slice" and \
                            c.operands and c.operands[0] == nm:
                        continue  # aliased in-place target: no read
                    else:
                        return size  # fully consumed
            return min(total_t, size)

        reads = sum(touched(p) for p in called.params)
        root = called.root
        if root.opcode == "dynamic-update-slice" and len(root.operands) > 1:
            upd = index.get(root.operands[1])
            write = float(upd.result_bytes) if upd and upd.shapes else \
                float(root.result_bytes)
        else:
            write = float(op.result_bytes)
        return reads + write

    def _is_dtype_plumbing(self, op: HLOOp) -> bool:
        """Fusion whose body only converts/copies (wrapped_convert etc.)."""
        plumbing = {"parameter", "convert", "bitcast", "copy", "tuple",
                    "get-tuple-element", "reshape", "transpose"}
        for cname in op.called_computations:
            comp = self.module.computations.get(cname)
            if comp is None:
                return False
            if any(o.opcode not in plumbing for o in comp.ops):
                return False
        return bool(op.called_computations)

    def module_flops(self) -> float:
        """Trip-aware FLOP estimate (callee flops via call sites, once)."""
        return self.computation_flops(self.module.entry_name)

    # -- bytes & time ---------------------------------------------------------

    def op_bytes(self, op: HLOOp, comp: HLOComputation) -> float:
        """HBM traffic estimate: operand reads + result write."""
        if op.opcode in _FREE:
            return 0.0
        if op.opcode == "dynamic-update-slice":
            # In-place update (XLA aliases the buffer): traffic = update
            # read + write, not the whole operand.
            upd = comp.op_by_name(op.operands[1]) if len(op.operands) > 1 else None
            return 2.0 * (upd.result_bytes if upd and upd.shapes else 0.0)
        if op.opcode == "dynamic-slice":
            return 2.0 * float(op.result_bytes)
        if op.opcode == "fusion":
            fused = self._fusion_bytes(op)
            if fused is not None:
                return fused
        total = float(op.result_bytes)
        for operand in op.operands:
            src = comp.op_by_name(operand)
            if src is not None:
                total += src.result_bytes
        return total

    def op_seconds(self, op: HLOOp, comp: HLOComputation) -> float:
        """Node weight: time on the op's bottleneck engine."""
        if op.is_collective:
            operand_bytes = 0.0
            for operand in op.operands:
                src = comp.op_by_name(operand)
                if src is not None:
                    operand_bytes += src.result_bytes
            group = op.replica_group_size(self.module.num_partitions)
            return self.chip.collective_model_seconds(op.opcode, operand_bytes, group)
        flops = self.op_flops(op, comp)
        mem = self.op_bytes(op, comp)
        return max(self.chip.compute_seconds(flops), self.chip.memory_seconds(mem))
