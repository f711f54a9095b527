"""Three-term roofline of an accelerator graph on a GPU (the counterpart
of ``repro.core.hlo.roofline``).

This is OSACA's throughput analysis run on the program's graph: the tensor
cores (``TC``), HBM and NVLink "ports" accumulate pressure from every op;
the dominant port is the bottleneck and its pressure the runtime lower
bound.

    compute term    = FLOPs(per card) / peak_FLOP/s
    memory term     = bytes(per card) / HBM_bw
    collective term = collective_bytes(per card) / link_bw

:func:`roofline_from_exported` takes a ``torch.export`` program: its raw
FLOP count is PyTorch's own (``torch.utils.flop_counter``, the counterpart
of XLA's ``cost_analysis()``), its bytes the static estimate over the
lowered graph; collective bytes are summed over the operand sizes of every
collective op.  :func:`roofline_report` reads HLO text alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.core.hlo.costs import HLOCostModel
from repro_torch.core.hlo.export import core_aten, lower_exported
from repro_torch.core.hlo.machine import GPUChip, H100_SXM
from repro_torch.core.hlo.parser import HLOModule, parse_hlo


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    total_bytes: float = 0.0
    ring_seconds: float = 0.0  # refined ring-model time (extra info)


@dataclass
class RooflineReport:
    name: str
    chip: GPUChip
    num_partitions: int
    hlo_flops: float  # per chip
    hlo_bytes: float  # per chip
    collective: CollectiveStats
    terms: Dict[str, float]  # TC / HBM / NVLink seconds
    model_flops: Optional[float] = None  # global useful FLOPs (6ND)
    memory_per_device: Optional[int] = None
    ca_raw_flops: float = 0.0  # uncorrected raw counts (PyTorch's flop counter)
    ca_raw_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        return max(self.terms, key=lambda k: self.terms[k])

    @property
    def bound_seconds(self) -> float:
        return self.terms[self.dominant]

    @property
    def useful_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / HLO_FLOPs (global): remat/redundancy waste catcher."""
        if self.model_flops is None or self.hlo_flops == 0:
            return None
        return self.model_flops / (self.hlo_flops * self.num_partitions)

    @property
    def roofline_fraction(self) -> float:
        """Achievable fraction of compute roofline if the bound is met."""
        if self.bound_seconds == 0:
            return 0.0
        return self.terms["TC"] / self.bound_seconds

    def recommendation(self) -> str:
        dom = self.dominant
        if dom == "TC":
            return ("tensor-core-bound: increase arithmetic intensity is moot - "
                    "reduce redundant FLOPs (remat policy, fused attention) "
                    f"[useful ratio {self.useful_ratio and round(self.useful_ratio, 3)}]")
        if dom == "HBM":
            return ("HBM-bound: cut HBM traffic - fuse attention/softmax and "
                    "elementwise chains, chunked loss, bf16 activations")
        top = max(self.collective.bytes_by_op, key=lambda k: self.collective.bytes_by_op[k],
                  default="-")
        return (f"NVLink-bound: dominant op {top} - reshard to reduce "
                "gather volume, overlap collectives with compute, or use "
                "reduce-scatter gradient sync")

    def row(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "chips": self.num_partitions,
            "compute_s": self.terms["TC"],
            "memory_s": self.terms["HBM"],
            "collective_s": self.terms["NVLink"],
            "dominant": self.dominant,
            "bound_s": self.bound_seconds,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "collective_bytes_per_chip": self.collective.total_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_per_device": self.memory_per_device,
            "ca_raw_flops": self.ca_raw_flops,
            "ca_raw_bytes": self.ca_raw_bytes,
        }

    def render(self) -> str:
        lines = [
            f"roofline  {self.name}  ({self.chip.name} x {self.num_partitions})",
            f"  compute   (TC):     {self.terms['TC'] * 1e3:10.3f} ms"
            f"   [{self.hlo_flops:.3e} FLOP/card]",
            f"  memory    (HBM):    {self.terms['HBM'] * 1e3:10.3f} ms"
            f"   [{self.hlo_bytes:.3e} B/card]",
            f"  collective(NVLink): {self.terms['NVLink'] * 1e3:10.3f} ms"
            f"   [{self.collective.total_bytes:.3e} B/card, "
            f"ring-model {self.collective.ring_seconds * 1e3:.3f} ms]",
            f"  dominant: {self.dominant}  -> bound {self.bound_seconds * 1e3:.3f} ms/step",
        ]
        if self.model_flops is not None:
            lines.append(
                f"  MODEL_FLOPS {self.model_flops:.3e}  useful-ratio "
                f"{self.useful_ratio:.3f}" if self.useful_ratio is not None else ""
            )
        if self.memory_per_device is not None:
            lines.append(f"  memory/device: {self.memory_per_device / 2**30:.2f} GiB")
        for op, b in sorted(self.collective.bytes_by_op.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {op:<22} x{self.collective.counts[op]:<4} "
                         f"{b:.3e} B/card")
        lines.append(f"  -> {self.recommendation()}")
        return "\n".join(l for l in lines if l)


def collective_stats(
    module: HLOModule, chip: GPUChip,
    exec_counts: Optional[Dict[str, float]] = None,
) -> CollectiveStats:
    """Sum collective operand bytes, weighting ops inside while bodies by the
    loop trip count (``exec_counts`` from the cost model)."""
    stats = CollectiveStats()
    for comp in module.computations.values():
        mult = (exec_counts or {}).get(comp.name, 1.0 if exec_counts is None else 0.0)
        if mult == 0.0:
            continue
        for op in comp.ops:
            if not op.is_collective or op.opcode.endswith("-done"):
                continue
            operand_bytes = 0.0
            for operand in op.operands:
                src = comp.op_by_name(operand)
                if src is not None:
                    operand_bytes += src.result_bytes
            base = op.opcode.replace("-start", "")
            stats.counts[base] = stats.counts.get(base, 0) + int(mult)
            stats.bytes_by_op[base] = stats.bytes_by_op.get(base, 0.0) + mult * operand_bytes
            stats.total_bytes += mult * operand_bytes
            stats.ring_seconds += mult * chip.collective_model_seconds(
                op.opcode, operand_bytes, op.replica_group_size(module.num_partitions)
            )
    return stats


class _BodiesOnce(torch.fx.Interpreter):
    """Runs an exported graph with each ``while_loop`` body run once, as
    XLA's ``cost_analysis()`` counts a while body once."""

    def call_function(self, target, args, kwargs):
        if target is torch.ops.higher_order.while_loop:
            _cond, body, carried, extra = args[:4]
            return tuple(_BodiesOnce(body).run(*carried, *extra))
        return super().call_function(target, args, kwargs)


def _counted_flops(ep) -> float:
    """PyTorch's own FLOP count of one run of ``ep`` (decomposed to core
    ATen), each while body counted once: ``FlopCounterMode`` over the graph
    under the export's ``FakeTensorMode``, so nothing runs on a device."""
    from torch._guards import detect_fake_mode
    from torch.utils.flop_counter import FlopCounterMode

    gm = core_aten(ep).graph_module
    vals = [n.meta["val"] for n in gm.graph.nodes if n.op == "placeholder"]
    with torch.no_grad(), detect_fake_mode(vals), \
            FlopCounterMode(display=False) as counter:
        _BodiesOnce(gm).run(*vals)
    return float(counter.get_total_flops())


def roofline_from_exported(
    ep,
    name: str = "step",
    chip: GPUChip = H100_SXM,
    model_flops: Optional[float] = None,
    memory_per_device: Optional[int] = None,
) -> RooflineReport:
    """Build the report from a ``torch.export.ExportedProgram``.

    PyTorch's flop counter counts each ``while`` body once (as XLA's
    ``cost_analysis()`` does), so a loop would be undercounted by its trip
    count.  We correct by the ratio of the static trip-aware estimate to
    the trips=1 estimate (both from the lowered graph itself), and scale
    collectives inside loop bodies by their execution counts.  PyTorch
    gives no bytes count (``ca_raw_bytes`` stays 0), and the memory per
    device only where the caller passes it.
    """
    ep = core_aten(ep)
    raw = _counted_flops(ep)
    module = lower_exported(ep)

    cost_trips = HLOCostModel(module, chip, count_while_trips=True)
    cost_once = HLOCostModel(module, chip, count_while_trips=False)
    est_flops_trips = cost_trips.module_flops()
    est_flops_once = cost_once.module_flops()
    flop_corr = (est_flops_trips / est_flops_once) if est_flops_once > 0 else 1.0
    flops = raw * max(flop_corr, 1.0)
    # Memory term: the static trip-aware estimate, walking scheduled
    # computations x execution counts.
    byts = cost_trips.module_bytes()

    stats = collective_stats(module, chip, exec_counts=cost_trips.execution_counts())
    report = RooflineReport(
        name=name,
        chip=chip,
        num_partitions=module.num_partitions,
        hlo_flops=flops,
        hlo_bytes=byts,
        collective=stats,
        terms=chip.port_pressure(flops, byts, stats.total_bytes),
        model_flops=model_flops,
        memory_per_device=memory_per_device,
    )
    report.ca_raw_flops = raw
    return report


def roofline_report(
    hlo_text: str,
    name: str = "step",
    chip: GPUChip = H100_SXM,
    model_flops: Optional[float] = None,
    flops: Optional[float] = None,
    bytes_accessed: Optional[float] = None,
) -> RooflineReport:
    """Build the report from HLO text alone (flops/bytes estimated if absent)."""
    module = parse_hlo(hlo_text)
    stats = collective_stats(module, chip)
    cost = HLOCostModel(module, chip)
    if flops is None:
        flops = cost.computation_flops(module.entry_name)
    if bytes_accessed is None:
        bytes_accessed = sum(
            cost.op_bytes(op, module.entry) for op in module.entry.ops
        )
    return RooflineReport(
        name=name,
        chip=chip,
        num_partitions=module.num_partitions,
        hlo_flops=float(flops),
        hlo_bytes=float(bytes_accessed),
        collective=stats,
        terms=chip.port_pressure(float(flops), float(bytes_accessed), stats.total_bytes),
        model_flops=model_flops,
    )
