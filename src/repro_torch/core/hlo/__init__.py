"""The accelerator-graph analyzer (the counterpart of ``repro.core.hlo``):
TP / CP / LCD over HLO text or a ``torch.export`` program, on an H100
engine model."""

from repro_torch.core.hlo.parser import HLOComputation, HLOModule, HLOOp, parse_hlo
from repro_torch.core.hlo.machine import H100_SXM, GPUChip
from repro_torch.core.hlo.export import lower_exported
from repro_torch.core.hlo.roofline import (RooflineReport, roofline_from_exported,
                                           roofline_report)
from repro_torch.core.hlo.critical_path import hlo_critical_path
from repro_torch.core.hlo.lcd import hlo_loop_carried

__all__ = [
    "HLOComputation", "HLOModule", "HLOOp", "parse_hlo",
    "H100_SXM", "GPUChip",
    "lower_exported",
    "RooflineReport", "roofline_from_exported", "roofline_report",
    "hlo_critical_path", "hlo_loop_carried",
]
