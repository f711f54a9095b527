"""The paper's static throughput / critical-path / LCD analysis of x86 and
AArch64 assembly, with its LCD sweep on float64 torch tensors on a chosen
device. Each module mirrors its namesake in ``repro.core``."""

from repro_torch.core.analysis import (AnalysisReport, analyze_kernel,
                                       analyze_kernels)
from repro_torch.core.isa import parse_aarch64, parse_x86
from repro_torch.core.machine import cascade_lake, thunderx2, zen
from repro_torch.core.registry import (ArchSpec, asm_arch_ids, get_arch,
                                       list_arch_ids, register_arch)

__all__ = ["AnalysisReport", "ArchSpec", "analyze_kernel", "analyze_kernels",
           "asm_arch_ids", "cascade_lake", "get_arch", "list_arch_ids",
           "parse_aarch64", "parse_x86", "register_arch", "thunderx2", "zen"]
