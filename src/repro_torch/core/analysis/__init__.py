"""The analysis engine of ``repro.core.analysis``: TP (uniform and
balanced), DAG, CP, LCD, the simulator's bracket closure, diagnostics and the
schema-v5 report, per kernel (the LCD sweep on torch tensors) and per wave
(``analyze_wave``: the CP and LCD passes on torch tensors)."""

from repro_torch.core.analysis.throughput import (ThroughputResult,
                                                  throughput_analysis,
                                                  throughput_from_costs)
from repro_torch.core.analysis.scheduler import (BalancedSchedule,
                                                 balance_from_costs,
                                                 brute_force_min_max,
                                                 gather_classes, min_max_load)
from repro_torch.core.analysis.dag import DependencyDAG, Node, build_dag
from repro_torch.core.analysis.critical_path import (CriticalPathResult,
                                                     critical_path,
                                                     critical_path_from_dag)
from repro_torch.core.analysis.lcd import (LCDResult, lcd_from_dag,
                                           loop_carried_dependencies)
from repro_torch.core.analysis.diagnostics import Finding, diagnose
from repro_torch.core.analysis.analyze import (ANALYSIS_STAGES, Analysis,
                                               DEGRADATION_LADDER, PREDICTORS,
                                               analysis_view, analyze_kernel,
                                               analyze_kernel_bracket,
                                               analyze_kernel_ladder,
                                               analyze_kernel_parse_only,
                                               analyze_kernel_rung,
                                               analyze_kernel_tp_only,
                                               analyze_kernels,
                                               clear_analysis_cache,
                                               normalize_predictors)
from repro_torch.core.analysis.batch import analyze_wave
from repro_torch.core.analysis.report import (AnalysisReport, InstructionRow,
                                              LCDChainRow, SCHEMA_VERSION)
from repro_torch.core.analysis.render import register_renderer, render

__all__ = [
    "ANALYSIS_STAGES",
    "Analysis",
    "AnalysisReport",
    "DEGRADATION_LADDER",
    "Finding",
    "diagnose",
    "PREDICTORS",
    "normalize_predictors",
    "analyze_kernel_bracket",
    "analyze_kernel_ladder",
    "analyze_kernel_parse_only",
    "analyze_kernel_rung",
    "analyze_kernel_tp_only",
    "BalancedSchedule",
    "balance_from_costs",
    "brute_force_min_max",
    "gather_classes",
    "min_max_load",
    "InstructionRow",
    "LCDChainRow",
    "SCHEMA_VERSION",
    "analysis_view",
    "register_renderer",
    "render",
    "CriticalPathResult",
    "DependencyDAG",
    "LCDResult",
    "Node",
    "ThroughputResult",
    "analyze_kernel",
    "analyze_kernels",
    "analyze_wave",
    "build_dag",
    "clear_analysis_cache",
    "critical_path",
    "critical_path_from_dag",
    "lcd_from_dag",
    "loop_carried_dependencies",
    "throughput_analysis",
    "throughput_from_costs",
]
