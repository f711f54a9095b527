"""Measurement (``repro.core.bench``): ``ibench``'s latency/throughput
microbenchmarks on torch ops, which populate machine-DB entries, and the
runner that measures a kernel through an injected executor or recalls it
from the recorded corpus."""

from repro_torch.core.bench.ibench import (
    BenchmarkResult,
    PopulatedEntry,
    dry_run_result,
    measure_latency,
    measure_throughput,
    populate_entry,
)
from repro_torch.core.bench.runner import KernelMeasurementRunner

__all__ = [
    "BenchmarkResult",
    "PopulatedEntry",
    "KernelMeasurementRunner",
    "dry_run_result",
    "measure_latency",
    "measure_throughput",
    "populate_entry",
]
