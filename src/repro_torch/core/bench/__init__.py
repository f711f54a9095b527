"""Kernel measurement (``repro.core.bench``): the runner that measures a
kernel through an injected executor or recalls it from the recorded corpus.

``ibench`` (instruction latency/throughput microbenchmarks, which populate
machine-DB entries) is not ported yet: ROADMAP item 11 rebuilds it on torch
ops.
"""

from repro_torch.core.bench.runner import KernelMeasurementRunner

__all__ = ["KernelMeasurementRunner"]
