"""Window-limited out-of-order point-prediction simulator.

Closes the paper's ``[TP, CP]`` bracket with a steady-state cycles-per-
iteration prediction; see :mod:`repro_torch.core.sim.engine` for the model and
:class:`repro_torch.core.machine.window.WindowParams` for the per-arch window
capacities it consumes.
"""

from repro_torch.core.machine.window import WindowParams
from repro_torch.core.sim.engine import (KernelTemplate, SimResult,
                                         simulate_from_dag, simulate_kernel,
                                         simulate_kernels, simulate_template,
                                         template_from_dag)

__all__ = [
    "KernelTemplate",
    "SimResult",
    "WindowParams",
    "simulate_from_dag",
    "simulate_kernel",
    "simulate_kernels",
    "simulate_template",
    "template_from_dag",
]
