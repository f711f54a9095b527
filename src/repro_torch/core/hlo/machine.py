"""GPU "port model" for accelerator graphs: the counterpart of
``repro.core.hlo.machine``, whose TPU chip it replaces with an NVIDIA H100.

The OSACA port-model concept carries over with the card's concurrently
operating engines as the ports: the tensor cores (``TC``), the HBM
interface and the NVLink links.  An op's "port pressure" is the time it
occupies each engine; the roofline terms are exactly the per-port
accumulated pressures of the module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class GPUChip:
    name: str
    peak_flops: float  # dense bf16 tensor-core FLOP/s per card
    hbm_bw: float  # bytes/s per card
    link_bw: float  # bytes/s a ring step sends, per direction
    links: int  # NVLink links per card
    sm_count: int
    smem_bytes_per_sm: int  # shared memory per SM (the TPU's VMEM role)
    hbm_bytes: int

    # ---- per-op port pressure (seconds) -----------------------------------

    def compute_seconds(self, flops: float) -> float:
        return flops / self.peak_flops

    def memory_seconds(self, bytes_accessed: float) -> float:
        return bytes_accessed / self.hbm_bw

    def collective_seconds(self, bytes_moved: float) -> float:
        # Roofline denominator: the bandwidth one ring step leaves a card by.
        return bytes_moved / self.link_bw

    def collective_model_seconds(self, opcode: str, operand_bytes: float,
                                 group_size: int) -> float:
        """Ring-model refinement: bytes each card moves over NVLink.

        all-reduce     : 2 (n-1)/n x B       (reduce-scatter + all-gather)
        all-gather     : (n-1) x B           (operand B is the local shard)
        reduce-scatter : (n-1)/n x B
        all-to-all     : (n-1)/n x B
        collective-permute : B
        """
        n = max(group_size, 1)
        base = opcode.replace("-start", "").replace("-done", "")
        if n == 1:
            return 0.0
        mult = {
            "all-reduce": 2.0 * (n - 1) / n,
            "all-gather": float(n - 1),
            "reduce-scatter": (n - 1) / n,
            "all-to-all": (n - 1) / n,
            "collective-permute": 1.0,
            "collective-broadcast": 1.0,
        }.get(base, 1.0)
        return mult * operand_bytes / self.link_bw

    def port_pressure(self, flops: float, bytes_accessed: float,
                      collective_bytes: float) -> Dict[str, float]:
        """The module-level three-term pressure (seconds per port)."""
        return {
            "TC": self.compute_seconds(flops),
            "HBM": self.memory_seconds(bytes_accessed),
            "NVLink": self.collective_seconds(collective_bytes),
        }


# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: 989.4 TFLOP/s dense
# BF16 on the tensor cores, 3.35 TB/s of HBM3, 80 GB, NVLink 900 GB/s
# (bidirectional) over 18 links.  132 SMs and 228 KiB of shared memory per
# SM: NVIDIA H100 Tensor Core GPU Architecture whitepaper (H100 SXM5).
#
# ``link_bw`` is the per-direction aggregate, 450 GB/s.  The TPU model
# divides by one ICI link, because a ring on a torus sends over one link
# each way; on an NVSwitch node a ring step leaves a GPU through all of its
# NVLinks at once, so their per-direction sum is the ring's link.
H100_SXM = GPUChip(
    name="h100_sxm",
    peak_flops=989.4e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    links=18,
    sm_count=132,
    smem_bytes_per_sm=228 * 1024,
    hbm_bytes=80 * 10**9,
)
