from repro_torch.kernels.ops import (LAUNCHES, flash_attention, flash_decode,
                                     fused_rmsnorm, reset_launches, ssd_chunk_dual)

__all__ = ["LAUNCHES", "flash_attention", "flash_decode", "fused_rmsnorm",
           "reset_launches", "ssd_chunk_dual"]
