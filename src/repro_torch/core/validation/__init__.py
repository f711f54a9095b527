from repro_torch.core.validation.gauss_seidel import (
    GS_CLX_ASM,
    GS_TX2_ASM,
    GS_ZEN_ASM,
    TABLE1,
    table1_row,
)

__all__ = ["GS_CLX_ASM", "GS_TX2_ASM", "GS_ZEN_ASM", "TABLE1", "table1_row"]
