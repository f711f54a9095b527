from repro_torch.optim.adamw import (
    OptState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)

__all__ = ["OptState", "adamw_init", "adamw_update", "cosine_schedule", "global_norm"]
