from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["AsyncCheckpointer", "latest_checkpoint", "restore_checkpoint",
           "save_checkpoint"]
