from repro_torch.models.transformer import (
    Transformer,
    decode_step,
    forward_hidden,
    forward_train,
    init_cache,
    init_params,
    prefill,
)

__all__ = ["Transformer", "decode_step", "forward_hidden", "forward_train",
           "init_cache", "init_params", "prefill"]
