"""Input specs and sharding specs for every (arch × shape) cell; the
counterpart of ``repro.launch.specs``. Specs are tensors on the ``meta``
device (shapes and dtypes, zero allocation), as the reference's are
``ShapeDtypeStruct``s."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (  # noqa: F401 (shardings re-exported)
    batch_shardings, cache_shardings)
from repro_torch.models.transformer import init_cache


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (a torch dtype or its name)."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract model inputs for one cell.

    train  : {tokens, labels[, frontend]}
    prefill: {tokens[, frontend]}
    decode : {cache, tokens}; the cache is ``init_cache``'s on ``meta``, its
             ``pos`` an int32 scalar as the reference's.
    """
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    if shape.kind == "decode":
        cache = init_cache(cfg, b, s, device="meta")
        cache["pos"] = sds((), torch.int32)
        return {"cache": cache, "tokens": sds((b, 1), torch.int32)}

    specs: Dict[str, Any] = {}
    if cfg.frontend == "vision_stub":
        f = cfg.frontend_len
        specs["tokens"] = sds((b, s - f), torch.int32)
        specs["frontend"] = sds((b, f, cfg.d_model), dt)
        if shape.kind == "train":
            specs["labels"] = sds((b, s - f), torch.int32)
    elif cfg.frontend == "audio_stub":
        specs["tokens"] = sds((b, s), torch.int32)
        specs["frontend"] = sds((b, cfg.frontend_len, cfg.d_model), dt)
        if shape.kind == "train":
            specs["labels"] = sds((b, s), torch.int32)
    else:
        specs["tokens"] = sds((b, s), torch.int32)
        if shape.kind == "train":
            specs["labels"] = sds((b, s), torch.int32)
    return specs


def model_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS per step: 6·N·D train (N = active params), 2·N·D forward."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq
