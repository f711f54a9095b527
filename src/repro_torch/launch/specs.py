"""Input specs and sharding specs for every (arch × shape) cell; the
counterpart of ``repro.launch.specs``. Specs are tensors on the ``meta``
device (shapes and dtypes, zero allocation), as the reference's are
``ShapeDtypeStruct``s."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import MeshContext
from repro_torch.distributed.sharding import (  # noqa: F401 (batch_shardings re-exported)
    P, NamedSharding, _sanitize, batch_shardings, data_entry)
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


def cache_shardings(cache_specs: Dict[str, Any], ctx: MeshContext) -> Dict[str, Any]:
    """KV caches: batch over data, sequence over model. SSM states: batch
    over data, heads over model; conv states: batch over data, channels over
    model. ``pos`` replicated."""
    data = data_entry(ctx)
    out = {}
    for name, leaf in cache_specs.items():
        nd = len(getattr(leaf, "shape", ()))
        if name in ("k", "v", "dk", "dv", "cross_k", "cross_v") and nd == 5:
            spec = P(None, data, "model", None, None)
        elif name == "ssm":
            spec = (P(None, data, "model", None, None) if nd == 5
                    else P(None, None, data, "model", None, None))
        elif name == "conv":
            spec = (P(None, data, None, "model") if nd == 4
                    else P(None, None, data, None, "model"))
        else:  # pos and misc scalars
            spec = P()
        shape = tuple(getattr(leaf, "shape", ()))
        out[name] = NamedSharding(ctx.mesh, _sanitize(ctx, shape, spec))
    return out


def model_flops_estimate(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS per step: 6·N·D train (N = active params), 2·N·D forward."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq
