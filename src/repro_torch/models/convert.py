"""Reference weights into the port: ``repro.models.init_params`` output, as
numpy arrays, becomes a :class:`~repro_torch.models.transformer.Transformer`.

The reference stacks layers on a leading axis; here each layer is its own
submodule, so the stacked arrays are split. bf16 arrays (``ml_dtypes``) go
through float32, which holds every bf16 value exactly. Only tests call this
with JAX output; it imports no JAX.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer


def _tensor(a: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(device=device,
                                                                  dtype=dtype)


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig, *,
                    device: Device, dtype: Optional[torch.dtype] = None) -> Transformer:
    """Build a Transformer holding the reference tree's weights.

    ``np_tree`` has the reference's keys: embed, final_norm, lm_head (unless
    tied) and layers/{attn/{wq,wk,wv,wo}, mlp/{wi,wo}, norm1, norm2}, each
    layer leaf of shape (L, ...). ``dtype`` defaults to ``cfg.dtype``; wi
    keeps the reference's [gate, up] column order.
    """
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta", dtype=dtype)
    dt = model.embed.dtype
    state = {"embed": np_tree["embed"], "final_norm": np_tree["final_norm"]}
    if not cfg.tie_embeddings:
        state["lm_head"] = np_tree["lm_head"]
    layers = np_tree["layers"]
    for i in range(cfg.n_layers):
        for group in ("attn", "mlp"):
            for name, stacked in layers[group].items():
                state[f"layers.{i}.{group}.{name}"] = np.asarray(stacked)[i]
        for name in ("norm1", "norm2"):
            state[f"layers.{i}.{name}"] = np.asarray(layers[name])[i]
    tensors = {k: _tensor(v, dev, dt) for k, v in state.items()}
    expected = {k: tuple(p.shape) for k, p in model.named_parameters()}
    got = {k: tuple(t.shape) for k, t in tensors.items()}
    if expected != got:
        raise ValueError(f"reference tree does not match {cfg.name}: "
                         f"expected {expected}, got {got}")
    model.load_state_dict(tensors, assign=True)
    return model
