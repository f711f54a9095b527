"""Reference weights into the port and back: ``repro.models.init_params``
output, as numpy arrays, becomes a
:class:`~repro_torch.models.transformer.Transformer` of any family
(``params_from_jax``), and the port's named tensors (its
parameters, or the optimizer moments beside them) become a tree in the
reference's layout (``reference_tree``), which checkpoints use.

The reference stacks layers on leading axes; here each layer is its own
submodule, so the stacked arrays are split, and stacked again on the way
back. bf16 arrays (``ml_dtypes``) go through float32, which holds every bf16
value exactly. Only tests call this with JAX output; it imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer


def as_tensor(a: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A tensor, or an array (bf16 ones through float32), on ``device`` in
    ``dtype``; a DTensor whole (its ``full_tensor``)."""
    if hasattr(a, "full_tensor"):
        a = a.full_tensor()
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.asarray(a).astype(np.float32)).to(device=device,
                                                                  dtype=dtype)


def _leaf(a: Any):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def named_leaves(np_tree: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The reference tree's leaves (arrays or tensors) under the port's
    parameter names, the stacked layer axes split into one entry per
    layer."""
    state = {"embed": np_tree["embed"], "final_norm": np_tree["final_norm"]}
    if not cfg.tie_embeddings:
        state["lm_head"] = np_tree["lm_head"]
    layers = np_tree["layers"]
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        dense = (("attn", "mlp"), ("norm1", "norm2"))
        if cfg.family == "moe":
            stacks = [("layers", layers, ("attn", "moe"), ("norm1", "norm2"))]
            if cfg.moe_first_dense:
                stacks.append(("dense_layers", np_tree["dense_layers"], *dense))
        elif cfg.family == "audio":
            stacks = [("enc_layers", np_tree["enc_layers"], *dense),
                      ("layers", layers, ("attn", "mlp", "cross"), ("norm1", "norm2", "norm3"))]
            state["enc_final_norm"] = np_tree["enc_final_norm"]
        else:
            stacks = [("layers", layers, *dense)]
        for prefix, tree, groups, norms in stacks:
            for group in groups:
                for name, stacked in tree[group].items():
                    for i, leaf in enumerate(_leaf(stacked)):
                        state[f"{prefix}.{i}.{group}.{name}"] = leaf
            for name in norms:
                for i, leaf in enumerate(_leaf(tree[name])):
                    state[f"{prefix}.{i}.{name}"] = leaf
        return state
    # ssm leaves are (L, ...), hybrid leaves (G, every, ...): flatten to L.
    lead = 1 if cfg.family == "ssm" else 2

    def per_layer(stacked):
        a = _leaf(stacked)
        return a.reshape(-1, *a.shape[lead:])

    for name, stacked in layers["mamba"].items():
        for i, leaf in enumerate(per_layer(stacked)):
            state[f"layers.{i}.mamba.{name}"] = leaf
    for i, leaf in enumerate(per_layer(layers["norm1"])):
        state[f"layers.{i}.norm1"] = leaf
    if cfg.family == "hybrid":
        for group in ("shared_attn", "shared_mlp"):
            for name, leaf in np_tree[group].items():
                state[f"{group}.{name}"] = leaf
        for name in ("shared_norm1", "shared_norm2", "inv_proj"):
            state[name] = np_tree[name]
    return state


# Parameter-name prefixes of per-layer submodules, which the reference stacks.
STACKED = ("layers", "dense_layers", "enc_layers")


def _put(tree: Dict[str, Any], path: Sequence[str], leaf: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def reference_tree(named: Mapping[str, Any], cfg: ModelConfig, *,
                   stack: bool = True) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``'s split: tensors under the port's
    parameter names (a model's ``named_parameters()``, or the optimizer
    moments keyed like them) as a nested dict in the reference's layout,
    e.g. ``layers/attn/wq`` (L, d, H*D) for the dense family, the layer
    axes of ``layers`` (and of the moe family's ``dense_layers``) stacked on
    the tensors' device ((G, every, ...) for hybrid ``layers`` leaves), and
    of the audio family's ``enc_layers``. Without ``stack`` the leaves are
    values every layer shares (a stacked leaf's sharding), and a stacked
    leaf takes its first layer's."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[tuple, list] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in STACKED:
            per_layer.setdefault((parts[0], *parts[2:]), []).append((int(parts[1]), t))
        else:
            _put(tree, parts, t)
    for path, items in per_layer.items():
        if not stack:
            _put(tree, path, min(items, key=lambda it: it[0])[1])
            continue
        stacked = torch.stack([t for _, t in sorted(items, key=lambda it: it[0])])
        if cfg.family == "hybrid" and path[0] == "layers":
            stacked = stacked.reshape(-1, cfg.hybrid_attn_every, *stacked.shape[1:])
        _put(tree, path, stacked)
    return tree


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig, *,
                    device: Device, dtype: Optional[torch.dtype] = None) -> Transformer:
    """Build a Transformer holding the reference tree's weights.

    ``np_tree`` has the reference's keys: embed, final_norm, lm_head (unless
    tied) and
      * dense, vlm: layers/{attn/{wq,wk,wv,wo}, mlp/{wi,wo}, norm1, norm2},
        each leaf (L, ...);
      * audio: enc_layers with the dense family's leaves, each
        (n_encoder_layers, ...), enc_final_norm, and layers/{attn/*, mlp/*,
        cross/{cross_wq,cross_wk,cross_wv,cross_wo}, norm1, norm2, norm3},
        each leaf (L, ...);
      * moe: layers/{attn/*, moe/{router,moe_wi,moe_wo,shared_wi,shared_wo},
        norm1, norm2}, each leaf (L - first_dense, ...), and dense_layers
        with the dense family's leaves, each (first_dense, ...);
      * ssm: layers/{mamba/{in_proj,conv_w,A_log,D,dt_bias,ssm_norm,out_proj},
        norm1}, each leaf (L, ...);
      * hybrid: layers/{mamba/*, norm1} with leaves (G, every, ...), plus
        shared_attn/{wq,wk,wv,wo}, shared_mlp/{wi,wo}, shared_norm1/2 and
        inv_proj (G, d, d).
    ``dtype`` defaults to ``cfg.dtype``; wi keeps the reference's [gate, up]
    column order. Raises if the tree's names or shapes differ from the
    model's.
    """
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta", dtype=dtype)
    dt = model.embed.dtype
    tensors = {k: as_tensor(v, dev, dt) for k, v in named_leaves(np_tree, cfg).items()}
    expected = {k: tuple(p.shape) for k, p in model.named_parameters()}
    got = {k: tuple(t.shape) for k, t in tensors.items()}
    if expected != got:
        raise ValueError(f"reference tree does not match {cfg.name}: "
                         f"expected {expected}, got {got}")
    model.load_state_dict(tensors, assign=True)
    return model
