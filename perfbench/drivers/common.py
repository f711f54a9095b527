"""What the drivers share: the family's reference module, the program's
model built from the benchmark's weights, and the release of the program's
state before the reference runs."""

from __future__ import annotations

import gc
import importlib

import torch

from perfbench.reference import weights


def family(m: dict):
    """``perfbench/reference/families/<family>.py``."""
    return importlib.import_module(f"perfbench.reference.families.{m['family']}")


def dtype(m: dict) -> torch.dtype:
    return getattr(torch, m["dtype"])


def model_config(m: dict):
    """The program's ModelConfig of the configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**m)


def build_model(m: dict, spec: dict, seed: int, device):
    """The program's ``Transformer`` for ``m``, allocated empty on ``device``
    and filled block by block from the seed; its parameter names and shapes
    must be the family's spec, one for one."""
    from repro_torch.models.transformer import Transformer

    model = Transformer(model_config(m), device="meta").to_empty(device=device)
    params = dict(model.named_parameters())
    got = {k: tuple(p.shape) for k, p in params.items()}
    want = {k: tuple(shape) for k, (shape, _) in spec.items()}
    if got != want:
        missing = sorted(set(want) - set(got))[:5]
        extra = sorted(set(got) - set(want))[:5]
        shapes = sorted(k for k in set(got) & set(want) if got[k] != want[k])[:5]
        raise ValueError(f"the program's parameters are not the reference's: missing {missing}, "
                         f"extra {extra}, other shapes {shapes}")
    with torch.no_grad():
        for block in weights.iter_blocks(spec, seed, device, dtype(m)):
            for name, t in block.items():
                params[name].copy_(t)
            del block
    return model


def free_memory() -> None:
    """Return what nothing refers to any more to the card (the caller has
    dropped the program's state first)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
