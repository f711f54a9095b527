"""Train state: parameters, optimizer moments and step; the counterpart of
``repro.train.state``.

One device has no mesh, so ``RunConfig.zero`` and ``RunConfig.fsdp``, which
shard the moments and parameters over the data axes in the reference, shard
over nothing here (sharding is ROADMAP item 9).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import as_tensor, named_leaves, reference_tree
from repro_torch.models.transformer import Transformer, init_params
from repro_torch.optim import OptState, adamw_init


class TrainState(NamedTuple):
    params: Transformer  # parameters with requires_grad on
    opt: OptState  # moments keyed by the parameters' names
    step: torch.Tensor  # int32 scalar


def init_train_state(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
                     device: Device = None) -> TrainState:
    """Random parameters (``init_params`` from ``generator``, seed 0 on the
    device when None; requires_grad switched on, as the model is built for
    serving with it off), zero moments and step 0, on ``device`` (the card
    unless named)."""
    model = init_params(cfg, generator, device=resolve_device(device))
    for p in model.parameters():
        p.requires_grad_(True)
    return TrainState(params=model, opt=adamw_init(dict(model.named_parameters())),
                      step=torch.zeros((), dtype=torch.int32, device=model.embed.device))


def state_tree(state: TrainState, cfg: ModelConfig) -> Dict[str, Any]:
    """The state in the reference's layout, leaf for leaf as
    ``repro.train.TrainState`` flattens: params/<reference parameter path>,
    opt/mu/..., opt/nu/..., opt/count and step, layers stacked on the
    state's device (the parameters detached)."""
    named = {k: p.detach() for k, p in state.params.named_parameters()}
    return {"params": reference_tree(named, cfg),
            "opt": {"mu": reference_tree(state.opt.mu, cfg),
                    "nu": reference_tree(state.opt.nu, cfg), "count": state.opt.count},
            "step": state.step}


@torch.no_grad()
def load_state_tree(state: TrainState, tree: Dict[str, Any], cfg: ModelConfig) -> TrainState:
    """Copy a tree of ``state_tree``'s layout (tensors or arrays, e.g. a
    restored checkpoint or the reference's state as numpy) into ``state``'s
    parameters and moments, and return the state with its count and step."""
    named = dict(state.params.named_parameters())
    for k, v in named_leaves(tree["params"], cfg).items():
        named[k].copy_(as_tensor(v, named[k].device, named[k].dtype))
    for moments, part in ((state.opt.mu, "mu"), (state.opt.nu, "nu")):
        for k, v in named_leaves(tree["opt"][part], cfg).items():
            moments[k].copy_(as_tensor(v, moments[k].device, torch.float32))
    device = state.step.device
    count = as_tensor(tree["opt"]["count"], device, torch.int32).reshape(())
    step = as_tensor(tree["step"], device, torch.int32).reshape(())
    return TrainState(params=state.params, opt=OptState(state.opt.mu, state.opt.nu, count),
                      step=step)
