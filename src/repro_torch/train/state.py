"""Train state: parameters, optimizer moments and step, with sharding specs;
the counterpart of ``repro.train.state``.

``state_shardings`` gives each parameter and moment a
:class:`~repro_torch.distributed.sharding.NamedSharding`: the parameters
follow the tensor/expert-parallel rules (FSDP: also over the data axes
under ``RunConfig.fsdp``), the moments are ZeRO-sharded over the data axes
under ``RunConfig.zero``, step and count are replicated. The rules run on
the reference's stacked shapes (``tree_shardings`` gives them in
``state_tree``'s layout, for checkpoints); ``distribute_state`` puts a
state's tensors on them as DTensors, and ``empty_train_state`` allocates a
state's shards alone.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import (P, MeshContext, NamedSharding, distribute,
                                              drop_layers, empty_sharded, is_distributed,
                                              layer_dims, stacked_param_shardings,
                                              zero_extend)
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


def empty_train_state(cfg: ModelConfig, *, device: Device = None,
                      shardings: Optional[TrainState] = None) -> TrainState:
    """A state of ``init_train_state``'s shapes and dtypes on ``device`` (the
    card unless named), its parameters and moments unset, for
    ``load_state_tree`` to fill; step 0. With ``shardings`` (a
    ``state_shardings`` result on a ``DeviceMesh`` of ``device``'s type)
    each parameter and moment is a DTensor of which this rank allocates its
    own shard only."""
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta")
    if shardings is None:
        model = model.to_empty(device=dev)
    else:
        for name, p in list(model.named_parameters()):
            owner, _, attr = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            setattr(module, attr, torch.nn.Parameter(
                empty_sharded(p.shape, p.dtype, shardings.params[name])))
    for p in model.parameters():
        p.requires_grad_(True)
    opt = adamw_init(dict(model.named_parameters()))
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if shardings is not None:
        mu, nu = ({k: empty_sharded(v.shape, torch.float32, part[k]) for k, v in moments.items()}
                  for moments, part in ((opt.mu, shardings.opt.mu), (opt.nu, shardings.opt.nu)))
        opt = OptState(mu, nu, distribute(opt.count, shardings.opt.count))
        step = distribute(step, shardings.step)
    return TrainState(params=model, opt=opt, step=step)


def abstract_train_state(cfg: ModelConfig) -> TrainState:
    """The state's shapes and dtypes on the ``meta`` device: parameters,
    f32 moments beside them, step. Allocates nothing, so every architecture
    builds at full size."""
    return init_train_state(cfg, device="meta")


def _layer_zero_extend(stacked: NamedSharding, shape, lead: int,
                       mesh_ctx: MeshContext) -> NamedSharding:
    """``zero_extend`` of a reference leaf, for the per-layer tensor: the
    reference's choice where it falls on a dim the per-layer tensor has;
    where it falls on the stacked layer axis, which the per-layer tensor
    lacks, the per-layer tensor's own (its first free dim that the data size
    divides)."""
    extended = zero_extend(stacked, shape, mesh_ctx)
    if any(entry is not None for entry in tuple(extended.spec)[:lead]):
        return zero_extend(drop_layers(stacked, shape, lead), tuple(shape[lead:]), mesh_ctx)
    return drop_layers(extended, shape, lead)


def state_shardings(state: TrainState, mesh_ctx: MeshContext, run: RunConfig) -> TrainState:
    """A TrainState of NamedShardings by parameter name: the parameters'
    tensor/expert-parallel rules (and FSDP under ``run.fsdp``), the moments
    additionally ZeRO-sharded over the data axes under ``run.zero``, the
    count and step replicated. The rules run on the reference's stacked
    leaf and its layer entries are dropped; where the reference's FSDP/ZeRO
    dim is the layer axis, the per-layer tensor takes its own
    (``_layer_zero_extend``)."""
    params, moments = {}, {}
    for name, (p, shape, lead) in stacked_param_shardings(state.params, mesh_ctx).items():
        extended = _layer_zero_extend(p, shape, lead, mesh_ctx)
        params[name] = extended if run.fsdp else drop_layers(p, shape, lead)
        moments[name] = extended if run.zero or run.fsdp else params[name]
    scalar = NamedSharding(mesh_ctx.mesh, P())
    return TrainState(params=params, opt=OptState(mu=moments, nu=dict(moments), count=scalar),
                      step=scalar)


def tree_shardings(shardings: TrainState, cfg: ModelConfig) -> Dict[str, Any]:
    """``shardings`` (a ``state_shardings`` result) in ``state_tree``'s
    layout, for a checkpoint's stacked leaves: each stacked leaf's layer
    dims whole, its other dims as its layers' (which share one spec)."""
    def stacked(part):
        return reference_tree({k: NamedSharding(s.mesh, P(*([None] * layer_dims(k, cfg)),
                                                        *s.spec))
                               for k, s in part.items()}, cfg, stack=False)

    return {"params": stacked(shardings.params),
            "opt": {"mu": stacked(shardings.opt.mu), "nu": stacked(shardings.opt.nu),
                    "count": shardings.opt.count},
            "step": shardings.step}


def distribute_state(state: TrainState, shardings: TrainState) -> TrainState:
    """The state's parameters (in place, as parameters of the same module),
    moments, count and step as DTensors on ``shardings`` (a
    ``state_shardings`` result)."""
    for name, p in list(state.params.named_parameters()):
        owner, _, attr = name.rpartition(".")
        module = state.params.get_submodule(owner) if owner else state.params
        dt = distribute(p.detach(), shardings.params[name])
        setattr(module, attr, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    mu = {k: distribute(v, shardings.opt.mu[k]) for k, v in state.opt.mu.items()}
    nu = {k: distribute(v, shardings.opt.nu[k]) for k, v in state.opt.nu.items()}
    return TrainState(params=state.params,
                      opt=OptState(mu, nu, distribute(state.opt.count, shardings.opt.count)),
                      step=distribute(state.step, shardings.step))


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
    parameters and moments, and return the state with its count and step.
    A DTensor state takes DTensor leaves (``restore_checkpoint`` on the
    state's ``tree_shardings``) shard by shard."""
    def put(t, v, dtype):
        return t.copy_(v if is_distributed(t) else as_tensor(v, t.device, dtype))

    named = dict(state.params.named_parameters())
    for k, v in named_leaves(tree["params"], cfg).items():
        put(named[k], v, named[k].dtype)
    for moments, part in ((state.opt.mu, "mu"), (state.opt.nu, "nu")):
        for k, v in named_leaves(tree["opt"][part], cfg).items():
            put(moments[k], v, torch.float32)
    count, step = state.opt.count, state.step
    if is_distributed(step):
        count, step = count.copy_(tree["opt"]["count"]), step.copy_(tree["step"])
    else:
        count = as_tensor(tree["opt"]["count"], step.device, torch.int32).reshape(())
        step = as_tensor(tree["step"], step.device, torch.int32).reshape(())
    return TrainState(params=state.params, opt=OptState(state.opt.mu, state.opt.nu, count),
                      step=step)
