"""Train and eval steps with optional gradient accumulation (microbatching);
the counterpart of ``repro.train.step``.

``make_train_step`` closes over the configs, so the step's signature is
``(state, batch) -> (state, metrics)``. A step updates the state's tensors in
place and returns the state with the next step (the reference's jitted step
donates its state).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import gathered, on_mesh
from repro_torch.models.convert import STACKED
from repro_torch.models.transformer import forward_train
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.optim.adamw import compress_int8, decompress_int8
from repro_torch.train.loss import cross_entropy_loss
from repro_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _loss_fn(params, cfg: ModelConfig, run: RunConfig, batch: Batch):
    """(total loss, {"loss", "aux", "accuracy"}) of one batch; a vlm's
    frontend positions take no loss."""
    hidden, extras = forward_train(params, cfg, run, batch["tokens"],
                                   frontend=batch.get("frontend"))
    head = params.embed.T if cfg.tie_embeddings else gathered(params.lm_head)
    labels = batch["labels"]
    if hidden.shape[1] != labels.shape[1]:  # vlm: frontend positions unsupervised
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
    loss, acc = cross_entropy_loss(hidden, head, labels, chunk=run.loss_chunk,
                                   vocab=cfg.vocab)
    aux = extras.get("aux", torch.zeros((), dtype=torch.float32, device=loss.device))
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux, "accuracy": acc}


def _grads(params, cfg: ModelConfig, run: RunConfig, batch: Batch):
    """(total loss, metrics, gradients by parameter name). Every parameter
    must get a gradient: one that the loss does not reach raises. On a mesh
    (``sharding.on_mesh``; backward included, as remat reruns the forward there)
    the losses and gradients are DTensors."""
    named = dict(params.named_parameters())
    batch, context = on_mesh(params.embed, batch)
    with context:
        total, metrics = _loss_fn(params, cfg, run, batch)
        grads = torch.autograd.grad(total, list(named.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, dict(zip(named, grads))


def _reference_leaf(name: str) -> str:
    """The reference leaf a parameter belongs to: its name without the layer
    index (the reference stacks the layers into one tensor)."""
    parts = name.split(".")
    return ".".join(parts[:1] + parts[2:]) if parts[0] in STACKED else name


def _int8_roundtrip(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Simulated compressed gradient exchange: symmetric int8 per reference
    tensor (the layers of a stacked leaf share one scale, as in the
    reference), so the optimizer sees what a compressed sync would
    deliver."""
    amax: Dict[str, torch.Tensor] = {}
    for k, g in grads.items():
        m = torch.max(torch.abs(g.float()))
        leaf = _reference_leaf(k)
        amax[leaf] = m if leaf not in amax else torch.maximum(amax[leaf], m)
    return {k: g if g.dim() == 0 else
            decompress_int8(*compress_int8(g.float(), amax[_reference_leaf(k)]))
            for k, g in grads.items()}


def train_step(state: TrainState, batch: Batch, cfg: ModelConfig,
               run: RunConfig) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step on ``batch`` ({"tokens", "labels"}, (B,S) each,
    and "frontend" (B,F,d) for the audio and vlm families):
    gradients (averaged in f32 over ``run.microbatch`` slices of the batch),
    the int8 round trip under ``run.grad_compression == "int8"``, then
    AdamW at the cosine schedule's rate for ``state.step``."""
    if run.microbatch > 1:
        mb = run.microbatch
        b = batch["tokens"].shape[0]
        if b % mb:
            raise ValueError(f"batch {b} % microbatch {mb} != 0")
        grads, metrics = None, None
        for i in range(mb):
            part = {k: v.reshape(mb, b // mb, *v.shape[1:])[i] for k, v in batch.items()}
            _, m, g = _grads(state.params, cfg, run, part)
            if grads is None:
                grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                         for k, v in g.items()}
                metrics = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                           for k, v in m.items()}
            grads = {k: grads[k] + g[k].float() / mb for k in grads}
            metrics = {k: metrics[k] + m[k] / mb for k in metrics}
    else:
        _, metrics, grads = _grads(state.params, cfg, run, batch)

    if run.grad_compression == "int8":
        grads = _int8_roundtrip(grads)

    lr = cosine_schedule(state.step, run.learning_rate, run.warmup_steps, run.total_steps)
    _, opt, opt_metrics = adamw_update(dict(state.params.named_parameters()), grads,
                                       state.opt, lr, weight_decay=run.weight_decay,
                                       grad_clip=run.grad_clip)
    return (TrainState(params=state.params, opt=opt, step=state.step + 1),
            {**metrics, **opt_metrics})


@torch.no_grad()
def eval_step(state: TrainState, batch: Batch, cfg: ModelConfig, run: RunConfig):
    batch, context = on_mesh(state.params.embed, batch)
    with context:
        _, metrics = _loss_fn(state.params, cfg, run, batch)
    return metrics


def make_train_step(cfg: ModelConfig, run: RunConfig):
    return functools.partial(train_step, cfg=cfg, run=run)
