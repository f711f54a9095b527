"""AdamW with decoupled weight decay, global-norm clipping, a cosine
schedule and optional int8 gradient compression; the counterpart of
``repro.optim.adamw``.

Parameters and moments are flat mappings of name to tensor. Moments are f32
whatever the parameters' dtype. ``adamw_update`` applies the reference's
arithmetic in its order, one tensor at a time, and updates the parameters
and moments in place (the reference's train step donates its state): no
second copy of the parameters, the moments or the f32 gradients is ever
held. ``torch.optim.AdamW`` is not used: it applies the decay first, as
``p * (1 - lr * wd)``, which rounds differently.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    mu: Tensors  # first moment (f32)
    nu: Tensors  # second moment (f32)
    count: torch.Tensor  # step counter, int32 scalar


def adamw_init(params: Mapping[str, torch.Tensor]) -> OptState:
    """Zero moments beside each parameter, and a zero count."""
    mu = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in params.items()}
    nu = {k: torch.zeros_like(m) for k, m in mu.items()}
    device = next(iter(params.values())).device
    return OptState(mu=mu, nu=nu, count=torch.zeros((), dtype=torch.int32, device=device))


def cosine_schedule(step, base_lr: float, warmup: int, total: int) -> torch.Tensor:
    """Linear warmup over ``warmup`` steps, then a cosine to 0 at ``total``;
    ``step`` is an int or an integer tensor, the result an f32 scalar."""
    step_f = torch.as_tensor(step).float()
    warm = base_lr * (step_f + 1.0) / max(warmup, 1)
    progress = torch.clamp((step_f - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * progress))
    return torch.where(step_f < warmup, warm, cos)


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the summed squares of every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors.values()))


def compress_int8(g: torch.Tensor,
                  amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization (gradient compression), at
    scale ``max(|g|) / 127``; ``amax`` stands in for ``max(|g|)`` where the
    tensor is one slice of a larger one (a layer of a stacked reference
    leaf) that shares its scale."""
    if amax is None:
        amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 opt: OptState, lr: torch.Tensor, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> Tuple[Mapping[str, torch.Tensor], OptState,
                                                  Dict[str, torch.Tensor]]:
    """One AdamW step: gradients to f32, the global norm, the clip scale,
    the count, ``c1``/``c2``, ``mu``, ``nu``, then ``p - lr * (m_hat /
    (sqrt(v_hat) + eps) + wd * p)`` in f32, cast to the parameter's dtype.
    Updates ``params`` in place and rebinds the moments in ``opt``'s
    mappings; returns (params, the new OptState, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    if grad_clip > 0:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    count = opt.count + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for k, p in params.items():
        g = grads[k].float() * scale
        m = b1 * opt.mu[k] + (1 - b1) * g
        v = b2 * opt.nu[k] + (1 - b2) * torch.square(g)
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
        opt.mu[k], opt.nu[k] = m, v
    return params, OptState(mu=opt.mu, nu=opt.nu, count=count), {"grad_norm": gnorm, "lr": lr}
