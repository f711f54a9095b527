"""Mixture-of-Experts FFN: GShard-style grouped top-k dispatch with capacity;
the counterpart of ``repro.models.moe``.

Tokens are split into groups (``moe_group_size``, or the largest size that
divides the token count); each group routes independently with per-group
expert capacity C = ceil(top_k * S_g * cf / E), earlier tokens winning a
slot (slot-major, GShard semantics); assignments past capacity are dropped.
Dispatch and combine are index gathers (``"gather"``) or, for any other
mode, as in the reference, one-hot einsums (``"einsum"``), with the same
result. Supports DeepSeek-MoE's fine-grained
routing (64 routed experts, top 6, plus 2 shared experts) and
Phi-3.5-MoE's (16 routed, top 2).

The top k breaks ties as ``jax.lax.top_k`` does, lower expert index first:
it takes the first k of a stable descending sort (``torch.topk`` promises no
order for ties, and the order decides which token gets a slot). The expert
GEMMs are batched products, as in the reference, outside any kernel. The
reference's sharding constraints are ``constrain`` calls at the same points
(groups over the data axes, experts over the model axis); without a mesh
they return their input.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import constrain
from repro_torch.distributed.sharding import einsum, gathered
from repro_torch.models.layers import DATA, MODEL, ParamGroup, gather_sequence
from repro_torch.tracing import span


class MoE(ParamGroup):
    """router (d, E), moe_wi (E, d, 2*ffe) [gate, up], moe_wo (E, ffe, d) and,
    with shared experts, shared_wi (d, 2*fsh) and shared_wo (fsh, d), fsh =
    moe_shared * ffe; in the reference's layouts."""

    def __init__(self, cfg, *, generator, device, dtype):
        d, e = cfg.d_model, cfg.moe_experts
        ffe = cfg.moe_d_ff or cfg.d_ff
        shapes = {"router": (d, e), "moe_wi": (e, d, 2 * ffe), "moe_wo": (e, ffe, d)}
        if cfg.moe_shared > 0:
            fsh = cfg.moe_shared * ffe
            shapes.update(shared_wi=(d, 2 * fsh), shared_wo=(fsh, d))
        super().__init__(shapes, generator=generator, device=device, dtype=dtype)


def _swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    gate, up = (x @ wi).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ wo


def _topk(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _slots(probs: torch.Tensor, top_k: int):
    """(top-k probs, indices, one-hot (G,S,k,E), position of each (token,
    k-slot) in its expert's queue (G,S,k), aux loss) of probs (G,S,E)."""
    g, s, e = probs.shape
    topk_probs, topk_idx = _topk(probs, top_k)  # (G,S,k)
    onehot = F.one_hot(topk_idx, e).to(torch.float32)  # (G,S,k,E)
    # Slot-major: every token's first choice queues before any second one.
    slot_major = onehot.transpose(1, 2).reshape(g, top_k * s, e)
    positions = torch.cumsum(slot_major, dim=1) - slot_major
    positions = positions.reshape(g, top_k, s, e).transpose(1, 2)  # (G,S,k,E)
    pos_in_expert = (positions * onehot).sum(dim=-1)  # (G,S,k)
    # aux load-balancing loss (Switch-style): E * mean(frac_tokens * frac_probs)
    token_frac = onehot.sum(dim=2).mean(dim=1)  # (G,E)
    prob_frac = probs.mean(dim=1)  # (G,E)
    aux = e * (token_frac * prob_frac).sum(dim=-1).mean()
    return topk_probs, topk_idx, onehot, pos_in_expert, aux


def route_topk(logits: torch.Tensor, top_k: int, capacity: int):
    """Top-k routing with per-group capacity. logits (G,S,E) -> (dispatch
    (G,S,E,C) 0/1 f32, combine (G,S,E,C) f32, aux loss)."""
    probs = torch.softmax(logits.float(), dim=-1)
    topk_probs, _, onehot, pos, aux = _slots(probs, top_k)
    topk_probs = topk_probs / torch.clamp(topk_probs.sum(dim=-1, keepdim=True), min=1e-9)
    keep = pos < capacity
    # One-hot over the C slots; a position past capacity has none (as
    # jax.nn.one_hot gives an out-of-range index), and ``keep`` drops it.
    slots = torch.arange(capacity, device=logits.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).to(torch.float32) * keep[..., None]  # (G,S,k,C)
    dispatch = einsum("gske,gskc->gsec", onehot, pos_oh)
    combine = einsum("gsk,gske,gskc->gsec", topk_probs, onehot, pos_oh)
    return dispatch, combine, aux


def route_topk_indices(logits: torch.Tensor, top_k: int, capacity: int):
    """Index routing (the gather path): (topk_idx (G,S,k), gates (G,S,k),
    pos (G,S,k) int32, keep (G,S,k), aux), the semantics of
    :func:`route_topk` without the (G,S,E,C) tensors."""
    probs = torch.softmax(logits.float(), dim=-1)
    topk_probs, topk_idx, _, pos, aux = _slots(probs, top_k)
    gates = topk_probs / torch.clamp(topk_probs.sum(dim=-1, keepdim=True), min=1e-9)
    pos = pos.to(torch.int32)
    return topk_idx, gates, pos, pos < capacity, aux


def _expert_ffn(params: MoE, expert_in: torch.Tensor) -> torch.Tensor:
    """(E,G,C,d) -> (E,G,C,d) through each expert's SwiGLU."""
    gate, up = einsum("egcd,edf->egcf", expert_in, gathered(params.moe_wi)).chunk(2, dim=-1)
    return einsum("egcf,efd->egcd", F.silu(gate) * up, gathered(params.moe_wo))


def _moe_gather_dispatch(params: MoE, xg: torch.Tensor, cfg, capacity: int, layer=None):
    """Gather/scatter dispatch: no (G,S,E,C) one-hot products. A kept
    assignment takes its (expert, position) slot; the rest go to an
    overflow slot C that is cut off (the reference's scatter with
    ``mode="drop"`` writes there, and no kept slot is written twice).
    Recorded as the einsum path's spans: routing and the slot tables
    ``moe.route``, the gather ``moe.dispatch``, the pick and weighted sum
    ``moe.combine``."""
    g, s, d = xg.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    with span("moe.route", layer=layer):
        logits = einsum("gsd,de->gse", xg, gathered(params.router))
        topk_idx, gates, pos, keep, aux = route_topk_indices(logits, k, capacity)

        gi = torch.arange(g, device=xg.device)[:, None, None].expand(g, s, k)
        si = torch.arange(s, device=xg.device)[None, :, None].expand(g, s, k)
        pos_c = torch.where(keep, pos, capacity).long()
        slot_token = torch.zeros((g, e, capacity + 1), dtype=torch.long, device=xg.device)
        slot_fill = torch.zeros((g, e, capacity + 1), dtype=xg.dtype, device=xg.device)
        slot_token[gi, topk_idx, pos_c] = si
        slot_fill[gi, topk_idx, pos_c] = 1.0
        slot_token, slot_fill = slot_token[..., :capacity], slot_fill[..., :capacity]

    with span("moe.dispatch", layer=layer):
        expert_in = xg[torch.arange(g, device=xg.device)[:, None, None], slot_token]  # (G,E,C,d)
        expert_in = (expert_in * slot_fill[..., None]).transpose(0, 1)  # (E,G,C,d)
        expert_in = constrain(expert_in, MODEL, DATA, None, None)
    with span("moe.experts", layer=layer):
        expert_out = constrain(_expert_ffn(params, expert_in), MODEL, DATA, None, None)
    expert_out = expert_out.transpose(0, 1)  # (G,E,C,d)

    with span("moe.combine", layer=layer):
        flat = expert_out.reshape(g, e * capacity, d)
        slot_of_token = topk_idx * capacity + torch.clamp(pos, max=capacity - 1)
        picked = flat[gi, slot_of_token]  # (G,S,k,d)
        w = (gates * keep).to(xg.dtype)  # dropped slots contribute zero
        return einsum("gsk,gskd->gsd", w, picked), aux


def moe_block(params: MoE, x: torch.Tensor, cfg, dispatch_mode: str = "einsum",
              layer=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y (B,S,d), aux loss). Shared experts run densely.
    Under the profiler it records ``moe.route`` (the router product,
    ``route_topk`` and the casts), ``moe.dispatch``, ``moe.experts``,
    ``moe.combine`` and ``moe.shared`` spans, labelled with ``layer``."""
    x = gather_sequence(x)
    b, s, d = x.shape
    e = cfg.moe_experts
    group = min(cfg.moe_group_size, b * s)
    while (b * s) % group != 0:  # largest group size dividing the token count
        group -= 1
    xg = constrain(x.reshape((b * s) // group, group, d), DATA, None, None)
    capacity = max(int(math.ceil(cfg.moe_top_k * group * cfg.moe_capacity_factor / e)), 1)

    if dispatch_mode == "gather":
        yg, aux = _moe_gather_dispatch(params, xg, cfg, capacity, layer)
    else:  # the reference runs the einsum path for any mode but "gather"
        with span("moe.route", layer=layer):
            logits = einsum("gsd,de->gse", xg, gathered(params.router))
            dispatch, combine, aux = route_topk(logits, cfg.moe_top_k, capacity)
            dispatch = constrain(dispatch.to(x.dtype), DATA, None, MODEL, None)
            combine = constrain(combine.to(x.dtype), DATA, None, MODEL, None)
        with span("moe.dispatch", layer=layer):
            expert_in = constrain(einsum("gsec,gsd->egcd", dispatch, xg),
                                  MODEL, DATA, None, None)
        with span("moe.experts", layer=layer):
            expert_out = constrain(_expert_ffn(params, expert_in), MODEL, DATA, None, None)
        # The combine contracts the expert dim, which a DTensor (torch 2.11)
        # cannot flatten sharded: on a mesh the experts whole first.
        with span("moe.combine", layer=layer):
            yg = einsum("gsec,egcd->gsd", constrain(combine, DATA, None, None, None),
                        constrain(expert_out, None, DATA, None, None))
    y = yg.reshape(b, s, d)
    if cfg.moe_shared > 0:
        with span("moe.shared", layer=layer):
            y = y + _swiglu(x, gathered(params.shared_wi), gathered(params.shared_wo))
    # aux replicated: on a mesh it is a pending mean over the groups, which
    # DTensor (torch 2.11) cannot add to the loss's pending sum.
    return constrain(y, DATA, None, None), constrain(aux)
