"""The moe family in plain float32: pre-norm attention blocks whose FFN is a
GShard mixture of experts (deepseek-moe), after ``moe_first_dense`` blocks
with a dense SwiGLU FFN.

Routing, per group of tokens: softmax of the router's logits over the E
experts, the top k by a stable descending sort (ties to the lower expert),
gates = the k probabilities over their sum; each expert takes at most
C = max(ceil(k * group * capacity_factor / E), 1) assignments, filled
slot-major (every token's first choice, in token order, before any second
choice); an assignment past C adds nothing. The shared experts run on every
token. Groups: a prompt pass of B rows of P positions routes its B * P
tokens, row-major, in groups of the largest size up to ``moe_group_size``
that divides B * P; each later position routes its B tokens (one per row)
as one group, as a decode step does.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from perfbench.reference.ops import (attention, attn_spec, attn_weights, head_spec, lm_logits,
                                     mlp_spec, rms, swiglu)


def param_spec(m: dict) -> dict:
    d, e, ffe = m["d_model"], m["moe_experts"], m["moe_d_ff"]
    spec = head_spec(m)
    for i in range(m["moe_first_dense"]):
        p = f"dense_layers.{i}"
        spec.update(attn_spec(f"{p}.attn", m, d))
        spec.update(mlp_spec(f"{p}.mlp", m, d))
        spec.update({f"{p}.norm1": ((d,), "ones"), f"{p}.norm2": ((d,), "ones")})
    for i in range(m["n_layers"] - m["moe_first_dense"]):
        p = f"layers.{i}"
        spec.update(attn_spec(f"{p}.attn", m, d))
        spec.update({f"{p}.moe.router": ((d, e), "normal"),
                     f"{p}.moe.moe_wi": ((e, d, 2 * ffe), "normal"),
                     f"{p}.moe.moe_wo": ((e, ffe, d), "normal")})
        if m["moe_shared"]:
            fsh = m["moe_shared"] * ffe
            spec.update({f"{p}.moe.shared_wi": ((d, 2 * fsh), "normal"),
                         f"{p}.moe.shared_wo": ((fsh, d), "normal")})
        spec.update({f"{p}.norm1": ((d,), "ones"), f"{p}.norm2": ((d,), "ones")})
    return spec


def _group_size(tokens: int, limit: int) -> int:
    g = min(limit, tokens)
    while tokens % g:
        g -= 1
    return g


def routing_groups(b: int, s: int, prompt: int, limit: int, device) -> List[torch.Tensor]:
    """Flat token indices (row * s + position) of each routing group, as
    (G, g) tensors: the prompt pass's groups, then one (1, b) per later
    position."""
    rows = torch.arange(b, device=device)[:, None] * s
    first = (rows + torch.arange(prompt, device=device)[None, :]).reshape(-1)
    g = _group_size(b * prompt, limit)
    groups = [first.reshape(-1, g)]
    for j in range(prompt, s):
        groups.append((rows[:, 0] + j)[None, :])
    return groups


def route(xg: torch.Tensor, router: torch.Tensor, m: dict, mm):
    """xg (G,g,d) -> (expert (G,g,k), gate (G,g,k), kept (G,g,k))."""
    e, k = m["moe_experts"], m["moe_top_k"]
    g = xg.shape[1]
    capacity = max(int(math.ceil(k * g * m["moe_capacity_factor"] / e)), 1)
    probs = torch.softmax(mm(xg, router), dim=-1)
    values, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, expert = values[..., :k], order[..., :k]
    gate = top / top.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    # Queue position of each (token, choice) in its expert: choices in
    # slot-major order (choice r of every token before choice r + 1).
    onehot = F.one_hot(expert, e).transpose(1, 2).reshape(xg.shape[0], k * g, e)
    before = torch.cumsum(onehot, dim=1) - onehot
    position = (before * onehot).sum(-1).reshape(xg.shape[0], k, g).transpose(1, 2)
    return expert, gate, position < capacity


def moe_ffn(x: torch.Tensor, w, p: str, m: dict, groups, mm) -> torch.Tensor:
    flat = x.reshape(-1, x.shape[-1])
    token, expert, gate = [], [], []
    for idx in groups:
        ex, gt, kept = route(flat[idx], w(f"{p}.router"), m, mm)
        token.append(idx[..., None].expand_as(ex)[kept])
        expert.append(ex[kept])
        gate.append(gt[kept])
    token, expert, gate = torch.cat(token), torch.cat(expert), torch.cat(gate)
    y = torch.zeros_like(flat)
    wi, wo = w(f"{p}.moe_wi"), w(f"{p}.moe_wo")
    for e in torch.unique(expert).tolist():
        sel = expert == e
        rows = token[sel]
        y.index_add_(0, rows, swiglu(flat[rows], wi[e], wo[e], mm) * gate[sel, None])
    if m["moe_shared"]:
        y = y + swiglu(flat, w(f"{p}.shared_wi"), w(f"{p}.shared_wo"), mm)
    return y.reshape(x.shape)


def hidden(m: dict, w, tokens: torch.Tensor, prompt: int, mm) -> torch.Tensor:
    """Final-normed hidden states (B,S,d) of tokens (B,S), whose first
    ``prompt`` positions are the prompt pass. ``w(name)`` gives a weight in
    float32."""
    b, s = tokens.shape
    eps = m["norm_eps"]
    x = w("embed")[tokens]
    groups = routing_groups(b, s, prompt, m["moe_group_size"], tokens.device)
    for i in range(m["moe_first_dense"]):
        p = f"dense_layers.{i}"
        x = x + attention(rms(x, w(f"{p}.norm1"), eps), attn_weights(w, f"{p}.attn"), m, mm)
        x = x + swiglu(rms(x, w(f"{p}.norm2"), eps), w(f"{p}.mlp.wi"), w(f"{p}.mlp.wo"), mm)
    for i in range(m["n_layers"] - m["moe_first_dense"]):
        p = f"layers.{i}"
        x = x + attention(rms(x, w(f"{p}.norm1"), eps), attn_weights(w, f"{p}.attn"), m, mm)
        x = x + moe_ffn(rms(x, w(f"{p}.norm2"), eps), w, f"{p}.moe", m, groups, mm)
    return rms(x, w("final_norm"), eps)


def serve_logits(m: dict, w, tokens: torch.Tensor, prompt: int, mm) -> torch.Tensor:
    """float32 logits (B, S - prompt + 1, vocab) at positions prompt - 1 ..
    S - 1: those from which the served tokens were chosen."""
    x = hidden(m, w, tokens, prompt, mm)[:, prompt - 1:]
    return lm_logits(x, w("lm_head") if not m.get("tie_embeddings") else w("embed").T, m, mm)
