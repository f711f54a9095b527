"""Plain PyTorch oracles in the layouts of ``repro.kernels.ref``, f32 math."""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (BH, S, D); k/v: (BH, T, D)."""
    s, d = q.shape[1], q.shape[2]
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None], scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bst,btd->bsd", probs, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, lengths):
    """q: (BK, G, D); k/v: (BK, T, D); lengths: (BK,)."""
    d = q.shape[2]
    t = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bgd,btd->bgt", q.float(), k.float()) * scale
    valid = torch.arange(t, device=q.device)[None, None, :] < lengths[:, None, None]
    scores = torch.where(valid, scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bgt,btd->bgd", probs, v.float()).to(q.dtype)


def ssd_intra_chunk_ref(xdt, cum, bm, cm):
    """xdt (B,NC,H,Q,P), cum (B,NC,H,Q), bm/cm (B,NC,Q,N)."""
    xdt, cum, bm, cm = xdt.float(), cum.float(), bm.float(), cm.float()
    q = xdt.shape[3]
    scores = torch.einsum("bcin,bcjn->bcij", cm, bm)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    diff = cum[..., :, None] - cum[..., None, :]  # (B,NC,H,Q,Q)
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    m = scores[:, :, None] * decay
    y = torch.einsum("bchij,bchjp->bchip", m, xdt)
    decay_to_end = torch.exp(cum[..., -1:] - cum)  # (B,NC,H,Q)
    states = torch.einsum("bcjn,bchj,bchjp->bchnp", bm, decay_to_end, xdt)
    return y, states


def rmsnorm_ref(x, w, eps=1e-5):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
