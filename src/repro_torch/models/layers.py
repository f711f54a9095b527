"""Shared model layers: norms, rotary embeddings, attention (naive / chunked
online-softmax / decode / kernel-backed flash), and gated MLPs.

Functions over tensors and parameter modules, in the layouts of
``repro.models.layers``: activations (B,S,d), q (B,S,H,D), k/v (B,T,K,D).
``RunConfig.attention_impl == "flash"`` routes the norm and both attention
paths through the kernels of ``repro_torch.kernels.ops``; ``chunked`` and
``naive`` are eager mirrors of the reference. Activation sharding goes
through ``repro_torch.distributed.constrain`` at the reference's points; it
returns its input when no mesh is set.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import constrain, current_mesh
from repro_torch.distributed.sharding import einsum, gathered, write_positions
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import softmax_scale

DATA = ("pod", "data")  # batch axes (sanitized away when the mesh lacks "pod")
MODEL = "model"
IMPLS = ("flash", "chunked", "naive")
INIT_STD = 0.02


class ParamGroup(nn.Module):
    """A group of named weights: N(0, INIT_STD) from ``generator``, or ones
    (names in ``ones``) or zeros (names in ``zeros``)."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], *, ones=(), zeros=(),
                 generator: torch.Generator, device, dtype):
        super().__init__()
        for name, shape in shapes.items():
            if name in ones:
                w = torch.ones(shape, device=device, dtype=dtype)
            elif name in zeros:
                w = torch.zeros(shape, device=device, dtype=dtype)
            else:
                w = torch.randn(shape, generator=generator, device=device,
                                dtype=dtype) * INIT_STD
            setattr(self, name, nn.Parameter(w, requires_grad=False))


def uses_kernels(run) -> bool:
    """Whether a run config routes through the kernel-backed ops."""
    if run.attention_impl not in IMPLS:
        raise ValueError(f"attention_impl must be one of {IMPLS}, "
                         f"got {run.attention_impl!r}")
    return run.attention_impl == "flash"


# ---------------------------------------------------------------------------
# Norms / positions
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5, *,
             kernel: bool = False) -> torch.Tensor:
    """RMSNorm in f32, cast back to x's dtype; ``kernel`` routes it through
    ``ops.fused_rmsnorm``. On a mesh the scale is gathered whole first
    (FSDP shards it over the data axes), as the kernel reduces over it."""
    scale = constrain(scale, None)
    if kernel:
        return ops.fused_rmsnorm(x, scale, eps=eps)
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def gather_sequence(x: torch.Tensor) -> torch.Tensor:
    """x (B,S,...) with its sequence whole on every rank and its batch over
    the data axes: sequence parallelism's all-gather before a block's
    matmuls (Megatron-SP), which XLA inserts for the reference. A DTensor
    flattens (B,S) into rows only where S is not sharded."""
    return constrain(x, DATA, *([None] * (x.ndim - 1)))


def split_heads(y: torch.Tensor, n: int, d: int, kv_heads: int) -> torch.Tensor:
    """(B,T,n*d) -> (B,T,n,d) under the reference's (data, -, model, -)
    constraint. On a mesh the heads stay sharded over the model axis only
    where it divides ``kv_heads`` too, so that each rank holds the key and
    value heads of its query heads, as the attention kernels need; else the
    product is gathered over it first (a DTensor does not split a sharded
    dim into pieces the mesh does not divide), and the heads stay whole."""
    ctx = current_mesh()
    heads = MODEL
    if ctx is not None and kv_heads % ctx.model_size:
        y, heads = constrain(y, DATA, None, None), None
    return constrain(y.reshape(*y.shape[:2], n, d), DATA, None, heads, None)


def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None, start: int = 0) -> torch.Tensor:
    """(length, dim) f32 table of positions p = start .. start + length - 1:
    sin(p * f_i) in column 2i and cos(p * f_i) in column 2i + 1, with
    f_i = exp(-2i ln(1e4) / dim)."""
    pos = torch.arange(start, start + length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(1e4) / dim))
    table = torch.zeros((length, dim), dtype=torch.float32, device=device)
    table[:, 0::2] = torch.sin(pos * div)
    table[:, 1::2] = torch.cos(pos * div)
    return table


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _group_query(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,D) -> (B,S,K,G,D)."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def naive_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0, softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Materializes the full (S, T) score matrix.

    q: (B,S,H,D); k/v: (B,T,K,D). Returns (B,S,H,D). The scores are
    ``scale * q.k`` (None: ``1 / sqrt(D)``). Products of the
    storage-dtype operands are summed in f32, and the probabilities are cast
    to v's dtype before the PV product, as in the reference.
    """
    b, s, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    qg = _group_query(q, n_kv)
    scale = softmax_scale(d, scale)
    scores = einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(s, device=q.device) + q_offset
    kpos = torch.arange(t, device=q.device)
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def chunked_attention(q, k, v, chunk: int = 512, causal: bool = True,
                      window: int = 0, q_offset: int = 0,
                      softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (flash-style, eager).

    Falls to :func:`naive_attention` when T is not a multiple of ``chunk``,
    as the reference does.
    """
    b, s, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    if t % chunk != 0:
        return naive_attention(q, k, v, causal, window, q_offset, softcap, scale)
    qg = _group_query(q, n_kv).float()
    scale = softmax_scale(d, scale)
    qpos = (torch.arange(s, device=q.device) + q_offset)[:, None]  # (S,1)
    n_g = h // n_kv
    m = torch.full((b, n_kv, n_g, s), -1e30, device=q.device)
    l = torch.zeros((b, n_kv, n_g, s), device=q.device)
    acc = torch.zeros((b, n_kv, n_g, s, d), device=q.device)
    for j in range(t // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk]
        vj = v[:, j * chunk:(j + 1) * chunk]
        scores = einsum("bskgd,btkd->bkgst", qg, kj.float()) * scale
        if softcap > 0:
            scores = softcap * torch.tanh(scores / softcap)
        kpos = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        bias = torch.zeros((s, chunk), device=q.device)
        if causal:
            bias = bias.masked_fill(kpos > qpos, -1e30)
        if window > 0:
            bias = bias.masked_fill(kpos <= qpos - window, -1e30)
        scores = scores + bias
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = einsum("bkgst,btkd->bkgsd", p.to(vj.dtype).float(), vj.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4)  # (b,s,k,g,d)
    return out.reshape(b, s, h, d).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, window: int = 0,
                     softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
    """Single-position attention against a (B,T,K,D) cache.

    q: (B,1,H,D); lengths: (B,) number of valid cache positions (inclusive of
    the current token). On a mesh the query's heads are gathered first, so
    that the scores keep the cache's sharding of T (a DTensor cannot
    flatten heads and batch both sharded into one product batch).
    """
    b, _, h, d = q.shape
    t, n_kv = k_cache.shape[1], k_cache.shape[2]
    q = constrain(q, DATA, None, None, None)
    qg = _group_query(q, n_kv)[:, 0].to(k_cache.dtype)  # (B,K,G,D)
    scale = softmax_scale(d, scale)
    scores = einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * scale
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    kpos = torch.arange(t, device=q.device)[None, :]  # (1,T)
    valid = kpos < lengths[:, None]
    if window > 0:
        valid &= kpos >= torch.clamp(lengths[:, None] - window, min=0)
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = einsum("bkgt,btkd->bkgd", probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projection + rope wrapper)
# ---------------------------------------------------------------------------


def attention_block(
    params,
    x: torch.Tensor,
    cfg,
    run,
    positions: torch.Tensor,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_pos: Optional[Union[int, torch.Tensor]] = None,
    causal: bool = True,
    cache_fill: Optional[int] = None,
    kv_x: Optional[torch.Tensor] = None,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (output, new_kv); ``params`` holds wq, wk, wv, wo (and
    q_norm, k_norm under ``cfg.qk_norm``).

    * prefill: ``new_kv`` is this segment's (K, V), rope'd under
      ``use_rope``.
    * decode (``kv_cache`` and ``cache_pos`` given): the new token's K/V is
      written into the cache in place (the reference returns an updated
      copy) and ``new_kv`` is the cache. The write starts at ``cache_pos``,
      clamped to ``T - S`` as the reference's ``dynamic_update_slice``
      clamps it, so a position past the cache overwrites its last slot. The
      first ``cache_fill`` slots are attended when it is given (a ring
      buffer, whose live slots all lie in the window, so the window mask is
      off), else the first ``cache_pos + S`` under ``cfg.window``. A
      ``cache_pos`` that is a 0-d int64 tensor on the cache's device is
      written and attended alike, by ``index_copy_`` and lengths computed
      on the device (no ``cache_fill``, no sharded cache).
    * ``kv_x`` (B,F,d) selects cross-attention: K/V are projected from it,
      with no rope, and S need not equal F.

    The scores are scaled by ``cfg.attn_scale`` (0: ``1 / sqrt(d_head)``).
    """
    b, s, _ = x.shape
    h, k_heads, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kernel = uses_kernels(run)
    scale = getattr(cfg, "attn_scale", 0.0) or None
    x = gather_sequence(x)
    kv_src = x if kv_x is None else gather_sequence(kv_x)
    t = kv_src.shape[1]

    q = split_heads(x @ gathered(params.wq), h, d, k_heads)
    kk = split_heads(kv_src @ gathered(params.wk), k_heads, d, k_heads)
    vv = split_heads(kv_src @ gathered(params.wv), k_heads, d, k_heads)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm, cfg.norm_eps, kernel=kernel)
        kk = rms_norm(kk, params.k_norm, cfg.norm_eps, kernel=kernel)
    if use_rope and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        kk = apply_rope(kk, positions, cfg.rope_theta)

    if kv_cache is not None:
        k_cache, v_cache = kv_cache
        if torch.is_tensor(cache_pos):  # on the device: nothing read on the host
            at = (torch.clamp(cache_pos, 0, k_cache.shape[1] - s)
                  + torch.arange(s, device=cache_pos.device))
            k_cache.index_copy_(1, at, kk.to(k_cache.dtype))
            v_cache.index_copy_(1, at, vv.to(v_cache.dtype))
            lengths = (cache_pos + s).to(torch.int32).repeat(b)
        else:
            slot = max(0, min(cache_pos, k_cache.shape[1] - s))
            write_positions(k_cache, slot, kk)
            write_positions(v_cache, slot, vv)
            fill = cache_fill if cache_fill is not None else cache_pos + s
            lengths = torch.full((b,), fill, dtype=torch.int32, device=x.device)
        win = 0 if cache_fill is not None else cfg.window
        attend = ops.flash_decode if kernel else decode_attention
        out = attend(q, k_cache, v_cache, lengths, window=win,
                     softcap=cfg.attn_logit_softcap, scale=scale)
        new_kv = (k_cache, v_cache)
    else:
        if kernel:
            out = ops.flash_attention(q, kk, vv, causal=causal, window=cfg.window,
                                      softcap=cfg.attn_logit_softcap, scale=scale)
        elif run.attention_impl == "naive":
            out = naive_attention(q, kk, vv, causal=causal, window=cfg.window,
                                  softcap=cfg.attn_logit_softcap, scale=scale)
        else:
            out = chunked_attention(q, kk, vv, chunk=run.attention_chunk,
                                    causal=causal, window=cfg.window,
                                    softcap=cfg.attn_logit_softcap, scale=scale)
        new_kv = (kk, vv)
    out = constrain(out, DATA, None, MODEL, None)
    # The merged heads pinned to the row-parallel layout wo's product
    # takes, so that its gradient reaches the reshape in out's layout.
    out = constrain(out.reshape(b, s, h * d), DATA, None, MODEL)
    y = out @ gathered(params.wo)
    return constrain(y, DATA, None, None), new_kv


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_block(params, x: torch.Tensor, act: str,
              adapter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``params`` holds wi (d, 2*ff for swiglu and geglu, split [gate, up])
    and wo. geglu is ``gelu(gate) * up`` with the exact (erf) GELU;
    ``adapter`` (A (d, r), B (r, 2*ff)), a low-rank term of the gated
    product, adds ``(x @ A) @ B`` to ``x @ wi`` in place (Zamba2's
    per-invocation MLP adapter; no third (B,S,2*ff) tensor)."""
    x = gather_sequence(x)
    if act in ("swiglu", "geglu"):
        gu = x @ gathered(params.wi)
        if adapter is not None:  # accumulated into gu by the product itself
            low = x @ adapter[0]
            gu.view(-1, gu.shape[-1]).addmm_(low.view(-1, low.shape[-1]), adapter[1])
        gate, up = constrain(gu, DATA, None, MODEL).chunk(2, dim=-1)
        hidden = (F.silu(gate) if act == "swiglu" else F.gelu(gate)) * up
    else:
        hidden = F.gelu(x @ gathered(params.wi), approximate="tanh")  # jax.nn.gelu
        hidden = constrain(hidden, DATA, None, MODEL)
    return constrain(hidden @ gathered(params.wo), DATA, None, None)
