"""The dense decoder (pre-norm GQA transformer: yi, tinyllama, starcoder2,
qwen3) as an ``nn.Module`` with one submodule per layer, and the functions
that drive it: ``forward_hidden``, ``init_cache``, ``prefill`` and
``decode_step``, with the signatures of ``repro.models.transformer``.

Weights keep the reference's layouts ((d_in, d_out) matrices, used as
``x @ w``), so converted reference weights drop in unchanged. The other
families (moe, ssm, hybrid, audio, vlm) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.layers import attention_block, mlp_block, rms_norm, uses_kernels

Cache = Dict[str, Any]
INIT_STD = 0.02


def _dtype(cfg: ModelConfig, dtype: Optional[torch.dtype] = None) -> torch.dtype:
    return dtype or getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: only the "
            f"dense family is (ROADMAP A8 ports the other families)")


class _Params(nn.Module):
    """A group of named weights, each N(0, INIT_STD) or ones."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], *, ones=(),
                 generator: torch.Generator, device, dtype):
        super().__init__()
        for name, shape in shapes.items():
            if name in ones:
                w = torch.ones(shape, device=device, dtype=dtype)
            else:
                w = torch.randn(shape, generator=generator, device=device,
                                dtype=dtype) * INIT_STD
            setattr(self, name, nn.Parameter(w, requires_grad=False))


class DenseBlock(nn.Module):
    """One pre-norm block: attn (wq, wk, wv, wo), mlp (wi, wo), norm1, norm2."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
        attn = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d)}
        if cfg.qk_norm:
            attn.update(q_norm=(cfg.d_head,), k_norm=(cfg.d_head,))
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.attn = _Params(attn, ones=("q_norm", "k_norm"), **kw)
        width = 2 * cfg.d_ff if cfg.act == "swiglu" else cfg.d_ff
        self.mlp = _Params({"wi": (d, width), "wo": (cfg.d_ff, d)}, **kw)
        self.norm1 = nn.Parameter(torch.ones(d, device=device, dtype=dtype),
                                  requires_grad=False)
        self.norm2 = nn.Parameter(torch.ones(d, device=device, dtype=dtype),
                                  requires_grad=False)


class Transformer(nn.Module):
    """Dense decoder weights: embed, layers, final_norm and lm_head (absent
    when ``cfg.tie_embeddings``). Initialized N(0, 0.02) from ``generator``
    (seed 0 on ``device`` when None), norms at one."""

    def __init__(self, cfg: ModelConfig, *, device: Device = None,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_family(cfg)
        dev = resolve_device(device)
        dt = _dtype(cfg, dtype)
        if generator is None and dev.type != "meta":  # meta: shapes only
            generator = torch.Generator(device=dev).manual_seed(0)
        kw = dict(generator=generator, device=dev, dtype=dt)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.padded_vocab
        self.embed = nn.Parameter(
            torch.randn((v, d), **kw) * INIT_STD, requires_grad=False)
        self.final_norm = nn.Parameter(torch.ones(d, device=dev, dtype=dt),
                                       requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.randn((d, v), **kw) * INIT_STD, requires_grad=False)
        self.layers = nn.ModuleList(DenseBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
                device: Device = None,
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """Random weights, the counterpart of ``repro.models.init_params``."""
    return Transformer(cfg, device=device, dtype=dtype, generator=generator)


# ---------------------------------------------------------------------------
# Blocks / embedding / head
# ---------------------------------------------------------------------------


def dense_block(lp: DenseBlock, x, cfg, run, positions, kv_cache=None,
                cache_pos=None):
    """One pre-norm transformer block."""
    kernel = uses_kernels(run)
    h, kv = attention_block(lp.attn, rms_norm(x, lp.norm1, cfg.norm_eps, kernel=kernel),
                            cfg, run, positions, kv_cache=kv_cache,
                            cache_pos=cache_pos)
    x = x + h
    h = mlp_block(lp.mlp, rms_norm(x, lp.norm2, cfg.norm_eps, kernel=kernel), cfg.act)
    return x + h, kv


def embed_tokens(params: Transformer, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens]


def lm_logits(params: Transformer, cfg, x: torch.Tensor) -> torch.Tensor:
    """f32 logits over the padded vocabulary; padding columns are -1e30."""
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x.float() @ head.float()
    if cfg.padded_vocab != cfg.vocab:  # mask vocabulary padding
        logits[..., cfg.vocab:] = -1e30
    return logits


# ---------------------------------------------------------------------------
# Forward / serving
# ---------------------------------------------------------------------------


def forward_hidden(params: Transformer, cfg: ModelConfig, run: RunConfig,
                   tokens: torch.Tensor,
                   collect_kv: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Token embeddings through the stack.

    Returns (hidden (B,S,d), extras); ``extras["kv"]`` lists each layer's
    rope'd (K, V), (B,S,K,D) each, when ``collect_kv``.
    """
    extras: Dict[str, Any] = {}
    x = embed_tokens(params, cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    kvs = []
    for lp in params.layers:
        x, kv = dense_block(lp, x, cfg, run, positions)
        if collect_kv:
            kvs.append(kv)
    if collect_kv:
        extras["kv"] = kvs
    x = rms_norm(x, params.final_norm, cfg.norm_eps, kernel=uses_kernels(run))
    return x, extras


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Device = None, dtype: Optional[torch.dtype] = None) -> Cache:
    """Zeroed KV cache: k/v (L, B, max_len, K, D) and ``pos`` (a Python int,
    the number of positions filled; every row shares it)."""
    _check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, device=dev, dtype=_dtype(cfg, dtype)),
            "v": torch.zeros(shape, device=dev, dtype=_dtype(cfg, dtype)),
            "pos": 0}


def prefill(params: Transformer, cfg: ModelConfig, run: RunConfig,
            tokens: torch.Tensor, max_len: Optional[int] = None):
    """Full-sequence forward that also returns the populated KV cache.

    The cache holds ``max(max_len, S)`` positions, so decoding can follow
    without growing it; the logits are those of the last position (B,1,V).
    """
    hidden, extras = forward_hidden(params, cfg, run, tokens, collect_kv=True)
    logits_last = lm_logits(params, cfg, hidden[:, -1:])
    b, s = tokens.shape
    cache = init_cache(cfg, b, max(max_len or s, s), device=tokens.device,
                       dtype=params.embed.dtype)
    for i, (k, v) in enumerate(extras["kv"]):
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["pos"] = s
    return logits_last, cache


def decode_step(params: Transformer, cfg: ModelConfig, run: RunConfig,
                cache: Cache, tokens: torch.Tensor):
    """One decode step: tokens (B,1) + cache -> (logits (B,1,V), new cache).

    The new token's K/V is written into the cache tensors in place, so the
    returned cache shares them with the one passed in; only ``pos`` differs.
    """
    pos = cache["pos"]
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"KV cache of {cache['k'].shape[2]} positions is full")
    b = tokens.shape[0]
    x = embed_tokens(params, cfg, tokens)
    positions = torch.full((b, 1), pos, device=x.device)
    for i, lp in enumerate(params.layers):
        x, _ = dense_block(lp, x, cfg, run, positions,
                           kv_cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
    x = rms_norm(x, params.final_norm, cfg.norm_eps, kernel=uses_kernels(run))
    logits = lm_logits(params, cfg, x)
    return logits, dict(cache, pos=pos + 1)
