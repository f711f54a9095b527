"""The decoder families as ``nn.Module``s with one submodule per layer, and
the functions that drive them: ``forward_hidden``, ``forward_train``,
``init_cache``, ``prefill`` and ``decode_step``, with the signatures of
``repro.models.transformer``. Families:

  dense   pre-norm GQA transformer (yi, tinyllama, starcoder2, qwen3)
  moe     dense attention + GShard MoE FFN (deepseek-moe, phi3.5-moe),
          optional leading dense-FFN layers (DeepSeek layer 0)
  ssm     Mamba-2 SSD stack (mamba2-130m)
  hybrid  Mamba-2 backbone + one shared attention block every k layers
          (zamba2), on concat(x, embed0) as in Zamba; with
          ``hybrid_layer_ids`` the published Zamba2 layout instead (a
          Mamba-2 layer each, the listed ones first running one of
          ``hybrid_blocks`` shared blocks, whose output enters the Mamba
          layer's input through a linear of the layer's own)
  audio   Whisper-style encoder/decoder over stub frame embeddings, with
          sinusoidal positions and no rope
  vlm     dense backbone with stub patch embeddings prepended (phi3-vision)

Weights keep the reference's layouts ((d_in, d_out) matrices, used as
``x @ w``), so converted reference weights drop in unchanged. Parameters
are built with ``requires_grad=False``, for serving;
``repro_torch.train.init_train_state`` switches them on. Every family
serves and trains (``forward_train``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import MeshContext, constrain, current_mesh, set_mesh_context
from repro_torch.distributed.sharding import (cache_shardings, empty_sharded, gathered,
                                              is_distributed, on_mesh, write_positions)
from repro_torch.kernels import ops
from repro_torch.models.layers import (DATA, INIT_STD, MODEL, ParamGroup, attention_block,
                                       decode_attention, gather_sequence, mlp_block, rms_norm,
                                       sinusoidal_positions, split_heads, uses_kernels)
from repro_torch.models.mamba2 import MambaBlock, mamba_block
from repro_torch.models.moe import MoE, moe_block
from repro_torch.tracing import span

Cache = Dict[str, Any]
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _dtype(cfg: ModelConfig, dtype: Optional[torch.dtype] = None) -> torch.dtype:
    return dtype or getattr(torch, cfg.dtype)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")


def _n_groups(cfg: ModelConfig) -> int:
    """Shared-attention invocations of a hybrid stack."""
    return cfg.n_layers // cfg.hybrid_attn_every


def _attn_shapes(cfg: ModelConfig, d_in: int):
    hq, hkv = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    shapes = {"wq": (d_in, hq), "wk": (d_in, hkv), "wv": (d_in, hkv),
              "wo": (hq, cfg.d_model)}
    if cfg.qk_norm:
        shapes.update(q_norm=(cfg.d_head,), k_norm=(cfg.d_head,))
    return shapes


def _mlp_shapes(cfg: ModelConfig, d_in: int):
    width = 2 * cfg.d_ff if cfg.act in ("swiglu", "geglu") else cfg.d_ff
    return {"wi": (d_in, width), "wo": (cfg.d_ff, cfg.d_model)}


def _ones(n: int, kw) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, device=kw["device"], dtype=kw["dtype"]),
                        requires_grad=False)


class DenseBlock(nn.Module):
    """One pre-norm block: attn (wq, wk, wv, wo), mlp (wi, wo), norm1, norm2;
    with ``cross`` (an audio decoder layer) also cross (cross_wq, cross_wk,
    cross_wv, cross_wo) and norm3."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype, cross: bool = False):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.attn = ParamGroup(_attn_shapes(cfg, cfg.d_model),
                               ones=("q_norm", "k_norm"), **kw)
        self.mlp = ParamGroup(_mlp_shapes(cfg, cfg.d_model), **kw)
        self.norm1 = _ones(cfg.d_model, kw)
        self.norm2 = _ones(cfg.d_model, kw)
        if cross:
            shapes = _attn_shapes(cfg, cfg.d_model)
            self.cross = ParamGroup({f"cross_{k}": shapes[k] for k in ("wq", "wk", "wv", "wo")},
                                    **kw)
            self.norm3 = _ones(cfg.d_model, kw)


class MambaLayer(nn.Module):
    """One pre-norm Mamba-2 layer: mamba (``MambaBlock``) and norm1."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.mamba = MambaBlock(cfg, **kw)
        self.norm1 = _ones(cfg.d_model, kw)


class HybridLayer(MambaLayer):
    """A Mamba-2 layer of the published Zamba2 layout that first runs a
    shared block: mamba, norm1, and its own linear (d, d), through which the
    block's output enters the Mamba input, and the rank-r adapter of the
    block's MLP at this invocation, adapter_in (d, r) and adapter_out
    (r, 2 * d_ff)."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__(cfg, generator=generator, device=device, dtype=dtype)
        d, r = cfg.d_model, cfg.adapter_rank
        for name, shape in (("linear", (d, d)), ("adapter_in", (d, r)),
                            ("adapter_out", (r, 2 * cfg.d_ff))):
            setattr(self, name, nn.Parameter(
                torch.randn(shape, generator=generator, device=device, dtype=dtype) * INIT_STD,
                requires_grad=False))


class SharedBlock(nn.Module):
    """A shared block of the published Zamba2 layout: attn (wq, wk, wv on
    2 * d_model inputs, wo), mlp (wi (d, 2 * d_ff), wo), norm1 (2 * d_model)
    and norm2 (d_model)."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.attn = ParamGroup(_attn_shapes(cfg, 2 * cfg.d_model), **kw)
        self.mlp = ParamGroup(_mlp_shapes(cfg, cfg.d_model), **kw)
        self.norm1 = _ones(2 * cfg.d_model, kw)
        self.norm2 = _ones(cfg.d_model, kw)


class MoELayer(nn.Module):
    """One pre-norm MoE layer: attn (wq, wk, wv, wo), moe (``MoE``), norm1,
    norm2."""

    def __init__(self, cfg: ModelConfig, *, generator, device, dtype):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.attn = ParamGroup(_attn_shapes(cfg, cfg.d_model),
                               ones=("q_norm", "k_norm"), **kw)
        self.moe = MoE(cfg, **kw)
        self.norm1 = _ones(cfg.d_model, kw)
        self.norm2 = _ones(cfg.d_model, kw)


class Transformer(nn.Module):
    """Decoder weights: embed, layers, final_norm and lm_head (absent when
    ``cfg.tie_embeddings``); for the hybrid family also the shared block
    (shared_attn and shared_mlp on 2*d_model inputs, shared_norm1/2) and
    inv_proj (G, d, d), one per invocation. ``layers`` holds a
    ``DenseBlock`` per layer (dense, vlm; audio, each with cross-attention,
    after the ``n_encoder_layers`` ``DenseBlock``s of ``enc_layers``, which
    ``enc_final_norm`` follows), a ``MambaLayer`` per layer (ssm;
    hybrid, group g's layer e at index g * every + e) or a ``MoELayer`` per
    MoE layer (moe, after the ``moe_first_dense`` ``DenseBlock``s of
    ``dense_layers``); the published hybrid layout holds a ``MambaLayer``
    per layer, a ``HybridLayer`` at each of ``hybrid_layer_ids``, and its
    ``SharedBlock``s in ``blocks``. Initialized N(0, 0.02)
    from ``generator`` (seed 0 on ``device`` when None), norms and the SSM's
    D at one, A_log and dt_bias at zero."""

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
        self.final_norm = _ones(d, kw)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.randn((d, v), **kw) * INIT_STD, requires_grad=False)
        if cfg.family in ("dense", "vlm"):
            self.layers = nn.ModuleList(DenseBlock(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "audio":
            self.enc_layers = nn.ModuleList(DenseBlock(cfg, **kw)
                                            for _ in range(cfg.n_encoder_layers))
            self.layers = nn.ModuleList(DenseBlock(cfg, cross=True, **kw)
                                        for _ in range(cfg.n_layers))
            self.enc_final_norm = _ones(d, kw)
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(MambaLayer(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "moe":
            self.dense_layers = nn.ModuleList(DenseBlock(cfg, **kw)
                                              for _ in range(cfg.moe_first_dense))
            self.layers = nn.ModuleList(MoELayer(cfg, **kw) for _ in
                                        range(cfg.n_layers - cfg.moe_first_dense))
        elif cfg.published_hybrid:
            ids = set(cfg.hybrid_layer_ids)
            self.layers = nn.ModuleList((HybridLayer if i in ids else MambaLayer)(cfg, **kw)
                                        for i in range(cfg.n_layers))
            self.blocks = nn.ModuleList(SharedBlock(cfg, **kw)
                                        for _ in range(cfg.hybrid_blocks))
        else:  # hybrid
            groups = _n_groups(cfg)
            self.layers = nn.ModuleList(MambaLayer(cfg, **kw) for _ in
                                        range(groups * cfg.hybrid_attn_every))
            self.shared_attn = ParamGroup(_attn_shapes(cfg, 2 * d),
                                          ones=("q_norm", "k_norm"), **kw)
            self.shared_mlp = ParamGroup(_mlp_shapes(cfg, 2 * d), **kw)
            self.shared_norm1 = _ones(2 * d, kw)
            self.shared_norm2 = _ones(2 * d, kw)
            self.inv_proj = nn.Parameter(
                torch.randn((groups, d, d), **kw) * INIT_STD, requires_grad=False)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
                device: Device = None,
                dtype: Optional[torch.dtype] = None) -> Transformer:
    """Random weights, the counterpart of ``repro.models.init_params``."""
    return Transformer(cfg, device=device, dtype=dtype, generator=generator)


# ---------------------------------------------------------------------------
# Blocks / embedding / head
# ---------------------------------------------------------------------------


def _cross_params(lp: DenseBlock) -> SimpleNamespace:
    """An audio decoder layer's cross-attention weights under the names
    ``attention_block`` reads."""
    c = lp.cross
    return SimpleNamespace(wq=c.cross_wq, wk=c.cross_wk, wv=c.cross_wv, wo=c.cross_wo)


def _seq_constrain(x, run: RunConfig):
    """Sequence-parallel residual stream under ``run.seq_shard`` (the
    reference's Megatron-SP), else batch over the data axes."""
    if run.seq_shard:
        return constrain(x, DATA, MODEL, None)
    return constrain(x, DATA, None, None)


def _residual(x, h, run: RunConfig):
    """x + h in the residual stream's layout, h brought to it first (under
    ``run.seq_shard``, sequence parallelism's reduce-scatter): on a mesh
    the add's gradient then reaches h's producer in h's own layout."""
    return _seq_constrain(x + _seq_constrain(h, run), run)


def dense_block(lp: DenseBlock, x, cfg, run, positions, kv_cache=None,
                cache_pos=None, causal=True, use_rope=True, enc_out=None, layer=None):
    """One pre-norm transformer block (+ cross-attention on ``enc_out``, the
    encoder's output, non-causal and without rope, after norm3); ``layer``,
    its index, labels its ``attn`` and ``mlp`` spans."""
    kernel = uses_kernels(run)
    with span("attn", layer=layer):
        h, kv = attention_block(lp.attn, rms_norm(x, lp.norm1, cfg.norm_eps, kernel=kernel),
                                cfg, run, positions, kv_cache=kv_cache,
                                cache_pos=cache_pos, causal=causal, use_rope=use_rope)
    x = _residual(x, h, run)
    if enc_out is not None:
        h, _ = attention_block(_cross_params(lp),
                               rms_norm(x, lp.norm3, cfg.norm_eps, kernel=kernel),
                               cfg, run, positions, kv_x=enc_out, causal=False,
                               use_rope=False)
        x = _residual(x, h, run)
    with span("mlp", layer=layer):
        h = mlp_block(lp.mlp, rms_norm(x, lp.norm2, cfg.norm_eps, kernel=kernel), cfg.act)
    return _residual(x, h, run), kv


def moe_layer_block(lp: MoELayer, x, cfg, run, positions, kv_cache=None,
                    cache_pos=None, layer=None):
    """One pre-norm MoE layer: (x + attn + moe, kv, aux); ``layer``, its
    index, labels its ``attn`` and ``moe.*`` spans."""
    kernel = uses_kernels(run)
    with span("attn", layer=layer):
        h, kv = attention_block(lp.attn, rms_norm(x, lp.norm1, cfg.norm_eps, kernel=kernel),
                                cfg, run, positions, kv_cache=kv_cache, cache_pos=cache_pos)
    x = _residual(x, h, run)
    h, aux = moe_block(lp.moe, rms_norm(x, lp.norm2, cfg.norm_eps, kernel=kernel), cfg,
                       dispatch_mode=run.moe_dispatch, layer=layer)
    return _residual(x, h, run), kv, aux


def mamba_layer(lp: MambaLayer, x, cfg, run, ssm_state=None, conv_state=None,
                single_step: bool = False, shared=None, layer=None):
    """One pre-norm Mamba-2 layer: (x + mamba(norm1(x)), ssm, conv), or with
    ``shared`` (a shared block's output through the layer's linear, the
    published hybrid layout) (x + mamba(norm1(x + shared)), ssm, conv).
    Recorded as the ``mamba`` span, with ``layer``."""
    kernel = uses_kernels(run)
    with span("mamba", layer=layer):
        h = x if shared is None else x + shared
        y, ssm, conv = mamba_block(lp.mamba, rms_norm(h, lp.norm1, cfg.norm_eps, kernel=kernel),
                                   cfg, kernel=kernel, ssm_state=ssm_state,
                                   conv_state=conv_state, single_step=single_step,
                                   chunk_shard=run.ssd_chunk_shard, layer=layer)
    return _residual(x, y, run), ssm, conv


def shared_block(params: Transformer, lp: HybridLayer, x, x0, cfg, run, positions,
                 invocation: int, layer: int, kv_cache=None, cache_pos=None):
    """The published Zamba2 layout's shared block at its ``invocation``-th
    use (block ``invocation % hybrid_blocks``), before Mamba layer
    ``layer``: a = attn(norm1(concat(x, x0))), then the gated MLP on
    norm2(a) with the layer's adapter, through the layer's linear. Returns
    (that output, (K, V)); recorded as the ``shared`` span, with the block,
    the invocation and the layer."""
    kernel = uses_kernels(run)
    b = invocation % cfg.hybrid_blocks
    blk = params.blocks[b]
    with span("shared", block=b, invocation=invocation, layer=layer):
        xin = torch.cat([x, x0], dim=-1)
        a, kv = attention_block(blk.attn, rms_norm(xin, blk.norm1, cfg.norm_eps, kernel=kernel),
                                cfg, run, positions, kv_cache=kv_cache, cache_pos=cache_pos)
        m = mlp_block(blk.mlp, rms_norm(a, blk.norm2, cfg.norm_eps, kernel=kernel), cfg.act,
                      adapter=(gathered(lp.adapter_in), gathered(lp.adapter_out)))
        return m @ gathered(lp.linear), kv


def _invocations(cfg: ModelConfig) -> Dict[int, int]:
    """Layer index -> its shared block's invocation (published hybrid)."""
    return {layer: j for j, layer in enumerate(cfg.hybrid_layer_ids)}


def _plain_only(cfg: ModelConfig, params: Transformer, what: str) -> None:
    """The published hybrid layout serves on a plain cache only: it has no
    training forward and no mesh path yet."""
    if cfg.published_hybrid and (what == "training" or is_distributed(params.embed)):
        raise NotImplementedError(f"the published hybrid layout has no {what} path "
                                  f"(it serves on one device)")


def hybrid_shared_block(params: Transformer, x, x0, inv_proj, cfg, run, positions,
                        kv_cache=None, cache_pos=None, cache_fill=None):
    """Zamba2 shared attention block on concat(x, embed0)."""
    kernel = uses_kernels(run)
    xin = torch.cat([x, x0], dim=-1)
    h, kv = attention_block(params.shared_attn,
                            rms_norm(xin, params.shared_norm1, cfg.norm_eps, kernel=kernel),
                            cfg, run, positions, kv_cache=kv_cache,
                            cache_pos=cache_pos, cache_fill=cache_fill)
    m = mlp_block(params.shared_mlp,
                  rms_norm(xin, params.shared_norm2, cfg.norm_eps, kernel=kernel), cfg.act)
    return _residual(x, (h + m) @ gathered(inv_proj), run), kv


def embed_tokens(params: Transformer, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``embed`` (the reference's ``embed[tokens]``). On a mesh
    the table is gathered whole first and looked up by ``F.embedding``:
    DTensor's rules for a sharded table's lookup and for indexing with
    sharded tokens fail (a mask of the local tokens' shape; a Shard(-1) in
    torch 2.11's ``index_put``)."""
    return constrain(F.embedding(tokens, constrain(params.embed, None, None)), DATA, None, None)


def lm_logits(params: Transformer, cfg, x: torch.Tensor) -> torch.Tensor:
    """f32 logits over the padded vocabulary; padding columns are -1e30.
    Recorded as the ``head`` span."""
    with span("head"):
        head = params.embed.T if cfg.tie_embeddings else gathered(params.lm_head)
        logits = constrain(gather_sequence(x).float() @ head.float(), DATA, None, MODEL)
        if cfg.padded_vocab != cfg.vocab:  # mask vocabulary padding
            if is_distributed(logits):  # a DTensor's sharded vocabulary cannot be sliced
                cols = torch.arange(cfg.padded_vocab, device=logits.device)
                return torch.where(cols < cfg.vocab, logits, -1e30)
            logits[..., cfg.vocab:] = -1e30
        return logits


# ---------------------------------------------------------------------------
# Forward / serving
# ---------------------------------------------------------------------------


# The matmuls whose outputs "dots" keeps, as ``jax.checkpoint_policies.
# dots_saveable`` keeps every dot's.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    cp = torch.utils.checkpoint.CheckpointPolicy
    return cp.MUST_SAVE if op in _DOTS else cp.PREFER_RECOMPUTE


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(_save_dots)


def _remat(fn, run: RunConfig):
    """The reference's ``_remat``: unless ``run.remat`` is "none", ``fn`` runs
    under non-reentrant activation checkpointing. "full" and "coarse" keep
    none of its activations and run its forward again in backward (so a
    kernel inside it launches twice a step); "dots" keeps the outputs of its
    matmuls (``aten.mm``, ``bmm``, ``addmm``, ``baddbmm``) and recomputes the
    rest, the kernels included. The numbers do not change. The recompute
    runs under the mesh context of the forward: autograd runs a CUDA
    backward on a thread of its own, where the (thread-local) context is
    not set."""
    if run.remat == "none":
        return fn
    kw = dict(context_fn=_dots_context) if run.remat == "dots" else {}

    def checkpointed(*args):
        ctx = current_mesh()

        def under_ctx(*inner):
            outer = current_mesh()
            set_mesh_context(ctx)
            try:
                return fn(*inner)
            finally:
                set_mesh_context(outer)

        return torch.utils.checkpoint.checkpoint(under_ctx, *args, use_reentrant=False, **kw)

    return checkpointed


def _embed(params: Transformer, cfg: ModelConfig, run: RunConfig, tokens: torch.Tensor,
           frontend: Optional[torch.Tensor]):
    """Token embeddings (B,S,d), a vlm's frontend (B,F,d) before them when
    given (so S grows to F + S), and their positions."""
    x = embed_tokens(params, cfg, tokens)
    if cfg.family == "vlm" and frontend is not None:
        x = torch.cat([frontend.to(x.dtype), x], dim=1)
    x = _seq_constrain(x, run)
    b, s, _ = x.shape
    return x, torch.arange(s, device=x.device)[None].expand(b, s)


def _encode(params: Transformer, cfg: ModelConfig, run: RunConfig,
            frontend: Optional[torch.Tensor], dtype: torch.dtype,
            remat: bool = False) -> torch.Tensor:
    """The audio encoder: the frame embeddings (B,F,d) plus sinusoidal
    positions through ``enc_layers`` (non-causal, no rope; each under
    ``_remat`` when ``remat``), then ``enc_final_norm``."""
    if frontend is None:
        raise ValueError(f"{cfg.name} needs its (B, F, d) frame embeddings (frontend)")
    enc = frontend.to(dtype)
    enc = enc + sinusoidal_positions(enc.shape[1], cfg.d_model, enc.device).to(dtype)
    enc = _seq_constrain(enc, run)

    def layer(lp, e):
        return dense_block(lp, e, cfg, run, None, causal=False, use_rope=False)[0]

    if remat:
        layer = _remat(layer, run)
    for lp in params.enc_layers:
        enc = layer(lp, enc)
    return rms_norm(enc, params.enc_final_norm, cfg.norm_eps, kernel=uses_kernels(run))


def _with_positions(cfg: ModelConfig, x: torch.Tensor, start: int = 0) -> torch.Tensor:
    """x (B,S,d) plus the sinusoidal positions start .. start + S - 1."""
    table = sinusoidal_positions(x.shape[1], cfg.d_model, x.device, start=start)
    return x + table.to(x.dtype)


def forward_train(params: Transformer, cfg: ModelConfig, run: RunConfig,
                  tokens: torch.Tensor,
                  frontend: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Hidden states (B,S,d) for training (a vlm's F + S, its frontend's
    positions first) and extras (``aux``, the mean MoE load-balancing loss,
    for the moe family): ``forward_hidden`` without the caches, under
    ``_remat`` per dense block, MoE layer, Mamba layer and encoder or
    decoder layer, and per hybrid group (its Mamba layers and the shared
    block after them, on concat(x, x0): x0, the embedding, enters every
    group, so its gradient sums over the groups; an audio model's encoder
    output likewise enters every decoder layer). The logits are left to the
    loss, which may chunk over the sequence."""
    _plain_only(cfg, params, "training")
    x, positions = _embed(params, cfg, run, tokens, frontend)
    extras: Dict[str, Any] = {}

    def dense(lp, x):
        return dense_block(lp, x, cfg, run, positions)[0]

    if cfg.family in ("dense", "vlm", "moe"):
        block = _remat(dense, run)
        for lp in (params.dense_layers if cfg.family == "moe" else params.layers):
            x = block(lp, x)
    if cfg.family == "moe":
        def moe_layer(lp, x):
            x, _, aux = moe_layer_block(lp, x, cfg, run, positions)
            return x, aux

        layer, auxes = _remat(moe_layer, run), []
        for lp in params.layers:
            x, aux = layer(lp, x)
            auxes.append(aux)
        extras["aux"] = torch.stack(auxes).mean()
    elif cfg.family == "ssm":
        layer = _remat(lambda lp, x: mamba_layer(lp, x, cfg, run)[0], run)
        for lp in params.layers:
            x = layer(lp, x)
    elif cfg.family == "hybrid":
        every = cfg.hybrid_attn_every

        def group(g, x, x0):
            for lp in params.layers[g * every:(g + 1) * every]:
                x = mamba_layer(lp, x, cfg, run)[0]
            return hybrid_shared_block(params, x, x0, params.inv_proj[g], cfg, run,
                                       positions)[0]

        group, x0 = _remat(group, run), x
        for g in range(_n_groups(cfg)):
            x = group(g, x, x0)
    elif cfg.family == "audio":
        enc = _encode(params, cfg, run, frontend, x.dtype, remat=True)
        layer = _remat(lambda lp, x, enc: dense_block(lp, x, cfg, run, positions,
                                                      use_rope=False, enc_out=enc)[0], run)
        x = _with_positions(cfg, x)
        for lp in params.layers:
            x = layer(lp, x, enc)
    x = rms_norm(x, params.final_norm, cfg.norm_eps, kernel=uses_kernels(run))
    return x, extras


def _walk(params: Transformer, cfg: ModelConfig, run: RunConfig, x: torch.Tensor,
          positions: torch.Tensor, cache: Optional[Cache] = None, pos=None,
          frontend: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Each family's layers over x (B,S,d) in order, for every serving step.

    * No ``cache``: the layers alone (``forward_hidden``).
    * ``cache`` without ``pos`` (prefill, into ``init_cache``'s cache):
      each self-attention layer's or shared-block invocation's (K, V) goes
      into its cache slots as soon as it is made, its last ``min(T, S)``
      positions into slots 0.. (T < S only in a hybrid ring buffer, as the
      reference keeps it), and each Mamba layer's (ssm, conv) likewise; an
      audio cache also takes each decoder layer's cross K/V. Nothing is
      held for a later copy.
    * ``cache`` and ``pos`` (a decode step, S = 1): every layer attends the
      cache at ``pos`` and writes the new token there (a hybrid ring at slot
      ``pos % wlen`` over its first ``min(pos + 1, wlen)`` slots); a Mamba
      layer steps its cached states, the ssm state in place. A full cache
      raises where ``pos`` is an int, but for the vlm family (the
      reference's clamp) and a ring.

    Returns (x, extras): without ``pos``, the moe family's mean
    load-balancing loss ``aux`` and an audio model's encoder output
    ``enc_out`` (B,F,d), which the decoder cross-attends."""
    _plain_only(cfg, params, "mesh")
    decode = pos is not None
    ring = cfg.family == "hybrid" and not cfg.published_hybrid
    if (decode and not torch.is_tensor(pos) and "k" in cache and not ring
            and cfg.family != "vlm" and pos >= cache["k"].shape[2]):
        raise ValueError(f"KV cache of {cache['k'].shape[2]} positions is full")
    if cache is not None and "ssm" in cache:
        ssm_l, conv_l = _layer_states(cache)
    extras: Dict[str, Any] = {}

    def attend(i, names=("k", "v")):
        """A block's cache arguments in decode: slot i of ``names``."""
        if not decode:
            return {}
        k, v = cache[names[0]][i], cache[names[1]][i]
        if not ring:
            return dict(kv_cache=(k, v), cache_pos=pos)
        wlen = k.shape[1]
        return dict(kv_cache=(k, v), cache_pos=pos % wlen, cache_fill=min(pos + 1, wlen))

    def keep(i, x, kv, *rest, names=("k", "v")):
        """A block's output without its (K, V), which prefill writes into
        slot i of ``names`` first; the caller holds no reference to it."""
        if cache is not None and not decode:
            for name, t in zip(names, kv):
                s = t.shape[1]
                write_positions(cache[name][i], 0, t[:, s - min(s, cache[name].shape[2]):])
        return (x, *rest) if rest else x

    def mamba(i, x, shared=None):
        lp = params.layers[i]
        if decode:
            x, _, conv_l[i] = mamba_layer(lp, x, cfg, run, ssm_state=ssm_l[i],
                                          conv_state=conv_l[i], single_step=True,
                                          shared=shared, layer=i)
            return x
        x, ssm, conv = mamba_layer(lp, x, cfg, run, shared=shared, layer=i)
        if cache is not None:
            ssm_l[i], conv_l[i] = ssm, conv
        return x

    if cfg.family in ("dense", "vlm", "moe"):
        moe = cfg.family == "moe"
        names = ("dk", "dv") if moe else ("k", "v")
        for i, lp in enumerate(params.dense_layers if moe else params.layers):
            x = keep(i, *dense_block(lp, x, cfg, run, positions, layer=i, **attend(i, names)),
                     names=names)
        if moe:
            first, auxes = len(params.dense_layers), []
            for i, lp in enumerate(params.layers):
                x, aux = keep(i, *moe_layer_block(lp, x, cfg, run, positions, layer=first + i,
                                                  **attend(i)))
                auxes.append(aux)
            if not decode:
                extras["aux"] = torch.stack(auxes).mean()
    elif cfg.family == "audio":
        if decode:
            x = _with_positions(cfg, x, start=pos)
            cross_lengths = torch.full((x.shape[0],), cache["cross_k"].shape[2],
                                       dtype=torch.int32, device=x.device)
        else:
            enc = extras["enc_out"] = _encode(params, cfg, run, frontend, x.dtype)
            x = _with_positions(cfg, x)
        heads = (cfg.n_kv_heads, cfg.d_head, cfg.n_kv_heads)
        for i, lp in enumerate(params.layers):
            if decode:
                x = _audio_decode_layer(lp, x, cfg, run, positions,
                                        (cache["k"][i], cache["v"][i]), pos,
                                        (cache["cross_k"][i], cache["cross_v"][i]),
                                        cross_lengths)
                continue
            x = keep(i, *dense_block(lp, x, cfg, run, positions, use_rope=False, enc_out=enc,
                                     layer=i))
            if cache is not None:
                cache["cross_k"][i] = split_heads(enc @ gathered(lp.cross.cross_wk), *heads)
                cache["cross_v"][i] = split_heads(enc @ gathered(lp.cross.cross_wv), *heads)
    elif cfg.family == "ssm":
        for i in range(len(params.layers)):
            x = mamba(i, x)
    elif cfg.published_hybrid:
        x0, calls = x, _invocations(cfg)
        for i, lp in enumerate(params.layers):
            t = None
            if i in calls:
                j = calls[i]
                t = keep(j, *shared_block(params, lp, x, x0, cfg, run, positions, j, i,
                                          **attend(j)))
            x = mamba(i, x, t)
    else:  # hybrid
        x0, every = x, cfg.hybrid_attn_every
        for g in range(_n_groups(cfg)):
            for i in range(g * every, (g + 1) * every):
                x = mamba(i, x)
            x = keep(g, *hybrid_shared_block(params, x, x0, params.inv_proj[g], cfg, run,
                                             positions, **attend(g)))
    return x, extras


def forward_hidden(params: Transformer, cfg: ModelConfig, run: RunConfig,
                   tokens: torch.Tensor,
                   frontend: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Token (+ frontend) embeddings through the stack.

    Returns (hidden (B,S,d), extras); a vlm's frontend (B,F,d) comes before
    the tokens, so its hidden states are (B,F+S,d). For the moe family
    ``extras["aux"]`` is the MoE layers' mean load-balancing loss; for the
    audio family ``extras["enc_out"]`` is the encoder's output (B,F,d), which
    the decoder cross-attends.
    """
    x, positions = _embed(params, cfg, run, tokens, frontend)
    x, extras = _walk(params, cfg, run, x, positions, frontend=frontend)
    return rms_norm(x, params.final_norm, cfg.norm_eps, kernel=uses_kernels(run)), extras


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Device = None, dtype: Optional[torch.dtype] = None,
               mesh: Optional[MeshContext] = None) -> Cache:
    """Zeroed cache and ``pos`` (a Python int, the number of positions
    filled; every row shares it). On ``mesh`` each tensor is a DTensor
    placed by ``cache_shardings`` (sequence, heads or channels over the
    model axis, batch over the data axes), of which this rank allocates its
    own shard only.

    * dense, vlm: k/v (L, B, max_len, K, D).
    * audio: k/v (L, B, max_len, K, D) and cross_k/cross_v (L, B, F, K, D),
      F = ``frontend_len``.
    * moe: k/v (L - first_dense, B, max_len, K, D) for the MoE layers and
      dk/dv (first_dense, B, max_len, K, D) for the leading dense ones.
    * ssm: ssm (L, B, H, N, P) and conv (L, B, K-1, C), C = d_inner + 2N.
    * hybrid: ssm (G, every, B, H, N, P), conv (G, every, B, K-1, C) and a
      ring buffer k/v (G, B, min(window, max_len), K, D) per invocation;
      the published layout ssm (L, B, H, N, P), conv (L, B, K-1, C), C =
      d_inner + 2 * groups * N, and k/v (J, B, max_len, K, D), one per
      shared-block invocation (its window is 0).
    """
    _check_family(cfg)
    dev = resolve_device(device)
    shapes: Dict[str, Tuple[int, ...]] = {}
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        dense = cfg.moe_first_dense if cfg.family == "moe" else 0
        cross = cfg.n_layers if cfg.family == "audio" else 0
        for k, v, layers, length in (("k", "v", cfg.n_layers - dense, max_len),
                                     ("dk", "dv", dense, max_len),
                                     ("cross_k", "cross_v", cross, cfg.frontend_len)):
            if layers:
                shapes[k] = shapes[v] = (layers, batch, length, cfg.n_kv_heads, cfg.d_head)
    else:
        lead = ((cfg.n_layers,) if cfg.family == "ssm" or cfg.published_hybrid
                else (_n_groups(cfg), cfg.hybrid_attn_every))
        shapes["ssm"] = (*lead, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
        shapes["conv"] = (*lead, batch, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state)
        if cfg.published_hybrid:
            if cfg.window:
                raise ValueError("the published hybrid layout's cache has no window")
            shapes["k"] = shapes["v"] = (len(cfg.hybrid_layer_ids), batch, max_len,
                                         cfg.n_kv_heads, cfg.d_head)
        elif cfg.family == "hybrid":
            wlen = min(cfg.window or max_len, max_len)
            shapes["k"] = shapes["v"] = (_n_groups(cfg), batch, wlen, cfg.n_kv_heads,
                                         cfg.d_head)
    dt = _dtype(cfg, dtype)
    cache: Cache = {"pos": 0}
    if mesh is None:
        cache.update({k: torch.zeros(shape, device=dev, dtype=dt) for k, shape in shapes.items()})
    else:
        placed = cache_shardings({k: torch.empty(shape, device="meta")
                                  for k, shape in shapes.items()}, mesh)
        cache.update({k: empty_sharded(shape, dt, placed[k]).zero_()
                      for k, shape in shapes.items()})
    return cache


def _layer_states(cache: Cache):
    """Views of the ssm and conv caches with one leading axis over the Mamba
    layers, in order (group g's layer e of a hybrid cache at g * every + e)."""
    ssm, conv = cache["ssm"], cache["conv"]
    return ssm.reshape(-1, *ssm.shape[-4:]), conv.reshape(-1, *conv.shape[-3:])


def prefill(params: Transformer, cfg: ModelConfig, run: RunConfig,
            tokens: torch.Tensor, max_len: Optional[int] = None,
            frontend: Optional[torch.Tensor] = None):
    """Full-sequence forward that also returns the populated cache.

    The cache is ``init_cache``'s for ``max(max_len, S)`` positions, where
    S counts a vlm's frontend positions (``max_len`` as the reference's
    engine grows it, to prompt + new tokens, may leave them out), allocated
    before the first layer runs; the layers write their K/V and states into
    it as they make them, and decoding follows in it without growing it (a
    hybrid ring buffer holds the last ``min(window, S)`` positions in its
    first slots). An audio cache also holds each decoder layer's cross K/V,
    the encoder output times cross_wk and cross_wv, as the reference
    computes them; the logits are those of the last position (B,1,V).

    On a mesh (a mesh context set and the parameters DTensors) the tokens
    and frontend are distributed by ``batch_shardings``, the step runs
    under ``implicit_replication`` and the cache is ``init_cache``'s on the
    mesh, each rank writing its own shard.
    """
    inputs, context = on_mesh(params.embed, {"tokens": tokens, "frontend": frontend})
    with context:
        return _prefill(params, cfg, run, inputs["tokens"], max_len, inputs["frontend"])


def _prefill(params: Transformer, cfg: ModelConfig, run: RunConfig,
             tokens: torch.Tensor, max_len: Optional[int],
             frontend: Optional[torch.Tensor]):
    x, positions = _embed(params, cfg, run, tokens, frontend)
    b, s = x.shape[:2]
    mesh = current_mesh() if is_distributed(params.embed) else None
    cache = init_cache(cfg, b, max(max_len or s, s), device=tokens.device,
                       dtype=params.embed.dtype, mesh=mesh)
    x, _ = _walk(params, cfg, run, x, positions, cache, frontend=frontend)
    # The published hybrid layout normalises its last position alone, the
    # other families every position, as the reference does. The two are not
    # interchangeable bit for bit: the norm's kernel reduces a row with
    # more warps where there are few rows.
    if cfg.published_hybrid:
        x = x[:, -1:].contiguous()
    x = rms_norm(x, params.final_norm, cfg.norm_eps, kernel=uses_kernels(run))
    cache["pos"] = s
    return lm_logits(params, cfg, x[:, -1:]), cache


def _audio_decode_layer(lp: DenseBlock, x, cfg, run, positions, kv_cache, pos,
                        cross_kv, cross_lengths):
    """One audio decoder layer for one new token: self-attention against the
    cache (no rope), the cross query (norm3) against the layer's cross K/V,
    then the MLP."""
    kernel = uses_kernels(run)
    h, _ = attention_block(lp.attn, rms_norm(x, lp.norm1, cfg.norm_eps, kernel=kernel),
                           cfg, run, positions, kv_cache=kv_cache, cache_pos=pos,
                           use_rope=False)
    x = x + h
    b = x.shape[0]
    q = split_heads(rms_norm(x, lp.norm3, cfg.norm_eps, kernel=kernel)
                    @ gathered(lp.cross.cross_wq), cfg.n_heads, cfg.d_head, cfg.n_kv_heads)
    attend = ops.flash_decode if kernel else decode_attention
    att = attend(q, *cross_kv, cross_lengths)
    x = x + att.reshape(b, 1, -1) @ gathered(lp.cross.cross_wo)
    return x + mlp_block(lp.mlp, rms_norm(x, lp.norm2, cfg.norm_eps, kernel=kernel), cfg.act)


def position_on_device(cfg: ModelConfig, like: torch.Tensor) -> bool:
    """Whether ``decode_step`` takes ``cache["pos"]`` as a 0-d tensor on the
    device for ``cfg`` on tensors like ``like`` (its parameters or its
    cache): a dense or moe step, or one of the published hybrid layout on a
    cache without a window, not on a mesh."""
    takes = cfg.family in ("dense", "moe") or (cfg.published_hybrid and not cfg.window)
    return takes and not is_distributed(like)


def decode_step(params: Transformer, cfg: ModelConfig, run: RunConfig,
                cache: Cache, tokens: torch.Tensor):
    """One decode step: tokens (B,1) + cache -> (logits (B,1,V), new cache).

    The cache tensors are updated in place (the new token's K/V, the SSM and
    conv states), so the returned cache shares them with the one passed in;
    only ``pos`` differs. A hybrid writes position ``pos`` to ring slot
    ``pos % wlen`` and attends the first ``min(pos + 1, wlen)`` slots. A moe
    step routes its B tokens as one group, whose capacity is that of B
    tokens (as in the reference). An audio step adds the sinusoid of
    ``pos`` and cross-attends all F encoder positions. A full cache raises,
    but for the vlm family, which mirrors the reference: position ``pos`` of
    a cache of T slots goes to slot ``min(pos, T - 1)`` and the step attends
    ``pos + 1`` positions, so all T.

    ``pos`` is a Python int, for which a step's graph holds for one
    position; at ``pos = T - 1`` the step attends all T slots, the
    reference's work, which is where the dry run traces it. A step for
    which ``position_on_device`` holds (dense, moe or the published hybrid
    layout, on a plain, not mesh, cache) also takes ``pos`` as a 0-d int64
    tensor on the cache's device, as the reference traces it: the rope
    positions, the K/V write (clamped alike) and the attended lengths are
    then computed on the device, nothing is read on the host, and one
    captured graph of the step serves every position. A full cache is not
    checked there (that would read ``pos``); the returned cache's ``pos``
    is a new tensor, ``pos + 1``. On a mesh (a mesh context set and
    the parameters DTensors) the tokens are distributed by
    ``batch_shardings``, the step runs under ``implicit_replication`` and
    the cache is a mesh cache (``init_cache``'s or ``prefill``'s on the
    mesh), whose sequence-sharded K/V each rank writes on its own shard.
    """
    inputs, context = on_mesh(params.embed, {"tokens": tokens})
    with context:
        return _decode_step(params, cfg, run, cache, inputs["tokens"])


def _decode_step(params: Transformer, cfg: ModelConfig, run: RunConfig,
                 cache: Cache, tokens: torch.Tensor):
    pos = cache["pos"]
    on_device = torch.is_tensor(pos)
    if on_device and not position_on_device(cfg, params.embed):
        raise ValueError(f"a position on the device is taken by a dense, moe or published "
                         f"hybrid step on a plain cache, not by a {cfg.family} step or a mesh "
                         f"cache")
    b = tokens.shape[0]
    x = embed_tokens(params, cfg, tokens)
    positions = pos.expand(b, 1) if on_device else torch.full((b, 1), pos, device=x.device)
    x, _ = _walk(params, cfg, run, x, positions, cache, pos)
    x = rms_norm(x, params.final_norm, cfg.norm_eps, kernel=uses_kernels(run))
    logits = lm_logits(params, cfg, x)
    return logits, dict(cache, pos=pos + 1)
