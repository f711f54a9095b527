"""Model / run configuration dataclasses and the architecture registry.

Plain data, carried over from ``repro.configs.base`` so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0
    moe_d_ff: int = 0  # per-expert hidden width
    moe_first_dense: int = 0  # number of leading dense-FFN layers
    moe_group_size: int = 512  # routing group size (GShard-style)
    moe_capacity_factor: float = 1.25

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1  # B and C groups: head h reads group h // (heads / groups)
    ssm_conv_bias: bool = False
    ssm_dt_min: float = 0.0  # dt clamped below at this (0: no clamp)

    # Hybrid (Zamba2): one shared attention block applied every k layers.
    hybrid_attn_every: int = 0
    # The published Zamba2 layout (non-empty ``hybrid_layer_ids``): every
    # layer a Mamba-2 layer, the j-th listed one first running shared block
    # j % hybrid_blocks (attention on concat(x, embed0), then a gated MLP
    # with a rank-``adapter_rank`` adapter of its own) and a d x d linear
    # whose output enters that layer's Mamba input.
    hybrid_layer_ids: Sequence[int] = ()
    hybrid_blocks: int = 0
    adapter_rank: int = 0

    # Attention details
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int = 0  # sliding window size; 0 = full causal
    attn_logit_softcap: float = 0.0
    attn_scale: float = 0.0  # softmax scale of the scores; 0: 1 / sqrt(d_head)

    # Encoder-decoder / modality frontends (audio/vlm backbones).
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: str = "none"  # none | audio_stub | vision_stub
    frontend_len: int = 0  # stub frames / patches per example

    act: str = "swiglu"  # swiglu | gelu (tanh) | geglu (erf-GELU gate times up)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def published_hybrid(self) -> bool:
        """A hybrid of the published Zamba2 layout (``hybrid_layer_ids``)."""
        return self.family == "hybrid" and bool(self.hybrid_layer_ids)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 16 so the embedding/lm_head shard
        cleanly over the model axis (padded logits are masked to -inf)."""
        return ((self.vocab + 15) // 16) * 16

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing: SSM / hybrid (windowed attn)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND MODEL_FLOPS)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        h_q = self.n_heads * self.d_head
        h_kv = self.n_kv_heads * self.d_head
        attn = d * h_q + 2 * d * h_kv + h_q * d
        per_dense = attn + (3 if self.act == "swiglu" else 2) * d * ff + 2 * d
        total = v * d  # embed
        if not self.tie_embeddings:
            total += d * v
        if self.family == "moe":
            ffe = self.moe_d_ff or ff
            moe = self.moe_experts * 3 * d * ffe + d * self.moe_experts
            shared = self.moe_shared * 3 * d * ffe
            dense_layers = self.moe_first_dense
            moe_layers = self.n_layers - dense_layers
            total += moe_layers * (attn + moe + shared + 2 * d)
            total += dense_layers * per_dense
        elif self.family == "ssm":
            di, n = self.d_inner, self.ssm_state
            per = d * (2 * di + 2 * n + self.ssm_heads) + di * d + 3 * self.ssm_heads
            total += self.n_layers * (per + d)
        elif self.published_hybrid:
            di, nh = self.d_inner, self.ssm_heads
            conv = di + 2 * self.ssm_groups * self.ssm_state
            per_mamba = (d * (di + conv + nh) + self.ssm_conv * conv
                         + conv * self.ssm_conv_bias + 3 * nh + di + di * d + d)
            block = (2 * d) * h_q + 2 * (2 * d) * h_kv + h_q * d + 3 * d * ff + 3 * d
            per_hybrid = d * d + self.adapter_rank * (d + 2 * ff)
            total += (self.n_layers * per_mamba + self.hybrid_blocks * block
                      + len(self.hybrid_layer_ids) * per_hybrid)
        elif self.family == "hybrid":
            di, n = self.d_inner, self.ssm_state
            per_mamba = d * (2 * di + 2 * n + self.ssm_heads) + di * d + d
            total += self.n_layers * per_mamba
            shared_blk = (2 * d) * h_q + 2 * (2 * d) * h_kv + h_q * d + 3 * d * ff
            n_inv = self.n_layers // max(self.hybrid_attn_every, 1)
            total += shared_blk + n_inv * (2 * d) * d  # + per-invocation proj
        else:
            layers = self.n_layers + self.n_encoder_layers
            total += layers * per_dense
            if self.encoder_decoder:  # cross attention in decoder layers
                total += self.n_layers * (attn + 2 * d)
        return int(total)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        h_q = self.n_heads * self.d_head
        h_kv = self.n_kv_heads * self.d_head
        attn = d * h_q + 2 * d * h_kv + h_q * d
        ffe = self.moe_d_ff or ff
        active_ffn = (self.moe_top_k + self.moe_shared) * 3 * d * ffe
        dense_layers = self.moe_first_dense
        moe_layers = self.n_layers - dense_layers
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        total += moe_layers * (attn + active_ffn + d * self.moe_experts + 2 * d)
        total += dense_layers * (attn + 3 * d * ff + 2 * d)
        return int(total)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: ``train_*`` lowers train_step, ``decode_*`` /
    ``long_*`` lower serve_step (1 new token against a seq_len KV cache),
    ``prefill_*`` lowers the prefill step."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    """Execution knobs orthogonal to the architecture (perf levers)."""

    # flash = the kernel-backed ops of ``repro_torch.kernels.ops`` (RMSNorm,
    # flash attention, flash decode); chunked | naive = eager mirrors of the
    # reference layers.
    attention_impl: str = "chunked"  # flash | chunked | naive
    attention_chunk: int = 512
    loss_chunk: int = 0  # 0 = full logits; >0 = vocab-chunked CE over seq chunks
    remat: str = "coarse"  # none | coarse | full | dots (matmul outputs saved)
    zero: bool = True  # shard optimizer state over the data axis
    fsdp: bool = False  # additionally shard parameters over the data axis
    grad_reduce: str = "reduce_scatter"  # all_reduce | reduce_scatter
    microbatch: int = 0  # 0 = no gradient accumulation
    seq_shard: bool = False  # sequence parallelism on activations
    # SSD chunk-dim sharding over the model axis (the intra-chunk dual form
    # is chunk-parallel) — §Perf iteration 1; False reproduces the baseline.
    ssd_chunk_shard: bool = True
    # MoE dispatch: "einsum" = GShard dense one-hot matmuls, "gather" =
    # index-based dispatch/combine.  §Perf iterations 2-4: with expert GEMMs
    # correctly group-sharded over data, einsum dispatch has lower HBM/ICI
    # pressure than gather (GSPMD turns the gathers into extra collectives),
    # so einsum stays the default; "gather" is kept as the measured
    # alternative.
    moe_dispatch: str = "einsum"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    grad_compression: str = "none"  # none | int8
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # Import the per-arch modules lazily on first miss.
        import repro_torch.configs.archs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs.archs  # noqa: F401
    return tuple(sorted(_REGISTRY))


def tiny_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return replace(
        cfg,
        name=cfg.name + "-tiny",
        n_layers=min(cfg.n_layers, 2),
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256,
        vocab=512,
        moe_experts=min(cfg.moe_experts, 4) if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        moe_group_size=64,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=32,
        hybrid_attn_every=2 if cfg.hybrid_attn_every else 0,
        frontend_len=min(cfg.frontend_len, 16) if cfg.frontend_len else 0,
        moe_first_dense=min(cfg.moe_first_dense, 1),
    )
