"""The ten assigned architectures, exactly as specified in the task sheet.

Each entry records its public source. ``--arch <id>`` selects these in the
launchers; ``tiny_variant`` derives the CPU smoke-test configs.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, register


@register("yi-9b")
def yi_9b() -> ModelConfig:
    # [arXiv:2403.04652; hf] llama-arch GQA. 48L d4096 32H kv4 ff11008 v64000.
    return ModelConfig(
        name="yi-9b", family="dense", n_layers=48, d_model=4096,
        n_heads=32, n_kv_heads=4, d_head=128, d_ff=11008, vocab=64000,
    )


@register("tinyllama-1.1b")
def tinyllama() -> ModelConfig:
    # [arXiv:2401.02385; hf] llama2-arch small. 22L d2048 32H kv4 ff5632 v32000.
    return ModelConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_head=64, d_ff=5632, vocab=32000,
    )


@register("starcoder2-15b")
def starcoder2() -> ModelConfig:
    # [arXiv:2402.19173; hf] GQA, RoPE. 40L d6144 48H kv4 ff24576 v49152.
    return ModelConfig(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, d_head=128, d_ff=24576, vocab=49152,
        act="gelu",
    )


@register("qwen3-8b")
def qwen3() -> ModelConfig:
    # [hf:Qwen/Qwen3-8B] qk_norm, GQA. 36L d4096 32H kv8 ff12288 v151936.
    return ModelConfig(
        name="qwen3-8b", family="dense", n_layers=36, d_model=4096,
        n_heads=32, n_kv_heads=8, d_head=128, d_ff=12288, vocab=151936,
        qk_norm=True, rope_theta=1e6,
    )


@register("zamba2-2.7b")
def zamba2() -> ModelConfig:
    # [arXiv:2411.15242; hf] Mamba2 backbone + shared attention block.
    # 54L d2560 32H kv32 ff10240 v32000 ssm_state=64.
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_head=80, d_ff=10240, vocab=32000,
        ssm_state=64, hybrid_attn_every=6,
        window=4096,  # long-context deployment mode for the shared attn block
    )


@register("deepseek-moe-16b")
def deepseek_moe() -> ModelConfig:
    # [arXiv:2401.06066; hf] fine-grained MoE: 2 shared + 64 routed top-6,
    # first layer dense. 28L d2048 16H kv16 expert-ff1408 v102400.
    return ModelConfig(
        name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=16, d_head=128, d_ff=10944, vocab=102400,
        moe_experts=64, moe_top_k=6, moe_shared=2, moe_d_ff=1408,
        moe_first_dense=1,
    )


@register("phi3.5-moe-42b-a6.6b")
def phi35_moe() -> ModelConfig:
    # [hf:microsoft/Phi-3.5-MoE-instruct] 16 experts top-2.
    # 32L d4096 32H kv8 expert-ff6400 v32064.
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_head=128, d_ff=6400, vocab=32064,
        moe_experts=16, moe_top_k=2, moe_shared=0, moe_d_ff=6400,
    )


@register("mamba2-130m")
def mamba2_130m() -> ModelConfig:
    # [arXiv:2405.21060] SSD (state-space duality). 24L d768 attn-free
    # v50280 ssm_state=128.
    return ModelConfig(
        name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0, vocab=50280,
        ssm_state=128, tie_embeddings=True,
    )


@register("whisper-base")
def whisper_base() -> ModelConfig:
    # [arXiv:2212.04356] enc-dec; conv frontend is a stub (input_specs feeds
    # precomputed 80-mel frame embeddings). 6L d512 8H ff2048 v51865.
    return ModelConfig(
        name="whisper-base", family="audio", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, d_head=64, d_ff=2048, vocab=51865,
        encoder_decoder=True, n_encoder_layers=6,
        frontend="audio_stub", frontend_len=1500, act="gelu",
    )


@register("phi-3-vision-4.2b")
def phi3_vision() -> ModelConfig:
    # [hf:microsoft/Phi-3-vision-128k-instruct] phi3-mini backbone + CLIP
    # (stubbed: input_specs provides patch embeddings). 32L d3072 32H kv32
    # ff8192 v32064.
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
        n_heads=32, n_kv_heads=32, d_head=96, d_ff=8192, vocab=32064,
        frontend="vision_stub", frontend_len=576,
    )
