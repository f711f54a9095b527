"""A small configuration of the published Zamba2 layout for the CPU tests:
7 layers, shared blocks before layers 2 and 5 (one of each of 2 blocks),
d 64, 4 heads of 32 (2d / heads, as Zamba2 sizes them), B/C in 2 groups,
chunks of 8; and a small chat mix for the serve driver."""

HYBRID = {"name": "zamba2-tiny", "family": "hybrid", "n_layers": 7, "d_model": 64,
          "n_heads": 4, "n_kv_heads": 4, "d_head": 32, "d_ff": 96, "vocab": 250,
          "ssm_state": 16, "ssm_expand": 2, "ssm_head_dim": 16, "ssm_chunk": 8, "ssm_conv": 4,
          "ssm_groups": 2, "ssm_conv_bias": True, "ssm_dt_min": 0.001,
          "hybrid_layer_ids": [2, 5], "hybrid_blocks": 2, "adapter_rank": 8,
          "qk_norm": False, "rope_theta": 10000.0, "window": 0, "attn_logit_softcap": 0.0,
          "attn_scale": 0.25, "act": "geglu", "tie_embeddings": True, "norm_eps": 1e-05,
          "dtype": "float32"}
CHAT = {"driver": "serve_waves", "batch_size": 4, "prompt_median": 12, "prompt_sigma": 0.6,
        "prompt_min": 3, "prompt_max": 20, "new_tokens": 6, "eos_id": None, "sample_waves": 2,
        "sample_from": 3}
