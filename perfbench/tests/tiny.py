"""A small configuration and mix for the CPU tests: the cell's family and
traffic at sizes a test run holds."""

import copy

import torch

MOE = {"name": "moe-tiny", "family": "moe", "n_layers": 3, "d_model": 64, "n_heads": 4,
       "n_kv_heads": 4, "d_head": 16, "d_ff": 96, "vocab": 250, "moe_experts": 8,
       "moe_top_k": 2, "moe_shared": 1, "moe_d_ff": 32, "moe_first_dense": 1,
       "moe_group_size": 24, "moe_capacity_factor": 1.25, "qk_norm": False,
       "rope_theta": 10000.0, "window": 0, "attn_logit_softcap": 0.0, "act": "swiglu",
       "tie_embeddings": False, "norm_eps": 1e-05, "dtype": "float32"}
SERVE = {"driver": "serve_waves", "batch_size": 4, "prompt_median": 20, "prompt_sigma": 0.6,
         "prompt_min": 4, "prompt_max": 37, "new_tokens": 5, "eos_id": None, "sample_waves": 2,
         "sample_from": 4}


def cell(driver, model: dict, mix: dict, seed: int = 7):
    """A driver's cell on the CPU (the run's look for a card skipped)."""
    return driver.Cell({"model": copy.deepcopy(model)}, copy.deepcopy(mix), seed,
                       torch.device("cpu"))
