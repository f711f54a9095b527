"""The port's dense decoder against ``repro.models`` on the reference's own
weights (``init_params`` output converted with ``params_from_jax``), on the
tiny variant of tinyllama-1.1b (2 layers, d_model 128, 4 heads, 2 KV heads,
d_head 32); and the serve cache of all seven serving layouts, which prefill
allocates before its first layer and fills as it goes, held to
``init_cache`` and to a teacher-forced decode step.

Tolerances: f32 1e-4 (summation order only); bf16 2e-2 on logits of
magnitude about 1, a few bf16 steps, because XLA and PyTorch round the bf16
activations at different places."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.models import (Transformer, decode_step, forward_hidden, init_cache, prefill,
                                transformer)
from repro_torch.models.convert import params_from_jax

IMPLS = ("flash", "chunked", "naive")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S = 2, 37  # S is a multiple of no attention chunk or kernel block
JAX_RUN = JRun(attention_impl="chunked", attention_chunk=16, remat="none", zero=False)


def _configs(dtype):
    return (dataclasses.replace(jax_tiny(jax_get_config("tinyllama-1.1b")), dtype=dtype),
            dataclasses.replace(tiny_variant(get_config("tinyllama-1.1b")), dtype=dtype))


@pytest.fixture(scope="module", params=list(TOL))
def setup(request):
    dtype = request.param
    jcfg, cfg = _configs(dtype)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_jax(tree, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S))
    return dtype, jcfg, cfg, params, tree, model, tokens


def _run(impl):
    return RunConfig(attention_impl=impl, attention_chunk=16, remat="none", zero=False)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


def test_params_from_jax_round_trip(setup):
    dtype, jcfg, cfg, params, tree, model, _ = setup
    state = {k: v.float().numpy() for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(state["embed"], tree["embed"].astype(np.float32))
    np.testing.assert_array_equal(state["lm_head"], tree["lm_head"].astype(np.float32))
    layers = tree["layers"]
    for i in range(cfg.n_layers):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(state[f"layers.{i}.attn.{name}"],
                                          layers["attn"][name][i].astype(np.float32))
        for name in ("wi", "wo"):
            np.testing.assert_array_equal(state[f"layers.{i}.mlp.{name}"],
                                          layers["mlp"][name][i].astype(np.float32))
        np.testing.assert_array_equal(state[f"layers.{i}.norm1"],
                                      layers["norm1"][i].astype(np.float32))
    assert model.embed.dtype == getattr(torch, dtype)
    assert len(state) == 3 + cfg.n_layers * 8


def test_params_from_jax_rejects_mismatched_tree(setup):
    _, _, cfg, _, tree, _, _ = setup
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, dataclasses.replace(cfg, d_ff=2 * cfg.d_ff), device="cpu")


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_hidden_matches_reference(setup, impl):
    dtype, jcfg, cfg, params, _, model, tokens = setup
    want, _ = jax_forward_hidden(params, jcfg, JAX_RUN, jnp.asarray(tokens))
    with torch.inference_mode():
        got, _ = forward_hidden(model, cfg, _run(impl), torch.from_numpy(tokens))
    _close(got.float(), jnp.asarray(want, jnp.float32), TOL[dtype])


@pytest.mark.parametrize("impl,pos", [(impl, "int") for impl in IMPLS]
                         + [(impl, "tensor") for impl in IMPLS],
                         ids=list(IMPLS) + [f"{impl}-device-pos" for impl in IMPLS])
def test_prefill_and_decode_match_reference(setup, impl, pos):
    """Prefill, then one decode step whose position is the int prefill
    gives or that int as a 0-d tensor (the engine's replayed step)."""
    dtype, jcfg, cfg, params, _, model, tokens = setup
    want_pre, jcache = jax_prefill(params, jcfg, JAX_RUN, jnp.asarray(tokens[:, :-1]))
    jcache = JaxEngine(jcfg, params, run=JAX_RUN)._grow_cache(jcache, S + 3, B)
    want_dec, _ = jax_decode_step(params, jcfg, JAX_RUN, jcache, jnp.asarray(tokens[:, -1:]))
    with torch.inference_mode():
        got_pre, cache = prefill(model, cfg, _run(impl), torch.from_numpy(tokens[:, :-1]),
                                 max_len=S + 3)
        assert cache["k"].shape == (cfg.n_layers, B, S + 3, cfg.n_kv_heads, cfg.d_head)
        _close(cache["k"][:, :, :S - 1].float(), jcache["k"][:, :, :S - 1], TOL[dtype])
        if pos == "tensor":
            cache["pos"] = torch.tensor(cache["pos"])
        got_dec, cache2 = decode_step(model, cfg, _run(impl), cache,
                                      torch.from_numpy(tokens[:, -1:]))
    _close(got_pre, want_pre, TOL[dtype])
    _close(got_dec, want_dec, TOL[dtype])
    assert int(cache2["pos"]) == S and got_dec.dtype == torch.float32


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_matches_prefill_logits(setup, impl):
    """Teacher-forced decode: the step's logits equal prefill's on the prefix."""
    dtype, _, cfg, _, _, model, tokens = setup
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        full, _ = prefill(model, cfg, _run(impl), t)
        _, cache = prefill(model, cfg, _run(impl), t[:, :-1], max_len=S + 4)
        step, cache2 = decode_step(model, cfg, _run(impl), cache, t[:, -1:])
    _close(step[:, 0], full[:, -1], TOL[dtype])
    assert (step[:, 0].argmax(-1) == full[:, -1].argmax(-1)).all()
    assert cache2["pos"] == S


def test_attention_impls_agree(setup):
    dtype, _, cfg, _, _, model, tokens = setup
    with torch.inference_mode():
        outs = [forward_hidden(model, cfg, _run(impl), torch.from_numpy(tokens))[0]
                for impl in IMPLS]
    for out in outs[1:]:
        _close(out.float(), outs[0].float(), TOL[dtype])


def test_unknown_attention_impl_raises(setup):
    _, _, cfg, _, _, model, tokens = setup
    with pytest.raises(ValueError, match="attention_impl"):
        forward_hidden(model, cfg, _run("pallas"), torch.from_numpy(tokens))


def test_random_init_is_seeded_and_scaled():
    cfg = tiny_variant(get_config("tinyllama-1.1b"))
    a = Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    std = a.layers[0].attn.wq.float().std().item()
    assert 0.018 < std < 0.022
    assert a.layers[0].norm1.float().eq(1).all()
    assert a.embed.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The serve cache of every layout: prefill allocates it first and fills it
# ---------------------------------------------------------------------------


def _layout(name):
    """(cfg, model, frontend) of a serving layout at tiny size in f32, its
    matrices scaled to N(0, 0.08), about 1/sqrt(d_model), so that the
    attended K/V and the carried states move the logits."""
    if name == "published":
        from test_torch_zamba2 import program

        cfg, model = program()
        return cfg, model, None
    arch = {"dense": "tinyllama-1.1b", "vlm": "phi-3-vision-4.2b", "audio": "whisper-base",
            "moe": "deepseek-moe-16b", "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b"}[name]
    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32")
    if name == "moe":  # a slot for every token: routing drops none in prefill or decode
        cfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    if name == "hybrid":
        cfg = dataclasses.replace(cfg, window=8)
    model = Transformer(cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.mul_(4)
    frontend = None
    if cfg.frontend_len:
        g = torch.Generator().manual_seed(1)
        frontend = torch.randn((B, cfg.frontend_len, cfg.d_model), generator=g)
    return cfg, model, frontend


@pytest.mark.parametrize("name", ["dense", "vlm", "audio", "moe", "ssm", "hybrid",
                                  "published"])
def test_prefill_fills_the_cache_it_allocates_first(name, monkeypatch):
    """``prefill(..., max_len=S + 3)`` (S counting a vlm's patches) allocates
    ``init_cache``'s cache before any layer runs and returns it filled: the
    same keys, shapes and dtypes, every slot of the prompt written and zeros
    past it (a ring of min(window, S + 3) slots full), the cross K/V and the
    states written; a decode step on it then gives the logits of a prefill
    of S + 1 at its last position."""
    cfg, model, frontend = _layout(name)
    # A prompt of 16 wraps the hybrid's ring of 8 twice. Its prefill keeps
    # positions S - 8.. in slots 0.. and decode writes position p to slot
    # p % 8, which agree only where 8 divides S: the reference's layout,
    # which the port mirrors.
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(B, 17)))
    filled = tokens.shape[1] - 1 + (cfg.frontend_len if name == "vlm" else 0)
    run = _run("flash")
    events = []

    def spy(fn, event):
        def called(*args, **kwargs):
            events.append(event)
            return fn(*args, **kwargs)
        return called

    monkeypatch.setattr(transformer, "init_cache", spy(init_cache, "cache"))
    for block in ("dense_block", "moe_layer_block", "mamba_layer", "shared_block",
                  "hybrid_shared_block"):
        monkeypatch.setattr(transformer, block, spy(getattr(transformer, block), "layer"))
    with torch.inference_mode():
        _, cache = prefill(model, cfg, run, tokens[:, :-1], max_len=filled + 3,
                           frontend=frontend)
        assert events[0] == "cache" and events.count("cache") == 1 and "layer" in events

        want = init_cache(cfg, B, filled + 3, device="cpu")
        assert set(cache) == set(want) and cache["pos"] == filled
        for key, t in want.items():
            if key != "pos":
                assert (cache[key].shape, cache[key].dtype) == (t.shape, t.dtype), key
        for key in ("k", "v", "dk", "dv"):
            if key in cache:
                ring = cache[key].shape[2] < filled
                assert ring == (name == "hybrid"), key
                live = min(cache[key].shape[2], filled)
                assert cache[key][:, :, :live].abs().amax(dim=(3, 4)).gt(0).all(), key
                assert not cache[key][:, :, live:].any(), key
        if name == "hybrid":
            assert cache["k"].shape[2] == min(cfg.window, filled + 3)
        for key in ("cross_k", "cross_v", "ssm", "conv"):
            if key in cache:
                assert cache[key].flatten(1).abs().amax(dim=1).gt(0).all(), key

        monkeypatch.undo()
        full, _ = prefill(model, cfg, run, tokens, frontend=frontend)
        step, after = decode_step(model, cfg, run, cache, tokens[:, -1:])
    err = float((step[:, 0] - full[:, -1]).abs().max()) / float(full[:, -1].abs().max())
    assert err < TOL["float32"], err
    assert int(after["pos"]) == filled + 1
