"""The port's Mamba-2 families against ``repro.models`` and
``repro.serving.ServeEngine`` on the reference's own weights (``init_params``
output converted with ``params_from_jax``): the tiny variants of
mamba2-130m (ssm: 2 Mamba layers, d_model 128, 8 SSM heads of 32, state 16,
chunk 32) and zamba2-2.7b (hybrid: 2 Mamba layers and one shared attention
block on concat(x, embed0), 4 heads of 32).

Tolerances: f32 1e-4 (summation order only); bf16 2e-2 on logits of
magnitude about 1, a few bf16 steps, because XLA and PyTorch round the bf16
activations at different places (as tests/test_torch_model.py)."""

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
from repro.models.mamba2 import _causal_conv as jax_causal_conv
from repro.models.mamba2 import init_mamba_params as jax_init_mamba
from repro.models.mamba2 import mamba_block as jax_mamba_block
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.models.transformer import lm_logits as jax_lm_logits
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import Transformer, decode_step, forward_hidden, init_cache, prefill
from repro_torch.models.convert import params_from_jax
from repro_torch.models.mamba2 import MambaBlock, _causal_conv, mamba_block, ssd_chunked
from repro_torch.models.transformer import lm_logits
from repro_torch.serving import ServeEngine

ARCHS = ("mamba2-130m", "zamba2-2.7b")
IMPLS = ("flash", "chunked", "naive")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S = 2, 37  # S is a multiple of no SSD chunk (32) or attention chunk (16)
JAX_RUN = JRun(attention_impl="chunked", attention_chunk=16, remat="none", zero=False)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11]]


def _configs(arch, dtype, **changes):
    return (dataclasses.replace(jax_tiny(jax_get_config(arch)), dtype=dtype, **changes),
            dataclasses.replace(tiny_variant(get_config(arch)), dtype=dtype, **changes))


def _run(impl):
    return RunConfig(attention_impl=impl, attention_chunk=16, remat="none", zero=False)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def setup(request):
    arch, dtype = request.param
    jcfg, cfg = _configs(arch, dtype)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_jax(tree, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S))
    return dtype, jcfg, cfg, params, tree, model, tokens


def test_params_from_jax_round_trip(setup):
    dtype, _, cfg, _, tree, model, _ = setup
    state = {k: v.float().numpy() for k, v in model.state_dict().items()}
    layers = tree["layers"]
    lead = 1 if cfg.family == "ssm" else 2
    for name, stacked in layers["mamba"].items():
        flat = stacked.reshape(-1, *stacked.shape[lead:]).astype(np.float32)
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(state[f"layers.{i}.mamba.{name}"], flat[i])
    if cfg.family == "hybrid":
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(state[f"shared_attn.{name}"],
                                          tree["shared_attn"][name].astype(np.float32))
        np.testing.assert_array_equal(state["inv_proj"], tree["inv_proj"].astype(np.float32))
        assert "lm_head" in state
    else:
        assert "lm_head" not in state  # mamba2-130m ties its embeddings
    assert model.embed.dtype == getattr(torch, dtype)
    # embed, final_norm, 7 Mamba leaves and norm1 per layer; hybrid adds
    # lm_head, wq/wk/wv/wo, wi/wo, two shared norms and inv_proj.
    assert len(state) == 2 + 8 * cfg.n_layers + (10 if cfg.family == "hybrid" else 0)


def test_params_from_jax_rejects_mismatched_tree(setup):
    _, _, cfg, _, tree, _, _ = setup
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, dataclasses.replace(cfg, ssm_state=2 * cfg.ssm_state),
                        device="cpu")


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_hidden_matches_reference(setup, impl):
    """Logits of every position from forward_hidden's output."""
    dtype, jcfg, cfg, params, _, model, tokens = setup
    hidden, _ = jax_forward_hidden(params, jcfg, JAX_RUN, jnp.asarray(tokens))
    want = jax_lm_logits(params, jcfg, hidden)
    with torch.inference_mode():
        got, _ = forward_hidden(model, cfg, _run(impl), torch.from_numpy(tokens))
        got = lm_logits(model, cfg, got)
    assert got.shape == (B, S, cfg.padded_vocab)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_reference(setup, impl):
    dtype, jcfg, cfg, params, _, model, tokens = setup
    want_pre, jcache = jax_prefill(params, jcfg, JAX_RUN, jnp.asarray(tokens[:, :-1]))
    jcache = JaxEngine(jcfg, params, run=JAX_RUN)._grow_cache(jcache, S + 3, B)
    want_dec, _ = jax_decode_step(params, jcfg, JAX_RUN, jcache, jnp.asarray(tokens[:, -1:]))
    with torch.inference_mode():
        got_pre, cache = prefill(model, cfg, _run(impl), torch.from_numpy(tokens[:, :-1]),
                                 max_len=S + 3)
        for key in ("ssm", "conv"):
            assert cache[key].shape == jcache[key].shape
            _close(cache[key].float(), jnp.asarray(jcache[key], jnp.float32), TOL[dtype])
        if cfg.family == "hybrid":
            assert cache["k"].shape == jcache["k"].shape
            _close(cache["k"].float(), jnp.asarray(jcache["k"], jnp.float32), TOL[dtype])
        else:
            assert "k" not in cache
        got_dec, cache2 = decode_step(model, cfg, _run(impl), cache,
                                      torch.from_numpy(tokens[:, -1:]))
    _close(got_pre, want_pre, TOL[dtype])
    _close(got_dec, want_dec, TOL[dtype])
    assert cache2["pos"] == S and got_dec.dtype == torch.float32


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


@pytest.mark.parametrize("n_layers", [6, 54])
def test_bf16_decode_gap_at_depth_tracks_reference(n_layers):
    """zamba2 in bf16 at its full depth (54 Mamba layers, a shared block
    every 6) and a fifth of its width (d_model 512): the teacher-forced
    decode step's gap to prefill's logits grows with depth in the reference
    itself, and the port's (kernel route, plain versions on the CPU) stays
    within twice the reference's on the same weights."""
    changes = dict(n_layers=n_layers, d_model=512,
                   hybrid_attn_every=get_config("zamba2-2.7b").hybrid_attn_every)
    jcfg, cfg = _configs("zamba2-2.7b", "bfloat16", **changes)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S))
    full, _ = jax_prefill(params, jcfg, JAX_RUN, jnp.asarray(tokens))
    _, jcache = jax_prefill(params, jcfg, JAX_RUN, jnp.asarray(tokens[:, :-1]))
    jcache = JaxEngine(jcfg, params, run=JAX_RUN)._grow_cache(jcache, S + 3, B)
    step, _ = jax_decode_step(params, jcfg, JAX_RUN, jcache, jnp.asarray(tokens[:, -1:]))
    want = float(np.abs(np.asarray(step[:, 0], np.float32)
                        - np.asarray(full[:, -1], np.float32)).max())
    t = torch.from_numpy(tokens)
    with torch.inference_mode():
        got_full, _ = prefill(model, cfg, _run("flash"), t)
        _, cache = prefill(model, cfg, _run("flash"), t[:, :-1], max_len=S + 3)
        got_step, _ = decode_step(model, cfg, _run("flash"), cache, t[:, -1:])
    got = float((got_step[:, 0] - got_full[:, -1]).abs().max())
    print(f"zamba2 bf16, {n_layers} layers, d_model 512: decode-vs-prefill max abs gap "
          f"reference {want:.4g}, port {got:.4g}")
    assert want > 0 and got <= 2 * want


def _block_pair(seed=0):
    """One f32 Mamba block of the tiny mamba2-130m in both packages."""
    jcfg, cfg = _configs("mamba2-130m", "float32")
    jp = jax_init_mamba(jax.random.PRNGKey(seed), jcfg, (), jnp.float32)
    # Non-trivial A, D and dt_bias (the reference initialises them constant).
    rng = np.random.default_rng(seed)
    jp = dict(jp, **{k: jnp.asarray(rng.standard_normal(jp[k].shape).astype(np.float32) * 0.5)
                     for k in ("A_log", "D", "dt_bias")})
    block = MambaBlock(cfg, generator=None, device="meta", dtype=torch.float32)
    block.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()},
                          assign=True)
    return jcfg, cfg, jp, block


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "plain"])
def test_mamba_block_prefill_and_single_step_match_reference(kernel):
    jcfg, cfg, jp, block = _block_pair()
    x = (np.random.default_rng(1).standard_normal((B, 45, cfg.d_model)) * 0.5
         ).astype(np.float32)
    want_y, want_ssm, want_conv = jax_mamba_block(jp, jnp.asarray(x[:, :-1]), jcfg)
    want_step = jax_mamba_block(jp, jnp.asarray(x[:, -1:]), jcfg, ssm_state=want_ssm,
                                conv_state=want_conv, single_step=True)
    with torch.inference_mode():
        y, ssm, conv = mamba_block(block, torch.from_numpy(x[:, :-1]), cfg, kernel=kernel)
        # The step updates the state it is given in place: give it a copy.
        step = mamba_block(block, torch.from_numpy(x[:, -1:]), cfg, kernel=kernel,
                           ssm_state=ssm.clone(), conv_state=conv, single_step=True)
    for got, want in zip((y, ssm, conv, *step), (want_y, want_ssm, want_conv, *want_step)):
        assert tuple(got.shape) == want.shape
        _close(got, want, TOL["float32"])


def test_causal_conv_carries_its_state():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for st in (None, state):
        want = jax_causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if st is None else jnp.asarray(st))
        got = _causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           None if st is None else torch.from_numpy(st))
        for g, e in zip(got, want):
            _close(g, e, 1e-5)


def test_mamba_chunked_equals_stepwise():
    """SSD chunked scan == the sequential single-step recurrence (the
    reference's test_models.py check, on the port)."""
    rng = np.random.default_rng(4)
    b, s, h, p, n, chunk = 1, 32, 2, 16, 8, 8
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.3)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h)).astype(np.float32)))
    a = -torch.exp(torch.from_numpy(rng.standard_normal(h).astype(np.float32)) * 0.3)
    bm = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32) * 0.3)
    cm = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32) * 0.3)
    state = torch.zeros((b, h, n, p))
    ys = []
    for t in range(s):
        xdt = x[:, t] * dt[:, t][..., None]
        state = torch.exp(dt[:, t] * a)[..., None, None] * state + torch.einsum(
            "bn,bhp->bhnp", bm[:, t], xdt)
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, t], state))
    for kernel in (True, False):
        y, h_last = ssd_chunked(x, dt, a, bm, cm, chunk, kernel=kernel)
        torch.testing.assert_close(y, torch.stack(ys, dim=1), rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h_last, state, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_shapes(arch):
    _, cfg = _configs(arch, "float32")
    cache = init_cache(cfg, 3, 20, device="cpu")
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    lead = (cfg.n_layers,) if cfg.family == "ssm" else (1, 2)
    assert cache["ssm"].shape == (*lead, 3, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    assert cache["conv"].shape == (*lead, 3, cfg.ssm_conv - 1, conv_ch)
    assert cache["pos"] == 0
    if cfg.family == "hybrid":
        assert cache["k"].shape == (1, 3, 20, cfg.n_kv_heads, cfg.d_head)
        ring = init_cache(dataclasses.replace(cfg, window=8), 3, 20, device="cpu")
        assert ring["k"].shape[2] == 8
    else:
        assert "k" not in cache


@pytest.fixture(scope="module", params=ARCHS)
def reference_tokens(request):
    jcfg, cfg = _configs(request.param, "float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    want = JaxEngine(jcfg, params, batch_size=2).generate(PROMPTS, max_new_tokens=4)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return cfg, model, want


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_matches_reference_tokens(reference_tokens, impl):
    cfg, model, want = reference_tokens
    run = None if impl == "flash" else RunConfig(attention_impl=impl, attention_chunk=64)
    ops.reset_launches()
    got = ServeEngine(cfg, model, run=run, batch_size=2, device="cpu").generate(
        PROMPTS, max_new_tokens=4)
    assert sum(ops.LAUNCHES.values()) == 0  # the CPU ran the plain versions
    assert [r.prompt for r in got] == PROMPTS
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_generate_wraps_the_ring_buffer_like_the_reference():
    """zamba2 with an 8-position window: a 5-token prompt and 8 new tokens
    write positions 5..11 to ring slots 5, 6, 7, 0, 1, 2, 3."""
    jcfg, cfg = _configs("zamba2-2.7b", "float32", window=8)
    params = jax_init_params(jcfg, jax.random.PRNGKey(1))
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]
    want = JaxEngine(jcfg, params, batch_size=2).generate(prompts, max_new_tokens=8)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    got = ServeEngine(cfg, model, batch_size=2, device="cpu").generate(prompts,
                                                                      max_new_tokens=8)
    assert [len(r.tokens) for r in got] == [8, 8]
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_ring_decode_matches_reference_after_the_wrap():
    """Logits of each decode step past the wrap, against the reference's."""
    jcfg, cfg = _configs("zamba2-2.7b", "float32", window=8)
    params = jax_init_params(jcfg, jax.random.PRNGKey(2))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(B, 16))
    _, jcache = jax_prefill(params, jcfg, JAX_RUN, jnp.asarray(tokens[:, :5]))
    jcache = JaxEngine(jcfg, params, run=JAX_RUN)._grow_cache(jcache, 16, B)
    with torch.inference_mode():
        _, cache = prefill(model, cfg, _run("flash"), torch.from_numpy(tokens[:, :5]),
                           max_len=16)
        for t in range(5, 16):
            want, jcache = jax_decode_step(params, jcfg, JAX_RUN, jcache,
                                           jnp.asarray(tokens[:, t:t + 1]))
            got, cache = decode_step(model, cfg, _run("flash"), cache,
                                     torch.from_numpy(tokens[:, t:t + 1]))
            _close(got, want, TOL["float32"])
    assert cache["pos"] == 16 and cache["k"].shape[2] == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch, capsys):
    ops.reset_launches()
    serve.main(["--device", "cpu", "--arch", arch, "--requests", "3", "--batch-size", "2",
                "--prompt-len", "8", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "tok/s) on cpu" in out
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_random_init_is_seeded(arch):
    _, cfg = _configs(arch, "bfloat16")
    a = Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    block = a.layers[0].mamba
    assert 0.018 < block.in_proj.float().std().item() < 0.022
    assert block.D.float().eq(1).all() and block.A_log.float().eq(0).all()
    assert block.dt_bias.float().eq(0).all() and block.ssm_norm.float().eq(1).all()
    assert a.embed.dtype == torch.bfloat16
