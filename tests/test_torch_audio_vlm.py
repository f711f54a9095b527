"""The port's audio and vlm families against ``repro.models`` on the CPU, on
the reference's own weights (``init_params`` output converted with
``params_from_jax``): the tiny whisper-base (an encoder of 2 layers over 16
stub frame embeddings, a decoder of 2 layers with cross-attention,
sinusoidal positions, no rope) and the tiny phi-3-vision-4.2b (16 stub
patch embeddings before the tokens of a dense stack), both at d_model 128,
through ``forward_hidden``, ``forward_train``, ``prefill``,
``decode_step``, ``ServeEngine.generate``, ``train_step`` and checkpoints
across the packages; and the pieces they add (sinusoidal positions, the
cross-attention block, the vlm's clamped cache write).

Inputs are made from a seed with numpy. Tolerances: f32 2e-5 and bf16 2e-2
on outputs, as tests/test_kernels.py; greedy tokens equal; parameters after
AdamW steps follow tests/test_torch_train.py's sign rule."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_checkpoint as jax_latest
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import RunConfig as JRun
from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.models.transformer import forward_train as jax_forward_train
from repro.serving.engine import ServeEngine as JaxEngine
from repro.train import init_train_state as jax_init_train_state
from repro.train.step import _loss_fn as jax_loss_fn
from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from repro_torch.configs import RunConfig, get_config, list_archs, tiny_variant
from repro_torch.data import DataPipeline, make_batch
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_loop
from repro_torch.models import (Transformer, decode_step, forward_hidden, forward_train,
                                init_cache, prefill)
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax, reference_tree
from repro_torch.serving import ServeEngine
from repro_torch.train import eval_step, train_step
from repro_torch.train.state import init_train_state, load_state_tree, state_tree
from test_torch_train import (_as_np_tree, _graph_nodes, _jax_train_step, _leaves,
                              _port_leaves, assert_params_match)

ARCHS = ("whisper-base", "phi-3-vision-4.2b")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
STEP_TOL = 1e-5
B, S = 2, 9  # the tiny models' frontends hold 16 positions
IMPLS = ("flash", "chunked", "naive")
JAX_RUN = JRun(attention_impl="chunked", attention_chunk=16, remat="none", zero=False)
KW = dict(attention_chunk=16, zero=False, warmup_steps=1, total_steps=10)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11], [12, 13, 14]]


def _run(impl, **kw):
    return RunConfig(attention_impl=impl, attention_chunk=16, remat="none", zero=False, **kw)


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jax_tiny(jax_get_config(arch)), dtype=dtype),
            dataclasses.replace(tiny_variant(get_config(arch)), dtype=dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.detach().float().numpy()


def _frontend(cfg, batch=B, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32)


# ---------------------------------------------------------------------------
# The pieces: sinusoidal positions, cross-attention, the parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length,dim,start", [(16, 128, 0), (1500, 512, 0), (7, 64, 0),
                                              (1, 512, 447), (5, 3072, 1090)])
def test_sinusoidal_positions_equal_reference(length, dim, start):
    """The table of positions start .. start + length - 1. XLA's f32 exp and
    torch's differ in the last bit for some frequencies f (26 of 256 at dim
    512, neither correctly rounded), and the argument p f carries that bit
    times p: held to 2e-6 plus p 2^-23 (1.8e-4 at p 1500, where 6.1e-5 is
    read); sin and cos themselves agree to 6e-8."""
    want = np.asarray(jax_layers.sinusoidal_positions(start + length, dim))[start:]
    got = layers.sinusoidal_positions(length, dim, start=start)
    assert got.dtype == torch.float32 and got.shape == (length, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 + (start + length) * 2.0 ** -23)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("s,t", [(9, 16), (1, 16), (12, 40)])
def test_cross_attention_block_equals_reference(impl, s, t):
    """``attention_block`` with ``kv_x``: K/V from the encoder output, no
    rope, non-causal, S != T."""
    jcfg, cfg = _configs("whisper-base")
    rng = np.random.default_rng(s + t)
    d, hd = cfg.d_model, cfg.n_heads * cfg.d_head
    w = {k: (rng.standard_normal(shape) * 0.05).astype(np.float32)
         for k, shape in (("wq", (d, hd)), ("wk", (d, hd)), ("wv", (d, hd)), ("wo", (hd, d)))}
    x = rng.standard_normal((B, s, d)).astype(np.float32)
    enc = rng.standard_normal((B, t, d)).astype(np.float32)
    pos = np.tile(np.arange(s)[None], (B, 1))
    jrun = JRun(attention_impl="naive" if impl == "naive" else "chunked", attention_chunk=8)
    want, (jk, jv) = jax_layers.attention_block(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x), jcfg, jrun,
        jnp.asarray(pos), kv_x=jnp.asarray(enc), causal=False, use_rope=False)
    params = dataclasses.make_dataclass("P", list(w))(**{k: torch.from_numpy(v)
                                                         for k, v in w.items()})
    got, (k, v) = layers.attention_block(params, torch.from_numpy(x), cfg,
                                         _run(impl), torch.from_numpy(pos),
                                         kv_x=torch.from_numpy(enc), causal=False,
                                         use_rope=False)
    assert k.shape == (B, t, cfg.n_kv_heads, cfg.d_head)
    _close(_np(got), want, TOL["float32"])
    _close(_np(k), jk, TOL["float32"])
    _close(_np(v), jv, TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    """Full width and depth: the port's parameters on the meta device against
    the reference's shapes (``jax.eval_shape``, no memory), leaf for leaf."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda k: jax_init_params(jcfg, k), jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in _leaves_of(shapes).items()}
    model = Transformer(cfg, device="meta")
    got = {k: tuple(v.shape) for k, v in
           _leaves_of(reference_tree(dict(model.named_parameters()), cfg)).items()}
    assert got == want
    n = sum(p.numel() for p in model.parameters())
    assert n == {"whisper-base": 97_173_504, "phi-3-vision-4.2b": 3_821_079_552}[arch]


def _leaves_of(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_leaves_of(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_every_architecture_builds():
    for arch in list_archs():
        cfg = tiny_variant(get_config(arch))
        model = Transformer(cfg, device="meta")
        assert sum(p.numel() for p in model.parameters()) > 0
        cache = init_cache(cfg, 1, 8, device="meta")
        assert cache["pos"] == 0


# ---------------------------------------------------------------------------
# The models on the reference's weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def setup(request):
    arch, dtype = request.param
    jcfg, cfg = _configs(arch, dtype)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_jax(tree, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S))
    return dtype, jcfg, cfg, params, tree, model, tokens, _frontend(cfg)


def test_params_from_jax_round_trip(setup):
    dtype, _, cfg, _, tree, model, _, _ = setup
    back = _port_leaves(reference_tree(dict(model.named_parameters()), cfg))
    want = _leaves(tree)
    assert set(back) == set(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], key)
    if cfg.family == "audio":
        for key in ("enc_layers/attn/wq", "enc_final_norm", "layers/cross/cross_wk",
                    "layers/norm3"):
            assert key in want
        assert model.layers[0].cross.cross_wq.shape == (cfg.d_model, cfg.n_heads * cfg.d_head)
    assert model.embed.dtype == getattr(torch, dtype)


def test_params_from_jax_rejects_mismatched_tree(setup):
    _, _, cfg, _, tree, _, _, _ = setup
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, dataclasses.replace(cfg, d_ff=2 * cfg.d_ff), device="cpu")


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_hidden_matches_reference(setup, impl):
    dtype, jcfg, cfg, params, _, model, tokens, fe = setup
    want, jextras = jax_forward_hidden(params, jcfg, JAX_RUN, jnp.asarray(tokens),
                                       jnp.asarray(fe))
    with torch.inference_mode():
        got, extras = forward_hidden(model, cfg, _run(impl), torch.from_numpy(tokens),
                                     torch.from_numpy(fe))
    offset = cfg.frontend_len if cfg.family == "vlm" else 0
    assert got.shape == (B, offset + S, cfg.d_model) and got.dtype == getattr(torch, dtype)
    # bf16: hidden states of magnitude up to ~4 after the final norm, a bf16
    # step or two apart; the logits below hold the 2e-2 of magnitude ~1.
    _close(_np(got), want, TOL[dtype] * (2 if dtype == "bfloat16" else 1))
    if cfg.family == "audio":
        _close(_np(extras["enc_out"]), jextras["enc_out"], TOL[dtype] * 2)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_forward_train_matches_reference(setup, remat):
    dtype, jcfg, cfg, params, _, model, tokens, fe = setup
    want, _ = jax_forward_train(params, jcfg, JAX_RUN, jnp.asarray(tokens), jnp.asarray(fe))
    run = RunConfig(attention_impl="flash", attention_chunk=16, remat=remat, zero=False)
    with torch.no_grad():
        got, extras = forward_train(model, cfg, run, torch.from_numpy(tokens),
                                    frontend=torch.from_numpy(fe))
    assert extras == {}
    _close(_np(got), want, TOL[dtype] * (2 if dtype == "bfloat16" else 1))


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_prefill_and_decode_match_reference(setup, impl):
    """Prefill on all but the last token (the reference's cache grown to S +
    3 by its engine), then one decode step on it: the logits, and the caches
    k, v (and cross_k, cross_v for audio) and pos."""
    dtype, jcfg, cfg, params, _, model, tokens, fe = setup
    want_pre, jcache = jax_prefill(params, jcfg, JAX_RUN, jnp.asarray(tokens[:, :-1]),
                                   jnp.asarray(fe))
    jcache = JaxEngine(jcfg, params, run=JAX_RUN)._grow_cache(jcache, S + 3, B)
    want_dec, jcache2 = jax_decode_step(params, jcfg, JAX_RUN, jcache,
                                        jnp.asarray(tokens[:, -1:]))
    with torch.inference_mode():
        pre, cache = prefill(model, cfg, _run(impl), torch.from_numpy(tokens[:, :-1]),
                             max_len=S + 3, frontend=torch.from_numpy(fe))
        want_keys = {"k", "v", "pos"} | ({"cross_k", "cross_v"} if cfg.family == "audio"
                                         else set())
        assert set(cache) == want_keys == set(jcache)
        for key in want_keys - {"pos"}:
            assert cache[key].shape == jcache[key].shape, key
            _close(_np(cache[key]), jcache[key], TOL[dtype])
        assert cache["pos"] == int(jcache["pos"])
        dec, cache2 = decode_step(model, cfg, _run(impl), cache, torch.from_numpy(tokens[:, -1:]))
    _close(_np(pre), want_pre, TOL[dtype])
    _close(_np(dec), want_dec, TOL[dtype])
    assert cache2["pos"] == int(jcache2["pos"])
    for key in ("k", "v"):
        _close(_np(cache2[key]), jcache2[key], TOL[dtype])


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_matches_prefill_logits(setup, impl):
    """Teacher-forced decode: the step's logits equal prefill's on the
    prefix, the cache sized to hold the step (for the vlm, F + S slots); in
    bf16 to tests/test_models.py's 0.1."""
    dtype, _, cfg, _, _, model, tokens, fe = setup
    t, f = torch.from_numpy(tokens), torch.from_numpy(fe)
    with torch.inference_mode():
        full, _ = prefill(model, cfg, _run(impl), t, frontend=f)
        _, cache = prefill(model, cfg, _run(impl), t[:, :-1], frontend=f,
                           max_len=cfg.frontend_len + S)
        step, _ = decode_step(model, cfg, _run(impl), cache, t[:, -1:])
    if dtype == "float32":
        _close(_np(step[:, 0]), _np(full[:, -1]), 1e-4)
        assert (step[:, 0].argmax(-1) == full[:, -1].argmax(-1)).all()
    else:
        assert float((step[:, 0] - full[:, -1]).abs().max()) <= 0.1


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_vlm_decode_past_the_cache_mirrors_reference(impl):
    """The reference's vlm cache holds F + S slots after prefill, and its
    engine grows it to S + new tokens only past F new tokens: a decode step
    at position p >= T writes slot T - 1 (``dynamic_update_slice`` clamps)
    and attends all T slots. Three such steps, logits and caches equal to
    the reference's; a dense or audio cache raises instead."""
    jcfg, cfg = _configs("phi-3-vision-4.2b")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(B, S + 3))
    fe = _frontend(cfg)
    _, jcache = jax_prefill(params, jcfg, JAX_RUN, jnp.asarray(tokens[:, :S]), jnp.asarray(fe))
    with torch.inference_mode():
        _, cache = prefill(model, cfg, _run(impl), torch.from_numpy(tokens[:, :S]),
                           frontend=torch.from_numpy(fe))
        t_len = cfg.frontend_len + S
        assert cache["k"].shape[2] == jcache["k"].shape[2] == t_len
        for i in range(3):
            tok = tokens[:, S + i:S + i + 1]
            want, jcache = jax_decode_step(params, jcfg, JAX_RUN, jcache, jnp.asarray(tok))
            got, cache = decode_step(model, cfg, _run(impl), cache, torch.from_numpy(tok))
            _close(_np(got), want, TOL["float32"])
            for key in ("k", "v"):
                _close(_np(cache[key]), jcache[key], TOL["float32"])
            assert cache["pos"] == int(jcache["pos"]) == t_len + i + 1
    for arch in ("tinyllama-1.1b", "whisper-base"):
        other = tiny_variant(get_config(arch))
        m = Transformer(other, device="cpu")
        full = init_cache(other, 1, 4, device="cpu")
        with pytest.raises(ValueError, match="is full"):
            decode_step(m, other, _run(impl), dict(full, pos=4),
                        torch.zeros((1, 1), dtype=torch.long))


def test_audio_needs_its_frontend():
    cfg = tiny_variant(get_config("whisper-base"))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="frontend"):
        forward_hidden(Transformer(cfg, device="cpu"), cfg, _run("flash"), tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launches_per_prefill_and_decode_step(monkeypatch, arch):
    """The kernel forwards of one prefill and one decode step (on the card
    each launches its kernel once): whisper K1 at 2 norms a encoder layer,
    enc_final_norm, 3 a decoder layer (norm1, norm3, norm2) and final_norm;
    K2 at each encoder layer and twice a decoder layer (self, cross); K3
    twice a decoder layer. phi-3-vision as the dense family."""
    cfg = tiny_variant(get_config(arch))
    calls = {"norm": 0, "attention": 0, "decode": 0}
    for key, name in (("norm", "_rmsnorm"), ("attention", "_attention"),
                      ("decode", "decode_attention_plain")):
        real = getattr(ops, name)

        def counted(*a, key=key, real=real, **kw):
            calls[key] += 1
            return real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    model = Transformer(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S)))
    with torch.inference_mode():
        _, cache = prefill(model, cfg, _run("flash"), tokens, max_len=S + cfg.frontend_len + 1,
                           frontend=torch.from_numpy(_frontend(cfg)))
        pre = dict(calls)
        calls.update(norm=0, attention=0, decode=0)
        decode_step(model, cfg, _run("flash"), cache, tokens[:, :1])
    L, E = cfg.n_layers, cfg.n_encoder_layers
    if cfg.family == "audio":
        assert pre == {"norm": 2 * E + 1 + 3 * L + 1, "attention": E + 2 * L, "decode": 0}
        assert calls == {"norm": 3 * L + 1, "attention": 0, "decode": 2 * L}
    else:
        assert pre == {"norm": 2 * L + 1, "attention": L, "decode": 0}
        assert calls == {"norm": 2 * L + 1, "attention": 0, "decode": L}


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    jcfg, cfg = _configs(request.param)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, model, _frontend(cfg, seed=4)


# The vlm's engines grow the cache past the frontend's 16 positions only at
# 20 new tokens; at 4 every step past the prompt + 4 slots writes the last.
@pytest.mark.parametrize("new_tokens", [4, 20])
@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_generate_matches_reference_tokens(served, impl, new_tokens):
    jcfg, cfg, params, model, fe = served
    want = JaxEngine(jcfg, params, batch_size=2).generate(
        PROMPTS, max_new_tokens=new_tokens, frontend=jnp.asarray(fe))
    run = None if impl == "flash" else RunConfig(attention_impl=impl, attention_chunk=64)
    engine = ServeEngine(cfg, model, run=run, batch_size=2, device="cpu")
    got = engine.generate(PROMPTS, max_new_tokens=new_tokens, frontend=torch.from_numpy(fe))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(len(r.tokens) == new_tokens for r in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(capsys, arch):
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "4", "--batch-size", "2",
                "--prompt-len", "8", "--max-new-tokens", "3"])
    assert "4 requests, 12 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's initial state and its state, gradients and metrics
    after each of two steps (remat "none"; remat changes no number), on
    make_batch's tokens and frontend."""
    jcfg, cfg = _configs(request.param)
    jrun = JRun(attention_impl="chunked", remat="none", **KW)
    grad = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=(1, 2))
    jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    initial, history = _as_np_tree(jstate), []
    for i in range(2):
        batch = make_batch(cfg, B, 2 * S + 1, 0, i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jgrads = _leaves(grad(jstate.params, jcfg, jrun, jb)[1])
        jstate, jm = _jax_train_step(jstate, jb, jcfg, jrun)
        history.append((batch, jgrads, jstate, {k: float(v) for k, v in jm.items()}))
    return request.param, jcfg, cfg, initial, history, jrun


@pytest.mark.parametrize("impl,remat", [("flash", "none"), ("flash", "full"),
                                        ("chunked", "none")])
def test_train_step_equals_reference(reference, impl, remat):
    """Two steps of the port against the reference's: metrics, the
    parameters by the AdamW rule after each, and the moments."""
    _, _, cfg, initial, history, _ = reference
    run = RunConfig(attention_impl=impl, remat=remat, **KW)
    state = load_state_tree(init_train_state(cfg, device="cpu"), initial, cfg)
    jgrads = []
    for batch, grads, jstate, jm in history:
        assert "frontend" in batch
        jgrads.append(grads)
        state, m = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              cfg, run)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=k)
        tree = state_tree(state, cfg)
        assert int(tree["step"]) == int(jstate.step)
        assert_params_match(tree["params"], jstate.params, jgrads, jm["lr"], len(jgrads))
        tol = STEP_TOL * (1 if len(jgrads) == 1 else 10)  # as test_torch_train.py
        for part in ("mu", "nu"):
            got, want = _port_leaves(tree["opt"][part]), _leaves(getattr(jstate.opt, part))
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=tol * np.abs(want[key]).max(), err_msg=key)
    for key, g in history[0][1].items():  # every leaf of the reference learns
        assert np.abs(g).max() > 0, key


def test_eval_step_equals_reference(reference):
    _, jcfg, cfg, initial, history, jrun = reference
    state = load_state_tree(init_train_state(cfg, device="cpu"), initial, cfg)
    batch = history[0][0]
    _, jm = jax_loss_fn(jax.tree_util.tree_map(jnp.asarray, initial["params"]), jcfg, jrun,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    m = eval_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                  RunConfig(attention_impl="flash", remat="none", **KW))
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=STEP_TOL, atol=STEP_TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_path_launches_per_step(monkeypatch, arch, remat):
    """The kernel forwards of one train step: per pass over the layers 2 K1
    and one K2 an encoder or vlm layer, 3 K1 and 2 K2 (self and cross) an
    audio decoder layer; enc_final_norm and final_norm outside the layers.
    Under remat each layer's forward runs again in backward."""
    cfg = tiny_variant(get_config(arch))
    calls = {"norm": 0, "attention": 0}
    for key, name in (("norm", "_rmsnorm"), ("attention", "_attention")):
        real = getattr(ops, name)

        def counted(*a, key=key, real=real):
            calls[key] += 1
            return real(*a)

        monkeypatch.setattr(ops, name, counted)
    state = init_train_state(cfg, device="cpu")
    run = RunConfig(attention_impl="flash", remat=remat, **KW)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 2, 16, 0, 0).items()}
    L, E = cfg.n_layers, cfg.n_encoder_layers
    norms, attention, outside = ((2 * E + 3 * L, E + 2 * L, 2) if cfg.family == "audio"
                                 else (2 * L, L, 1))
    if remat == "none":
        hidden, _ = forward_train(state.params, cfg, run, batch["tokens"],
                                  frontend=batch["frontend"])
        nodes = _graph_nodes(hidden)
        assert nodes.count("FusedRMSNormBackward") == norms + outside
        assert nodes.count("FlashAttentionBackward") == attention
    calls.update(norm=0, attention=0)
    train_step(state, batch, cfg, run)
    times = 1 if remat == "none" else 2
    assert calls == {"norm": times * norms + outside, "attention": times * attention}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, reference, writer):
    """A state after one step, written by one package and restored into the
    other (the manifest equal), then stepped in both on the second batch:
    equal by the AdamW rule."""
    _, jcfg, cfg, _, history, jrun = reference
    (_, grads0, jstate, _), (batch, grads1, jnext, jm) = history
    port = load_state_tree(init_train_state(cfg, device="cpu"), _as_np_tree(jstate), cfg)
    if writer == "reference":
        jax_save(tmp_path, int(jstate.step), jstate)
        fresh = init_train_state(cfg, torch.Generator().manual_seed(3), device="cpu")
        tree, step = restore_checkpoint(latest_checkpoint(tmp_path), state_tree(fresh, cfg))
        port = load_state_tree(fresh, tree, cfg)
    else:
        save_checkpoint(tmp_path, int(port.step), state_tree(port, cfg))
        jax_save(tmp_path / "ref", int(jstate.step), jstate)
        manifests = [json.loads((d / "step_00000001" / "manifest.json").read_text())
                     for d in (tmp_path, tmp_path / "ref")]
        assert manifests[0] == manifests[1]
        restored, step = jax_restore(jax_latest(tmp_path),
                                     jax_init_train_state(jcfg, jax.random.PRNGKey(5)))
        want = _leaves(_as_np_tree(jstate))
        for key, got in _leaves(_as_np_tree(restored)).items():
            np.testing.assert_array_equal(got, want[key], key)
        jnext, jm = _jax_train_step(restored, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jcfg, jrun)
        jm = {k: float(v) for k, v in jm.items()}
    assert step == 1 and int(port.step) == 1 and int(port.opt.count) == 1
    run = RunConfig(attention_impl="flash", remat="full", **KW)
    port, m = train_step(port, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, run)
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=STEP_TOL, atol=STEP_TOL)
    assert_params_match(state_tree(port, cfg)["params"], jnext.params, [grads0, grads1],
                        jm["lr"], 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_carries_the_frontend(arch):
    """The pipeline's batches hold make_batch's frontend on the device; for
    the vlm its seq_len counts the patches."""
    cfg = tiny_variant(get_config(arch))
    pipe = DataPipeline(cfg, 2, 40, seed=0, device="cpu")
    try:
        batch = next(pipe)
    finally:
        pipe.close()
    tokens = 40 - (cfg.frontend_len if cfg.family == "vlm" else 0)
    assert batch["tokens"].shape == (2, tokens)
    assert batch["frontend"].shape == (2, cfg.frontend_len, cfg.d_model)
    np.testing.assert_array_equal(batch["frontend"].numpy(),
                                  make_batch(cfg, 2, tokens, 0, 0)["frontend"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_on_cpu(tmp_path, capsys, arch):
    cfg = tiny_variant(get_config(arch))
    run = RunConfig(attention_impl="flash", attention_chunk=16, remat="full", zero=False,
                    warmup_steps=1, total_steps=3)
    state, metrics = train_loop(cfg, run, steps=3, global_batch=2, seq_len=40,
                                ckpt_dir=tmp_path, log_every=1, device="cpu")
    assert "done: 3 steps" in capsys.readouterr().out
    assert [m["step"] for m in metrics] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) for m in metrics) and int(state.step) == 3
    assert [p.name for p in tmp_path.glob("step_*")] == ["step_00000003"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_on_cpu(capsys, arch):
    train_main(["--arch", arch, "--device", "cpu", "--steps", "2", "--global-batch", "2",
                "--seq-len", "24"])
    out = capsys.readouterr().out
    assert "step     1  loss" in out and "done: 2 steps" in out
