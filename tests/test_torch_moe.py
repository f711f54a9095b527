"""The port's moe family against ``repro.models`` on the CPU, on the
reference's own weights (``init_params`` output converted with
``params_from_jax``): the routing of ``models/moe.py`` (ties included), the
two dispatch modes, parameter counts, and the tiny deepseek-moe-16b (one
dense layer, then one MoE layer of 4 experts, top 2, 2 shared experts, d_model
128) through ``forward_hidden``, ``prefill``, ``decode_step``,
``ServeEngine.generate`` and ``train_step``.

Tolerances: f32 1e-4 on logits (summation order only) and 1e-5 on the train
step, as tests/test_torch_model.py and tests/test_torch_train.py; routing
and greedy tokens exactly."""

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
from repro.models.moe import moe_block as jax_moe_block
from repro.models.moe import route_topk as jax_route_topk
from repro.models.moe import route_topk_indices as jax_route_topk_indices
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.serving.engine import ServeEngine as JaxEngine
from repro.train import init_train_state as jax_init_train_state
from repro.train.step import _loss_fn as jax_loss_fn
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.data import make_batch
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.train import main as train_main
from repro_torch.models import (Transformer, decode_step, forward_hidden, forward_train,
                                init_cache, prefill)
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax, reference_tree
from repro_torch.serving import ServeEngine
from repro_torch.train import train_step
from repro_torch.train.state import init_train_state, load_state_tree, state_tree
from test_torch_train import (_as_np_tree, _graph_nodes, _jax_train_step, _leaves,
                              _port_leaves, assert_params_match)

ARCH = "deepseek-moe-16b"
TOL, STEP_TOL = 1e-4, 1e-5
B, S = 2, 37  # 74 tokens: groups of 37, capacity 24
JAX_RUN = JRun(attention_impl="chunked", attention_chunk=16, remat="none", zero=False)
PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11]]


def _run(impl, **kw):
    return RunConfig(attention_impl=impl, attention_chunk=16, remat="none", zero=False, **kw)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _tied_logits(seed, shape):
    """Logits of a few integer levels: most tokens tie across experts."""
    return np.random.default_rng(seed).integers(0, 3, size=shape).astype(np.float32)


def _seeded_logits(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (groups, tokens, experts, top k, capacity): deepseek's top 6 of 64 and
# phi3.5's top 2 of 16 at the decode step's capacity 1 and below and above
# what the tokens need.
ROUTE_CASES = [(2, 16, 8, 2, 8), (1, 40, 64, 6, 5), (3, 4, 64, 6, 1), (2, 24, 16, 2, 3),
               (1, 9, 4, 2, 20)]


@pytest.mark.parametrize("logits", ["seeded", "tied"])
@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_topk_equals_reference(case, logits):
    g, s, e, k, cap = case
    x = (_tied_logits if logits == "tied" else _seeded_logits)(sum(case), (g, s, e))
    jd, jc, jaux = jax_route_topk(jnp.asarray(x), k, cap)
    d, c, aux = moe.route_topk(torch.from_numpy(x), k, cap)
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    _close(_np(c), jc, 1e-6)
    _close(float(aux), float(jaux), 1e-6)
    jidx, jgates, jpos, jkeep, jaux = jax_route_topk_indices(jnp.asarray(x), k, cap)
    idx, gates, pos, keep, aux = moe.route_topk_indices(torch.from_numpy(x), k, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    _close(_np(gates), jgates, 1e-6)
    _close(float(aux), float(jaux), 1e-6)


def test_ties_go_to_the_lower_expert():
    """On tied logits the reference's top k takes the lower expert index
    first, and the order decides who gets a capacity slot. A plain
    ``torch.topk`` orders ties otherwise on these logits, and its dispatch
    differs from the reference's: the case tells the two apart."""
    x = _tied_logits(0, (2, 40, 8))
    jd, _, _ = jax_route_topk(jnp.asarray(x), 2, 6)
    d, _, _ = moe.route_topk(torch.from_numpy(x), 2, 6)
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    probs = torch.softmax(torch.from_numpy(x), dim=-1)
    assert torch.equal(moe._topk(probs, 2)[1], torch.from_numpy(
        np.array(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1])).long())
    topk = moe._topk
    try:
        moe._topk = lambda p, k: torch.topk(p, k)
        plain, _, _ = moe.route_topk(torch.from_numpy(x), 2, 6)
    finally:
        moe._topk = topk
    assert not np.array_equal(_np(plain), np.asarray(jd))


def test_moe_routing_respects_topk():
    """tests/test_models.py's case, through the port."""
    g, s, e, k, cap = 2, 16, 8, 2, 8
    logits = torch.from_numpy(_seeded_logits(3, (g, s, e)))
    dispatch, combine, aux = moe.route_topk(logits, k, cap)
    assert (dispatch.sum(dim=(2, 3)) <= k + 1e-6).all()  # at most k slots a token
    assert dispatch.sum(dim=1).max() <= 1 + 1e-6  # no slot takes two tokens
    cw = combine.sum(dim=(2, 3))
    assert (cw <= 1 + 1e-5).all() and (cw >= 0).all()
    assert float(aux) > 0


@pytest.fixture(scope="module")
def block_setup():
    jcfg = dataclasses.replace(jax_tiny(jax_get_config(ARCH)), dtype="float32")
    cfg = dataclasses.replace(tiny_variant(get_config(ARCH)), dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(1)))
    model = params_from_jax(tree, cfg, device="cpu")
    return jcfg, cfg, tree, model


@pytest.mark.parametrize("tokens", [(2, 37), (1, 4), (4, 64)])
def test_moe_block_dispatch_modes_equal_reference(block_setup, tokens):
    """Both dispatch modes, the group size and capacity of the token count
    (74 tokens: groups of 37, capacity 24; 4: one group, capacity 2; 256:
    groups of 64), against the reference's einsum mode."""
    jcfg, cfg, tree, model = block_setup
    x = np.random.default_rng(sum(tokens)).standard_normal((*tokens, cfg.d_model))
    x = x.astype(np.float32)
    jparams = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    jy, jaux = jax_moe_block(jparams, jnp.asarray(x), jcfg)
    got = {mode: moe.moe_block(model.layers[0].moe, torch.from_numpy(x), cfg, mode)
           for mode in ("einsum", "gather")}
    for y, aux in got.values():
        _close(_np(y), jy, 1e-5)
        _close(float(aux), float(jaux), 1e-6)
    _close(_np(got["gather"][0]), _np(got["einsum"][0]), 1e-6)


@pytest.mark.parametrize("mode", ["sparse", "dense", ""])
def test_moe_block_other_dispatch_modes_run_einsum(block_setup, mode):
    """Any mode but "gather" runs the einsum path, in both packages."""
    jcfg, cfg, tree, model = block_setup
    x = np.random.default_rng(len(mode)).standard_normal((2, 37, cfg.d_model))
    x = x.astype(np.float32)
    jparams = {k: v[0] for k, v in tree["layers"]["moe"].items()}
    jy, jaux = jax_moe_block(jparams, jnp.asarray(x), jcfg, dispatch_mode=mode)
    y, aux = moe.moe_block(model.layers[0].moe, torch.from_numpy(x), cfg, mode)
    _close(_np(y), jy, 1e-5)
    _close(float(aux), float(jaux), 1e-6)
    einsum, _ = moe.moe_block(model.layers[0].moe, torch.from_numpy(x), cfg, "einsum")
    assert torch.equal(y, einsum)


@pytest.mark.parametrize("arch,bounds", [("deepseek-moe-16b", (14e9, 18e9)),
                                         ("phi3.5-moe-42b-a6.6b", (39e9, 45e9))])
def test_param_counts_on_meta(arch, bounds):
    """tests/test_models.py's bounds, counted from the port's parameters on
    the meta device (no memory)."""
    cfg = get_config(arch)
    model = Transformer(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert bounds[0] <= n <= bounds[1]
    assert n == cfg.param_count() + cfg.d_model  # the spec leaves out final_norm


# ---------------------------------------------------------------------------
# The model on the reference's weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_tiny(jax_get_config(ARCH)), dtype="float32")
    cfg = dataclasses.replace(tiny_variant(get_config(ARCH)), dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_jax(tree, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S))
    return jcfg, cfg, params, tree, model, tokens


def test_params_from_jax_round_trip(setup):
    _, cfg, _, tree, model, _ = setup
    back = _port_leaves(reference_tree(dict(model.named_parameters()), cfg))
    want = _leaves(tree)
    assert set(back) == set(want)
    assert "layers/moe/router" in want and "dense_layers/mlp/wi" in want
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], key)
    assert model.layers[0].moe.moe_wi.shape == (cfg.moe_experts, cfg.d_model,
                                                2 * cfg.moe_d_ff)


def test_params_from_jax_rejects_mismatched_tree(setup):
    _, cfg, _, tree, _, _ = setup
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, dataclasses.replace(cfg, moe_experts=2 * cfg.moe_experts),
                        device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(tree, dataclasses.replace(cfg, moe_first_dense=0), device="cpu")


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_forward_hidden_matches_reference(setup, impl, dispatch):
    jcfg, cfg, params, _, model, tokens = setup
    want, jextras = jax_forward_hidden(params, jcfg, JAX_RUN, jnp.asarray(tokens))
    with torch.inference_mode():
        got, extras = forward_hidden(model, cfg, _run(impl, moe_dispatch=dispatch),
                                     torch.from_numpy(tokens))
    _close(_np(got), want)
    assert float(extras["aux"]) > 0
    _close(float(extras["aux"]), float(jextras["aux"]), 1e-6)


@pytest.mark.parametrize("impl,pos", [("flash", "int"), ("chunked", "int"),
                                      ("flash", "tensor"), ("chunked", "tensor")],
                         ids=["flash", "chunked", "flash-device-pos", "chunked-device-pos"])
def test_prefill_and_decode_match_reference(setup, impl, pos):
    """Prefill on all but the last token, then one decode step on it, whose
    4 tokens route as one group of capacity 1 in both packages; the step's
    position is the int prefill gives or that int as a 0-d tensor (the
    engine's replayed step)."""
    jcfg, cfg, params, _, model, tokens = setup
    want_pre, jcache = jax_prefill(params, jcfg, JAX_RUN, jnp.asarray(tokens[:, :-1]))
    jcache = JaxEngine(jcfg, params, run=JAX_RUN)._grow_cache(jcache, S + 3, B)
    want_dec, _ = jax_decode_step(params, jcfg, JAX_RUN, jcache, jnp.asarray(tokens[:, -1:]))
    with torch.inference_mode():
        run = _run(impl)
        pre, cache = prefill(model, cfg, run, torch.from_numpy(tokens[:, :-1]), max_len=S + 3)
        assert set(cache) == {"k", "v", "dk", "dv", "pos"}
        assert cache["dk"].shape == (cfg.moe_first_dense, B, S + 3, cfg.n_kv_heads, cfg.d_head)
        for key in ("k", "v", "dk", "dv"):
            _close(_np(cache[key][:, :, :S - 1]), jcache[key][:, :, :S - 1])
        if pos == "tensor":
            cache["pos"] = torch.tensor(cache["pos"])
        dec, cache = decode_step(model, cfg, run, cache, torch.from_numpy(tokens[:, -1:]))
    _close(_np(pre), want_pre)
    _close(_np(dec), want_dec)
    assert int(cache["pos"]) == S


def test_init_cache_shapes(setup):
    _, cfg, _, _, _, _ = setup
    cache = init_cache(cfg, 3, 10, device="cpu")
    n_moe = cfg.n_layers - cfg.moe_first_dense
    assert cache["k"].shape == (n_moe, 3, 10, cfg.n_kv_heads, cfg.d_head)
    assert cache["dv"].shape == (cfg.moe_first_dense, 3, 10, cfg.n_kv_heads, cfg.d_head)
    no_dense = init_cache(dataclasses.replace(cfg, moe_first_dense=0), 3, 10, device="cpu")
    assert set(no_dense) == {"k", "v", "pos"}


@pytest.fixture(scope="module")
def reference_tokens(setup):
    jcfg, _, params, _, _, _ = setup
    return JaxEngine(jcfg, params, batch_size=2).generate(PROMPTS, max_new_tokens=4)


@pytest.mark.parametrize("impl", ["flash", "chunked"])
def test_generate_matches_reference_tokens(setup, reference_tokens, impl):
    _, cfg, _, _, model, _ = setup
    run = None if impl == "flash" else RunConfig(attention_impl=impl, attention_chunk=64)
    got = ServeEngine(cfg, model, run=run, batch_size=2, device="cpu").generate(
        PROMPTS, max_new_tokens=4)
    assert [r.tokens for r in got] == [r.tokens for r in reference_tokens]


def test_serve_cli_runs_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--batch-size", "2",
                "--prompt-len", "8", "--max-new-tokens", "3"])
    assert "2 requests, 6 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


KW = dict(attention_chunk=16, zero=False, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_equals_reference(setup, remat):
    """Two steps of the port (kernel path) against the reference's, the aux
    loss among the metrics (the total loss adds 0.01 aux in both)."""
    jcfg, cfg, _, _, _, _ = setup
    jrun = JRun(attention_impl="chunked", remat="none", **KW)
    run = RunConfig(attention_impl="flash", remat=remat, **KW)
    jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    state = load_state_tree(init_train_state(cfg, device="cpu"), _as_np_tree(jstate), cfg)
    grad = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=(1, 2))
    jgrads = []
    for i in range(2):
        batch = make_batch(cfg, B, S, 0, i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jgrads.append(_leaves(grad(jstate.params, jcfg, jrun, jb)[1]))
        jstate, jm = _jax_train_step(jstate, jb, jcfg, jrun)
        state, m = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              cfg, run)
        assert set(m) == set(jm) and float(m["aux"]) > 0
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=k)
        tree = state_tree(state, cfg)
        assert_params_match(tree["params"], jstate.params, jgrads, float(jm["lr"]),
                            len(jgrads))
        for key, g in jgrads[-1].items():  # the router and every expert tensor learn
            if "/moe/" in key:
                assert np.abs(g).max() > 0, key


@pytest.mark.parametrize("remat", ["none", "full"])
def test_kernel_path_launches_per_step(monkeypatch, setup, remat):
    """K1 at both norms of every layer and the final norm, K2 at every
    attention layer; under remat each layer's forward runs again."""
    _, cfg, _, _, _, _ = setup
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
    L = cfg.n_layers
    if remat == "none":
        hidden, extras = forward_train(state.params, cfg, run, batch["tokens"])
        nodes = _graph_nodes(hidden)
        assert nodes.count("FusedRMSNormBackward") == 2 * L + 1
        assert nodes.count("FlashAttentionBackward") == L
        assert extras["aux"].requires_grad
    calls.update(norm=0, attention=0)
    train_step(state, batch, cfg, run)
    times = 1 if remat == "none" else 2
    assert calls == {"norm": times * 2 * L + 1, "attention": times * L}


def test_train_cli_runs_on_cpu(capsys):
    train_main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--global-batch", "2",
                "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "step     1  loss" in out and "done: 2 steps" in out
