"""The port's training slice against the JAX package on the CPU, on the same
numpy inputs: the autograd Functions of K1 and K2 (``ops.FusedRMSNorm``,
``ops.FlashAttention``) against ``jax.vjp`` of the reference's
``rms_norm``, ``naive_attention`` and ``chunked_attention``; the loss,
AdamW, the schedule, the global norm and int8 compression; ``train_step``
and ``eval_step`` of the tiny tinyllama on the reference's own weights;
the data pipeline; the fault-tolerance helpers; and ``train_loop``.

On the CPU the Functions run the kernels' plain versions forward and the
same hand-written backward the card runs (their ``grad_fn`` is checked).

Tolerances: f32 1e-5 (summation order only). AdamW's first step moves each
element by about ``lr * g / |g|``, so an element whose gradient is within
the gradients' own rounding of 0 (|g| <= 1e-5 of its tensor's largest) can
move the other way in one package than in the other: such elements are
bounded by 2 lr a step, every other element by the f32 tolerance. Under
int8 compression an element whose scaled gradient sits within rounding of
a quantization boundary (|g| / scale within 1e-3 of a half-integer) can
round to the next level; it is bounded the same way."""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny
from repro.data import make_batch as jax_make_batch
from repro.models import layers as jax_layers
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import global_norm as jax_global_norm
from repro.optim.adamw import compress_int8 as jax_compress_int8
from repro.train import cross_entropy_loss as jax_ce
from repro.train import eval_step as jax_eval_step
from repro.train import init_train_state as jax_init_train_state
from repro.train import train_step as jax_train_step
from repro.train.step import _loss_fn as jax_loss_fn
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.data import DataPipeline, make_batch
from repro_torch.kernels import ops
from repro_torch.launch.ft import HeartbeatRegistry, StragglerDetector, Supervisor
from repro_torch.launch.train import train_loop
from repro_torch.models import forward_train
from repro_torch.models.convert import reference_tree
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule, global_norm
from repro_torch.optim.adamw import compress_int8, decompress_int8
from repro_torch.train import cross_entropy_loss, eval_step, train_step
from repro_torch.train.state import init_train_state, load_state_tree, state_tree
from repro_torch.train.step import _grads

TOL = 1e-5
B, S = 4, 37  # S is a multiple of no attention chunk, kernel block or loss chunk
KW = dict(attention_chunk=16, remat="none", zero=False, warmup_steps=1, total_steps=10)


# The reference's functions, jitted (op by op they take seconds a call).
_jax_train_step = jax.jit(jax_train_step, static_argnums=(2, 3))
_jax_value_and_grad = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True),
                              static_argnums=(1, 2))


def _jax_vjp(fn, *args):
    """fn(*args) and its vjp at the last argument, jitted."""
    return jax.jit(lambda *a: (lambda out, vjp: (out, vjp(a[-1])))(*jax.vjp(fn, *a[:-1])))(
        *args)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# The autograd Functions of K1 and K2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 9, 128), (5, 2050), (1, 3, 64)])
def test_rmsnorm_function_grads_equal_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x, g = rng.standard_normal(shape).astype(np.float32), \
        rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    out, (jdx, jdw) = _jax_vjp(lambda x, w: jax_layers.rms_norm(x, w, 1e-5), jnp.asarray(x),
                               jnp.asarray(w), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = ops.fused_rmsnorm(xt, wt, eps=1e-5)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    _close(_np(y), out)
    _close(_np(dx), jdx)
    _close(_np(dw), jdw)


# (s, t, h, kv, d, causal, window, q_offset, softcap): G = h / kv of 1, 2, 4.
ATTENTION_CASES = [
    (37, 37, 4, 1, 32, True, 0, 0, 0.0),     # G 4, ragged S
    (37, 37, 4, 2, 32, True, 0, 0, 0.0),     # G 2
    (37, 37, 4, 4, 32, True, 0, 0, 0.0),     # G 1
    (64, 64, 4, 2, 64, True, 9, 0, 0.0),     # window
    (40, 40, 4, 4, 80, True, 0, 0, 30.0),    # softcap at D 80
    (33, 33, 4, 1, 32, True, 5, 0, 20.0),    # window and softcap
    (20, 50, 4, 2, 32, True, 0, 30, 0.0),    # query offset
    (25, 25, 4, 2, 32, False, 0, 0, 0.0),    # not causal
    (12, 40, 4, 4, 32, False, 0, 0, 0.0),    # not causal, S != T (cross-attention)
    (37, 16, 4, 2, 32, False, 0, 0, 0.0),    # not causal, S > T
    (3, 4, 2, 1, 8, True, 2, 6, 0.0),        # no query sees a key: zeros
]


def _attention_inputs(seed, s, t, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, s, h, d), (B, t, kv, d), (B, t, kv, d), (B, s, h, d))]


@pytest.mark.parametrize("case", ATTENTION_CASES)
def test_attention_function_grads_equal_jax(case):
    s, t, h, kv, d, causal, window, q_offset, softcap = case
    q, k, v, g = _attention_inputs(s + 7 * t + h, s, t, h, kv, d)
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, **kw)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    refs = [lambda q, k, v: jax_layers.naive_attention(q, k, v, **kw)]
    if t % 16 == 0:  # the reference's chunked path needs T in whole chunks
        refs.append(lambda q, k, v: jax_layers.chunked_attention(q, k, v, chunk=16, **kw))
    if t > q_offset - window + 1 or window == 0:
        for ref in refs:
            jout, jgrads = _jax_vjp(ref, *(jnp.asarray(a) for a in (q, k, v, g)))
            _close(_np(out), jout)
            for got, want in zip(grads, jgrads):
                _close(_np(got), want)
    else:  # the reference gives such queries the mean of V; the kernel gives 0
        assert not out.detach().abs().any()
        assert not any(gr.abs().any() for gr in grads)


# gradcheck differentiates numerically, one forward per input element and
# side: batch 1, D 4. (s, t, h, kv, causal, window, q_offset, softcap)
GRADCHECK_CASES = [
    (5, 5, 2, 1, True, 0, 0, 0.0),      # G 2, causal
    (5, 5, 2, 2, True, 3, 0, 0.0),      # G 1, window
    (4, 6, 2, 1, True, 0, 2, 2.0),      # query offset, softcap
    (4, 4, 2, 1, True, 2, 3, 1.5),      # offset, window and softcap
    (5, 5, 2, 1, False, 0, 0, 0.0),     # not causal
    (3, 7, 2, 2, False, 0, 0, 0.0),     # not causal, S != T
]


@pytest.mark.parametrize("case", GRADCHECK_CASES)
def test_attention_function_gradcheck_f64(case):
    s, t, h, kv, causal, window, q_offset, softcap = case
    rng = np.random.default_rng(s + 10 * t + kv)
    inputs = tuple(torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
                   for shape in ((1, s, h, 4), (1, t, kv, 4), (1, t, kv, 4)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    assert torch.autograd.gradcheck(lambda q, k, v: ops.flash_attention(q, k, v, **kw), inputs)


def test_rmsnorm_function_gradcheck_f64():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 8))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal(8)).requires_grad_()
    assert torch.autograd.gradcheck(lambda x, w: ops.fused_rmsnorm(x, w), (x, w))


def test_grad_fn_is_the_function():
    x = torch.randn(2, 8, requires_grad=True)
    w = torch.ones(8, requires_grad=True)
    assert type(ops.fused_rmsnorm(x, w).grad_fn).__name__ == "FusedRMSNormBackward"
    q = torch.randn(1, 5, 4, 8, requires_grad=True)
    k = torch.randn(1, 5, 2, 8, requires_grad=True)
    assert type(ops.flash_attention(q, k, k).grad_fn).__name__ == "FlashAttentionBackward"
    # Without grad the wrappers skip the Functions, as the serve paths do.
    with torch.no_grad():
        assert ops.fused_rmsnorm(x, w).grad_fn is None
    assert ops.flash_attention(q.detach(), k.detach(), k.detach()).grad_fn is None


def _graph_nodes(t):
    seen, stack = set(), [t.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        stack.extend(n for n, _ in node.next_functions)
    return [type(n).__name__ for n in seen]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_kernel_path_launches_per_step(monkeypatch, remat):
    """Counts the Functions' forward calls of one train step (on the card,
    each launches its kernel once): 2L + 1 norms and L attentions per
    forward; under remat each block's forward runs again in backward (the
    final norm is outside the blocks), so 4L + 1 and 2L."""
    cfg = tiny_variant(get_config("tinyllama-1.1b"))
    calls = {"norm": 0, "attention": 0}
    real_norm, real_attn = ops._rmsnorm, ops._attention

    def norm(*a):
        calls["norm"] += 1
        return real_norm(*a)

    def attn(*a):
        calls["attention"] += 1
        return real_attn(*a)

    monkeypatch.setattr(ops, "_rmsnorm", norm)
    monkeypatch.setattr(ops, "_attention", attn)
    state = init_train_state(cfg, device="cpu")
    run = RunConfig(attention_impl="flash", **dict(KW, remat=remat))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 2, 16, 0, 0).items()}
    hidden, _ = forward_train(state.params, cfg, run, batch["tokens"])
    nodes = _graph_nodes(hidden)
    if remat == "none":
        assert nodes.count("FusedRMSNormBackward") == 2 * cfg.n_layers + 1
        assert nodes.count("FlashAttentionBackward") == cfg.n_layers
    calls.update(norm=0, attention=0)
    train_step(state, batch, cfg, run)
    L = cfg.n_layers
    assert calls == ({"norm": 2 * L + 1, "attention": L} if remat == "none"
                     else {"norm": 4 * L + 1, "attention": 2 * L})


# ---------------------------------------------------------------------------
# Loss and optimizer (tests/test_substrate.py's cases, through both packages)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 8, 12])
@pytest.mark.parametrize("vocab", [48, 0])
def test_cross_entropy_loss_equals_reference(chunk, vocab):
    rng = np.random.default_rng(chunk + vocab)
    hidden = rng.standard_normal((2, 12, 16)).astype(np.float32)
    head = rng.standard_normal((16, 64)).astype(np.float32)  # padded past vocab 48
    labels = rng.integers(0, vocab or 64, size=(2, 12)).astype(np.int32)
    (jl, ja), (jdh, jdw) = _jax_vjp(
        lambda h, w: jax_ce(h, w, jnp.asarray(labels), chunk=chunk, vocab=vocab),
        jnp.asarray(hidden), jnp.asarray(head), (jnp.ones(()), jnp.zeros(())))
    ht, wt = (torch.from_numpy(a).requires_grad_() for a in (hidden, head))
    loss, acc = cross_entropy_loss(ht, wt, torch.from_numpy(labels), chunk=chunk, vocab=vocab)
    dh, dw = torch.autograd.grad(loss, (ht, wt))
    _close(float(loss.detach()), float(jl))
    assert float(acc) == pytest.approx(float(ja), abs=1e-7)
    _close(_np(dh), jdh)
    _close(_np(dw), jdw)
    if vocab:
        assert not dw[:, vocab:].any()  # the padding takes no gradient


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, opt, _ = adamw_update(params, grads, opt, lr=torch.tensor(0.05),
                                      weight_decay=0.0, grad_clip=0.0)
    assert float(params["w"].abs().max()) < 0.2
    assert int(opt.count) == 200


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    _, _, metrics = adamw_update(params, {"w": torch.full((4,), 1e6)}, adamw_init(params),
                                 lr=torch.tensor(1e-3), grad_clip=1.0)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


@pytest.mark.parametrize("grad_clip,weight_decay,dtype", [
    (1.0, 0.1, "float32"), (0.0, 0.0, "float32"), (1.0, 0.1, "bfloat16")])
def test_adamw_update_equals_reference(grad_clip, weight_decay, dtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (17, 5), "b": (33,), "c": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    tp = {k: torch.from_numpy(np.array(jp[k], np.float32)).to(getattr(torch, dtype))
          for k in params}
    jopt, topt = jax_adamw_init(jp), adamw_init(tp)
    for step in range(3):
        grads = {k: np.asarray(rng.standard_normal(s) * 3, np.float32)
                 for k, s in shapes.items()}
        lr = 1e-3 * (step + 1)
        jp, jopt, jm = jax_adamw_update(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                                        jopt, jnp.asarray(lr, jnp.float32),
                                        weight_decay=weight_decay, grad_clip=grad_clip)
        tp, topt, tm = adamw_update(tp, {k: torch.from_numpy(v) for k, v in grads.items()},
                                    topt, torch.tensor(lr), weight_decay=weight_decay,
                                    grad_clip=grad_clip)
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]))
        for k in shapes:
            # bf16 parameters round the f32 update to bf16: one bf16 step.
            tol = TOL if dtype == "float32" else 2 ** -7
            _close(_np(tp[k]), np.asarray(jp[k], np.float32), tol)
            _close(_np(topt.mu[k]), jopt.mu[k])
            _close(_np(topt.nu[k]), jopt.nu[k])
    assert int(topt.count) == int(jopt.count) == 3


def test_cosine_schedule_equals_reference():
    for warmup, total in ((10, 100), (0, 50), (20, 20)):
        for step in (0, 1, 9, 10, 11, 55, 99, 100, 150):
            want = float(jax_cosine(jnp.asarray(step), 1e-3, warmup, total))
            assert float(cosine_schedule(step, 1e-3, warmup, total)) == \
                pytest.approx(want, rel=1e-6)
    lr0, lr9 = (float(cosine_schedule(torch.tensor(s), 1e-3, 10, 100)) for s in (0, 9))
    lr_mid, lr_end = (float(cosine_schedule(s, 1e-3, 10, 100)) for s in (55, 99))
    assert 0 < lr0 < lr9 <= 1e-3 + 1e-9
    assert lr_end < lr_mid < 1e-3


def test_global_norm_equals_reference():
    assert float(global_norm({"a": torch.ones(3), "b": torch.ones(4)})) == \
        pytest.approx(np.sqrt(7.0))
    rng = np.random.default_rng(0)
    tree = {k: rng.standard_normal((8, n)).astype(np.float32) for k, n in (("x", 3), ("y", 9))}
    want = float(jax_global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = float(global_norm({k: torch.from_numpy(v) for k, v in tree.items()}))
    assert got == pytest.approx(want, rel=1e-6)


def test_int8_compression_equals_reference():
    g = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32) * 3.0
    jq, jscale = jax_compress_int8(jnp.asarray(g))
    q, scale = compress_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))  # q exact
    rec = decompress_int8(q, scale)
    assert float((rec - torch.from_numpy(g)).abs().max()) <= float(scale) * 0.51
    assert q.numel() * q.element_size() * 4 == g.nbytes


# ---------------------------------------------------------------------------
# train_step / eval_step on the reference's weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    jcfg = dataclasses.replace(jax_tiny(jax_get_config("tinyllama-1.1b")), dtype="float32")
    cfg = dataclasses.replace(tiny_variant(get_config("tinyllama-1.1b")), dtype="float32")
    state = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, state


def _as_np_tree(jax_state):
    tree = jax.tree_util.tree_map(np.asarray, jax_state._asdict())
    tree["opt"] = tree["opt"]._asdict()
    return tree


def _leaves(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    return {k: _np(v) for k, v in _leaves_torch(tree, "")}


def _leaves_torch(tree, prefix):
    for k, v in sorted(tree.items()):
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves_torch(v, key)
        else:
            yield key, v


def assert_params_match(port_params, jax_params, jax_grads, lr, steps, slack=None):
    """The AdamW rule of the module docstring: every element within the f32
    tolerance, or within ``2 lr`` a step where its gradient at some step was
    within rounding of 0 (or ``slack`` marks it)."""
    got, want = _port_leaves(port_params), _leaves(jax_params)
    assert set(got) == set(want)
    for key, w in want.items():
        off = np.abs(got[key] - w) > TOL * (1 + np.abs(w))
        if not off.any():
            continue
        near_zero = np.zeros_like(off)
        for grads in jax_grads:
            g = np.abs(grads[key])
            near_zero |= g <= TOL * g.max()
        if slack is not None:
            near_zero |= slack[key]
        assert near_zero[off].all(), f"{key}: {off.sum()} elements off, not near 0"
        assert np.abs(got[key] - w)[off].max() <= 2 * lr * steps + TOL, key
        assert off.mean() < 1e-3, f"{key}: {off.mean()} of elements off"


def _batches(cfg, n, seed=0):
    return [make_batch(cfg, B, S, seed, i) for i in range(n)]


@pytest.mark.parametrize("impl,microbatch", [("flash", 0), ("chunked", 0), ("flash", 2)])
def test_train_step_equals_reference(reference, impl, microbatch):
    jcfg, cfg, jstate = reference
    kw = dict(KW, microbatch=microbatch)
    jrun, run = JRun(attention_impl="chunked", **kw), RunConfig(attention_impl=impl, **kw)
    state = load_state_tree(init_train_state(cfg, device="cpu"), _as_np_tree(jstate), cfg)
    jgrads = []
    for batch in _batches(cfg, 2):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jgrads.append(_leaves(_jax_value_and_grad(jstate.params, jcfg, jrun, jb)[1]))
        jstate, jm = _jax_train_step(jstate, jb, jcfg, jrun)
        state, m = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              cfg, run)
        assert set(m) == set(jm)
        for k in jm:
            _close(float(m[k]), float(jm[k]))
        tree = state_tree(state, cfg)
        assert int(tree["step"]) == int(jstate.step)
        assert_params_match(tree["params"], jstate.params, jgrads, float(jm["lr"]),
                            len(jgrads))
        # The moments follow the gradients: to the f32 tolerance (of each
        # tensor's largest) after one step; after two, to 10 times that, since
        # the elements the first step moved the other way (by 2 lr) change
        # the second gradient by more than summation order does.
        tol = TOL * (1 if len(jgrads) == 1 else 10)
        for part in ("mu", "nu"):
            got, want = _port_leaves(tree["opt"][part]), _leaves(getattr(jstate.opt, part))
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=tol * np.abs(want[key]).max())


def test_train_step_gradients_equal_reference(reference):
    jcfg, cfg, jstate = reference
    jrun, run = JRun(attention_impl="chunked", **KW), RunConfig(attention_impl="flash", **KW)
    state = load_state_tree(init_train_state(cfg, device="cpu"), _as_np_tree(jstate), cfg)
    batch = _batches(cfg, 1)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, _), jg = _jax_value_and_grad(jstate.params, jcfg, jrun, jb)
    total, _, grads = _grads(state.params, cfg, run,
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(float(total), float(jtotal))
    got, want = _port_leaves(reference_tree(grads, cfg)), _leaves(jg)
    assert set(got) == set(want)
    for key, w in want.items():  # every parameter has a gradient, wq/wk/wv and norms too
        assert np.abs(got[key]).max() > 0, key
        np.testing.assert_allclose(got[key], w, rtol=0, atol=TOL * np.abs(w).max())


def test_train_step_int8_equals_reference(reference):
    """One step under int8 compression: q is exact where the packages'
    gradients round alike; elements at a rounding boundary of q move by at
    most 2 lr (see the module docstring)."""
    jcfg, cfg, jstate = reference
    kw = dict(KW, grad_compression="int8")
    jrun, run = JRun(attention_impl="chunked", **kw), RunConfig(attention_impl="flash", **kw)
    state = load_state_tree(init_train_state(cfg, device="cpu"), _as_np_tree(jstate), cfg)
    batch = _batches(cfg, 1)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = _leaves(_jax_value_and_grad(jstate.params, jcfg, jrun, jb)[1])
    boundary = {}
    for key, g in jg.items():
        scaled = np.abs(g) / (np.abs(g).max() / 127.0)
        boundary[key] = np.abs(scaled - np.floor(scaled) - 0.5) <= 1e-3
    jstate, jm = _jax_train_step(jstate, jb, jcfg, jrun)
    state, m = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, run)
    for k in jm:
        _close(float(m[k]), float(jm[k]))
    assert_params_match(state_tree(state, cfg)["params"], jstate.params, [jg],
                        float(jm["lr"]), 1, slack=boundary)


def test_train_step_with_grad_compression_trains():
    cfg = tiny_variant(get_config("tinyllama-1.1b"))
    run = RunConfig(attention_impl="flash", attention_chunk=32, remat="none", zero=False,
                    grad_compression="int8", warmup_steps=1, total_steps=10)
    state = init_train_state(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 32)))
    batch = {"tokens": tokens, "labels": tokens}
    state, m1 = train_step(state, batch, cfg, run)
    assert np.isfinite(float(m1["loss"]))
    _, m2 = train_step(state, batch, cfg, run)
    assert float(m2["loss"]) != float(m1["loss"])  # params moved


def test_eval_step_equals_reference(reference):
    jcfg, cfg, jstate = reference
    jrun, run = JRun(attention_impl="chunked", **KW), RunConfig(attention_impl="flash", **KW)
    state = load_state_tree(init_train_state(cfg, device="cpu"), _as_np_tree(jstate), cfg)
    batch = _batches(cfg, 1, seed=5)[0]
    jm = jax_eval_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, jrun)
    m = eval_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, run)
    assert set(m) == set(jm)
    for k in jm:
        _close(float(m[k]), float(jm[k]))
    assert m["loss"].grad_fn is None


# ---------------------------------------------------------------------------
# Data pipeline (tests/test_ft.py's and test_substrate.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "phi-3-vision-4.2b", "whisper-base"])
def test_make_batch_bit_equal_to_reference(arch):
    cfg, jcfg = tiny_variant(get_config(arch)), jax_tiny(jax_get_config(arch))
    for seed, step in ((0, 0), (0, 10), (3, 7), (12345, 999)):
        got, want = make_batch(cfg, 4, 32, seed, step), jax_make_batch(jcfg, 4, 32, seed, step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_data_determinism_and_restart_safety():
    cfg = tiny_variant(get_config("tinyllama-1.1b"))
    a, b, c = (make_batch(cfg, 4, 32, seed=0, step=s) for s in (10, 10, 11))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    pipe = DataPipeline(cfg, batch=4, seq=32, seed=0, start_step=10, device="cpu")
    try:
        first = next(pipe)
        assert first["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(first["tokens"].numpy(), a["tokens"])
        np.testing.assert_array_equal(next(pipe)["tokens"].numpy(), c["tokens"])
        assert pipe.step == 12
    finally:
        pipe.close()


def test_data_pipeline_prefetch():
    pipe = DataPipeline(tiny_variant(get_config("tinyllama-1.1b")), batch=2, seq=16, seed=3,
                        device="cpu")
    b1, b2 = next(pipe), next(pipe)
    assert b1["tokens"].shape == (2, 16)
    assert not torch.equal(b1["tokens"], b2["tokens"])
    pipe.close()


def test_pipeline_producer_exception_propagates():
    class FailingPipeline(DataPipeline):
        def _produce_one(self, step):
            if step >= 2:
                raise ValueError(f"corrupt shard at step {step}")
            return super()._produce_one(step)

    pipe = FailingPipeline(tiny_variant(get_config("tinyllama-1.1b")), batch=2, seq=16,
                           device="cpu")
    assert next(pipe)["tokens"].shape == (2, 16)
    assert next(pipe)["tokens"].shape == (2, 16)
    with pytest.raises(RuntimeError, match="producer failed.*corrupt shard"):
        next(pipe)
    pipe.close()


def test_pipeline_immediate_failure_does_not_hang():
    class DeadOnArrival(DataPipeline):
        def _produce_one(self, step):
            raise KeyError("missing field")

    pipe = DeadOnArrival(tiny_variant(get_config("tinyllama-1.1b")), batch=2, seq=16,
                         device="cpu")
    with pytest.raises(RuntimeError) as ei:
        next(pipe)
    assert isinstance(ei.value.__cause__, KeyError)
    pipe.close()


def test_pipeline_close_surfaces_stuck_thread():
    release = threading.Event()

    class StuckPipeline(DataPipeline):
        def _producer(self):
            release.wait()  # ignores _stop: a wedged copy to the device

    pipe = StuckPipeline(tiny_variant(get_config("tinyllama-1.1b")), batch=2, seq=16,
                         device="cpu")
    try:
        with pytest.raises(RuntimeError, match="failed to stop"):
            pipe.close(timeout=0.1)
    finally:
        release.set()
        pipe._thread.join(timeout=2.0)
    assert not pipe._thread.is_alive()


# ---------------------------------------------------------------------------
# Heartbeats, stragglers, supervised restarts (tests/test_ft.py's cases)
# ---------------------------------------------------------------------------


def test_heartbeat_registry():
    hb = HeartbeatRegistry(timeout_s=10.0)
    hb.beat("h0", now=100.0)
    hb.beat("h1", now=100.0)
    assert hb.dead_hosts(now=105.0) == []
    assert hb.dead_hosts(now=111.0) == ["h0", "h1"]
    hb.beat("h0", now=112.0)
    assert hb.dead_hosts(now=115.0) == ["h1"]


def test_heartbeat_injected_clock_boundary():
    t = {"now": 100.0}
    reg = HeartbeatRegistry(timeout_s=10.0, clock=lambda: t["now"])
    reg.beat("h0")
    reg.beat("h1")
    t["now"] = 110.0  # exactly timeout_s since the beats
    assert reg.dead_hosts() == [] and reg.alive_count() == 2
    t["now"] = 110.0 + 1e-6
    assert sorted(reg.dead_hosts()) == ["h0", "h1"] and reg.alive_count() == 0


def test_heartbeat_late_beat_revives_host():
    t = {"now": 0.0}
    reg = HeartbeatRegistry(timeout_s=5.0, clock=lambda: t["now"])
    reg.beat("h0")
    reg.beat("h1")
    t["now"] = 20.0
    assert sorted(reg.dead_hosts()) == ["h0", "h1"]
    reg.beat("h0")
    assert reg.dead_hosts() == ["h1"] and reg.alive_count() == 1
    reg.beat("h1", now=19.0)
    assert reg.dead_hosts(now=24.0) == []
    assert reg.dead_hosts(now=24.0 + 1e-6) == ["h1"]


def test_straggler_detection():
    det = StragglerDetector(z_threshold=4.0)
    for _ in range(8):
        for h in range(6):
            det.record(f"h{h}", 1.0 + 0.01 * h)
    det.record("h5", 3.0)
    assert det.stragglers() == ["h5"]


def test_supervisor_restarts_from_checkpoint():
    saved = {}
    crashes = {"left": 2}

    def step_fn(state, step):
        if step == 7 and crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("simulated node failure")
        return state + 1

    sup = Supervisor(step_fn, lambda step, state: saved.update(state=state, step=step),
                     lambda: (saved["state"], saved["step"]), checkpoint_every=5,
                     max_restarts=3)
    final, step = sup.run(0, 0, 10)
    assert step == 10 and sup.restarts == 2 and final >= 10


def test_supervisor_gives_up_after_max_restarts():
    def step_fn(state, step):
        raise RuntimeError("persistent failure")

    sup = Supervisor(step_fn, lambda s, st: None, lambda: (0, 0), checkpoint_every=5,
                     max_restarts=2)
    with pytest.raises(RuntimeError):
        sup.run(0, 0, 5)


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------


def test_train_loop_on_cpu(tmp_path, capsys):
    cfg = tiny_variant(get_config("tinyllama-1.1b"))
    run = RunConfig(attention_impl="flash", attention_chunk=16, remat="full", zero=False,
                    warmup_steps=2, total_steps=6)
    state, metrics = train_loop(cfg, run, steps=4, global_batch=2, seq_len=16,
                                ckpt_dir=tmp_path, checkpoint_every=2, log_every=2,
                                device="cpu")
    out = capsys.readouterr().out
    assert "step     1  loss" in out and "tok/s" in out and "done: 4 steps" in out
    assert [m["step"] for m in metrics] == [1, 2, 4]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert int(state.step) == 4
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000002", "step_00000004"]
    # A second run restores step 4 and goes on from there.
    state2, metrics2 = train_loop(cfg, run, steps=1, global_batch=2, seq_len=16,
                                  ckpt_dir=tmp_path, log_every=1, device="cpu")
    assert "restored checkpoint @ step 4" in capsys.readouterr().out
    assert metrics2[0]["step"] == 5 and int(state2.step) == 5
