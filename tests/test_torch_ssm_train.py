"""Training the port's Mamba-2 families against the JAX package on the CPU,
on the same numpy inputs: the autograd Function of K4
(``ops.SSDChunkDual``) against ``jax.vjp`` of the reference's
``ssd_intra_chunk_ref`` and gradcheck; ``train_step`` of the tiny
mamba2-130m (ssm) and zamba2-2.7b (hybrid) on the reference's own weights
under remat "none" and "full"; the kernel forwards a step runs; and
checkpoints across the packages.

On the CPU the Function runs the kernel's plain version forward and the
same hand-written backward the card runs (its ``grad_fn`` is checked).

Tolerances: f32 1e-5 of each tensor's largest element (summation order
only); bf16 B and C come back rounded to bf16 from both packages, held to
2e-2 of the largest element, a bf16 step or two. Parameters after AdamW
steps follow tests/test_torch_train.py's sign rule."""

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
from repro.kernels.ref import ssd_intra_chunk_ref
from repro.train import init_train_state as jax_init_train_state
from repro.train.step import _loss_fn as jax_loss_fn
from repro_torch.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.data import make_batch
from repro_torch.kernels import ops
from repro_torch.launch.train import train_loop
from repro_torch.models import forward_train
from repro_torch.train import train_step
from repro_torch.train.state import init_train_state, load_state_tree, state_tree
from test_torch_train import (_as_np_tree, _graph_nodes, _jax_train_step, _jax_vjp, _leaves,
                              _port_leaves, assert_params_match)

TOL = 1e-5
ARCHS = ("mamba2-130m", "zamba2-2.7b")
B, S = 2, 37  # S is a multiple of no SSD chunk (32) or attention chunk (16)
KW = dict(attention_chunk=16, zero=False, warmup_steps=1, total_steps=10)


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# The autograd Function of K4
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b, nc, h, q, p, n, span=1.0, dtype=np.float32):
    """xdt and cum as the model's (B,NC,Q,H,.) views, B/C slices of one
    projection, and the cotangents of y and the states."""
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((b, nc, q, h, p)) * 0.5).astype(dtype)
    cum = -np.cumsum(rng.random((b, nc, q, h)) * span, axis=2).astype(dtype)
    proj = (rng.standard_normal((b, nc, q, 2 * n + 3)) * 0.5).astype(dtype)
    dy = rng.standard_normal((b, nc, h, q, p)).astype(dtype)
    dstates = rng.standard_normal((b, nc, h, n, p)).astype(dtype)
    return (np.swapaxes(xdt, 2, 3), np.swapaxes(cum, 2, 3), proj[..., 3:3 + n],
            proj[..., 3 + n:], dy, dstates)


def _torch_ssd(xdt, cum, bm, cm, b_dtype=torch.float32):
    """The inputs as torch views of the model's layout (xdt, cum permuted;
    B/C slices of one projection), leaves that require grad."""
    x = torch.from_numpy(np.ascontiguousarray(np.swapaxes(xdt, 2, 3))).requires_grad_()
    c = torch.from_numpy(np.ascontiguousarray(np.swapaxes(cum, 2, 3))).requires_grad_()
    proj = torch.from_numpy(np.concatenate([bm, cm], -1)).to(b_dtype).requires_grad_()
    n = bm.shape[-1]
    return (x, c, proj), (x.permute(0, 1, 3, 2, 4), c.permute(0, 1, 3, 2), proj[..., :n],
                          proj[..., n:])


# (b, nc, h, q, p, n): ragged Q (77 is no multiple of the 64-key tiles), the
# tiny models' chunk, heads that take several backward blocks, Q 1.
SSD_CASES = [(2, 2, 3, 77, 16, 8), (2, 1, 8, 32, 32, 16), (1, 3, 5, 64, 8, 32),
             (2, 2, 2, 1, 4, 4)]


@pytest.mark.parametrize("b_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_function_grads_equal_jax(monkeypatch, case, b_dtype):
    from repro_torch.kernels import ssd_scan

    b, nc, h, q, p, n = case
    monkeypatch.setattr(ssd_scan, "BACKWARD_BLOCK", b * nc * q * q * 2)  # 2 heads a block
    xdt, cum, bm, cm, dy, ds = _ssd_inputs(sum(case), *case)
    if b_dtype == "bfloat16":  # the same bf16 values on both sides
        bm, cm = (np.asarray(torch.from_numpy(a).to(torch.bfloat16).float()) for a in (bm, cm))
    jb, jc = (jnp.asarray(a, b_dtype) for a in (bm, cm))
    (jy, js), (jdx, jdcum, jdb, jdc) = _jax_vjp(
        ssd_intra_chunk_ref, jnp.asarray(xdt), jnp.asarray(cum), jb, jc,
        (jnp.asarray(dy), jnp.asarray(ds)))
    leaves, args = _torch_ssd(xdt, cum, bm, cm, getattr(torch, b_dtype))
    y, states = ops.ssd_chunk_dual(*args)
    assert type(y.grad_fn).__name__ == "SSDChunkDualBackward"
    dx, dcum, dproj = torch.autograd.grad((y, states), leaves,
                                          (torch.from_numpy(dy), torch.from_numpy(ds)))
    assert dproj.dtype == getattr(torch, b_dtype)
    fwd_tol = TOL if b_dtype == "float32" else 1e-4  # bf16: the hi + lo terms
    _rel_close(y.detach(), jy, fwd_tol)
    _rel_close(states.detach(), js, fwd_tol)
    _rel_close(dx.permute(0, 1, 3, 2, 4), jdx, TOL)
    _rel_close(dcum.permute(0, 1, 3, 2), jdcum, TOL)
    tol = TOL if b_dtype == "float32" else 2e-2
    _rel_close(dproj[..., :n].float(), np.asarray(jdb, np.float32), tol)
    _rel_close(dproj[..., n:].float(), np.asarray(jdc, np.float32), tol)


@pytest.mark.parametrize("q", [5, 77])
def test_ssd_function_gradcheck_f64(q):
    """gradcheck differentiates numerically, two forwards per input element:
    one head, P 2, N 2; Q 77 has a ragged key tile."""
    xdt, cum, bm, cm, _, _ = _ssd_inputs(q, 1, 1, 2, q, 2, 2, dtype=np.float64)
    leaves, _ = _torch_ssd(xdt, cum, bm, cm, torch.float64)

    def fn(x, c, proj):
        return ops.ssd_chunk_dual(x.permute(0, 1, 3, 2, 4), c.permute(0, 1, 3, 2),
                                  proj[..., :2], proj[..., 2:])

    assert torch.autograd.gradcheck(fn, leaves)


def test_ssd_function_masks_the_exponent():
    """cum falling by up to 40 a step: exp of the unmasked upper triangle
    would be inf (and inf * 0 NaN); every gradient stays finite and equals
    the reference's."""
    xdt, cum, bm, cm, dy, ds = _ssd_inputs(5, 1, 1, 2, 64, 8, 16, span=40.0)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[0, 0, 0][:, None] - cum[0, 0, 0][None, :])).any()
    _, jgrads = _jax_vjp(ssd_intra_chunk_ref, *(jnp.asarray(a) for a in (xdt, cum, bm, cm)),
                         (jnp.asarray(dy), jnp.asarray(ds)))
    leaves, args = _torch_ssd(xdt, cum, bm, cm)
    y, states = ops.ssd_chunk_dual(*args)
    dx, dcum, dproj = torch.autograd.grad((y, states), leaves,
                                          (torch.from_numpy(dy), torch.from_numpy(ds)))
    for g in (dx, dcum, dproj):
        assert torch.isfinite(g).all()
    _rel_close(dx.permute(0, 1, 3, 2, 4), jgrads[0], TOL)
    _rel_close(dcum.permute(0, 1, 3, 2), jgrads[1], TOL)


def test_ssd_grad_fn_is_the_function():
    _, args = _torch_ssd(*_ssd_inputs(1, 1, 1, 2, 8, 4, 4)[:4])
    y, states = ops.ssd_chunk_dual(*args)
    assert type(y.grad_fn).__name__ == type(states.grad_fn).__name__ == "SSDChunkDualBackward"
    with torch.no_grad():  # the serve paths skip the Function
        assert ops.ssd_chunk_dual(*args)[0].grad_fn is None
    assert ops.ssd_chunk_dual(*(a.detach() for a in args))[0].grad_fn is None


# ---------------------------------------------------------------------------
# train_step of the two families on the reference's weights
# ---------------------------------------------------------------------------


def _configs(arch):
    return (dataclasses.replace(jax_tiny(jax_get_config(arch)), dtype="float32"),
            dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32"))


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's initial state and its state, gradients and metrics
    after each of two steps (remat "none"; remat changes no number)."""
    jcfg, cfg = _configs(request.param)
    jrun = JRun(attention_impl="chunked", remat="none", **KW)
    grad = jax.jit(jax.value_and_grad(jax_loss_fn, has_aux=True), static_argnums=(1, 2))
    jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0))
    initial, history = _as_np_tree(jstate), []
    for i in range(2):
        batch = make_batch(cfg, B, S, 0, i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jgrads = _leaves(grad(jstate.params, jcfg, jrun, jb)[1])
        jstate, jm = _jax_train_step(jstate, jb, jcfg, jrun)
        history.append((batch, jgrads, jstate, {k: float(v) for k, v in jm.items()}))
    return request.param, jcfg, cfg, initial, history, jrun


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_equals_reference(reference, remat):
    arch, _, cfg, initial, history, _ = reference
    run = RunConfig(attention_impl="flash", remat=remat, **KW)
    state = load_state_tree(init_train_state(cfg, device="cpu"), initial, cfg)
    jgrads = []
    for batch, grads, jstate, jm in history:
        jgrads.append(grads)
        state, m = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                              cfg, run)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), jm[k], rtol=TOL, atol=TOL, err_msg=k)
        tree = state_tree(state, cfg)
        assert int(tree["step"]) == int(jstate.step)
        assert_params_match(tree["params"], jstate.params, jgrads, jm["lr"], len(jgrads))
        tol = TOL * (1 if len(jgrads) == 1 else 10)  # as test_torch_train.py
        for part in ("mu", "nu"):
            got, want = _port_leaves(tree["opt"][part]), _leaves(getattr(jstate.opt, part))
            for key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=tol * np.abs(want[key]).max(), err_msg=key)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_path_launches_per_step(monkeypatch, arch, remat):
    """Counts the forwards of K1, K2 and K4 in one train step (on the card,
    each launches its kernel once). Forward: 2 K1 and one K4 per Mamba layer
    (its norm1 and gated norm), 2 K1 and one K2 per shared-block
    invocation, and the final norm; under remat the layers (ssm) or groups
    (hybrid) run their forward again in backward, the final norm does
    not."""
    cfg = tiny_variant(get_config(arch))
    calls = {"norm": 0, "attention": 0, "ssd": 0}
    for key, name in (("norm", "_rmsnorm"), ("attention", "_attention"), ("ssd", "_ssd")):
        real = getattr(ops, name)

        def counted(*a, key=key, real=real):
            calls[key] += 1
            return real(*a)

        monkeypatch.setattr(ops, name, counted)
    state = init_train_state(cfg, device="cpu")
    run = RunConfig(attention_impl="flash", remat=remat, **KW)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 2, 40, 0, 0).items()}
    L, G = cfg.n_layers, (cfg.n_layers // cfg.hybrid_attn_every if arch == "zamba2-2.7b" else 0)
    hidden, _ = forward_train(state.params, cfg, run, batch["tokens"])
    if remat == "none":
        nodes = _graph_nodes(hidden)
        assert nodes.count("SSDChunkDualBackward") == L
        assert nodes.count("FusedRMSNormBackward") == 2 * L + 2 * G + 1
        assert nodes.count("FlashAttentionBackward") == G
    calls.update(norm=0, attention=0, ssd=0)
    train_step(state, batch, cfg, run)
    times = 1 if remat == "none" else 2
    assert calls == {"norm": times * (2 * L + 2 * G) + 1, "attention": times * G,
                     "ssd": times * L}


# ---------------------------------------------------------------------------
# Checkpoints across the packages, and train_loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_across_packages(tmp_path, reference, writer):
    """A state after one step, written by one package and restored into the
    other (bytes in, bytes out, the manifest equal), then stepped in both
    on the second batch: equal by the AdamW rule."""
    arch, jcfg, cfg, initial, history, jrun = reference
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
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], rtol=TOL, atol=TOL)
    assert_params_match(state_tree(port, cfg)["params"], jnext.params, [grads0, grads1],
                        jm["lr"], 2)


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
