"""``models/transformer.py::_remat`` under the reference's three policies:
"none" keeps every activation, "full" keeps none and runs each block's
forward again in backward, and "dots" (``jax.checkpoint_policies.
dots_saveable``) keeps the matmul outputs and recomputes the rest.  The loss
and gradients are the same under all three, exactly in f32; a
``TorchDispatchMode`` counts the matmuls backward runs; the kernel wrappers'
calls are counted the way ``ops.LAUNCHES`` counts launches on the card."""

import dataclasses
import threading

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.distributed import MeshContext, current_mesh, set_mesh_context
from repro_torch.kernels import ops
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.transformer import _remat
from repro_torch.train.state import init_train_state
from repro_torch.train.step import _grads, _loss_fn

MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


class CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in MATMULS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def setup(arch="tinyllama-1.1b"):
    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g)
    return cfg, state, {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def run_config(remat, impl="flash"):
    return RunConfig(attention_impl=impl, remat=remat, zero=False)


@pytest.mark.parametrize("impl", ["flash", "chunked"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m"])
def test_dots_gives_the_loss_and_gradients_of_full_and_none(arch, impl):
    cfg, state, batch = setup(arch)
    results = {r: _grads(state.params, cfg, run_config(r, impl), batch)
               for r in ("none", "full", "dots")}
    loss, _, grads = results["none"]
    for remat in ("full", "dots"):
        other_loss, _, other = results[remat]
        assert torch.equal(other_loss, loss)
        assert other.keys() == grads.keys()
        for k in grads:
            assert torch.equal(other[k], grads[k]), (remat, k)


def count_backward(cfg, state, batch, remat, early_stop=True):
    """(matmuls in forward, matmuls in backward) of one loss."""
    params = list(state.params.parameters())
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        with CountMatmuls() as fwd:
            total, _ = _loss_fn(state.params, cfg, run_config(remat), batch)
        with CountMatmuls() as bwd:
            torch.autograd.grad(total, params)
    return fwd.n, bwd.n


@pytest.mark.parametrize("early_stop", [True, False])
def test_dots_recomputes_no_matmul(early_stop):
    cfg, state, batch = setup()
    fwd, bwd_none = count_backward(cfg, state, batch, "none", early_stop)
    assert count_backward(cfg, state, batch, "dots", early_stop) == (fwd, bwd_none)
    # "full" runs every matmul of the blocks once more, all but the loss's
    # logits product, which lies outside them.  Stopping early, the
    # recomputation ends at the last saved tensor it needs, before each
    # block's MLP output product, whose result no backward reads.
    rerun = fwd - 1 - (cfg.n_layers if early_stop else 0)
    assert count_backward(cfg, state, batch, "full", early_stop) == (fwd, bwd_none + rerun)


def test_kernels_rerun_under_dots(monkeypatch):
    """The kernel wrappers' forwards run again in backward under "dots", as
    the reference's Pallas calls do (a custom call is no dot): each block's
    norms and attention twice, the final norm once."""
    calls = {"fused_rmsnorm": 0, "flash_attention": 0}
    for name, attr in (("fused_rmsnorm", "_rmsnorm"), ("flash_attention", "_attention")):
        def counted(*args, _fn=getattr(ops, attr), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(ops, attr, counted)
    cfg, state, batch = setup()
    layers = cfg.n_layers
    for remat, rerun in (("none", 0), ("full", 1), ("dots", 1)):
        calls.update(fused_rmsnorm=0, flash_attention=0)
        _grads(state.params, cfg, run_config(remat), batch)
        assert calls == {"fused_rmsnorm": (2 * layers) * (1 + rerun) + 1,
                         "flash_attention": layers * (1 + rerun)}, remat


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recompute_runs_under_the_forwards_mesh_context(remat):
    """Autograd runs a CUDA backward on a thread of its own; the recompute
    of a remat'd block, wherever it runs, sees the mesh context of its
    forward (here backward is called from another thread), and the thread
    that runs it keeps its own context after."""
    ctx = MeshContext(AbstractMesh((("data", 2), ("model", 2))))
    seen = []

    def block(x):
        seen.append(current_mesh())
        return torch.sin(x @ x.T).sum(dim=0)

    x = torch.randn(4, 4, requires_grad=True)
    set_mesh_context(ctx)
    try:
        y = _remat(block, RunConfig(remat=remat))(x).sum()
    finally:
        set_mesh_context(None)
    after = []

    def backward():
        y.backward()
        after.append(current_mesh())

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    assert seen == [ctx, ctx] and after == [None]
    want = torch.autograd.grad(torch.sin(x @ x.T).sum(), x)[0]
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)
