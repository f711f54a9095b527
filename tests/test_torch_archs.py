"""The four architectures no other test pins, against ``repro`` on the
reference's own weights (tiny variants, f32, B 2, S 37, ``models/convert.py``):
yi-9b (GQA, G 4 at this size), qwen3-8b (q/k norms, rope theta 1e6),
starcoder2-15b (the dense GELU model) and phi3.5-moe-42b-a6.6b (16 experts,
top 2; 4 at this size).

- the full-sequence logits equal the reference's over ``flash``, ``chunked``
  and ``naive``, within ``LOGITS_TOL`` (summation order only);
- ``ServeEngine.generate``'s greedy tokens equal the reference engine's (3
  prompts, 6 new tokens);
- qwen3-8b's and starcoder2-15b's gradients through ``train/step.py::_grads``
  are within ``GRAD_TOL`` of each leaf's largest element of
  ``jax.value_and_grad``'s. The worst leaf is qwen3-8b's ``k_norm``, 1.30e-6
  of its largest on this batch: a (D,) scale whose gradient sums over every
  row of B·S·K, in another order than XLA's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny
from repro.models import init_params as jax_init_params
from repro.models.transformer import forward_hidden as jax_forward_hidden
from repro.models.transformer import lm_logits as jax_lm_logits
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.models import forward_hidden
from repro_torch.models.convert import params_from_jax, reference_tree
from repro_torch.models.transformer import lm_logits
from repro_torch.serving import ServeEngine
from repro_torch.train.state import init_train_state, load_state_tree
from repro_torch.train.step import _grads
from test_torch_train import _jax_value_and_grad, _leaves, _port_leaves

ARCHS = ["yi-9b", "qwen3-8b", "starcoder2-15b", "phi3.5-moe-42b-a6.6b"]
B, S = 2, 37  # S is a multiple of no attention chunk or kernel block
LOGITS_TOL = 2e-6
GRAD_TOL = 2e-6
PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11]]


@functools.lru_cache(maxsize=None)
def reference(arch):
    jcfg = dataclasses.replace(jax_tiny(jax_get_config(arch)), dtype="float32")
    cfg = dataclasses.replace(tiny_variant(get_config(arch)), dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, cfg, params, tree


def _run(impl):
    return RunConfig(attention_impl=impl, attention_chunk=16, remat="none", zero=False)


@functools.lru_cache(maxsize=None)
def reference_logits(arch, tokens_seed=0):
    jcfg, cfg, params, _ = reference(arch)
    tokens = np.random.default_rng(tokens_seed).integers(0, cfg.vocab, size=(B, S))
    jrun = JRun(attention_impl="chunked", attention_chunk=16, remat="none", zero=False)

    def forward(p, t):
        x, _ = jax_forward_hidden(p, jcfg, jrun, t)
        return jax_lm_logits(p, jcfg, x)

    return tokens, np.asarray(jax.jit(forward)(params, jnp.asarray(tokens)))


@pytest.mark.parametrize("impl", ["flash", "chunked", "naive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_equal_reference(arch, impl):
    _, cfg, _, tree = reference(arch)
    tokens, want = reference_logits(arch)
    model = params_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        x, _ = forward_hidden(model, cfg, _run(impl), torch.as_tensor(tokens))
        got = lm_logits(model, cfg, x).numpy()
    np.testing.assert_allclose(got[..., :cfg.vocab], want[..., :cfg.vocab], rtol=0,
                               atol=LOGITS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_reference(arch):
    jcfg, cfg, params, tree = reference(arch)
    want = JaxEngine(jcfg, params, batch_size=2).generate(PROMPTS, max_new_tokens=6)
    model = params_from_jax(tree, cfg, device="cpu")
    got = ServeEngine(cfg, model, batch_size=2, device="cpu").generate(PROMPTS,
                                                                       max_new_tokens=6)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(len(r.tokens) == 6 for r in got)


@pytest.mark.parametrize("arch", ["qwen3-8b", "starcoder2-15b"])
def test_gradients_equal_reference(arch):
    jcfg, cfg, params, tree = reference(arch)
    kw = dict(attention_chunk=16, remat="none", zero=False)
    jrun, run = JRun(attention_impl="chunked", **kw), RunConfig(attention_impl="flash", **kw)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(B, S + 1))
    batch = {"tokens": tokens[:, :-1].astype(np.int32), "labels": tokens[:, 1:].astype(np.int32)}
    (jtotal, _), jg = _jax_value_and_grad(params, jcfg, jrun,
                                          {k: jnp.asarray(v) for k, v in batch.items()})
    state = init_train_state(cfg, device="cpu")
    state = load_state_tree(state, {"params": tree, "opt": {"mu": tree, "nu": tree, "count": 0},
                                    "step": 0}, cfg)
    total, _, grads = _grads(state.params, cfg, run,
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-6)
    got, want = _port_leaves(reference_tree(grads, cfg)), _leaves(jg)
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.abs(got[key]).max() > 0, key
        np.testing.assert_allclose(got[key], w, rtol=0, atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=key)
