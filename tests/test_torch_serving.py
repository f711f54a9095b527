"""The port's serve engine and CLI against ``repro.serving.ServeEngine``:
greedy tokens in f32 on the reference's weights, on the prompts of
test_distributed.py::test_serve_engine_roundtrip (left-padded to S = 5)."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import tiny_variant as jax_tiny
from repro.models import init_params as jax_init_params
from repro.serving import ServeEngine as JaxEngine
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ServeEngine

PROMPTS = [[1, 2, 3, 4], [5, 6, 7, 8, 9], [10, 11]]


@pytest.fixture(scope="module")
def reference():
    jcfg = dataclasses.replace(jax_tiny(jax_get_config("tinyllama-1.1b")), dtype="float32")
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    want = JaxEngine(jcfg, params, batch_size=2).generate(PROMPTS, max_new_tokens=4)
    cfg = dataclasses.replace(tiny_variant(get_config("tinyllama-1.1b")), dtype="float32")
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return cfg, model, want


@pytest.mark.parametrize("impl", ["flash", "chunked", "naive"])
def test_generate_matches_reference_tokens(reference, impl):
    cfg, model, want = reference
    run = None if impl == "flash" else RunConfig(attention_impl=impl, attention_chunk=64)
    engine = ServeEngine(cfg, model, run=run, batch_size=2, device="cpu")
    assert engine.run.attention_impl == impl
    got = engine.generate(PROMPTS, max_new_tokens=4)
    assert [r.request_id for r in got] == [0, 1, 2]
    assert [r.prompt for r in got] == PROMPTS
    assert [r.tokens for r in got] == [r.tokens for r in want]


def test_generate_stops_at_eos(reference):
    cfg, model, want = reference
    eos = want[0].tokens[1]
    got = ServeEngine(cfg, model, batch_size=2, device="cpu").generate(
        PROMPTS, max_new_tokens=4, eos_id=eos)
    assert got[0].tokens == want[0].tokens[:2]


def test_engine_rejects_weights_on_another_device(reference):
    cfg, model, _ = reference
    with pytest.raises(ValueError, match="weights are on"):
        ServeEngine(cfg, model, device="meta")


def test_serve_cli_runs_on_cpu(capsys):
    ops.reset_launches()
    serve.main(["--device", "cpu", "--requests", "3", "--batch-size", "2",
                "--prompt-len", "8", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "tok/s) on cpu" in out
    assert sum(ops.LAUNCHES.values()) == 0  # the CPU ran the plain versions


def test_serve_cli_rejects_unknown_arch():
    with pytest.raises(SystemExit, match="unknown model config"):
        serve.main(["--device", "cpu", "--arch", "nope"])
