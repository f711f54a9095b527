"""The port's checkpoints against the JAX package's, on the CPU: the cases of
tests/test_ft.py (roundtrip, atomic rename, pruning, a shape mismatch
rejected, the async writer) on torch trees; the reference's on-disk layout
(manifest keys, shapes and dtypes of a train state, leaf for leaf); a
checkpoint saved by ``repro`` restored into ``repro_torch`` and the
reverse, each followed by one train step in both packages, equal to the
f32 tolerance (with test_torch_train.py's AdamW rule); and the
reference-layout tree of every served family round-tripping through
``params_from_jax``."""

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
from repro.models import init_params as jax_init_params
from repro.train import init_train_state as jax_init_train_state
from repro_torch.checkpoint import (AsyncCheckpointer, latest_checkpoint, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.data import make_batch
from repro_torch.models.convert import params_from_jax, reference_tree
from repro_torch.train import train_step
from repro_torch.train.state import init_train_state, load_state_tree, state_tree
from test_torch_train import (KW, _as_np_tree, _close, _jax_train_step, _jax_value_and_grad,
                              _leaves, _leaves_torch, _port_leaves, assert_params_match)


def small_tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"w": torch.ones((2, 2), dtype=torch.bfloat16),
              "n": torch.tensor(3, dtype=torch.int32)},
        "scalar": torch.tensor(1.5),
    }


def test_checkpoint_roundtrip(tmp_path):
    tree = small_tree()
    save_checkpoint(tmp_path, 7, tree)
    restored, step = restore_checkpoint(latest_checkpoint(tmp_path), tree)
    assert step == 7
    for (ka, a), (kb, b) in zip(_leaves_torch(tree, ""), _leaves_torch(restored, "")):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_atomic_no_partial(tmp_path):
    save_checkpoint(tmp_path, 1, small_tree())
    (tmp_path / "tmp.2").mkdir()  # a crash mid-save
    (tmp_path / "tmp.2" / "junk.bin").write_bytes(b"xx")
    latest = latest_checkpoint(tmp_path)
    assert latest is not None and latest.name == "step_00000001"


def test_checkpoint_pruning(tmp_path):
    for s in range(5):
        save_checkpoint(tmp_path, s, small_tree(), keep=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000003", "step_00000004"]


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(latest_checkpoint(tmp_path), {"a": torch.ones((3, 3))})
    with pytest.raises(ValueError, match="missing leaves"):
        restore_checkpoint(latest_checkpoint(tmp_path), {"a": torch.ones((2, 2)),
                                                         "b": torch.ones(1)})


def test_async_checkpointer_snapshots(tmp_path):
    tree = small_tree()
    ck = AsyncCheckpointer(tmp_path)
    ck.save(5, tree)
    tree["a"].add_(100)  # a step after the save must not reach the checkpoint
    ck.wait()
    restored, step = restore_checkpoint(latest_checkpoint(tmp_path), small_tree())
    assert step == 5
    assert torch.equal(restored["a"], small_tree()["a"])


def test_async_checkpointer_raises_a_failed_write(tmp_path):
    (tmp_path / "file").write_text("")
    ck = AsyncCheckpointer(tmp_path / "file" / "sub")  # cannot be made
    ck.save(1, small_tree())
    with pytest.raises(OSError):
        ck.wait()


def test_small_tree_reads_back_in_the_reference(tmp_path):
    save_checkpoint(tmp_path, 3, small_tree())
    target = {"a": jnp.zeros((3, 4), jnp.float32),
              "b": {"w": jnp.zeros((2, 2), jnp.bfloat16), "n": jnp.asarray(0, jnp.int32)},
              "scalar": jnp.asarray(0.0, jnp.float32)}
    restored, step = jax_restore(jax_latest(tmp_path), target)
    assert step == 3
    for (key, a), (_, b) in zip(_leaves_torch(small_tree(), ""), _leaves_torch(restored, "")):
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32), key)
        assert str(b.dtype) == {"a": "float32", "b/w": "bfloat16", "b/n": "int32",
                                "scalar": "float32"}[key]


# ---------------------------------------------------------------------------
# Train states across the two packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def states(request):
    jcfg = dataclasses.replace(jax_tiny(jax_get_config("tinyllama-1.1b")), dtype=request.param)
    cfg = dataclasses.replace(tiny_variant(get_config("tinyllama-1.1b")), dtype=request.param)
    return jcfg, cfg, jax_init_train_state(jcfg, jax.random.PRNGKey(0))


def _after_steps(jcfg, jstate, steps):
    jrun = JRun(attention_impl="chunked", **KW)
    for i in range(steps):
        batch = make_batch(jcfg, 2, 16, 1, i)
        jstate, _ = _jax_train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jcfg, jrun)
    return jstate


def test_manifest_layout_equals_reference(tmp_path, states):
    jcfg, cfg, jstate = states
    jax_save(tmp_path / "ref", 0, jstate)
    port = init_train_state(cfg, device="cpu")
    save_checkpoint(tmp_path / "port", 0, state_tree(port, cfg))
    ref = json.loads((tmp_path / "ref" / "step_00000000" / "manifest.json").read_text())
    got = json.loads((tmp_path / "port" / "step_00000000" / "manifest.json").read_text())
    assert got == ref
    assert "params/layers/attn/wq" in got["leaves"] and "opt/mu/embed" in got["leaves"]
    assert got["leaves"]["opt/count"] == {"file": "opt__count.bin", "shape": [],
                                          "dtype": "int32"}


def _step_both(jcfg, cfg, jstate, state, seed=7):
    """One train step of each package on the same batch; the outcome must
    be equal by test_torch_train.py's rule."""
    jrun, run = JRun(attention_impl="chunked", **KW), RunConfig(attention_impl="flash", **KW)
    batch = make_batch(cfg, 2, 16, seed, int(jstate.step))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = _leaves(_jax_value_and_grad(jstate.params, jcfg, jrun, jb)[1])
    jstate, jm = _jax_train_step(jstate, jb, jcfg, jrun)
    state, m = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, run)
    if cfg.dtype == "float32":
        for k in jm:
            _close(float(m[k]), float(jm[k]))
        assert_params_match(state_tree(state, cfg)["params"], jstate.params, [jgrads],
                            float(jm["lr"]), 1)
    else:  # bf16 activations round at other places in the two packages
        _close(float(m["loss"]), float(jm["loss"]), 2e-2)
    assert int(state.step) == int(jstate.step)
    return jstate, state


def test_reference_checkpoint_restores_into_port(tmp_path, states):
    jcfg, cfg, jstate = states
    jstate = _after_steps(jcfg, jstate, 2)  # moments and count that are not zero
    jax_save(tmp_path, int(jstate.step), jstate)
    port = init_train_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    tree, step = restore_checkpoint(latest_checkpoint(tmp_path), state_tree(port, cfg))
    port = load_state_tree(port, tree, cfg)
    assert step == 2 and int(port.step) == 2 and int(port.opt.count) == 2
    want = _leaves(_as_np_tree(jstate))
    got = _port_leaves(state_tree(port, cfg))
    assert set(got) == set(want)
    for key in want:  # bytes in, bytes out
        np.testing.assert_array_equal(got[key], want[key], key)
    _step_both(jcfg, cfg, jstate, port)


def test_port_checkpoint_restores_into_reference(tmp_path, states):
    jcfg, cfg, jstate = states
    port = load_state_tree(init_train_state(cfg, device="cpu"), _as_np_tree(jstate), cfg)
    jrun, run = JRun(attention_impl="chunked", **KW), RunConfig(attention_impl="flash", **KW)
    for i in range(2):
        batch = make_batch(cfg, 2, 16, 1, i)
        port, _ = train_step(port, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                             run)
    save_checkpoint(tmp_path, int(port.step), state_tree(port, cfg))
    target = jax_init_train_state(jcfg, jax.random.PRNGKey(5))
    restored, step = jax_restore(jax_latest(tmp_path), target)
    assert step == 2 and int(restored.step) == 2 and int(restored.opt.count) == 2
    want = _port_leaves(state_tree(port, cfg))
    got = _leaves(_as_np_tree(restored))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], key)
    _step_both(jcfg, cfg, restored, port)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-130m", "zamba2-2.7b",
                                  "deepseek-moe-16b", "whisper-base", "phi-3-vision-4.2b"])
def test_reference_tree_inverts_params_from_jax(arch):
    jcfg, cfg = jax_tiny(jax_get_config(arch)), tiny_variant(get_config(arch))
    tree = jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    model = params_from_jax(tree, cfg, device="cpu")
    back = reference_tree(dict(model.named_parameters()), cfg)
    got, want = _port_leaves(back), _leaves(tree)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], key)
