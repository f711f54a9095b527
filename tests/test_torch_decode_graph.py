"""The decode step with its position on the device, and the serve engine's
replays of one CUDA graph of that step.

On the CPU: a dense and a moe step given ``cache["pos"]`` as a 0-d tensor
give the int step's logits and cache, step for step up to the cache's last
slot (``test_torch_model.py`` and ``test_torch_moe.py`` hold such a step to
the JAX reference); the other families refuse such a position; the engine
decodes eagerly and says so in its spans. On a card (tiny bf16 models): the
engine's replays serve the tokens of a loop of eager steps, with the launch
counts of that loop, which the kernels of a profiler trace of the replays
match; the spans read one capture and 12 replays for a first wave; a wave
whose cache comes back at the same addresses captures nothing; of waves of
other prompt lengths, those capture whose cache's shape or addresses moved;
a wrapper on the engine module's ``decode_step``
sees every step; a batch change captures anew; and a hybrid model stays
eager. Each card test's engine and graph are freed when it ends. This file
imports no JAX, so its card tests run on the card with
``python -m pytest -q -m card tests/test_torch_decode_graph.py``."""

import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import RunConfig, get_config, tiny_variant
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.serving import ServeEngine
from repro_torch.serving import engine as engine_module

STEPS = 12
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [12, 13, 14], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [99, 4]]
RUN = RunConfig(attention_impl="flash", attention_chunk=64, remat="none", zero=False)


def config(arch, dtype="float32"):
    return dataclasses.replace(tiny_variant(get_config(arch)), dtype=dtype)


def padded(prompts, device):
    """The prompts left-padded with 0, as the engine pads them."""
    plen = max(map(len, prompts))
    rows = np.zeros((len(prompts), plen), np.int64)
    for i, p in enumerate(prompts):
        rows[i, plen - len(p):] = p
    return torch.from_numpy(rows).to(device)


@pytest.fixture
def recorder(monkeypatch):
    fresh = tracing.Recorder()
    monkeypatch.setattr(tracing, "_RECORDER", fresh)
    return fresh


# -- the CPU ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b"])
def test_a_position_on_the_device_steps_as_the_int(arch):
    """12 steps from the prompt's end to the cache's last slot, T - 1, the
    bound T - S of the write's clamp: the same logits and cache tensors,
    exactly, and the tensor position advanced as the int."""
    cfg = config(arch)
    model = transformer.Transformer(cfg, device="cpu")
    tokens = padded(PROMPTS, "cpu")
    plen = tokens.shape[1]
    with torch.inference_mode():
        logits, cache = transformer.prefill(model, cfg, RUN, tokens, max_len=plen + STEPS)
        other = {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}
        other["pos"] = torch.tensor(cache["pos"])
        cur = logits[:, -1].argmax(-1)[:, None]
        for _ in range(STEPS):
            want, cache = transformer.decode_step(model, cfg, RUN, cache, cur)
            got, other = transformer.decode_step(model, cfg, RUN, other, cur)
            assert torch.equal(got, want)
            assert other["pos"].dim() == 0 and int(other["pos"]) == cache["pos"]
            for key, t in cache.items():
                if torch.is_tensor(t):
                    assert torch.equal(other[key], t), key
            cur = want[:, -1].argmax(-1)[:, None]
    assert cache["pos"] == cache["k"].shape[2] == plen + STEPS


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_a_position_on_the_device_is_refused_by_the_other_families(arch):
    cfg = config(arch)
    model = transformer.Transformer(cfg, device="cpu")
    cache = dict(transformer.init_cache(cfg, 2, 8, device="cpu"), pos=torch.tensor(3))
    assert not transformer.position_on_device(cfg, model.embed)
    with pytest.raises(ValueError, match="position on the device"):
        transformer.decode_step(model, cfg, RUN, cache, torch.ones((2, 1), dtype=torch.long))


def test_the_engine_decodes_eagerly_on_the_cpu(recorder):
    """No graph on the CPU: every step reaches the model's own step through
    the engine module's name, and its span says it ran eagerly."""
    cfg = config("deepseek-moe-16b")
    engine = ServeEngine(cfg, transformer.Transformer(cfg, device="cpu"), batch_size=4,
                         device="cpu")
    cache = transformer.init_cache(cfg, 4, 8, device="cpu")
    assert transformer.position_on_device(cfg, cache["k"])  # the step would take one
    with profile(activities=[ProfilerActivity.CPU]):
        engine.generate(PROMPTS, max_new_tokens=4)
    decode = [s for s in tracing.spans() if s.name == "serve.decode"]
    assert [(s.fields["graph"], s.fields["captured"]) for s in decode] == [("eager", False)] * 3
    assert engine._graph.graph is None and engine._graph.pos is None


# -- the card ---------------------------------------------------------------------


@pytest.fixture
def card():
    """The card; when the test ends (after ``monkeypatch`` has put the
    engine module back), its engines, graphs, pools and traces are freed and
    the allocator's cache emptied, so that no later test in the process runs
    beside them or collects them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def traced_launches(prof):
    """Per counter of ``ops.LAUNCHES``, the kernels of its symbols that the
    trace holds."""
    from torch.autograd import DeviceType

    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    return {counter: sum(any(s in n for s in symbols) for n in names)
            for counter, symbols in ops.KERNELS.items()}


def engine_on(card, arch="deepseek-moe-16b", dtype="bfloat16"):
    cfg = config(arch, dtype)
    model = transformer.Transformer(cfg, device=card)
    return ServeEngine(cfg, model, batch_size=len(PROMPTS), device=card)


def watched(monkeypatch):
    """Wrap the engine module's ``decode_step`` as a caller that keeps every
    step's logits does: each call's logits copied at once, its cache's K
    address and shape, the addresses of all its tensors and its ``graph``
    argument kept."""
    real = engine_module.decode_step
    calls = []

    def kept(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        calls.append({"logits": logits[:, -1].float().cpu(), "k": args[3]["k"].data_ptr(),
                      "shape": tuple(args[3]["k"].shape),
                      "ptrs": [t.data_ptr() for t in args[3].values() if torch.is_tensor(t)],
                      "graph": kwargs.get("graph")})
        return logits, cache

    monkeypatch.setattr(engine_module, "decode_step", kept)
    return calls


def eager(engine, prompts):
    """(tokens (B, STEPS + 1), logits of each step (B, STEPS, V), launches) of
    the prefill and a loop of eager ``transformer.decode_step`` calls."""
    tokens = padded(prompts, engine.device)
    ops.reset_launches()
    with torch.inference_mode():
        logits, cache = transformer.prefill(engine.params, engine.cfg, engine.run, tokens,
                                            max_len=tokens.shape[1] + STEPS + 1)
        cur = logits[:, -1].argmax(-1)
        out, kept = [cur], []
        for _ in range(STEPS):
            logits, cache = transformer.decode_step(engine.params, engine.cfg, engine.run,
                                                    cache, cur[:, None])
            kept.append(logits[:, -1].float().cpu())
            cur = logits[:, -1].argmax(-1)
            out.append(cur)
    return torch.stack(out, 1).cpu(), torch.stack(kept, 1), dict(ops.LAUNCHES)


@pytest.mark.card
def test_replays_serve_the_eager_tokens_on_the_card(card, monkeypatch):
    """Tokens and logits of the eager loop; its launch counts, which the
    trace of the replayed wave holds kernel for kernel."""
    engine = engine_on(card)
    want_tokens, want_logits, want_launches = eager(engine, PROMPTS)
    engine.generate(PROMPTS, max_new_tokens=STEPS + 1)  # the capture's cuBLAS set-up
    calls = watched(monkeypatch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # A fresh session may leave its first launches out of the trace.
        torch.ones(1, device=card).add_(1)
        torch.cuda.synchronize()
        ops.reset_launches()
        got = engine.generate(PROMPTS, max_new_tokens=STEPS + 1)
        torch.cuda.synchronize()
    assert len(calls) == STEPS and all(c["graph"] is engine._graph for c in calls)
    assert [r.tokens for r in got] == want_tokens.tolist()
    torch.testing.assert_close(torch.stack([c["logits"] for c in calls], 1), want_logits,
                               rtol=1e-2, atol=1e-2)
    assert dict(ops.LAUNCHES) == want_launches == traced_launches(prof)
    assert want_launches["flash_decode"] == STEPS * engine.cfg.n_layers


@pytest.mark.card
def test_a_first_wave_captures_once_and_a_wave_at_the_same_addresses_not_at_all(
        card, monkeypatch, recorder):
    """Under the profiler (device activity, as a traced benchmark run): the
    first wave's 12 steps are replays, the first of them captured, and the
    trace holds device work inside each; waves follow until one's cache
    comes back at the previous wave's addresses, which captures nothing."""
    from torch.autograd import DeviceType

    engine = engine_on(card)
    calls = watched(monkeypatch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.generate(PROMPTS, max_new_tokens=STEPS + 1)
        torch.cuda.synchronize()
    decode = [s for s in tracing.spans() if s.name == "serve.decode"]
    assert [s.fields["graph"] for s in decode] == ["replay"] * STEPS
    assert [s.fields["captured"] for s in decode] == [True] + [False] * (STEPS - 1)
    kernels = [e.start_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    tokens = sorted(s.end_ns for s in tracing.spans() if s.name == "serve.tokens")
    for lo, hi in zip(tokens, tokens[1:]):
        assert any(lo <= k <= hi for k in kernels), (lo, hi)

    for _ in range(4):
        before = len(calls)
        with profile(activities=[ProfilerActivity.CPU]):
            engine.generate(PROMPTS, max_new_tokens=STEPS + 1)
        wave = calls[before:]
        if wave[0]["k"] == calls[before - 1]["k"]:
            break
    else:
        pytest.fail("no wave's cache came back at the previous wave's addresses")
    decode = [s for s in tracing.spans() if s.name == "serve.decode"][-STEPS:]
    assert [s.fields["graph"] for s in decode] == ["replay"] * STEPS
    assert not any(s.fields["captured"] for s in decode)


@pytest.mark.card
def test_waves_of_other_lengths_capture_where_the_cache_moved_on_the_card(
        card, monkeypatch, recorder):
    """Waves of 4 whose longest prompts differ: a wave captures where its
    cache's shape or any of its addresses differ from the previous wave's,
    and only there, and each serves the eager loop's tokens."""
    engine = engine_on(card)
    waves = [PROMPTS, [p[:5] for p in PROMPTS], [p[:9] + [7, 7, 7] for p in PROMPTS],
             [p[:2] for p in PROMPTS], PROMPTS]
    wants = [eager(engine, prompts)[0].tolist() for prompts in waves]
    calls = watched(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        gots = [[r.tokens for r in engine.generate(prompts, max_new_tokens=STEPS + 1)]
                for prompts in waves]
    assert gots == wants
    firsts = calls[::STEPS]
    assert len(calls) == STEPS * len(waves)
    assert [c["shape"][2] for c in firsts] == [max(map(len, w)) + STEPS + 1 for w in waves]
    decode = [s for s in tracing.spans() if s.name == "serve.decode"]
    captured = [s.fields["captured"] for s in decode[::STEPS]]
    moved = [True] + [(a["ptrs"], a["shape"]) != (b["ptrs"], b["shape"])
                      for a, b in zip(firsts, firsts[1:])]
    assert captured == moved
    assert not any(s.fields["captured"] for i, s in enumerate(decode) if i % STEPS)


@pytest.mark.card
def test_a_hybrid_model_stays_eager_on_the_card(card, monkeypatch, recorder):
    engine = engine_on(card, "zamba2-2.7b", "float32")
    calls = watched(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        got = engine.generate(PROMPTS, max_new_tokens=STEPS + 1)
    assert all(len(r.tokens) == STEPS + 1 for r in got)
    assert len(calls) == STEPS and all(c["graph"] is None for c in calls)
    decode = [s for s in tracing.spans() if s.name == "serve.decode"]
    assert [(s.fields["graph"], s.fields["captured"]) for s in decode] == [("eager", False)] * STEPS
    assert engine._graph.graph is None


@pytest.mark.card
def test_a_wave_of_another_batch_captures_anew_on_the_card(card, monkeypatch, recorder):
    """After a wave of 4, a wave of 3 drops the graph and captures its own
    into the same pool, and serves the eager loop's tokens; a wave of 4
    after it captures again."""
    engine = engine_on(card)
    engine.generate(PROMPTS, max_new_tokens=STEPS + 1)
    want_tokens, _, _ = eager(engine, PROMPTS[:3])
    calls = watched(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        got = engine.generate(PROMPTS[:3], max_new_tokens=STEPS + 1)
        engine.generate(PROMPTS, max_new_tokens=STEPS + 1)
    assert len(calls) == 2 * STEPS
    assert [r.tokens for r in got] == want_tokens.tolist()
    decode = [s for s in tracing.spans() if s.name == "serve.decode"]
    assert [s.fields["captured"] for s in decode] == 2 * ([True] + [False] * (STEPS - 1))
