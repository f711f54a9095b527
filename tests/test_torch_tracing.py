"""The port's spans (``repro_torch.tracing``) on the serve path: nothing
recorded with the profiler off, the engine's and the model's spans under
it, nested and grouped by wave, the same tokens either way, the profiler's
clock, the bound on what is kept; and, on a card, the device's operations
inside their span and the span's timing events against the kernels' time.

The model is the tiny MoE of ``perfbench/tests/tiny.py`` (float32). This
file imports no JAX, so its card test runs on the card with
``python -m pytest -q -m card tests/test_torch_tracing.py``."""

import dataclasses
import importlib.util
import pathlib
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer
from repro_torch.serving import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("perfbench_tiny",
                                               ROOT / "perfbench" / "tests" / "tiny.py")
tiny = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tiny)

PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [12, 13, 14], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [99, 4]]
NEW = tiny.SERVE["new_tokens"]
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine", "moe.shared")


@pytest.fixture
def recorder(monkeypatch):
    """A fresh span store for the test."""
    fresh = tracing.Recorder()
    monkeypatch.setattr(tracing, "_RECORDER", fresh)
    return fresh


def engine(dispatch="einsum"):
    cfg = ModelConfig(**tiny.MOE)
    model = Transformer(cfg, device="cpu")
    e = ServeEngine(cfg, model, batch_size=len(PROMPTS), max_len=32, device="cpu")
    e.run = dataclasses.replace(e.run, moe_dispatch=dispatch)
    return e


def traced(e):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = e.generate(PROMPTS, max_new_tokens=NEW)
    return out, tracing.spans(), prof


def test_off_records_nothing(recorder):
    assert tracing.span("attn", layer=0) is tracing.span("head") is tracing._OFF
    engine().generate(PROMPTS, max_new_tokens=NEW)
    assert tracing.spans() == [] and recorder.open == [] and recorder.pool == []


def test_a_wave_gives_its_engine_spans(recorder):
    _, got, _ = traced(engine())
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    (wave,) = by["serve.wave"]
    assert wave.fields == {"requests": [0, 1, 2, 3], "batch": 4, "padded": 11,
                           "prompt_tokens": sum(map(len, PROMPTS))}
    (pre,) = by["serve.prefill"]
    assert pre.fields == {"batch": 4, "padded": 11} and pre.parent == wave.id
    assert [s.fields["step"] for s in by["serve.decode"]] == list(range(NEW - 1))
    assert all(s.fields["graph"] == "eager" and s.fields["captured"] is False
               for s in by["serve.decode"])  # no graph on the CPU
    assert [s.fields["step"] for s in by["serve.tokens"]] == list(range(NEW))
    for s in by["serve.decode"] + by["serve.tokens"]:
        assert s.parent == wave.id
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in got)
    if not torch.cuda.is_initialized():  # timing events only where CUDA is in use
        assert all(s.device_s is None for s in got)
    assert recorder.open == []


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_layer_spans_nest_under_their_pass(recorder, dispatch):
    _, got, _ = traced(engine(dispatch))
    wave = next(s for s in got if s.name == "serve.wave")
    passes = [s for s in got if s.name in ("serve.prefill", "serve.decode")]
    assert len(passes) == NEW
    first_moe = tiny.MOE["moe_first_dense"]
    want = ([("attn", i) for i in range(first_moe)] + [("mlp", i) for i in range(first_moe)]
            + [(n, i) for i in range(first_moe, tiny.MOE["n_layers"])
               for n in ("attn",) + MOE_SPANS] + [("head", None)])
    for p in passes:
        inner = [s for s in got if s.parent == p.id]
        assert Counter((s.name, s.fields.get("layer")) for s in inner) == Counter(want)
        assert p.timed == (p.name == "serve.prefill")  # decode is host-paced: untimed
        for s in inner:
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns and s.timed == p.timed
    assert {s.wave for s in got} == {wave.id}


def hybrid_engine():
    """The tiny published Zamba2 layout of ``perfbench/tests/tiny_hybrid.py``
    (7 layers, shared blocks before layers 2 and 5, B/C in 2 groups)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_tiny_hybrid", ROOT / "perfbench" / "tests" / "tiny_hybrid.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    cfg = ModelConfig(**module.HYBRID)
    return ServeEngine(cfg, Transformer(cfg, device="cpu"), batch_size=len(PROMPTS),
                       max_len=32, device="cpu"), module.HYBRID


def test_hybrid_spans_nest_and_carry_their_fields(recorder):
    """Prefill and every (eager) decode step hold a ``mamba`` span a layer,
    each holding one ``mamba.ssd`` with its layer and groups, and a
    ``shared`` span before each listed layer with its block, invocation and
    layer; the shared span closes before its layer's Mamba span opens."""
    e, m = hybrid_engine()
    _, got, _ = traced(e)
    passes = [s for s in got if s.name in ("serve.prefill", "serve.decode")]
    assert len(passes) == NEW
    by_id = {s.id: s for s in got}
    calls = {layer: j for j, layer in enumerate(m["hybrid_layer_ids"])}
    for p in passes:
        inner = sorted((s for s in got if s.parent == p.id), key=lambda s: s.start_ns)
        mamba = [s for s in inner if s.name == "mamba"]
        shared = [s for s in inner if s.name == "shared"]
        assert [s.fields for s in mamba] == [{"layer": i} for i in range(m["n_layers"])]
        assert [s.fields for s in shared] == [
            {"block": j % m["hybrid_blocks"], "invocation": j, "layer": layer}
            for layer, j in calls.items()]
        for sh in shared:
            after = next(s for s in mamba if s.fields["layer"] == sh.fields["layer"])
            assert sh.end_ns <= after.start_ns
        for s in mamba:
            (ssd,) = [t for t in got if t.parent == s.id and t.name == "mamba.ssd"]
            assert ssd.fields == {"layer": s.fields["layer"], "groups": m["ssm_groups"]}
            assert s.start_ns <= ssd.start_ns <= ssd.end_ns <= s.end_ns
            assert by_id[s.parent] is p and s.timed == p.timed
    assert recorder.open == []


def test_tokens_are_the_same_with_spans_on_and_off(recorder):
    e = engine()
    off = e.generate(PROMPTS, max_new_tokens=NEW)
    on, got, _ = traced(e)
    assert [r.tokens for r in on] == [r.tokens for r in off]
    assert len(got) > 0


def test_spans_share_the_profilers_clock(recorder):
    """Every ``aten::argmax`` (only ``serve.tokens`` runs one) and every
    ``aten::sort`` (only ``moe.route`` runs one) lies inside such a span
    on the profiler's clock."""
    _, got, prof = traced(engine())
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    for op, name in (("aten::argmax", "serve.tokens"), ("aten::sort", "moe.route")):
        ops = [(s, e) for n, s, e in events if n == op]
        holders = [(s.start_ns, s.end_ns) for s in got if s.name == name]
        assert ops and len(holders) >= NEW
        for start, end in ops:
            assert any(lo <= start and end <= hi for lo, hi in holders), (op, start)


def test_what_is_kept_stays_at_the_bound(monkeypatch):
    small = tracing.Recorder(capacity=16)
    monkeypatch.setattr(tracing, "_RECORDER", small)
    _, got, _ = traced(engine())
    assert len(got) == 16 and len(small.kept) == 16
    assert [s.id for s in got] == list(range(small.next_id - 16, small.next_id))
    assert small.next_id > 16 and got[-1].name == "serve.tokens"


@pytest.mark.card
def test_span_holds_its_device_ops_on_the_card(recorder):
    """A span around a run of matmuls that ends in a synchronize: every
    device operation the profiler records lies inside it (within 50 us),
    and its timing events' interval is within 5 % of the kernels' time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):  # cuBLAS's handle and the kernel's first launch
        b = a @ a
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("matmuls"):
            for _ in range(20):
                b = a @ a
            torch.cuda.synchronize()
        with tracing.span("untimed", timed=False):
            pass
    s, untimed = tracing.spans()
    assert untimed.device_s is None and recorder.pool  # the pair went back to the pool
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    assert len(kernels) >= 20
    slack = 50_000
    for start, end in kernels:
        assert s.start_ns - slack <= start and end <= s.end_ns + slack, (s, start, end)
    busy = sum(end - start for start, end in kernels) / 1e9
    assert abs(s.device_s - busy) <= 0.05 * busy, (s.device_s, busy)
    del b
