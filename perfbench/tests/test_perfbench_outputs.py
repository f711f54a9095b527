"""The output check on the CPU at small sizes: the float32 program equals the
plain reference (which shows that the reference has the program's
semantics: routing groups and capacity, the left padding, decoding through
the cache), and a run driven through the harness with the timed path broken
underneath comes out not correct."""

import time

import pytest
import torch

from perfbench import harness
from perfbench.drivers import serve_waves
from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    """The small models run on one CPU thread, which other test workers
    share least; the count is restored after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def serve_run(model, calls=tiny.SERVE["sample_from"], seed=7):
    cell = tiny.cell(serve_waves, model, tiny.SERVE, seed)
    cell.setup()
    records = [cell.call(i) for i in range(calls)]
    cell.release()
    return cell, records


@pytest.mark.parametrize("model", [tiny.MOE], ids=["moe"])
def test_float32_program_serves_the_references_tokens(model):
    cell, records = serve_run(model)
    got, low = cell.readings(records, control=True)
    assert got["served_gap"] <= 1e-5 and got["logit_error"] <= 1e-5
    assert got["own_gap"] == 0 and low["own_gap"] == 0
    assert low["served_gap"] > 0  # float8 products move the logits


def run(workload, driver, model, mix):
    """A run of the workload's harness (its metrics and limits) on a small
    cell on the CPU, the look for a card skipped."""
    spec = harness.CellSpec(workload)
    return harness.run(spec, tiny.cell(driver, model, mix), 0.0, False, time.time())


@pytest.mark.parametrize("workload,model", [("moe-serve-docs", tiny.MOE)])
def test_sound_serve_run_is_correct(workload, model):
    result = run(workload, serve_waves, model, tiny.SERVE)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] % tiny.SERVE["batch_size"] == 0
    assert set(result["checks"]) == {"own_gap", "logit_error"}


@pytest.mark.parametrize("workload,model", [("moe-serve-docs", tiny.MOE)])
def test_a_token_altered_where_it_is_made_is_caught(workload, model, monkeypatch):
    """Every decode step's logits turned over, so that the engine takes the
    least likely token at every position after the first."""
    from repro_torch.serving import engine

    real = engine.decode_step

    def turned(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        return -logits, cache

    monkeypatch.setattr(engine, "decode_step", turned)
    result = run(workload, serve_waves, model, tiny.SERVE)
    assert not result["correct"]


def test_a_lone_token_altered_in_one_answer_is_caught(monkeypatch):
    """One token of one request's answer changed as the result is made: the
    served token is no longer the engine's own choice."""
    from repro_torch.serving import engine

    real = engine.GenerationResult

    def altered(request_id, prompt, tokens):
        if request_id == 1:
            tokens = list(tokens)
            tokens[2] = (tokens[2] + 1) % tiny.MOE["vocab"]
        return real(request_id=request_id, prompt=prompt, tokens=tokens)

    monkeypatch.setattr(engine, "GenerationResult", altered)
    result = run("moe-serve-docs", serve_waves, tiny.MOE, tiny.SERVE)
    assert not result["correct"]
    assert result["checks"]["own_gap"]["value"] > 0


def test_one_slot_served_another_requests_logits_is_caught(monkeypatch):
    """Slot 0 of every decode step gets slot 1's logits (a result handed to
    the wrong request, as a cache fault in one slot would): its tokens follow
    them, so only the comparison with the reference sees it, in a quarter of
    the served positions."""
    from repro_torch.serving import engine

    real = engine.decode_step

    def crossed(*args, **kwargs):
        logits, cache = real(*args, **kwargs)
        logits = logits.clone()
        logits[0] = logits[1]
        return logits, cache

    monkeypatch.setattr(engine, "decode_step", crossed)
    result = run("moe-serve-docs", serve_waves, tiny.MOE, tiny.SERVE)
    assert not result["correct"]
    assert result["checks"]["own_gap"]["value"] == 0
    check = result["checks"]["logit_error"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("model", [tiny.MOE], ids=["moe"])
def test_the_float8_control_serves_worse_than_bf16(model):
    """The control, the reference with float8 products in the program's
    place, reads wider gaps and logit errors than the bf16 program does, as
    on the card."""
    model = dict(model, dtype="bfloat16")
    sound, low = [], []
    for seed in (1, 2, 3):
        cell, records = serve_run(model, seed=seed)
        got, control = cell.readings(records, control=True)
        sound.append(got)
        low.append(control)
    for number in ("served_gap", "logit_error"):
        assert max(c[number] for c in low) > 3 * max(g[number] for g in sound)
