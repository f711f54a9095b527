"""The reader of ``decode_graph_share.serve`` on made-up spans and a made-up
trace (the helpers of ``test_perfbench_spans.py``): all replays, a mix, all
eager, spans without the ``graph`` field (an earlier program's), none
recorded, and a program without spans."""

import sys

import pytest

from perfbench.tests.test_perfbench_spans import OPS, read, trace_of, wave
from perfbench.yardstick import spans as yard

NAME = "decode_graph_share.serve"


@pytest.fixture
def made(monkeypatch):
    made = []
    monkeypatch.setattr(yard, "recorded", lambda: made)
    return made


@pytest.mark.parametrize("first,second,want", [
    (["replay"] * 2, ["replay"] * 3, 100.0),
    (["replay"] * 2, ["eager", "replay", "eager"], 100.0 * 3 / 5),
    (["eager"] * 2, ["eager"] * 3, 0.0),
    ([None] * 2, [None] * 3, 0.0),  # an earlier program's spans carry no such field
], ids=["all-replays", "a-mix", "all-eager", "no-field"])
def test_replayed_steps_over_all(made, first, second, want):
    """The replayed ``serve.decode`` spans over all of them, across the two
    traced waves; the host-recorded wave after them counts for nothing."""
    for t0, tokens, modes in ((0, [110, 150, 190], first), (200, [260, 270, 280, 290], second),
                              (400, [450, 460], ["eager"])):
        wave(made, t0, tokens)
        decode = [s for s in made if s.name == "serve.decode" and not s.fields]
        assert len(decode) == len(modes)
        for s, mode in zip(decode, modes):
            s.fields = {"step": 0} if mode is None else {"step": 0, "graph": mode,
                                                          "captured": False}
    trace = trace_of(OPS + [(205, 250), (262, 272), (285, 300)])
    assert read(NAME, trace) == pytest.approx(want)


def test_no_spans_nothing_to_read(made):
    assert read(NAME, trace_of(OPS)) is None


def test_a_program_without_spans(monkeypatch):
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(NAME, trace_of(OPS)) is None
