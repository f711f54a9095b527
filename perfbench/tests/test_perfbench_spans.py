"""The readers of the program's spans (``ttft_ms.serve``,
``token_gap_ms.serve``, ``decode_idle_share.serve``,
``moe_dispatch_share.serve``) on a made-up trace and made-up spans, against
values worked out by hand; and what they read where the program records no
spans, as an earlier commit's program does not."""

import sys
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.yardstick import spans as yard
from perfbench.yardstick.trace import Trace

BASE = 1_800_000_000 * 10 ** 9  # Unix-epoch ns, the profiler's clock
MS = 10 ** 6
# The trace holds epoch seconds as floats, 0.24 us apart near BASE: an idle
# share over 30-80 ms is good to about 1e-3 percent.
CLOCK = 1e-3
READERS = ("ttft_ms.serve", "token_gap_ms.serve", "decode_idle_share.serve",
           "moe_dispatch_share.serve")


def read(name, trace):
    return harness.CellSpec("moe-serve-docs").reader(name).read(trace)


class Wave:
    """Spans of one wave, its times in ms after ``BASE``."""

    def __init__(self, made, start, end):
        self.made = made
        self.root = self.add("serve.wave", start, end, None)

    def add(self, name, start, end, parent, device_ms=None):
        s = SimpleNamespace(id=len(self.made), name=name, start_ns=BASE + start * MS,
                            end_ns=BASE + end * MS, parent=parent, fields={},
                            device_s=None if device_ms is None else device_ms / 1e3)
        s.wave = s.id if parent is None else self.root.id
        self.made.append(s)
        return s


def wave(made, t0, tokens, prefill_ms=90.0, routing=(10.0, 5.0, 6.0), layers=2):
    """A wave starting at ``t0`` (ms): prefill (device time ``prefill_ms``)
    holding per layer ``attn``, ``moe.route``, ``moe.dispatch``,
    ``moe.experts``, ``moe.combine`` and ``moe.shared`` (the routing spans'
    device ms ``routing``), then ``serve.tokens`` spans ending at
    ``tokens`` (ms) with ``serve.decode`` spans between them."""
    w = Wave(made, t0, tokens[-1] + 10)
    pre = w.add("serve.prefill", t0 + 1, tokens[0] - 10, w.root.id, prefill_ms)
    route, dispatch, combine = routing
    for layer in range(layers):
        for name, ms in (("attn", 20.0), ("moe.route", route), ("moe.dispatch", dispatch),
                         ("moe.experts", 30.0), ("moe.combine", combine),
                         ("moe.shared", 4.0)):
            w.add(name, t0 + 2, t0 + 3, pre.id, ms / layers)
    w.add("head", t0 + 4, t0 + 5, pre.id, 0.1)
    last = tokens[0] - 10
    for i, end in enumerate(tokens):
        if i:
            w.add("serve.decode", last, end - 10, w.root.id, 25.0)
        w.add("serve.tokens", end - 10, end, w.root.id, 0.5)
        last = end
    return w


def trace_of(device_ms):
    device = [("op", (BASE + s * MS) / 1e9, (BASE + e * MS) / 1e9) for s, e in device_ms]
    return Trace(device=device, host=[], window=None, window_s=1.0, calls=[], launches={},
                 cell=None)


@pytest.fixture
def made(monkeypatch):
    made = []
    monkeypatch.setattr(yard, "recorded", lambda: made)
    return made


# Decode of the first wave runs from 110 ms (end of its first tokens) to 190
# ms (end of its last): device ops [105, 120] (partly inside), [125, 135],
# [155, 175] and [185, 195] (partly) are busy 10 + 10 + 20 + 5 = 45 of 80
# ms, so idle 35 / 80. Its prefill's routing spans take (10 + 5 + 6) / 90 of
# the prefill's device time.
OPS = [(2, 100), (105, 120), (125, 135), (155, 175), (185, 195)]


def test_one_wave_by_hand(made):
    wave(made, 0, [110, 150, 190])
    trace = trace_of(OPS)
    assert read("ttft_ms.serve", trace) == pytest.approx(110.0)
    assert read("token_gap_ms.serve", trace) == pytest.approx(40.0)
    assert read("decode_idle_share.serve", trace) == pytest.approx(100.0 * 35 / 80, abs=CLOCK)
    assert read("moe_dispatch_share.serve", trace) == pytest.approx(100.0 * 21 / 90)


def test_the_host_recorded_call_is_left_out(made):
    """A wave that began after the trace's last device op (the call
    recorded with the host) counts in no reader."""
    wave(made, 0, [110, 150, 190])
    wave(made, 300, [350, 360, 370, 380], prefill_ms=10.0, routing=(5.0, 5.0, 0.0))
    trace = trace_of(OPS)
    assert read("ttft_ms.serve", trace) == pytest.approx(110.0)
    assert read("token_gap_ms.serve", trace) == pytest.approx(40.0)
    assert read("decode_idle_share.serve", trace) == pytest.approx(100.0 * 35 / 80, abs=CLOCK)
    assert read("moe_dispatch_share.serve", trace) == pytest.approx(100.0 * 21 / 90)


def test_two_traced_waves(made):
    """Median first-token time, mean gap, and the shares over both waves'
    summed intervals and device times."""
    wave(made, 0, [110, 150, 190])
    wave(made, 200, [260, 270, 280, 290], prefill_ms=50.0, routing=(4.0, 2.0, 0.0))
    # second decode: 260 to 290; op [262, 272] and [285, 300] busy 10 + 5
    trace = trace_of(OPS + [(205, 250), (262, 272), (285, 300)])
    assert read("ttft_ms.serve", trace) == pytest.approx((110.0 + 60.0) / 2)
    assert read("token_gap_ms.serve", trace) == pytest.approx((40.0 + 10.0) / 2)
    assert read("decode_idle_share.serve", trace) == pytest.approx(100.0 * (35 + 15) / (80 + 30),
                                                                abs=CLOCK)
    assert read("moe_dispatch_share.serve", trace) == pytest.approx(100.0 * (21 + 6) / (90 + 50))


def test_no_device_times_no_dispatch_share(made):
    wave(made, 0, [110, 150, 190])
    for s in made:
        s.device_s = None
    trace = trace_of(OPS)
    assert read("moe_dispatch_share.serve", trace) is None
    assert read("ttft_ms.serve", trace) == pytest.approx(110.0)


@pytest.mark.parametrize("name", READERS)
def test_no_spans_nothing_to_read(made, name):
    assert read(name, trace_of(OPS)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans(monkeypatch, name):
    """An earlier commit's program has no ``repro_torch.tracing``: the
    readers read nothing and raise nothing."""
    import repro_torch

    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert yard.recorded() == []
    assert read(name, trace_of(OPS)) is None
