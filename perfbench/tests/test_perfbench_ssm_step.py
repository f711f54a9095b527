"""``ssm_step_roofline.hybrid`` on made-up traces: its launches counted by
hand on the small hybrid configuration's waves, its share at Zamba2-7B's
served shape, a trace that lost a record, and a program without the
decode step's kernel (no counter: nothing to read)."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.tests import tiny_hybrid
from perfbench.yardstick import flops
from perfbench.yardstick.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
ZAMBA = json.loads((ROOT / "perfbench" / "configs" / "zamba2-7b.json").read_text())
NAME = "ssm_step_roofline.hybrid"


def made_trace(m, launches, device, prompts, new):
    calls = [{"prompts": [list(p) for p in wave]} for wave in prompts]
    return Trace(device=device, host=[], window=None, window_s=2.0, calls=calls,
                 launches=launches, cell=SimpleNamespace(m=m, mix={"new_tokens": new}))


def reader():
    return harness.CellSpec("zamba2-serve-chat").reader(NAME)


def kernels(count, seconds):
    return [("void (anonymous namespace)::ssm_step_kernel<float, float, 64>", i * 1.0,
             i * 1.0 + seconds) for i in range(count)]


def test_counts_on_the_small_hybrid_waves():
    """Two waves of the small configuration (7 layers; 2 and 3 rows) and
    its chat mix's 6 new tokens: 5 decode steps a wave, a launch a layer
    and step. A launch of b rows (8 heads of 16, state 16, 2 groups, f32)
    moves the state twice, x and y, B and C, and dt."""
    m, new = tiny_hybrid.HYBRID, tiny_hybrid.CHAT["new_tokens"]
    waves = [((1,) * 9, (1,) * 12), ((1,) * 3,) * 3]
    count = 2 * (new - 1) * m["n_layers"]
    assert count == 70
    trace = made_trace(m, {"ssm_step": count}, kernels(count, 1e-6), waves, new)
    mod = reader()
    got = mod.launches(trace)
    assert len(got) == count
    by_rows = {b: (4 * b * 8 * 16 * 16, 4 * (2 * b * 8 * 16 * 16 + 2 * b * 8 * 16
                                            + 2 * b * 2 * 16) + 4 * b * 8) for b in (2, 3)}
    assert got == [by_rows[2]] * 35 + [by_rows[3]] * 35
    least = 35 * (flops.least_s(*by_rows[2], 67e12) + flops.least_s(*by_rows[3], 67e12))
    assert mod.read(trace) == pytest.approx(100 * least / (count * 1e-6))
    with pytest.raises(RuntimeError, match="reckoned"):  # a launch missing from the trace
        mod.read(made_trace(m, {"ssm_step": count}, kernels(count - 1, 1e-6), waves, new))


def test_share_at_the_served_shape():
    """Zamba2-7B, one wave of 64 rows and 256 new tokens: 81 x 255 launches
    of 2 x 58.7 MB of bf16 state, bounded by bytes."""
    m = ZAMBA["model"]
    count = 81 * 255
    trace = made_trace(m, {"ssm_step": count}, kernels(count, 50e-6), [((1,) * 1024,) * 64], 256)
    ops, nbytes = reader().launch(m, 64, 2)
    assert ops == 4 * 64 * 112 * 64 * 64
    assert nbytes == 2 * (2 * 64 * 112 * 64 * 64 + 2 * 64 * 112 * 64 + 2 * 64 * 2 * 64) + 4 * 64 * 112
    share = reader().read(trace)
    assert share == pytest.approx(100 * nbytes / 3.35e12 / 50e-6)
    assert 65 < share < 75


def test_nothing_to_read_without_the_kernel():
    """A program that decodes without the kernel has no such counter."""
    m, new = tiny_hybrid.HYBRID, tiny_hybrid.CHAT["new_tokens"]
    trace = made_trace(m, {"flash_decode": 10}, kernels(0, 1e-6), [((1,) * 9,)], new)
    assert reader().read(trace) is None
