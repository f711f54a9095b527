"""Operation and byte counts of the yardstick against hand counts and brute
force at small shapes."""

import itertools
import json
import math
from pathlib import Path

import pytest

from perfbench.drivers import common
from perfbench.tests import tiny
from perfbench.yardstick import flops

ROOT = Path(__file__).resolve().parents[2]


def brute_pairs(s, t, causal, window):
    return sum(1 for i, j in itertools.product(range(s), range(t))
               if (not causal or j <= i) and (not window or j > i - window))


@pytest.mark.parametrize("s,t,causal,window", [(1, 1, True, 0), (3, 3, True, 0), (17, 17, True, 0),
                                               (5, 5, True, 2), (9, 9, True, 9), (9, 9, True, 4),
                                               (2, 5, False, 0), (7, 3, False, 0)])
def test_pairs_match_brute_force(s, t, causal, window):
    assert flops.pairs(s, t, causal, window) == brute_pairs(s, t, causal, window)


def test_k2_hand_counts():
    # causal b1 s3 h1 kv1 d2: 6 pairs, 4 flops a pair and dim; q, k, v, out
    # of 6 elements each at 2 bytes
    assert flops.k2(1, 3, 3, 1, 1, 2, True) == (48, 48)
    # not causal, b2 s2 t5 h4 kv2 d8: 10 pairs a head; q and out 2*2*4*8,
    # k and v 2*5*2*8 elements
    ops, nbytes = flops.k2(2, 2, 5, 4, 2, 8, False)
    assert ops == 4 * 2 * 4 * 8 * 10
    assert nbytes == 2 * (2 * 2 * 2 * 4 * 8 + 2 * 2 * 5 * 2 * 8)
    # grouped-query heads change bytes, not operations
    assert flops.k2(1, 4, 4, 8, 1, 16, True)[0] == flops.k2(1, 4, 4, 8, 8, 16, True)[0]


def test_served_request_moe_hand_count():
    m = tiny.MOE
    attn = 64 * 64 * 4  # wq, wk, wv, wo at d 64, 4 heads of 16
    dense = attn + 3 * 64 * 96
    moe = attn + 64 * 8 + (2 + 1) * 3 * 64 * 32  # router, top 2 + 1 shared
    assert flops.token_weights(m) == dense + 2 * moe
    positions = 10 + 3 - 1
    want = (2 * (dense + 2 * moe) * positions + 2 * 64 * 250 * 3
            + 4 * 4 * 16 * 3 * positions * (positions + 1) // 2)
    assert flops.served_request(m, 10, 3) == want


@pytest.mark.parametrize("config", ["deepseek-moe-16b"])
def test_published_sizes(config):
    """The parameter count of the published configuration, counted by hand
    from its config.json: the embedding and the head, 28 attention blocks
    and their two norms, the final norm, one dense SwiGLU of 10,944, and 27
    MoE layers of 64 routed and 2 shared experts of 1,408 and a router."""
    m = json.loads((ROOT / "perfbench" / "configs" / f"{config}.json").read_text())["model"]
    spec = common.family(m).param_spec(m)
    total = sum(math.prod(shape) for shape, _ in spec.values())
    d, layers = 2048, 28
    want = (2 * 102400 * d + layers * (4 * d * d + 2 * d) + d + 3 * d * 10944
            + (layers - 1) * ((64 + 2) * 3 * d * 1408 + 64 * d))
    assert want == 16_375_728_128
    assert total == want
