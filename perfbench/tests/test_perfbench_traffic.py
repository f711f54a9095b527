"""The traffic: deterministic for a seed, within the mix's ranges, and the
same work for every seed."""

import json
from pathlib import Path

import pytest

from perfbench.drivers import serve_waves

ROOT = Path(__file__).resolve().parents[2]
DOCS = json.loads((ROOT / "perfbench" / "traffic" / "docs-short-answer.json").read_text())
SEEDS = [0, 1, 2 ** 31 + 11, 2 ** 33 + 5]


def test_lengths_are_the_clipped_lognormal_quantiles():
    lengths = serve_waves.lengths(DOCS)
    assert len(lengths) == DOCS["batch_size"] == 24
    assert lengths == sorted(lengths)
    assert min(lengths) >= DOCS["prompt_min"] and max(lengths) == DOCS["prompt_max"]
    assert lengths[11] < DOCS["prompt_median"] < lengths[12]  # the median between the middle two
    assert max(lengths) + DOCS["new_tokens"] <= 4096  # the published context


@pytest.mark.parametrize("seed", SEEDS)
def test_waves_are_deterministic_and_in_range(seed):
    vocab = 102400
    for index in (-1, 0, 1, 7):
        a = serve_waves.wave(DOCS, seed, index, vocab)
        assert a == serve_waves.wave(DOCS, seed, index, vocab)
        assert sorted(len(p) for p in a) == serve_waves.lengths(DOCS)
        assert all(1 <= t < vocab for p in a for t in p)
    assert serve_waves.wave(DOCS, seed, 0, vocab) != serve_waves.wave(DOCS, seed, 1, vocab)


def test_seeds_place_the_same_lengths_differently():
    waves = [serve_waves.wave(DOCS, s, 0, 32000) for s in SEEDS]
    orders = {tuple(len(p) for p in w) for w in waves}
    assert len(orders) > 1
    assert {tuple(sorted(o)) for o in orders} == {tuple(serve_waves.lengths(DOCS))}
