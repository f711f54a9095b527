"""``repro_torch.core.bench.ibench`` against ``repro.core.bench.ibench``: the
``--dry-run`` output byte for byte, ``dry_run_result``, and the latency /
throughput measurements under an injected clock (the same clock sequence
gives the same numbers); then the torch chains themselves on the CPU."""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.bench.ibench as ref
import repro_torch.core.bench as port_bench
import repro_torch.core.bench.ibench as port

CPU = torch.device("cpu")
OPS = list(ref.DEFAULT_OPS) + ["gelu", "x", "a-much-longer-op-name"]


def ticking_clock(step=0.25, start=1.0):
    """A clock whose reads rise by a growing step: each timed call's delta
    differs, so best-of-N picks one of them."""
    counter = itertools.count()
    return lambda: start + sum(step * k for k in range(next(counter)))


def identity(value):
    return value


@pytest.mark.parametrize("argv", [["--dry-run"],
                                  ["--dry-run", "--ops", "exp", "gelu", "softmax"],
                                  ["--dry-run", "--chain-length", "8", "--n-parallel", "2"]])
def test_dry_run_output_equal_reference(argv, capsys):
    assert ref.main(argv) == 0
    want = capsys.readouterr().out
    assert port.main(argv) == 0
    assert capsys.readouterr().out == want
    assert want.count("\n") == 2 + len(argv[argv.index("--ops") + 1:] if "--ops" in argv
                                      else ref.DEFAULT_OPS)


@pytest.mark.parametrize("chain_length,n_parallel", [(32, 4), (64, 8), (1, 1)])
@pytest.mark.parametrize("name", OPS)
def test_dry_run_result_equal_reference(name, chain_length, n_parallel):
    want = ref.dry_run_result(name, chain_length, n_parallel)
    got = port.dry_run_result(name, chain_length, n_parallel)
    assert vars(got) == vars(want)
    assert got.ilp_speedup == want.ilp_speedup


@pytest.mark.parametrize("name", ref.DEFAULT_OPS)
def test_measurements_equal_reference_under_an_injected_clock(name):
    kw = dict(shape=(4, 4), chain_length=8)
    assert port.measure_latency(port._op_factory(name), clock=ticking_clock(), sync=identity,
                                device=CPU, **kw) == \
        ref.measure_latency(ref._op_factory(name), clock=ticking_clock(), sync=identity, **kw)
    assert port.measure_throughput(port._op_factory(name), n_parallel=3,
                                   clock=ticking_clock(0.5), sync=identity, device=CPU, **kw) == \
        ref.measure_throughput(ref._op_factory(name), n_parallel=3,
                               clock=ticking_clock(0.5), sync=identity, **kw)
    got = port.populate_entry(name, port._op_factory(name), shape=(4, 4), ports=("A", "B"),
                              clock=ticking_clock(), sync=identity, device=CPU)
    want = ref.populate_entry(name, ref._op_factory(name), shape=(4, 4), ports=("A", "B"),
                              clock=ticking_clock(), sync=identity)
    assert vars(got.result) == vars(want.result)
    assert (got.entry.latency, got.entry.pressure, got.entry.note) == \
        (want.entry.latency, want.entry.pressure, want.entry.note)


def test_chains_run_serially_and_in_parallel_on_the_cpu():
    shapes = []

    def op(x):
        shapes.append(tuple(x.shape))
        return torch.tanh(x)

    lat = port.measure_latency(op, shape=(8, 8), chain_length=5, device=CPU)
    assert shapes == [(8, 8)] * 5 * 6  # warm-up + 5 timed calls of 5 links
    shapes.clear()
    tput = port.measure_throughput(op, shape=(8, 8), chain_length=5, n_parallel=3, device=CPU)
    assert shapes == [(3, 8, 8)] * 5 * 6
    assert all(math.isfinite(t) and t > 0 for t in (lat, tput))
    result, entry = port_bench.populate_entry("tanh", torch.tanh, shape=(8, 8), device=CPU)
    assert entry.latency == result.latency_us > 0
    assert entry.pressure == {"VPU": result.inverse_throughput_us}
    x = torch.ones(2)
    assert port._default_sync(x) is x


def test_ilp_speedup_of_a_zero_time():
    assert port.BenchmarkResult("z", 1.0, 0.0, 1, 1).ilp_speedup == float("inf")


def test_op_factory_matches_the_reference_ops():
    x = torch.linspace(0.5, 2.0, 7, dtype=torch.float64)
    for name in ref.DEFAULT_OPS:
        want = ref._op_factory(name)(jnp.asarray(x.numpy()))
        got = port._op_factory(name)(x)
        torch.testing.assert_close(got, torch.tensor(np.array(want), dtype=torch.float64),
                                   rtol=1e-6, atol=1e-6)
