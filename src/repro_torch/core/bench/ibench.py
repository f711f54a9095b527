"""Semi-automatic benchmark pipeline (paper §II-B, the ibench/asmbench role),
on torch ops: the counterpart of ``repro.core.bench.ibench``.

The paper populates its instruction database by generating two synthetic
micro-benchmarks per instruction form:

* **latency**: a serial dependency chain (each op consumes the previous
  result), so steady-state time/op = latency;
* **throughput**: independent parallel chains, so steady-state time/op =
  inverse throughput.

The same methodology is re-targeted here at torch ops on the card: the
serial chain is a Python loop of the op over one tensor, the parallel
chains are ``n_parallel`` independent chains stacked in one tensor (the
counterpart of the reference's ``vmap``).  It populates the measured
per-op cost table used to sanity-check the H100 engine model
(``repro_torch.core.hlo``).

Timing is injectable: every measure function takes ``clock`` (a monotonic
seconds counter, default ``time.perf_counter``) and ``sync`` (a completion
barrier, default ``torch.cuda.synchronize`` for a tensor on the card, a
no-op on the CPU), so tests — and the ``--dry-run`` CLI path — can run the
whole pipeline deterministically without hardware counters or a card.  The
tensors live on ``device`` (``None``: the CUDA device, which raises when
there is none).  Run it as::

    python -m repro_torch.core.bench.ibench --dry-run
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.machine.model import DBEntry


@dataclass
class BenchmarkResult:
    name: str
    latency_us: float  # time per op in the serial-chain benchmark
    inverse_throughput_us: float  # time per op with independent chains
    chain_length: int
    n_parallel: int

    @property
    def ilp_speedup(self) -> float:
        if self.inverse_throughput_us == 0:
            return float("inf")
        return self.latency_us / self.inverse_throughput_us


class PopulatedEntry(NamedTuple):
    """``populate_entry``'s structured return: measurement + DB record.

    A NamedTuple so the historical ``result, entry = populate_entry(...)``
    unpacking keeps working while new callers can say ``.result``/``.entry``.
    """

    result: BenchmarkResult
    entry: DBEntry


def _default_sync(value):
    """Wait for ``value``'s device to finish; a CPU tensor is ready."""
    if value.is_cuda:
        torch.cuda.synchronize(value.device)
    return value


def _time_fn(fn: Callable, *args, repeats: int = 5,
             clock: Optional[Callable[[], float]] = None,
             sync: Optional[Callable] = None) -> float:
    """Best-of-N wall time of ``fn(*args)``, in seconds.

    ``clock``/``sync`` are injectable for deterministic tests; the defaults
    are ``time.perf_counter`` and :func:`_default_sync`.
    """
    clock = clock or time.perf_counter
    sync = sync or _default_sync
    sync(fn(*args))  # one warm-up call: lazy init + first execution
    best = float("inf")
    for _ in range(repeats):
        t0 = clock()
        sync(fn(*args))
        best = min(best, clock() - t0)
    return best


def _chain(op: Callable, chain_length: int) -> Callable:
    def chained(x):
        for _ in range(chain_length):
            x = op(x)
        return x
    return chained


def measure_latency(
    op: Callable,
    shape: Tuple[int, ...] = (128, 128),
    dtype=None,
    chain_length: int = 64,
    clock: Optional[Callable[[], float]] = None,
    sync: Optional[Callable] = None,
    device=None,
) -> float:
    """Serial dependency chain: y = op(op(...op(x)...)). µs per op."""
    x = torch.ones(shape, dtype=dtype or torch.float32,
                   device=resolve_device(device))
    total = _time_fn(_chain(op, chain_length), x, clock=clock, sync=sync)
    return total / chain_length * 1e6


def measure_throughput(
    op: Callable,
    shape: Tuple[int, ...] = (128, 128),
    dtype=None,
    chain_length: int = 64,
    n_parallel: int = 8,
    clock: Optional[Callable[[], float]] = None,
    sync: Optional[Callable] = None,
    device=None,
) -> float:
    """``n_parallel`` independent chains, stacked in one tensor: exposes
    ILP. µs per op."""
    x = torch.ones((n_parallel, *shape), dtype=dtype or torch.float32,
                   device=resolve_device(device))
    total = _time_fn(_chain(op, chain_length), x, clock=clock, sync=sync)
    return total / (chain_length * n_parallel) * 1e6


def populate_entry(
    name: str,
    op: Callable,
    shape: Tuple[int, ...] = (128, 128),
    dtype=None,
    chain_length: int = 32,
    n_parallel: int = 4,
    ports: Tuple[str, ...] = ("VPU",),
    clock: Optional[Callable[[], float]] = None,
    sync: Optional[Callable] = None,
    device=None,
) -> PopulatedEntry:
    """Run both benchmarks and emit a database entry (µs-denominated).

    This is the ibench import path of the paper: measurement → DB record.
    """
    lat = measure_latency(op, shape, dtype, chain_length,
                          clock=clock, sync=sync, device=device)
    tput = measure_throughput(op, shape, dtype, chain_length, n_parallel,
                              clock=clock, sync=sync, device=device)
    result = BenchmarkResult(
        name=name,
        latency_us=lat,
        inverse_throughput_us=tput,
        chain_length=chain_length,
        n_parallel=n_parallel,
    )
    share = tput / len(ports)
    entry = DBEntry(
        latency=lat,
        pressure={p: share for p in ports},
        note=f"measured via ibench pipeline ({chain_length}-chain x {n_parallel})",
    )
    return PopulatedEntry(result, entry)


# ---------------------------------------------------------------------------
# dry-run path — no hardware counters, no device, no torch op run
# ---------------------------------------------------------------------------

#: Ops the CLI benchmarks by default.
DEFAULT_OPS = ("exp", "tanh", "rsqrt", "add", "mul")


def _op_factory(name: str) -> Callable:
    return {
        "exp": torch.exp,
        "tanh": torch.tanh,
        "rsqrt": lambda x: torch.reciprocal(torch.sqrt(x)),
        "add": lambda x: x + 1.0,
        "mul": lambda x: x * 1.0001,
    }[name]


def dry_run_result(name: str, chain_length: int = 32,
                   n_parallel: int = 4) -> BenchmarkResult:
    """Deterministic synthetic measurement for ``--dry-run`` / tests.

    Values derive from a hash of the op name, so repeated runs (and CI on
    machines without working perf counters) agree bit-for-bit while still
    exercising every consumer of :class:`BenchmarkResult`.
    """
    h = int(hashlib.sha256(name.encode("utf-8")).hexdigest()[:8], 16)
    lat = 1.0 + (h % 400) / 100.0  # 1.00 .. 4.99 µs
    tput = lat / (1.0 + (h >> 16) % 4)  # ILP speedup 1x .. 4x
    return BenchmarkResult(name=name, latency_us=lat,
                           inverse_throughput_us=tput,
                           chain_length=chain_length, n_parallel=n_parallel)


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.core.bench.ibench",
        description="latency/throughput micro-benchmark pipeline (§II-B)")
    parser.add_argument("--dry-run", action="store_true",
                        help="deterministic synthetic results; needs no "
                             "hardware counters and runs no torch op")
    parser.add_argument("--ops", nargs="*", default=list(DEFAULT_OPS),
                        help=f"ops to benchmark (default: {DEFAULT_OPS})")
    parser.add_argument("--chain-length", type=int, default=32)
    parser.add_argument("--n-parallel", type=int, default=4)
    args = parser.parse_args(argv)
    header = f"{'op':<8} {'lat µs/op':>10} {'1/tput µs/op':>13} {'ILP':>5}"
    print(header)
    print("-" * len(header))
    for name in args.ops:
        if args.dry_run:
            result = dry_run_result(name, args.chain_length, args.n_parallel)
        else:
            result, _ = populate_entry(
                name, _op_factory(name), shape=(64, 64),
                chain_length=args.chain_length, n_parallel=args.n_parallel)
        print(f"{result.name:<8} {result.latency_us:>10.3f} "
              f"{result.inverse_throughput_us:>13.3f} "
              f"{result.ilp_speedup:>5.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
