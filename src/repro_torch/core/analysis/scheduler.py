"""Optimal µ-op→port assignment: the *balanced* block-throughput bound.

The paper's §II-B model (``uniform()``) charges every instruction a *fixed*
``t/n`` pressure on each of its *n* equivalent ports.  That over-predicts
congestion whenever two instruction classes share only part of their port
sets: the hardware scheduler is free to push flexible work onto the less
contended ports.  The correct bound under perfect out-of-order scheduling is
the **min-max port load over all feasible fractional µ-op→port assignments**
— the restricted-assignment makespan LP, whose optimum has the classic
water-filling characterization

    T* = max over port subsets S of  demand(S) / |S|,

where ``demand(S)`` sums the cycles of µ-ops whose eligible ports all lie in
``S`` (work that *cannot* escape ``S``).  Single-port (pinned) µ-ops are just
singleton-eligibility classes, so pre-baked per-port DB entries fall out of
the same formula and make ``balanced == optimistic``.

The solver here peels tight sets iteratively (the water level drops after
each peel), evaluating each level's ``argmax`` over subsets with one
vectorized NumPy pass over a ``(classes × subsets)`` bitmask containment
matrix.  The subset space is ``2^k`` for ``k`` *contended* ports — ports
reachable by at least one multi-port µ-op — which is small on real machine
models (≤ 9 on the shipped DBs); ports that only ever receive pinned work
never enter the enumeration.

The pass stays in NumPy on the host, as in ``repro.core.analysis.scheduler``.
Its one float64 reduction, ``demands @ contained``, goes to NumPy's BLAS,
whose summation order is that of the kernel OpenBLAS picks for the host CPU
at run time: its Haswell and Sandybridge kernels round non-dyadic demands
such as 1/3 or 0.1 differently, so no one fixed order on a device reproduces
the reference on every host (``tests/test_torch_analysis.py::
test_blas_kernel_sets_the_demand_bits``).  What is left around that product,
a bitwise containment test and one argmax, is too small to pay for a round
trip to the card.

:func:`brute_force_min_max` is the differential-test oracle: an independent
pure-Python enumeration over *all* subsets of *all* relevant ports, no
peeling, no vectorization, no contended-port restriction.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import combinations
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

#: Hard cap on the vectorized subset enumeration: 2^18 subsets ≈ 2 MB of
#: masks.  No shipped model comes close (k ≤ 9); a pathological custom model
#: beyond it falls back to enumerating only unions of eligibility sets.
_MAX_ENUM_PORTS = 18


@dataclass(frozen=True)
class BalancedSchedule:
    """Result of one kernel-global min-max port assignment."""

    bound: float  # optimal makespan T*: min over assignments of max port load
    port_load: Dict[str, float]  # per-port load under the optimal assignment
    bottleneck_port: str = ""
    #: Water-filling levels, outermost peel first: (level, ports) pairs.
    levels: Tuple[Tuple[float, Tuple[str, ...]], ...] = ()


#: Memo for :func:`_part_class_items`: DB entries are shared across costs
#: (the model's lookup memo) and immutable, so each part's class-item
#: decomposition is computed once.  Keyed by ``id`` with a strong reference
#: to the part, which keeps the id stable; crudely bounded for long-lived
#: serving processes.
_class_items_memo: Dict[int, tuple] = {}


def _part_class_items(part) -> Tuple[Tuple[frozenset, float], ...]:
    """One cost part's ``(eligible port frozenset, cycles)`` items, in the
    order :func:`gather_classes` accumulates them."""
    ent = _class_items_memo.get(id(part))
    if ent is not None and ent[0] is part:
        return ent[1]
    if part.uops is not None:
        items = tuple((frozenset(ports), cycles)
                      for cycles, ports in part.uops if cycles)
    else:
        items = tuple((frozenset((port,)), cy)
                      for port, cy in part.pressure.items() if cy)
    if len(_class_items_memo) >= 1 << 16:
        _class_items_memo.clear()
    _class_items_memo[id(part)] = (part, items)
    return items


def gather_classes(costs) -> Dict[frozenset, float]:
    """Aggregate a resolved kernel's µ-ops into eligibility classes.

    Returns ``{eligible port frozenset: total cycles}``.  Every cost part
    (arithmetic entry + split load/store µ-ops) contributes; parts without
    explicit ``uops`` contribute their ``pressure`` items as pinned
    single-port classes (the already-assigned fast path).  Macro-fused
    compares contribute nothing, mirroring ``InstructionCost.total_pressure``.
    """
    classes: Dict[frozenset, float] = {}
    get = classes.get
    for cost in costs:
        if cost.fused_away:
            continue
        for part in (cost.entry, cost.load, cost.store):
            if part is None:
                continue
            for key, cycles in _part_class_items(part):
                classes[key] = get(key, 0.0) + cycles
    return classes


#: Memo for :func:`_subset_masks`: a pure function of the subset count, and
#: ``n_subsets`` is bounded by ``1 << _MAX_ENUM_PORTS``, so at most 18 distinct
#: entries ever exist per process.  The arrays are frozen — callers only read
#: them (masking copies).
_subset_masks_memo: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}


def _subset_masks(n_subsets: int) -> Tuple[np.ndarray, np.ndarray]:
    """All non-empty subset bitmasks of ``k`` ports plus their popcounts."""
    cached = _subset_masks_memo.get(n_subsets)
    if cached is not None:
        return cached
    subs = np.arange(1, n_subsets, dtype=np.int64)
    sizes = np.zeros_like(subs)
    shifted = subs.copy()
    while shifted.any():
        sizes += shifted & 1
        shifted >>= 1
    subs.setflags(write=False)
    sizes.setflags(write=False)
    _subset_masks_memo[n_subsets] = (subs, sizes)
    return subs, sizes


def _union_closure(masks: Iterable[int], cap: int = 1 << 16) -> List[int]:
    """Closure of the eligibility masks under union (fallback search space
    for models with more contended ports than the dense enumeration allows).
    """
    closed = set(masks)
    frontier = list(closed)
    while frontier:
        m = frontier.pop()
        for other in list(closed):
            u = m | other
            if u not in closed:
                if len(closed) >= cap:
                    return sorted(closed)
                closed.add(u)
                frontier.append(u)
    return sorted(closed)


def _tight_set(demands: np.ndarray, masks: np.ndarray,
               candidates: np.ndarray, sizes: np.ndarray) -> Tuple[float, int]:
    """The water level and its tight port set: argmax demand(S)/|S|.

    One vectorized pass: a ``(classes × candidates)`` containment test
    (``class_mask & ~S == 0``) folds class demands into per-subset demand.
    """
    contained = (masks[:, None] & ~candidates[None, :]) == 0
    demand = demands @ contained
    ratios = demand / sizes
    best = int(np.argmax(ratios))
    return float(ratios[best]), int(candidates[best])


def min_max_load(classes: Mapping[frozenset, float],
                 ports: Sequence[str] = ()) -> BalancedSchedule:
    """Solve the fractional min-max port-load problem exactly.

    ``classes`` maps eligible port sets to total cycles of work; ``ports``
    (optional) fixes the key order of the returned ``port_load`` dict and
    adds zero-load entries for unused machine ports.

    Peeling loop: find the tightest subset ``S*`` (the highest water level),
    fix its ports at that level, drop ``S*``'s ports from every remaining
    class (an optimal schedule puts no escapable work on a saturated set),
    and repeat on the residual problem.
    """
    port_load: Dict[str, float] = {p: 0.0 for p in ports}
    levels: List[Tuple[float, Tuple[str, ...]]] = []

    # Pinned-only ports never interact with balancing decisions: their load
    # is their own demand.  Only ports reachable by a multi-port class join
    # the subset enumeration (as do pinned classes *on* those ports, which
    # raise the water level there).
    contended: set = set()
    for eligible in classes:
        if len(eligible) > 1:
            contended.update(eligible)
    pinned_only: Dict[str, float] = {}
    flex: Dict[frozenset, float] = {}
    for eligible, cycles in classes.items():
        if len(eligible) == 1 and next(iter(eligible)) not in contended:
            (port,) = eligible
            pinned_only[port] = pinned_only.get(port, 0.0) + cycles
        else:
            flex[eligible] = flex.get(eligible, 0.0) + cycles
    for port, cycles in pinned_only.items():
        port_load[port] = cycles

    order = sorted(contended)
    bit = {p: i for i, p in enumerate(order)}
    masks = np.array(
        [sum(1 << bit[p] for p in eligible) for eligible in flex],
        dtype=np.int64)
    demands = np.array([flex[eligible] for eligible in flex],
                       dtype=np.float64)

    dense = len(order) <= _MAX_ENUM_PORTS
    if dense and order:
        all_subs, all_sizes = _subset_masks(1 << len(order))
    while masks.size:
        if dense:
            # Restrict to subsets of the ports still in play.
            alive = 0
            for m in masks:
                alive |= int(m)
            keep = (all_subs & ~alive) == 0
            candidates, sizes = all_subs[keep], all_sizes[keep]
        else:
            candidates = np.array(_union_closure(int(m) for m in masks),
                                  dtype=np.int64)
            sizes = np.array([int(c).bit_count() for c in candidates],
                             dtype=np.int64)
        level, tight = _tight_set(demands, masks, candidates, sizes)
        for p, i in bit.items():
            if tight >> i & 1:
                port_load[p] = level
        levels.append(
            (level, tuple(p for p in order if tight >> bit[p] & 1)))
        keep = (masks & ~tight) != 0
        masks = masks[keep] & ~tight
        demands = demands[keep]

    bound = max(port_load.values(), default=0.0)
    bottleneck = ""
    if port_load:
        bottleneck = max(port_load, key=lambda p: port_load[p])
    return BalancedSchedule(bound=bound, port_load=port_load,
                            bottleneck_port=bottleneck,
                            levels=tuple(levels))


def balance_from_costs(costs, ports: Sequence[str] = ()) -> BalancedSchedule:
    """Kernel-global optimal assignment from resolved instruction costs."""
    return min_max_load(gather_classes(costs), ports)


# ---------------------------------------------------------------------------
# Differential-test oracle
# ---------------------------------------------------------------------------


def brute_force_min_max(classes: Mapping[frozenset, float]) -> float:
    """Independent enumeration oracle for the optimal makespan.

    Pure Python, no peeling, no vectorization, no contended-port restriction:
    evaluates ``demand(S)/|S|`` for *every* non-empty subset ``S`` of the
    full relevant port set.  Exponential in the port count — tests only.
    """
    ports = sorted({p for eligible in classes for p in eligible})
    best = 0.0
    for k in range(1, len(ports) + 1):
        for subset in combinations(ports, k):
            s = set(subset)
            demand = sum(cycles for eligible, cycles in classes.items()
                         if eligible <= s)
            best = max(best, demand / k)
    return best


def linprog_min_max(classes: Mapping[frozenset, float]):
    """LP oracle via ``scipy.optimize.linprog`` (``None`` if scipy missing).

    Variables: one assignment fraction per (class, eligible port) pair plus
    the makespan ``T``; minimize ``T`` subject to per-class conservation and
    per-port load ≤ ``T``.  Verifies *feasibility* of the combinatorial
    bound, not just the subset formula.
    """
    try:
        from scipy.optimize import linprog
    except ImportError:  # pragma: no cover - scipy is present in CI
        return None
    ports = sorted({p for eligible in classes for p in eligible})
    if not ports:
        return 0.0
    port_index = {p: i for i, p in enumerate(ports)}
    pairs = [(ci, port_index[p])
             for ci, eligible in enumerate(classes) for p in sorted(eligible)]
    n = len(pairs) + 1  # + T
    c = np.zeros(n)
    c[-1] = 1.0
    a_eq = np.zeros((len(classes), n))
    b_eq = np.array(list(classes.values()), dtype=np.float64)
    for col, (ci, _) in enumerate(pairs):
        a_eq[ci, col] = 1.0
    a_ub = np.zeros((len(ports), n))
    for col, (_, pi) in enumerate(pairs):
        a_ub[pi, col] = 1.0
    a_ub[:, -1] = -1.0
    res = linprog(c, A_ub=a_ub, b_ub=np.zeros(len(ports)),
                  A_eq=a_eq, b_eq=b_eq, bounds=[(0, None)] * n,
                  method="highs")
    return float(res.fun) if res.success else None
