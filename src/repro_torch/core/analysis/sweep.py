"""Batched all-sources longest-path sweep over a topologically-ordered DAG.

The LCD analysis needs, for every candidate source ``s``, the longest
node-weighted path from ``s`` to every other node.  Running one DP per source
costs O(S·(V+E)) Python-interpreted work; instead we keep a ``(S × V)``
float64 distance matrix as a torch tensor on the device of the weights and
make a *single* forward sweep over node ids (ids are already topological:
every dependency edge points forward), reducing each node's column from its
predecessor columns with a ``max``-over-predecessors.  Total work is O(V)
sweep steps of O(S · indeg) tensor arithmetic — one pass, regardless of how
many sources there are.

The sweep's structure (the CSR, the weights, the start rows) comes in as
host arrays and stays there, so no step of the loop waits for the device:
the predecessor ids and the start rows go to the device in one copy each,
and only the distance and parent rows live on it.

Semantics match ``repro.core.analysis.sweep`` and the scalar DP bit-for-bit,
including tie-breaking:

* among equal-distance predecessors the *first* in insertion order wins
  (``torch.max`` over a dimension returns the first maximal index on the CPU
  and on CUDA, as the scalar ``>`` scan does);
* a source node starts at its own weight unless a longer (or equal) path
  from the row's allowed starts already reaches it — path-through wins ties.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

NEG_INF = float("-inf")

# Unreachable sentinel for the batched sweep.  A finite sentinel instead of
# -inf lets the inner loop skip reachability masks entirely: real path sums
# (|weight sums| < 1e12 in both the cycle and seconds domains) can never climb
# within 1e17 of it, and float64 has whole-number resolution ~128 at 1e18, so
# sentinel + weights stays far below REACH_THRESHOLD.
UNREACHABLE = -1.0e18
REACH_THRESHOLD = -1.0e17

#: Batched sweeps run, by the device type their distance matrix lived on.
SWEEPS: Dict[str, int] = {"cpu": 0, "cuda": 0}


def reset_sweeps() -> None:
    for name in SWEEPS:
        SWEEPS[name] = 0


def is_reached(value: float) -> bool:
    return value > REACH_THRESHOLD


def pred_csr_from_lists(preds: Sequence[Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    """Predecessor adjacency lists -> CSR ``(ptr, idx)`` in insertion order."""
    ptr = np.zeros(len(preds) + 1, dtype=np.int64)
    for v, p in enumerate(preds):
        ptr[v + 1] = ptr[v] + len(p)
    idx = np.fromiter((u for p in preds for u in p), dtype=np.int64,
                      count=int(ptr[-1]))
    return ptr, idx


def batched_longest_paths(
    ptr: np.ndarray,
    idx: np.ndarray,
    weights: Sequence[float],
    starts_per_row: Sequence[Sequence[int]],
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-sweep longest paths from each row's allowed start set.

    ``ptr``/``idx`` is the host predecessor CSR (node ids topologically
    ordered, edges forward); ``weights`` the host per-node weight vector; row
    ``r`` may only start paths at nodes in ``starts_per_row[r]``.  The sweep
    runs on ``device`` (``None``: the CUDA device, see
    :func:`repro_torch.resolve_device`).

    Returns ``(D, P)``, float64 and int64 tensors on ``device``:
    ``D[r, v]`` is the maximum weight sum over paths from
    ``starts_per_row[r]`` ending at ``v`` (below :data:`REACH_THRESHOLD` — see
    :func:`is_reached` — if unreachable), ``P[r, v]`` the predecessor of ``v``
    on that path (``-1`` at path starts; arbitrary junk on unreachable
    entries, which callers must filter with :func:`is_reached` first).
    """
    device = resolve_device(device)
    n = len(weights)
    n_rows = len(starts_per_row)
    # Node-major layout: D[v] is one contiguous row per node, so the
    # per-node predecessor gather reads (indeg × rows) contiguous rows and
    # writes one contiguous row — the sweep's whole working set streams.
    D = torch.full((n, n_rows), UNREACHABLE, dtype=torch.float64,
                   device=device)
    P = torch.full((n, n_rows), -1, dtype=torch.int64, device=device)
    SWEEPS[device.type] = SWEEPS.get(device.type, 0) + 1
    if n == 0 or n_rows == 0:
        return D.T, P.T

    # node id -> rows allowed to start there.
    start_rows: Dict[int, List[int]] = {}
    for r, starts in enumerate(starts_per_row):
        for v in starts:
            start_rows.setdefault(int(v), []).append(r)
    # All start rows reach the device in one copy; each node gets a slice.
    flat = torch.tensor([r for rows in start_rows.values() for r in rows],
                        dtype=torch.int64, device=device)
    start_idx, offset = {}, 0
    for v, rows in start_rows.items():
        start_idx[v] = flat[offset:offset + len(rows)]
        offset += len(rows)

    ptr_l = np.asarray(ptr).tolist()
    idx_l = np.asarray(idx).tolist()
    idx_d = torch.tensor(idx_l, dtype=torch.int64, device=device)
    w_l = np.asarray(weights, dtype=np.float64).tolist()
    for v in range(n):
        lo, hi = ptr_l[v], ptr_l[v + 1]
        if hi - lo == 1:
            u = idx_l[lo]
            torch.add(D[u], w_l[v], out=D[v])
            P[v] = u
        elif hi > lo:
            p = idx_d[lo:hi]
            best, arg = D[p].max(dim=0)     # (indeg × rows) gather, first max
            torch.add(best, w_l[v], out=D[v])
            torch.index_select(p, 0, arg, out=P[v])
        rows = start_idx.get(v)
        if rows is not None:
            wv = w_l[v]
            dv = D[v].index_select(0, rows)
            # Path-through wins ties (strict <), matching the scalar DP.
            take = dv < wv
            D[v].index_copy_(0, rows, torch.where(take, wv, dv))
            P[v].index_copy_(0, rows,
                             torch.where(take, -1, P[v].index_select(0, rows)))
    return D.T, P.T


def single_longest_path(
    preds: Sequence[Sequence[int]],
    weights: Sequence[float],
) -> Tuple[List[float], List[int]]:
    """Scalar all-starts longest path (every node may begin a path).

    The CP analysis needs just one unrestricted DP; a plain Python sweep over
    precomputed predecessor lists beats NumPy's per-node dispatch overhead at
    these graph sizes and keeps tie-breaking identical to the reference.
    """
    n = len(weights)
    dist = [0.0] * n
    parent = [-1] * n
    for v in range(n):
        best = NEG_INF
        best_pred = -1
        for u in preds[v]:
            if dist[u] > best:
                best = dist[u]
                best_pred = u
        if best == NEG_INF:
            dist[v] = weights[v]
        else:
            dist[v] = best + weights[v]
            parent[v] = best_pred
    return dist, parent


def backtrack(parent_row: Sequence[int], v: int) -> List[int]:
    """Follow parent pointers from ``v`` back to a path start; returns the
    node ids in forward order."""
    path: List[int] = []
    v = int(v)
    while v != -1:
        path.append(v)
        v = int(parent_row[v])
    path.reverse()
    return path
