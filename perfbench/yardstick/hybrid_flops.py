"""Operations and bytes of the published Zamba2 layout (the hybrid family
with ``hybrid_layer_ids``), counted from shapes and the configuration, as
``flops`` counts the other families: each input byte read once and each
output byte written once, causal pairs once, elementwise work left out.

The launches a traced serve wave must hold: K2 once per shared-block
invocation at prefill; K3 once per invocation and decode step, the step
after the prompt of P positions attending P + step + 1 keys; K4 once per
Mamba layer and group of B/C at prefill, over the group's heads.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from perfbench.yardstick import flops, readers

K3 = ("flash_decode", ("decode_cluster_kernel", "decode_split_kernel"))
K4 = ("ssd_chunk_dual", ("ssd_bf16_kernel", "ssd_f32_kernel"))


def _mamba(m: dict) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, head dim, state, groups) of a Mamba layer."""
    di = m["ssm_expand"] * m["d_model"]
    return di, di // m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]


def mamba_weights(m: dict) -> int:
    """Matrix weights of one Mamba layer: in_proj and out_proj."""
    d = m["d_model"]
    di, nh, _, n, g = _mamba(m)
    return d * (di + di + 2 * g * n + nh) + di * d


def shared_weights(m: dict) -> int:
    """Matrix weights of one shared-block invocation: its attention on
    2 * d inputs, its gated MLP, the invocation's adapter and linear."""
    d, ff, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    hq, hkv = m["n_heads"] * m["d_head"], m["n_kv_heads"] * m["d_head"]
    attn = 2 * d * hq + 2 * (2 * d) * hkv + hq * d
    return attn + 3 * d * ff + r * (d + 2 * ff) + d * d


def token_weights(m: dict) -> int:
    """Matrix weights a position passes through, the embedding and the
    output head aside: every Mamba layer and every invocation."""
    return m["n_layers"] * mamba_weights(m) + len(m["hybrid_layer_ids"]) * shared_weights(m)


def served_request(m: dict, prompt: int, new: int) -> int:
    """Useful FLOPs of one request: its prompt and fed-back tokens (prompt +
    new - 1 positions) through the weights (2 a weight), the SSD's state
    update and readout at every position of every layer (2 H N P each),
    its causal pairs at every invocation, and the output head at the new
    positions."""
    positions = prompt + new - 1
    _, nh, p, n, _ = _mamba(m)
    matmul = 2 * token_weights(m) * positions + 2 * m["d_model"] * m["vocab"] * new
    ssd = 4 * nh * n * p * m["n_layers"] * positions
    attn = 4 * m["n_heads"] * m["d_head"] * len(m["hybrid_layer_ids"]) * flops.pairs(
        positions, positions, True)
    return matmul + ssd + attn


def k3(b: int, length: int, h: int, kv: int, d: int, elem: int = 2) -> Tuple[int, int]:
    """flash decode (K3): q (b,1,h,d) against ``length`` cache rows of k/v
    (b,T,kv,d) per batch row, out like q."""
    ops = 4 * b * h * d * length
    nbytes = elem * (2 * b * h * d + 2 * b * length * kv * d)
    return ops, nbytes


def k4(b: int, nc: int, h: int, q: int, p: int, n: int, elem: int = 2) -> Tuple[int, int]:
    """SSD intra-chunk step (K4) on h heads sharing one group's B and C:
    xdt (b,nc,h,q,p) and cum (b,nc,h,q) in f32 and B/C (b,nc,q,n) of
    ``elem`` bytes in; y (b,nc,h,q,p) and the states (b,nc,h,n,p) in f32
    out. Operations: the scores C.B^T over the causal pairs once a chunk,
    then per head M.X over those pairs and the state's B^T.(w xdt)."""
    pairs = q * (q + 1) // 2
    ops = b * nc * (2 * pairs * n + h * (2 * pairs * p + 2 * q * n * p))
    nbytes = (4 * b * nc * h * (q * p + q + q * p + n * p)) + elem * 2 * b * nc * q * n
    return ops, nbytes


def k2_launches(trace) -> List[Tuple[int, int]]:
    m = readers.model(trace)
    elem, _ = readers.dtype(m)
    return [flops.k2(b, s, s, m["n_heads"], m["n_kv_heads"], m["d_head"], True, 0, elem)
            for b, s in readers.serve_waves(trace) for _ in m["hybrid_layer_ids"]]


def k3_launches(trace) -> List[Tuple[int, int]]:
    m, new = readers.model(trace), trace.cell.mix["new_tokens"]
    elem, _ = readers.dtype(m)
    return [k3(b, s + step + 1, m["n_heads"], m["n_kv_heads"], m["d_head"], elem)
            for b, s in readers.serve_waves(trace) for step in range(new - 1)
            for _ in m["hybrid_layer_ids"]]


def k4_launches(trace) -> List[Tuple[int, int]]:
    m = readers.model(trace)
    elem, _ = readers.dtype(m)
    _, nh, p, n, g = _mamba(m)
    out = []
    for b, s in readers.serve_waves(trace):
        q = min(m["ssm_chunk"], s)
        out += [k4(b, math.ceil(s / q), nh // g, q, p, n, elem)] * (m["n_layers"] * g)
    return out
