"""Operations and bytes, counted from shapes and the configuration.

A kernel launch's least time is the larger of its operations at the peak
rate and its bytes at the memory rate, each input byte read once and each
output byte written once; causal (query, key) pairs count once. The model
counts give the useful work of a served request; they leave out every
elementwise operation, so they are lower bounds.
"""

from __future__ import annotations

from typing import Tuple

from perfbench.yardstick import peaks


def pairs(s: int, t: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs per head: query i of s (the last s of t keys when
    causal, so s == t here) sees keys j <= i, and only the last ``window``
    of them when a window is set."""
    if not causal:
        return s * t
    if s != t:
        raise ValueError("causal pairs are counted for s == t")
    if window and window < s:
        return window * (window + 1) // 2 + (s - window) * window
    return s * (s + 1) // 2


def k2(b: int, s: int, t: int, h: int, kv: int, d: int, causal: bool, window: int = 0,
       elem: int = 2) -> Tuple[int, int]:
    """flash attention (K2): q (b,s,h,d), k/v (b,t,kv,d), out like q."""
    ops = 4 * b * h * d * pairs(s, t, causal, window)
    nbytes = elem * (2 * b * s * h * d + 2 * b * t * kv * d)
    return ops, nbytes


def least_s(ops: int, nbytes: int, peak_flops: float = peaks.BF16_FLOPS) -> float:
    return max(ops / peak_flops, nbytes / peaks.HBM_BYTES)


def _attn(m: dict, d_in: int) -> int:
    hq, hkv = m["n_heads"] * m["d_head"], m["n_kv_heads"] * m["d_head"]
    return d_in * hq + 2 * d_in * hkv + hq * m["d_model"]


def token_weights(m: dict) -> int:
    """Matrix weights a token's position passes through, the embedding and
    the output head aside: for moe its top-k and shared experts and the
    router."""
    d = m["d_model"]
    if m["family"] == "moe":
        ffe = m["moe_d_ff"]
        dense = _attn(m, d) + 3 * d * m["d_ff"]
        moe = (_attn(m, d) + d * m["moe_experts"]
               + (m["moe_top_k"] + m["moe_shared"]) * 3 * d * ffe)
        return m["moe_first_dense"] * dense + (m["n_layers"] - m["moe_first_dense"]) * moe
    raise NotImplementedError(m["family"])


def served_request(m: dict, prompt: int, new: int) -> int:
    """Useful FLOPs of one request: its prompt and its fed-back tokens
    (prompt + new - 1 positions) through the weights, its causal pairs in
    every attention layer, and the output head at the new positions."""
    positions = prompt + new - 1
    matmul = 2 * token_weights(m) * positions + 2 * m["d_model"] * m["vocab"] * new
    attn = 4 * m["n_heads"] * m["d_head"] * m["n_layers"] * pairs(
        positions, positions, True, m.get("window", 0))
    return matmul + attn
