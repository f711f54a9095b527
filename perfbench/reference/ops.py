"""Plain float32 building blocks of the reference models.

Every product of a weight goes through ``mm``: ``exact`` (float32, with the
card's TF32 switched off by ``float32_strict``) for the reference, or
``fp8`` for the control, which rounds both operands to float8 e4m3 under one
scale per tensor, as a float8 GEMM would, and adds in float32. Attention
scores are formed per batch row and per block of heads, so that the
reference fits beside nothing else on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def float32_strict() -> None:
    """float32 products in float32, not TF32, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def _fp8(t: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        scale = t.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    # The rounding passes gradients straight through (float8 forward GEMMs).
    return t + (q - t).detach() if t.requires_grad else q


def fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _fp8(x) @ _fp8(w)


MATMULS = {"exact": exact, "fp8": fp8}


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor, mm) -> torch.Tensor:
    gate, up = mm(x, wi).chunk(2, dim=-1)
    return mm(F.silu(gate) * up, wo)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0 .. S-1 on x (B,S,H,D): the two halves of D
    rotate together, (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x: torch.Tensor, w: dict, m: dict, mm, head_block: int = 4) -> torch.Tensor:
    """Causal self-attention (windowed when ``m["window"]``) of x (B,S,d_in)
    with rope; ``w`` holds wq, wk, wv, wo. Grouped query heads: head h reads
    key/value head h // (H / K)."""
    b, s, _ = x.shape
    h, kv, d = m["n_heads"], m["n_kv_heads"], m["d_head"]
    q = rope(mm(x, w["wq"]).view(b, s, h, d), m["rope_theta"])
    k = rope(mm(x, w["wk"]).view(b, s, kv, d), m["rope_theta"])
    v = mm(x, w["wv"]).view(b, s, kv, d)
    pos = torch.arange(s, device=x.device)
    allowed = pos[None, :] <= pos[:, None]
    if m.get("window"):
        allowed &= pos[None, :] > pos[:, None] - m["window"]
    group = h // kv
    scale = 1.0 / math.sqrt(d)
    rows = []
    for i in range(b):
        heads = []
        for h0 in range(0, h, head_block):
            idx = torch.arange(h0, min(h0 + head_block, h), device=x.device)
            qi = q[i][:, idx].transpose(0, 1)  # (hb,S,D)
            ki = k[i][:, idx // group].transpose(0, 1)
            vi = v[i][:, idx // group].transpose(0, 1)
            scores = (qi @ ki.transpose(1, 2)) * scale
            scores = scores.masked_fill(~allowed, float("-inf"))
            heads.append(torch.softmax(scores, dim=-1) @ vi)  # (hb,S,D)
        rows.append(torch.cat(heads, dim=0).transpose(0, 1).reshape(s, h * d))
    return mm(torch.stack(rows), w["wo"])


def padded_vocab(m: dict) -> int:
    return (m["vocab"] + 15) // 16 * 16


# -- parameter specs shared by the families: name -> (shape, init) ----------------


def attn_spec(prefix: str, m: dict, d_in: int) -> dict:
    hq, hkv = m["n_heads"] * m["d_head"], m["n_kv_heads"] * m["d_head"]
    spec = {f"{prefix}.wq": ((d_in, hq), "normal"), f"{prefix}.wk": ((d_in, hkv), "normal"),
            f"{prefix}.wv": ((d_in, hkv), "normal"), f"{prefix}.wo": ((hq, m["d_model"]), "normal")}
    if m.get("qk_norm"):
        raise NotImplementedError("qk_norm is not in this reference")
    return spec


def mlp_spec(prefix: str, m: dict, d_in: int) -> dict:
    if m["act"] != "swiglu":
        raise NotImplementedError("only swiglu is in this reference")
    return {f"{prefix}.wi": ((d_in, 2 * m["d_ff"]), "normal"),
            f"{prefix}.wo": ((m["d_ff"], m["d_model"]), "normal")}


def head_spec(m: dict) -> dict:
    d, v = m["d_model"], padded_vocab(m)
    spec = {"embed": ((v, d), "normal"), "final_norm": ((d,), "ones")}
    if not m.get("tie_embeddings"):
        spec["lm_head"] = ((d, v), "normal")
    return spec


def attn_weights(w, p: str) -> dict:
    return {k: w(f"{p}.{k}") for k in ("wq", "wk", "wv", "wo")}


def lm_logits(x: torch.Tensor, head: torch.Tensor, m: dict, mm) -> torch.Tensor:
    """float32 logits over the true vocabulary."""
    return mm(x, head)[..., :m["vocab"]]
