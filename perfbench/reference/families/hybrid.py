"""The hybrid family in plain float32: the published Zamba2 stack
(Zamba2-7B, arXiv:2411.15242), as transformers' ``modeling_zamba2.py``
computes it without a cache.

Every layer i is a Mamba-2 layer, x = x + Mamba_i(RMSNorm(x + t)). At the
j-th of ``hybrid_layer_ids`` a shared block runs first, block b = j mod
``hybrid_blocks``: a = Attn_b(RMSNorm(concat(x, x0))), x0 the embeddings,
with rope over the whole head and the scores scaled by ``attn_scale``; then
t = MLP_b,j(RMSNorm(a)) @ linear_j, where MLP_b,j(h) = (gelu(g) * u) @ wo_b
(exact erf GELU) and [g, u] = h @ wi_b + (h @ adapter_in_j) @ adapter_out_j.
Elsewhere t = 0. The logits are RMSNorm(x) @ embed^T (tied).

Mamba_i(h): h @ in_proj splits into z, xBC and dt; xBC = silu(causal
depthwise conv of width K over xBC, plus its bias) splits into x (H heads
of P), B and C (G groups of N each; head h reads group h // (H / G)); dt =
max(softplus(dt + dt_bias), ssm_dt_min); A = -exp(A_log); the state runs
h_t = exp(dt A) h_{t-1} + dt B_t x_t^T and y_t = C_t h_t + D x_t; out =
GroupRMSNorm(y * silu(z)) @ out_proj, each of the G groups of channels
normalised apart. The scan is the state-space dual form in chunks of
``CHUNK`` positions (64, not the program's 256): inside a chunk the masked
products (C_i . B_j) exp(cum_i - cum_j), across chunks the recurrence of
the chunks' states, one group of heads at a time over the whole batch.

Nothing here reads the program. Attention is computed per batch row and per
block of heads, so that the reference fits beside nothing else on the card.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.ops import head_spec, lm_logits, rms, rope

CHUNK = 64  # positions of a chunk of the scan (the program's is 256)


def param_spec(m: dict) -> dict:
    d, di, r = m["d_model"], m["ssm_expand"] * m["d_model"], m["adapter_rank"]
    nh, n, g = di // m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]
    conv = di + 2 * g * n
    hq, hkv, ff = m["n_heads"] * m["d_head"], m["n_kv_heads"] * m["d_head"], m["d_ff"]
    spec = head_spec(m)
    for i in range(m["n_layers"]):
        p = f"layers.{i}"
        spec.update({f"{p}.mamba.in_proj": ((d, di + conv + nh), "normal"),
                     f"{p}.mamba.conv_w": ((m["ssm_conv"], conv), "normal"),
                     f"{p}.mamba.conv_b": ((conv,), "normal"),
                     f"{p}.mamba.A_log": ((nh,), "a_log"), f"{p}.mamba.D": ((nh,), "ones"),
                     f"{p}.mamba.dt_bias": ((nh,), "dt_bias"),
                     f"{p}.mamba.ssm_norm": ((di,), "ones"),
                     f"{p}.mamba.out_proj": ((di, d), "normal"), f"{p}.norm1": ((d,), "ones")})
        if i in m["hybrid_layer_ids"]:
            spec.update({f"{p}.linear": ((d, d), "normal"),
                         f"{p}.adapter_in": ((d, r), "normal"),
                         f"{p}.adapter_out": ((r, 2 * ff), "normal")})
    for b in range(m["hybrid_blocks"]):
        p = f"blocks.{b}"
        spec.update({f"{p}.attn.wq": ((2 * d, hq), "normal"),
                     f"{p}.attn.wk": ((2 * d, hkv), "normal"),
                     f"{p}.attn.wv": ((2 * d, hkv), "normal"),
                     f"{p}.attn.wo": ((hq, d), "normal"),
                     f"{p}.mlp.wi": ((d, 2 * ff), "normal"), f"{p}.mlp.wo": ((ff, d), "normal"),
                     f"{p}.norm1": ((2 * d,), "ones"), f"{p}.norm2": ((d,), "ones")})
    return spec


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], m: dict, mm,
              head_block: int = 16) -> torch.Tensor:
    """Causal self-attention of x (B,S,2d) with rope and the scores scaled
    by ``attn_scale``; head h reads key/value head h // (H / K)."""
    b, s, _ = x.shape
    h, kv, d = m["n_heads"], m["n_kv_heads"], m["d_head"]
    q = rope(mm(x, w["attn.wq"]).view(b, s, h, d), m["rope_theta"])
    k = rope(mm(x, w["attn.wk"]).view(b, s, kv, d), m["rope_theta"])
    v = mm(x, w["attn.wv"]).view(b, s, kv, d)
    pos = torch.arange(s, device=x.device)
    allowed = pos[None, :] <= pos[:, None]
    group, rows = h // kv, []
    for i in range(b):
        heads = []
        for h0 in range(0, h, head_block):
            idx = torch.arange(h0, min(h0 + head_block, h), device=x.device)
            qi = q[i][:, idx].transpose(0, 1)  # (hb,S,D)
            ki = k[i][:, idx // group].transpose(0, 1)
            vi = v[i][:, idx // group].transpose(0, 1)
            scores = (qi @ ki.transpose(1, 2)) * m["attn_scale"]
            scores = scores.masked_fill(~allowed, float("-inf"))
            heads.append(torch.softmax(scores, dim=-1) @ vi)
        rows.append(torch.cat(heads, dim=0).transpose(0, 1).reshape(s, h * d))
    return mm(torch.stack(rows), w["attn.wo"])


def mlp(x: torch.Tensor, w: Dict[str, torch.Tensor], adapter, mm) -> torch.Tensor:
    """(gelu(g) * u) @ wo, [g, u] = x @ wi + (x @ A) @ B, exact GELU."""
    gu = mm(x, w["mlp.wi"]) + mm(mm(x, adapter[0]), adapter[1])
    gate, up = gu.chunk(2, dim=-1)
    return mm(F.gelu(gate) * up, w["mlp.wo"])


def scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
         cm: torch.Tensor) -> torch.Tensor:
    """y (B,S,H,P): x (B,S,H,P), dt (B,S,H), a = -exp(A_log) (H,), B/C
    (B,S,G,N), head h reading group h // (H / G); the dual form in chunks of
    CHUNK, one group of heads at a time."""
    b, s, nh, p = x.shape
    g = bm.shape[2]
    pad = -s % CHUNK
    x, dt, bm, cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, bm, cm))
    nc, per = x.shape[1] // CHUNK, nh // g
    cum = torch.cumsum((dt * a).reshape(b, nc, CHUNK, nh), dim=2)  # (B,nc,Q,H)
    xdt = (x * dt[..., None]).reshape(b, nc, CHUNK, nh, p)
    bc, cc = (t.reshape(b, nc, CHUNK, g, -1) for t in (bm, cm))
    i = torch.arange(CHUNK, device=x.device)
    below = i[None, :] <= i[:, None]  # (Q,Q): j <= i
    ys = []
    for grp in range(g):
        heads = slice(grp * per, (grp + 1) * per)
        cg, xg, bg, qg = cum[..., heads], xdt[:, :, :, heads], bc[:, :, :, grp], cc[:, :, :, grp]
        ch = cg.permute(0, 1, 3, 2)  # (B,nc,h,Q)
        diff = ch[..., :, None] - ch[..., None, :]
        decay = torch.where(below, torch.exp(torch.where(below, diff, 0.0)), 0.0)
        scores = torch.einsum("bcin,bcjn->bcij", qg, bg)
        y = torch.einsum("bchij,bcjhp->bcihp", scores[:, :, None] * decay, xg)
        del diff, decay
        last = torch.exp(cg[:, :, -1:] - cg)  # (B,nc,Q,h)
        states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bg, last, xg)
        h = torch.zeros_like(states[:, 0])
        entering = []
        for c in range(nc):
            entering.append(h)
            h = torch.exp(cg[:, c, -1])[..., None, None] * h + states[:, c]
        y = y + (torch.einsum("bcin,bchnp->bcihp", qg, torch.stack(entering, dim=1))
                 * torch.exp(cg)[..., None])
        ys.append(y)
    return torch.cat(ys, dim=3).reshape(b, nc * CHUNK, nh, p)[:, :s]


def mamba(x: torch.Tensor, w, p: str, m: dict, mm) -> torch.Tensor:
    """The Mamba-2 mixer on x (B,S,d), already normed."""
    b, s, _ = x.shape
    di = m["ssm_expand"] * m["d_model"]
    hd, n, g, k = m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"], m["ssm_conv"]
    nh = di // hd
    proj = mm(x, w(f"{p}.in_proj"))
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * g * n], proj[..., 2 * di + 2 * g * n:]
    conv_w, padded = w(f"{p}.conv_w"), F.pad(xbc, (0, 0, k - 1, 0))
    xbc = sum(padded[:, j:j + s] * conv_w[j] for j in range(k)) + w(f"{p}.conv_b")
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(b, s, nh, hd)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = torch.clamp(F.softplus(dt + w(f"{p}.dt_bias")), min=m["ssm_dt_min"])
    y = scan(xs, dt, -torch.exp(w(f"{p}.A_log")), bm, cm)
    y = (y + w(f"{p}.D")[:, None] * xs).reshape(b, s, di)
    gated = (y * F.silu(z)).reshape(b, s, g, di // g)
    normed = rms(gated, torch.ones((), device=x.device), m["norm_eps"]).reshape(b, s, di)
    return mm(normed * w(f"{p}.ssm_norm"), w(f"{p}.out_proj"))


def hidden(m: dict, w, tokens: torch.Tensor, prompt: int, mm) -> torch.Tensor:
    """Final-normed hidden states (B,S,d) of tokens (B,S). ``w(name)`` gives
    a weight in float32; ``prompt`` is not read (every position is computed
    alike)."""
    eps = m["norm_eps"]
    x = w("embed")[tokens]
    x0 = x
    calls = {layer: j for j, layer in enumerate(m["hybrid_layer_ids"])}
    for i in range(m["n_layers"]):
        p = f"layers.{i}"
        h = x
        if i in calls:
            q = f"blocks.{calls[i] % m['hybrid_blocks']}"
            bw = {k: w(f"{q}.{k}") for k in ("attn.wq", "attn.wk", "attn.wv", "attn.wo",
                                              "mlp.wi", "mlp.wo", "norm1", "norm2")}
            a = attention(rms(torch.cat([x, x0], dim=-1), bw["norm1"], eps), bw, m, mm)
            del bw["attn.wq"], bw["attn.wk"], bw["attn.wv"], bw["attn.wo"]
            adapter = (w(f"{p}.adapter_in"), w(f"{p}.adapter_out"))
            h = x + mm(mlp(rms(a, bw["norm2"], eps), bw, adapter, mm), w(f"{p}.linear"))
            del a, bw, adapter
        x = x + mamba(rms(h, w(f"{p}.norm1"), eps), w, f"{p}.mamba", m, mm)
        del h
    return rms(x, w("final_norm"), eps)


def serve_logits(m: dict, w, tokens: torch.Tensor, prompt: int, mm) -> torch.Tensor:
    """float32 logits (B, S - prompt + 1, vocab) at positions prompt - 1 ..
    S - 1: those from which the served tokens were chosen."""
    x = hidden(m, w, tokens, prompt, mm)[:, prompt - 1:]
    return lm_logits(x, w("lm_head") if not m.get("tie_embeddings") else w("embed").T, m, mm)
