"""Flash attention (prefill): the CUDA kernel and its plain version.

Both take the model's layouts, q (B,S,H,D) against k/v (B,T,K,D) with
H a multiple of K, and read KV head ``h // (H/K)`` for query head h: no KV
head is copied and nothing is transposed. Both mask the ragged edge, so any
S and T work, skip KV tiles no query can see, and give 0 for a query that
sees no key. Query i sits at position ``i + q_offset``; the scores are
``scale * q.k`` in f32 (``scale`` None: ``1 / sqrt(D)``; q is never
scaled before its product), and ``softcap > 0`` caps them as
``softcap * tanh(s / softcap)``, as
``repro.models.layers.chunked_attention`` does. The kernel
(``csrc/flash_attention.cu``: bf16 on Hopper's wgmma, fed by TMA; f32 on
the CUDA cores) replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention_bhsd``. TMA reads the
bf16 q, k and v through tensor maps (the f32 kernel in 16-byte vectors),
so each must start on 16 bytes and have batch and sequence strides of
whole 16 bytes (:func:`check_tma_layout`); the wrapper raises on any
other, and copies nothing.

Its gradient (``flash_attention_backward``) is plain PyTorch in f32, run by
``ops.FlashAttention``'s backward: the reference differentiates through its
eager attention with ``jax.grad`` and has no backward kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (32, 64, 80, 96, 128, 224)
BLOCK_K = 64  # keys per KV tile, as in the bf16 kernel
NEG_INF = -1e30
# The backward recomputes the scores one block of queries at a time: a block
# holds at most this many (batch, head, query, key) elements, so that each of
# its f32 transients (scores, P, dP, dS) stays near 32 MB whatever S and T.
BACKWARD_BLOCK_ELEMENTS = 1 << 23


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in f64 where it is f64 (so that gradcheck can run the
    plain versions and the backward in double precision)."""
    return t if t.dtype == torch.float64 else t.float()


def _visible(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
             window: int) -> torch.Tensor:
    """(S, Tk) mask of the keys each query may attend to."""
    mask = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _as_terms(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """p as the kernel feeds it to the P.V product: for bf16, the sum of
    two bf16 terms hi = bf16(p) and lo = bf16(p - hi) (exact in f32)."""
    if dtype != torch.bfloat16:
        return p
    hi = p.to(dtype).float()
    return hi + (p - hi).to(dtype).float()


def softmax_scale(d: int, scale: Optional[float]) -> float:
    """The scores' scale: ``scale``, or ``1 / sqrt(d)`` where it is None."""
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0, q_offset: int = 0,
                          softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's algorithm in PyTorch: online softmax over KV tiles of
    ``BLOCK_K`` keys with f32 running max, sum and accumulator. For bf16
    inputs p enters the P.V product as two bf16 terms, hi + lo (as the bf16
    kernel carries it), and the sum l is taken from the f32 p."""
    b, s, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    scale = softmax_scale(d, scale)
    qg = _wide(q).reshape(b, s, n_kv, g, d)
    f = dict(device=q.device, dtype=qg.dtype)
    qpos = torch.arange(s, device=q.device) + q_offset
    m = torch.full((b, n_kv, g, s), NEG_INF, **f)
    l = torch.zeros((b, n_kv, g, s), **f)
    acc = torch.zeros((b, n_kv, g, s, d), **f)
    hi = max(0, min(t, s + q_offset)) if causal else t
    for t0 in range(0, hi, BLOCK_K):
        kt = _wide(k[:, t0:t0 + BLOCK_K])
        vt = v[:, t0:t0 + BLOCK_K]
        kpos = torch.arange(t0, t0 + kt.shape[1], device=q.device)
        valid = _visible(qpos, kpos, causal, window)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kt) * scale
        if softcap > 0:
            sc = softcap * torch.tanh(sc / softcap)
        sc = sc.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None]).masked_fill(~valid, 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", _as_terms(p, v.dtype), _wide(vt))
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: int = 0, q_offset: int = 0,
                             softcap: float = 0.0, scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of the attention that gave ``out`` for the
    output gradient ``dout``, in f32 (f64 for f64 inputs), each cast to its
    input's dtype.

    Per block of queries it recomputes ``s = scale q k^T`` (``scale``
    None: ``1 / sqrt(D)``, written so below) against the
    keys the block can see (query head h reads KV head ``h // (H/K)``), the
    softcap ``c tanh(s / c)``, the masks and ``P = softmax(s)``; then
    ``dV += sum over the group of P^T dO``, ``dP = dO V^T``,
    ``dS = P (dP - rowsum(dO * O))``, times ``1 - tanh^2`` under the softcap,
    ``dQ = dS K / sqrt(D)`` and ``dK += sum over the group of dS^T Q /
    sqrt(D)``. A query that sees no key has output 0 and gradient 0."""
    b, s, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    scale = softmax_scale(d, scale)
    qg = _wide(q).reshape(b, s, n_kv, g, d)
    dog = _wide(dout).reshape(b, s, n_kv, g, d)
    # rowsum(dO * O): (B,K,G,S)
    delta = (dog * _wide(out).reshape(b, s, n_kv, g, d)).sum(-1).permute(0, 2, 3, 1)
    k32, v32 = _wide(k), _wide(v)
    f = dict(device=q.device, dtype=qg.dtype)
    dq = torch.zeros((b, s, n_kv, g, d), **f)
    dk = torch.zeros((b, t, n_kv, d), **f)
    dv = torch.zeros((b, t, n_kv, d), **f)
    block = max(1, BACKWARD_BLOCK_ELEMENTS // max(1, b * h * t))
    for s0 in range(0, s, block):
        s1 = min(s, s0 + block)
        # Keys the block's queries (positions s0 + q_offset .. s1 - 1 +
        # q_offset) can see: [lo, hi).
        hi = max(0, min(t, s1 + q_offset)) if causal else t
        lo = min(hi, max(0, s0 + q_offset - window + 1)) if window > 0 else 0
        if hi <= lo:
            continue
        qb, dob = qg[:, s0:s1], dog[:, s0:s1]
        kb, vb = k32[:, lo:hi], v32[:, lo:hi]
        qpos = torch.arange(s0, s1, device=q.device) + q_offset
        valid = _visible(qpos, torch.arange(lo, hi, device=q.device), causal, window)
        sc = torch.einsum("bskgd,btkd->bkgst", qb, kb) * scale
        if softcap > 0:
            cap = torch.tanh(sc / softcap)
            sc = softcap * cap
        p = torch.softmax(sc.masked_fill(~valid, NEG_INF), dim=-1).masked_fill(~valid, 0.0)
        dv[:, lo:hi] += torch.einsum("bkgst,bskgd->btkd", p, dob)
        dp = torch.einsum("bskgd,btkd->bkgst", dob, vb)
        ds = p * (dp - delta[..., s0:s1, None])
        if softcap > 0:
            ds = ds * (1.0 - cap.square())
        dq[:, s0:s1] = torch.einsum("bkgst,btkd->bskgd", ds, kb) * scale
        dk[:, lo:hi] += torch.einsum("bkgst,bskgd->btkd", ds, qb) * scale
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes one of f32/bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash attention kernel needs q (B,S,H,D) and k/v "
                         f"(B,T,K,D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"flash attention kernel: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes D in {HEAD_DIMS}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or x.stride(2) != d:
            raise ValueError(f"flash attention kernel needs {name} with unit "
                             f"stride over D and heads D apart, got strides "
                             f"{x.stride()}")


def _strides(x: torch.Tensor) -> tuple:
    """(batch, sequence) strides of a (B, S, H, D) tensor, where a dim of
    size 1 takes the stride a contiguous tensor would give it (its own is
    never read, and may be anything)."""
    s_row = x.stride(1) if x.shape[1] > 1 else x.shape[2] * x.shape[3]
    s_b = x.stride(0) if x.shape[0] > 1 else x.shape[1] * s_row
    return s_b, s_row


def check_tma_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the kernels can read q, k and v in place: each starts on
    a 16-byte boundary and steps over its batch and sequence dims by whole
    16 bytes (``_strides``), as the bf16 kernel's TMA tensor maps and the
    f32 kernel's vector loads require. Device-independent, so it runs
    before anything is built."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        size = x.element_size()
        if x.data_ptr() % 16 or any(st * size % 16 for st in _strides(x)):
            raise ValueError(f"flash attention kernel (TMA) needs {name} 16-byte "
                             f"aligned with batch and sequence strides of whole "
                             f"16 bytes, got address {x.data_ptr():#x} and strides "
                             f"{x.stride()} of {size}-byte elements")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0, q_offset: int = 0,
                         softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel; the output is a new contiguous (B,S,H,D) tensor."""
    check_tma_layout(q, k, v)
    _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"flash attention kernel needs q_offset >= 0, got {q_offset}")
    b, s, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    fn = _build.entry("flash_attention", f"repro_flash_attention_{DTYPES[q.dtype]}",
                      [P, P, P, P, I, I, I, I, I, I, L, L, L, L, L, L, L, L,
                       I, I, I, F, F, P])
    _build.check("flash_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t, h, n_kv, d,
        *_strides(q), *_strides(k), *_strides(v), out.stride(0), out.stride(1),
        int(causal), int(window), int(q_offset), softmax_scale(d, scale), float(softcap),
        _build.stream()))
    return out
