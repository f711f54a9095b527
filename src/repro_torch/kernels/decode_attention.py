"""Flash decode: the CUDA kernel and its plain version.

Both take the model's layouts, q (B,1,H,D) against a KV cache k/v (B,T,K,D)
with ``lengths`` (B,) valid positions per row, and compute the G = H/K query
heads of a group against their KV head in place. Both stop at ``lengths``
(any T works) and give zeros where it is 0, as the TPU kernel does. The
kernel (``csrc/decode_attention.cu``) replaces the TPU kernel
``repro/kernels/decode_attention.py:decode_attention_bkgd``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (32, 64, 80, 128)
NEG_INF = -1e30


def block_k(d: int) -> int:
    """Keys per KV tile, as in the kernel."""
    return 64 if d <= 64 else 32


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm in PyTorch: online softmax over KV tiles up to
    the longest row, each row masked to its own length."""
    b, _, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    scale = 1.0 / math.sqrt(d)
    qg = q[:, 0].float().reshape(b, n_kv, g, d)
    lens = lengths.to(device=q.device, dtype=torch.int64).clamp(0, t)
    m = torch.full((b, n_kv, g), NEG_INF, device=q.device)
    l = torch.zeros((b, n_kv, g), device=q.device)
    acc = torch.zeros((b, n_kv, g, d), device=q.device)
    bk = block_k(d)
    for t0 in range(0, int(lens.max()) if b else 0, bk):
        kt = k[:, t0:t0 + bk].float()
        vt = v[:, t0:t0 + bk].float()
        kpos = torch.arange(t0, t0 + kt.shape[1], device=q.device)
        valid = (kpos[None, :] < lens[:, None])[:, None, None, :]  # (B,1,1,bk)
        sc = torch.einsum("bkgd,btkd->bkgt", qg, kt) * scale
        sc = sc.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None]).masked_fill(~valid, 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgt,btkd->bkgd", p, vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor) -> None:
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev and lengths.device == dev):
        raise ValueError(f"flash decode kernel needs q, k, v, lengths on one "
                         f"CUDA device, got {q.device}, {k.device}, {v.device}, "
                         f"{lengths.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash decode kernel takes one of f32/bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"flash decode kernel needs int32 lengths, got {lengths.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash decode kernel needs q (B,1,H,D) and k/v "
                         f"(B,T,K,D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    n_kv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % n_kv or lengths.shape != (b,):
        raise ValueError(f"flash decode kernel: k/v {tuple(k.shape)} or lengths "
                         f"{tuple(lengths.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or h // n_kv > 32:
        raise ValueError(f"flash decode kernel takes D in {HEAD_DIMS} and at "
                         f"most 32 query heads per KV head, got D={d}, "
                         f"G={h // n_kv}")
    if not (q.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("flash decode kernel needs contiguous q and lengths")
    vec = 16 // q.element_size()
    for name, x in (("k", k), ("v", v)):
        if x.stride(3) != 1 or x.stride(2) != d or x.stride(0) % vec or x.stride(1) % vec:
            raise ValueError(f"flash decode kernel needs {name} with unit stride "
                             f"over D, heads D apart and 16-byte aligned rows, "
                             f"got strides {x.stride()}")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel; the output is a new contiguous (B,1,H,D) tensor."""
    _check(q, k, v, lengths)
    b, _, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    fn = _build.entry("decode_attention", f"repro_decode_attention_{DTYPES[q.dtype]}",
                      [P, P, P, P, P, I, I, I, I, I, L, L, L, L, L, L, F, P])
    _build.check("decode_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, n_kv, h // n_kv, t, d,
        q.stride(0), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), 1.0 / math.sqrt(d), _build.stream()))
    return out
