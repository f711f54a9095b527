"""Public wrappers of the port's kernels, in the model's layouts.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the CUDA kernel, or the wrapper raises. Nothing falls back from one to the
other. ``LAUNCHES`` counts, per wrapper, the kernels it has launched; a plain
version adds nothing to it.

``fused_rmsnorm``, ``flash_attention`` and ``ssd_chunk_dual`` go through the
autograd Functions ``FusedRMSNorm``, ``FlashAttention`` and ``SSDChunkDual``
whenever grad mode is on and an input requires grad. The kernels write into
fresh outputs through ctypes, which autograd cannot see through, so each
Function runs the forward (kernel on the card, plain version on the CPU)
under no_grad and brings its own backward: plain PyTorch in f32
(``rmsnorm_rows_backward``, ``flash_attention_backward``,
``ssd_intra_chunk_backward``), the same on either device. Autograd never
traces ``flash_attention_plain``, a tiled Python loop, nor
``ssd_intra_chunk_plain``, whose bf16 path feeds its products as hi + lo
terms (autograd would give ``lo`` a zero derivative): SSDChunkDual's
backward is the gradient of the exact f32 function.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm_rows_backward, rmsnorm_rows_cuda,
                                         rmsnorm_rows_plain)
from repro_torch.kernels.ssd_scan import (ssd_intra_chunk_backward, ssd_intra_chunk_cuda,
                                          ssd_intra_chunk_plain)

LAUNCHES: Dict[str, int] = {"fused_rmsnorm": 0, "flash_attention": 0,
                            "flash_decode": 0, "ssd_chunk_dual": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.is_cuda:
        return rmsnorm_rows_plain(x, w, eps)
    out = rmsnorm_rows_cuda(x.reshape(-1, x.shape[-1]), w, eps)
    LAUNCHES["fused_rmsnorm"] += 1
    return out.reshape(x.shape)


def _attention(q, k, v, kw) -> torch.Tensor:
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, **kw)
    out = flash_attention_cuda(q, k, v, **kw)
    LAUNCHES["flash_attention"] += 1
    return out


def _ssd(xdt, cum, bm, cm):
    if not xdt.is_cuda:
        return ssd_intra_chunk_plain(xdt, cum, bm, cm)
    # The kernel reads strided views but needs unit stride over P and N.
    xdt, bm, cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (xdt, bm, cm))
    out = ssd_intra_chunk_cuda(xdt, cum, bm, cm)
    LAUNCHES["ssd_chunk_dual"] += 1
    return out


class FusedRMSNorm(torch.autograd.Function):
    """``fused_rmsnorm`` with a gradient; saves x and w."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return _rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (*rmsnorm_rows_backward(x, w, g, ctx.eps), None)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient; saves q, k, v and the output, and
    recomputes the probabilities in backward, one block of queries at a
    time."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, softcap):
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        out = _attention(q, k, v, ctx.kw)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


class SSDChunkDual(torch.autograd.Function):
    """``ssd_chunk_dual`` with a gradient; saves xdt, cum, B and C (views as
    given) and recomputes the decay and scores in backward, one block of
    heads at a time."""

    @staticmethod
    def forward(ctx, xdt, cum, bm, cm):
        ctx.save_for_backward(xdt, cum, bm, cm)
        return _ssd(xdt, cum, bm, cm)

    @staticmethod
    def backward(ctx, dy, dstates):
        return ssd_intra_chunk_backward(*ctx.saved_tensors, dy, dstates)


def fused_rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
                  eps: float = 1e-5) -> torch.Tensor:
    """x (..., d) RMSNorm with learned scale w (d,)."""
    if _needs_grad(x, w):
        return FusedRMSNorm.apply(x, w, eps)
    return _rmsnorm(x, w, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,D); k/v (B,T,K,D) grouped-query -> (B,S,H,D)."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, q_offset, softcap)
    return _attention(q, k, v, dict(causal=causal, window=window, q_offset=q_offset,
                                     softcap=softcap))


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor, *, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """q (B,1,H,D); k/v cache (B,T,K,D); lengths (B,) -> (B,1,H,D). One
    launch counts both passes (split and combine) of one call."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, lengths, window=window,
                                      softcap=softcap)
    out = decode_attention_cuda(q, k_cache, v_cache, lengths, window=window,
                                softcap=softcap)
    LAUNCHES["flash_decode"] += 1
    return out


def ssd_chunk_dual(xdt: torch.Tensor, cum: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD intra-chunk step: xdt (B,NC,H,Q,P) f32, cum (B,NC,H,Q)
    f32, B/C (B,NC,Q,N) -> (y (B,NC,H,Q,P) f32, states (B,NC,H,N,P) f32)."""
    if _needs_grad(xdt, cum, bm, cm):
        return SSDChunkDual.apply(xdt, cum, bm, cm)
    return _ssd(xdt, cum, bm, cm)
