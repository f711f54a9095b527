"""Fused RMSNorm with a learned scale: the CUDA kernel and its plain version.

The kernel (``csrc/rmsnorm.cu``) replaces the TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm_rows``, for any row count: a row spread
over 1, 2 or 4 warps and held in registers as 16-byte vectors (read from
device memory once, every load issued before the f32 reduction), up to
d = 8192; wider rows, and rows not in 16-byte vectors, take a loop that
reads the row twice.

Its gradient (``rmsnorm_rows_backward``) is plain PyTorch in f32, run by
``ops.FusedRMSNorm``'s backward: the reference differentiates through its
norm with ``jax.grad`` and has no backward kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in f64 where it is f64 (for gradcheck)."""
    return t if t.dtype == torch.float64 else t.float()


def rmsnorm_rows_plain(x: torch.Tensor, w: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), w (d,): ``x * rsqrt(mean(x^2) + eps) * w`` in f32, cast
    back to x's dtype."""
    x32 = _wide(x)
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * _wide(w)).to(x.dtype)


def rmsnorm_rows_backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                          eps: float = 1e-5):
    """Gradients of ``rmsnorm_rows_plain`` at x (..., d), w (d,) for the
    output gradient g: with ``r = rsqrt(mean(x^2) + eps)`` and ``gw = g * w``,
    ``dx = r * gw - x * r^3 * mean(gw * x)`` and ``dw = sum over rows of
    g * x * r``, in f32 (f64 for f64 inputs), each cast to its input's
    dtype."""
    x32, g32 = _wide(x), _wide(g)
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    gw = g32 * _wide(w)
    dx = r * gw - x32 * r.pow(3) * (gw * x32).mean(dim=-1, keepdim=True)
    dw = (g32 * x32 * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"rmsnorm kernel needs x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if x.dtype not in DTYPES or w.dtype not in DTYPES:
        raise TypeError(f"rmsnorm kernel takes f32/bf16, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm kernel needs x (rows, d) and w (d,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and w")


def rmsnorm_rows_cuda(x: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Launch the kernel on x (rows, d) and w (d,), both on one CUDA device."""
    _check(x, w)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    fn = _build.entry("rmsnorm",
                      f"repro_rmsnorm_{DTYPES[x.dtype]}_{DTYPES[w.dtype]}",
                      [_build.P, _build.P, _build.P, _build.I, _build.I,
                       _build.F, _build.P])
    _build.check("rmsnorm", fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                               x.shape[0], x.shape[1], eps, _build.stream()))
    return out
