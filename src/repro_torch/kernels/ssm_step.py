"""Mamba-2 decode step (one token): the CUDA kernel and its plain version.

For each batch row and head, with the head's group's B and C (head h reads
group ``h // (H / G)``):

    state <- exp(dt A) state + (dt x) B^T        (N x P)
    y      = C state                              (P)

in f32, y read from the f32 state, and the state written back in place,
rounded once to its own dtype. Layouts are the model's: state (B,H,N,P), x
(B,H,P), dt (B,H) and A (H,) in f32, B and C (B,G,N); y comes back (B,H,P)
in x's dtype. Both versions update ``state`` in place, so the caller
stores nothing.

The kernel (``csrc/ssm_step.cu``) replaces no TPU kernel: the JAX model runs
this step as plain operations. It takes P 64 and N 64 or 128 (every
published Mamba-2 family here) and P 32 with N 16 or 32 (their small test
variants), the state and x, B and C in one dtype, bf16 or f32
(the cache's dtype is the model's), x, B and C by their strides (views into
the conv output) and a contiguous state; anything else raises.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import einsum
from repro_torch.kernels import _build

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (32, 64)
STATES = (16, 32, 64, 128)


def ssm_step_plain(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The step in PyTorch (DTensors too, on a mesh): the f32 state formed
    from the outer product and the decayed state, y read from it, then the
    state stored in place."""
    heads, groups = x.shape[1], B.shape[1]
    bh, ch = (t.float().repeat_interleave(heads // groups, dim=1) for t in (B, C))
    h = einsum("bhn,bhp->bhnp", bh, x.float() * dt[..., None])  # (B,H,N,P) f32
    h.addcmul_(state, torch.exp(dt * A)[..., None, None])
    y = einsum("bhn,bhnp->bhp", ch, h).to(x.dtype)
    state.copy_(h)
    return y


def _check(state, x, dt, A, B, C) -> None:
    shapes = [tuple(t.shape) for t in (state, x, dt, A, B, C)]
    if state.dim() != 4 or B.dim() != 3:
        raise ValueError(f"ssm_step kernel needs state (B,H,N,P) and B, C (B,G,N); got {shapes}")
    b, heads, n, p = state.shape
    groups = B.shape[1]
    if (x.shape != (b, heads, p) or dt.shape != (b, heads) or A.shape != (heads,)
            or B.shape != (b, groups, n) or C.shape != B.shape or groups == 0 or heads % groups):
        raise ValueError(f"ssm_step kernel needs state (B,H,N,P), x (B,H,P), dt (B,H), A (H,) "
                         f"and B, C (B,G,N) with G dividing H; got {shapes}")
    if p not in HEAD_DIMS or n not in STATES:
        raise ValueError(f"ssm_step kernel takes P in {HEAD_DIMS} and N in {STATES}, "
                         f"got P {p}, N {n}")
    if (state.dtype not in DTYPES or any(t.dtype != state.dtype for t in (x, B, C))
            or dt.dtype != torch.float32 or A.dtype != torch.float32):
        raise TypeError(f"ssm_step kernel takes the state, x, B and C in one dtype, bf16 or f32, "
                        f"and f32 dt and A; got {state.dtype}, {x.dtype}, {B.dtype}, "
                        f"{C.dtype}, {dt.dtype}, {A.dtype}")
    if not all(t.is_cuda and t.device == state.device for t in (state, x, dt, A, B, C)):
        raise ValueError("ssm_step kernel needs every input on one CUDA device")
    if not (state.is_contiguous() and state.data_ptr() % 16 == 0 and A.is_contiguous()
            and all(t.stride(-1) == 1 for t in (x, B, C))):
        raise ValueError("ssm_step kernel needs a contiguous, 16-byte aligned state, a "
                         "contiguous A and unit stride in the last dim of x, B and C")


def ssm_step_cuda(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``state`` updated in place, y returned."""
    _check(state, x, dt, A, B, C)
    b, heads, n, p = state.shape
    y = torch.empty((b, heads, p), dtype=x.dtype, device=x.device)
    fn = _build.entry("ssm_step", f"repro_ssm_step_{DTYPES[state.dtype]}",
                      [_build.P] * 7 + [_build.I] * 5 + [_build.L] * 8 + [_build.P])
    _build.check("ssm_step", fn(state.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                B.data_ptr(), C.data_ptr(), y.data_ptr(), b, heads, B.shape[1],
                                n, p, x.stride(0), x.stride(1), B.stride(0), B.stride(1),
                                C.stride(0), C.stride(1), dt.stride(0), dt.stride(1),
                                _build.stream()))
    return y
