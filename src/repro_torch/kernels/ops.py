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

``ssm_step``, the Mamba-2 decode step's state update and readout, writes
its state in place (the kernel, ``csrc/ssm_step.cu``, replaces no TPU
kernel): it was added because the largest share of a served Mamba-2
decode step's device time went to four plain PyTorch kernels that moved
about six times the state's bytes. It is bound by bytes, so it reads the
bf16 or f32 state once in 16-byte loads, all in flight before any is used,
keeps the update in f32 registers and writes the state back where it
lies, rounded once; as it updates the cache's state in place, the caller
stores nothing. It has no gradient (decode runs under inference mode) and
no DTensor kernel path: a mesh's state, on the CPU, takes the plain
version, which updates it in place alike.

A ``DTensor`` (the inputs of a model on a mesh) runs on its local shard: the
wrapper takes ``to_local()``, calls the kernel (or its Function, whose
backward then runs on the local shards too) and wraps the result with
``DTensor.from_local`` under the input's placements. It does so only when
the dims the kernel reduces over hold whole on every rank: the last dim for
``fused_rmsnorm``; S, T and D for ``flash_attention`` and ``flash_decode``
(batch and heads may be sharded, alike in q, k and v); Q, P and N for
``ssd_chunk_dual`` (batch, chunks and heads may be sharded). Otherwise it
raises: it never gathers a shard quietly and never falls back to the plain
version. A weight or B/C replicated on a mesh dim over which the rows or
heads are sharded gets a partial-sum gradient there.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_backward,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm_rows_backward, rmsnorm_rows_cuda,
                                         rmsnorm_rows_plain)
from repro_torch.kernels.ssd_scan import (ssd_intra_chunk_backward, ssd_intra_chunk_cuda,
                                          ssd_intra_chunk_plain, tma_ready as ssd_tma_ready)
from repro_torch.kernels.ssm_step import ssm_step_cuda, ssm_step_plain

LAUNCHES: Dict[str, int] = {"fused_rmsnorm": 0, "flash_attention": 0,
                            "flash_decode": 0, "ssd_chunk_dual": 0, "ssm_step": 0}


# The CUDA symbols whose launches each wrapper counts, for holding
# ``LAUNCHES`` to a profiler trace: one kernel a call (an f32 decode's
# combine pass is counted with its split pass; the SSD step's kernel may run
# more than once a call, where its wrapper cuts P or N into pieces).
KERNELS: Dict[str, Tuple[str, ...]] = {
    "fused_rmsnorm": ("rmsnorm_regs_kernel", "rmsnorm_loop_kernel"),
    "flash_attention": ("flash_attention_bf16_kernel", "flash_attention_f32_kernel"),
    "flash_decode": ("decode_cluster_kernel", "decode_split_kernel"),
    "ssd_chunk_dual": ("ssd_bf16_kernel", "ssd_f32_kernel"),
    "ssm_step": ("ssm_step_kernel",),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


# -- DTensors: local shards ------------------------------------------------------


def _is_dtensor(*tensors) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in tensors)


def _effective(t) -> tuple:
    """``t``'s placements with those on size-1 mesh dims read as Replicate;
    a pending (partial) sum on a larger dim raises."""
    from torch.distributed.tensor import Replicate

    out = []
    for i, p in enumerate(t.placements):
        if t.device_mesh.size(i) == 1:
            out.append(Replicate())
        elif p.is_partial():
            raise ValueError(f"a kernel input holds a pending sum ({p}) on mesh dim {i}")
        else:
            out.append(p)
    return tuple(out)


def _whole(kernel: str, what: str, t, dims) -> None:
    """Raise unless each of ``t``'s ``dims`` is whole on every rank."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        raise ValueError(f"{kernel}: {what} is a plain tensor beside DTensor inputs")
    dims = {d % t.ndim for d in dims}
    for i, p in enumerate(_effective(t)):
        if p.is_shard() and p.dim % t.ndim in dims:
            raise ValueError(f"{kernel}: dim {p.dim} of {what} {tuple(t.shape)} is sharded "
                             f"over mesh dim {i}, and the kernel reduces over it; "
                             f"redistribute it first")


def _alike(kernel: str, what: str, a, b, dims_a, dims_b) -> None:
    """Raise unless ``a``'s dims ``dims_a`` and ``b``'s ``dims_b`` are sharded
    over the same mesh dims, pair for pair (other dims are free)."""
    def which(p, t, dims):
        return dims.index(p.dim % t.ndim) if p.is_shard() and p.dim % t.ndim in dims else None

    for i, (pa, pb) in enumerate(zip(_effective(a), _effective(b))):
        if which(pa, a, dims_a) != which(pb, b, dims_b):
            raise ValueError(f"{kernel}: {what} are sharded differently over mesh dim {i} "
                             f"({pa} against {pb}); redistribute them alike")


def _partial_where(t, sharded_by) -> tuple:
    """Gradient placements of ``t``'s local shard: a partial sum on each
    mesh dim that shards ``sharded_by`` but not ``t``, else ``t``'s own."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if (pb.is_shard() and not pt.is_shard()) else pt
                 for pt, pb in zip(_effective(t), _effective(sharded_by)))


def _wrap(local: torch.Tensor, like, shape) -> "torch.Tensor":
    from torch.distributed.tensor import DTensor

    # The global stride given is a contiguous tensor's, so the shard must be.
    return DTensor.from_local(local.contiguous(), like.device_mesh, like.placements,
                              run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


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
    # The kernel reads strided views but needs unit stride over P and N,
    # and on bf16 B/C the starts and strides its tensor maps take.
    xdt, bm, cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (xdt, bm, cm))
    if bm.dtype == torch.bfloat16:
        xdt, bm, cm = ssd_tma_ready(xdt, bm, cm)
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
    def forward(ctx, q, k, v, causal, window, q_offset, softcap, scale):
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap,
                      scale=scale)
        out = _attention(q, k, v, ctx.kw)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


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
    if _is_dtensor(x, w):
        _whole("fused_rmsnorm", "x", x, (-1,))
        _whole("fused_rmsnorm", "w", w, (0,))
        out = fused_rmsnorm(x.to_local(), w.to_local(grad_placements=_partial_where(w, x)),
                            eps=eps)
        return _wrap(out, x, x.shape)
    if _needs_grad(x, w):
        return FusedRMSNorm.apply(x, w, eps)
    return _rmsnorm(x, w, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,D); k/v (B,T,K,D) grouped-query -> (B,S,H,D); the scores
    are ``scale * q.k`` (None: ``1 / sqrt(D)``)."""
    if _is_dtensor(q, k, v):
        for what, t in (("q", q), ("k", k), ("v", v)):
            _whole("flash_attention", what, t, (1, 3))
        _alike("flash_attention", "q and k", q, k, (0, 2), (0, 2))
        _alike("flash_attention", "k and v", k, v, (0, 2), (0, 2))
        out = flash_attention(q.to_local(), k.to_local(), v.to_local(), causal=causal,
                              window=window, q_offset=q_offset, softcap=softcap, scale=scale)
        return _wrap(out, q, q.shape)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, q_offset, softcap, scale)
    return _attention(q, k, v, dict(causal=causal, window=window, q_offset=q_offset,
                                     softcap=softcap, scale=scale))


def _local_lengths(q, lengths: torch.Tensor) -> torch.Tensor:
    """The rows of ``lengths`` (B,), a plain tensor, that ``q``'s local
    shard holds."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, offset = compute_local_shape_and_global_offset(q.shape, q.device_mesh,
                                                          _effective(q))
    return lengths[offset[0]:offset[0] + local[0]]


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor, *, window: int = 0,
                 softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
    """q (B,1,H,D); k/v cache (B,T,K,D); lengths (B,) -> (B,1,H,D), the
    scores ``scale * q.k`` (None: ``1 / sqrt(D)``). One
    launch counts one call: bf16's single clustered launch, or the f32
    path's two passes (split and combine)."""
    if _is_dtensor(q, k_cache, v_cache):
        for what, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
            _whole("flash_decode", what, t, (1, 3))
        _alike("flash_decode", "q and k_cache", q, k_cache, (0, 2), (0, 2))
        _alike("flash_decode", "k_cache and v_cache", k_cache, v_cache, (0, 2), (0, 2))
        out = flash_decode(q.to_local(), k_cache.to_local(), v_cache.to_local(),
                           _local_lengths(q, lengths), window=window, softcap=softcap,
                           scale=scale)
        return _wrap(out, q, q.shape)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, lengths, window=window,
                                      softcap=softcap, scale=scale)
    out = decode_attention_cuda(q, k_cache, v_cache, lengths, window=window,
                                softcap=softcap, scale=scale)
    LAUNCHES["flash_decode"] += 1
    return out


def ssd_chunk_dual(xdt: torch.Tensor, cum: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD intra-chunk step: xdt (B,NC,H,Q,P) f32, cum (B,NC,H,Q)
    f32, B/C (B,NC,Q,N) -> (y (B,NC,H,Q,P) f32, states (B,NC,H,N,P) f32)."""
    if _is_dtensor(xdt, cum, bm, cm):
        kernel = "ssd_chunk_dual"
        for what, t, dims in (("xdt", xdt, (3, 4)), ("cum", cum, (3,)),
                              ("B", bm, (2, 3)), ("C", cm, (2, 3))):
            _whole(kernel, what, t, dims)
        _alike(kernel, "xdt and cum", xdt, cum, (0, 1, 2), (0, 1, 2))
        _alike(kernel, "xdt and B", xdt, bm, (0, 1), (0, 1))
        _alike(kernel, "B and C", bm, cm, (0, 1), (0, 1))
        y, states = ssd_chunk_dual(xdt.to_local(), cum.to_local(),
                                   bm.to_local(grad_placements=_partial_where(bm, xdt)),
                                   cm.to_local(grad_placements=_partial_where(cm, xdt)))
        return (_wrap(y, xdt, xdt.shape),
                _wrap(states, xdt, (*xdt.shape[:3], bm.shape[3], xdt.shape[4])))
    if _needs_grad(xdt, cum, bm, cm):
        return SSDChunkDual.apply(xdt, cum, bm, cm)
    return _ssd(xdt, cum, bm, cm)


def ssm_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor) -> torch.Tensor:
    """Mamba-2 decode step, in place: state (B,H,N,P) <- exp(dt A) state +
    (dt x) B^T in f32, rounded once to the state's dtype; returns y = C
    state (B,H,P) in x's dtype, read from the f32 state. x (B,H,P), dt
    (B,H) and A (H,) in f32, B/C (B,G,N), head h reading group h // (H/G)."""
    if not state.is_cuda:
        return ssm_step_plain(state, x, dt, A, bm, cm)
    if _is_dtensor(state, x, dt, A, bm, cm):
        raise NotImplementedError("ssm_step has no kernel path for DTensors on the card")
    y = ssm_step_cuda(state, x, dt, A, bm, cm)
    LAUNCHES["ssm_step"] += 1
    return y
