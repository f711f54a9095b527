"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) block: the
counterpart of ``repro.models.mamba2``.

Prefill uses the chunked dual form: quadratic attention-like work inside
chunks of Q positions plus a sequential recurrence over the chunks' states.
With the kernel-backed run config (``attention_impl="flash"``) the
intra-chunk part (each chunk's output and state) comes from
``ops.ssd_chunk_dual``; the recurrence stays here. ``chunked`` and ``naive``
keep the reference's plain form. Decode is the O(1)-state recurrence: on
the kernel path ``ops.ssm_step`` (one launch a layer), else its plain
version, either updating the cached state in place. B and C come in
``cfg.ssm_groups`` G groups (one for mamba2-130m and the simplified
hybrid), head h reading group ``h // (H / G)``: the scan runs once per
group on its heads (so the kernel launches once a group), decode reads
each head's group, and the gated norm normalises each
group of ``d_inner / G`` channels apart (``gated_group_norm``). ``cfg.ssm_conv_bias`` adds the conv's bias before its SiLU and
``cfg.ssm_dt_min`` clamps dt below. ``chunk_shard``
(``RunConfig.ssd_chunk_shard``) and the reference's sharding constraints are
``constrain`` calls at its points, which return their input when no mesh is
set.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import constrain, current_mesh
from repro_torch.distributed.sharding import einsum, gathered, is_distributed, on_local_shard
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_step import ssm_step_plain
from repro_torch.models.layers import DATA, MODEL, ParamGroup, gather_sequence, rms_norm
from repro_torch.tracing import span

# Heads per step of the plain intra-chunk form, which bounds its (B,nc,Q,Q,h)
# decay tensor, as the reference's ``head_block`` default.
HEAD_BLOCK = 4


class MambaBlock(ParamGroup):
    """in_proj (d, 2*di + 2*G*N + H: z, x, B, C, dt), conv_w (K, di + 2*G*N),
    conv_b (di + 2*G*N,) zeros under ``cfg.ssm_conv_bias``, A_log (H,) zeros,
    D (H,) ones, dt_bias (H,) zeros, ssm_norm (di,) ones and out_proj (di, d),
    in the reference's layouts (G = ``cfg.ssm_groups``)."""

    def __init__(self, cfg, *, generator, device, dtype):
        d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_heads
        conv = di + 2 * cfg.ssm_groups * cfg.ssm_state
        shapes = {"in_proj": (d, di + conv + nh), "conv_w": (cfg.ssm_conv, conv)}
        if cfg.ssm_conv_bias:
            shapes["conv_b"] = (conv,)
        shapes.update({"A_log": (nh,), "D": (nh,), "dt_bias": (nh,), "ssm_norm": (di,),
                       "out_proj": (di, d)})
        super().__init__(shapes, ones=("D", "ssm_norm"), zeros=("A_log", "dt_bias", "conv_b"),
                         generator=generator, device=device, dtype=dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d via shifted adds. x: (B,S,C); w: (K,C);
    ``bias`` (C,) added before the SiLU.

    ``state``: (B, K-1, C) trailing context from the previous segment.
    Returns (silu(y), new_state)."""
    k = w.shape[0]
    b, s, c = x.shape
    if state is None:
        state = torch.zeros((b, k - 1, c), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)  # (B, S+K-1, C)
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xp[:, i:i + s, :] * w[i]
    if bias is not None:
        y = y + bias
    new_state = xp[:, -(k - 1):, :].contiguous() if k > 1 else state
    return F.silu(y), new_state


def _split_proj(proj: torch.Tensor, cfg):
    di, n, nh = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * n]
    dt = proj[..., -nh:]
    return z, xbc, dt


def ssd_grouped(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None, *, kernel: bool = False,
                chunk_shard: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked`` with B and C in groups: Bm/Cm (B,S,G,N), head h
    reading group ``h // (H / G)``. One scan a group, over its heads (a
    kernel launch a group); y and the state are joined over the heads (one
    group's are its scan's own)."""
    g = Bm.shape[2]
    per = x.shape[2] // g
    ys, states = [], []
    for i in range(g):
        heads = slice(i * per, (i + 1) * per)
        y, h = ssd_chunked(x[:, :, heads], dt[:, :, heads], A[heads], Bm[:, :, i], Cm[:, :, i],
                           chunk, None if h0 is None else h0[:, heads], kernel=kernel,
                           chunk_shard=chunk_shard)
        ys.append(y)
        states.append(h)
    if g == 1:
        return ys[0], states[0]
    return torch.cat(ys, dim=2), torch.cat(states, dim=1)


def gated_group_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, groups: int,
                     eps: float, kernel: bool) -> torch.Tensor:
    """The gated RMSNorm of ``y * silu(z)``, times ``scale``. One group
    (mamba2-130m, the simplified hybrid) is normalised whole with the weight
    inside the norm, as the JAX reference does; more (Zamba2) are each
    normalised apart and rounded to y's dtype before the weight, as
    modeling_zamba2 does."""
    g = y * F.silu(z)
    if groups == 1:
        return rms_norm(g, scale, eps, kernel=kernel)
    b, s, di = y.shape
    ones = torch.ones(di // groups, device=y.device, dtype=y.dtype)
    return rms_norm(g.reshape(b, s, groups, di // groups), ones, eps,
                    kernel=kernel).reshape(b, s, di) * scale


def _intra_chunk_plain(xdt, cum, bc, cc, chunk_shard: bool = False):
    """The reference's intra-chunk form, heads in blocks of ``HEAD_BLOCK``.

    xdt (B,nc,Q,H,P) f32, cum (B,nc,Q,H) f32, bc/cc (B,nc,Q,N). Returns
    y_intra (B,nc,Q,H,P) and the chunk states (B,nc,H,N,P), f32."""
    q, nh = xdt.shape[2], xdt.shape[3]
    scores = einsum("bcin,bcjn->bcij", cc.float(), bc.float())  # (B,nc,Q,Q)
    if chunk_shard:
        scores = constrain(scores, DATA, MODEL, None, None)
    valid = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    hb = next(c for c in range(min(HEAD_BLOCK, nh), 0, -1) if nh % c == 0)
    ys, states = [], []
    for h0 in range(0, nh, hb):
        cum_h, xdt_h = cum[..., h0:h0 + hb], xdt[:, :, :, h0:h0 + hb]
        # Mask the exponent before exp: the upper triangle has
        # cum_i - cum_j > 0 growing with the chunk, so exp() overflows there.
        diff = cum_h[:, :, :, None, :] - cum_h[:, :, None, :, :]  # (B,nc,Q,Q,hb)
        mask = valid[None, None, :, :, None]
        decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
        m = scores[..., None] * decay
        ys.append(einsum("bcijh,bcjhp->bcihp", m, xdt_h))
        d2e = torch.exp(cum_h[:, :, -1:, :] - cum_h)  # (B,nc,Q,hb)
        states.append(einsum("bcjn,bcjh,bcjhp->bchnp", bc.float(), d2e, xdt_h))
    return torch.cat(ys, dim=3), torch.cat(states, dim=2)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None, *, kernel: bool = False,
                chunk_shard: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (B,S,H,P)  dt: (B,S,H)  A: (H,)  Bm/Cm: (B,S,N)
    h0: optional initial state (B,H,N,P).
    Returns (y (B,S,H,P), final state (B,H,N,P)), both in x's dtype.
    ``kernel`` takes the intra-chunk part from ``ops.ssd_chunk_dual``;
    ``chunk_shard`` constrains the chunk dim over the model axis.
    """
    b, s, nh, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    if s % q != 0:
        # Right-pad to a chunk multiple: dt=0 there => decay 1, contribution
        # 0, so the final state equals the state after the s real steps.
        pad = q - s % q
        y, h_last = ssd_chunked(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)),
            chunk, h0, kernel=kernel, chunk_shard=chunk_shard)
        return y[:, :s], h_last
    nc = s // q
    ctx, x_in = current_mesh(), x
    on_mesh = chunk_shard and ctx is not None and is_distributed(x)
    if on_mesh and nc % ctx.model_size:
        # The sequence, sharded over the model axis, splits into chunks
        # sharded over it only where it divides nc: gather it first.
        x, dt, Bm, Cm = (gather_sequence(t) for t in (x, dt, Bm, Cm))

    xc = x.reshape(b, nc, q, nh, p)
    dtc = dt.reshape(b, nc, q, nh).float()
    bc = Bm.reshape(b, nc, q, n)
    cc = Cm.reshape(b, nc, q, n)

    dA = dtc * A.float()  # (B,nc,Q,H), negative
    # Inclusive cumulative log-decay; on a mesh over the local chunks
    # (DTensor of torch 2.11 has no rule for the flip of cumsum's backward).
    cum = on_local_shard(lambda t: torch.cumsum(t, dim=2), dA, (2,), "cumsum")
    xdt = xc.float() * dtc[..., None]  # (B,nc,Q,H,P) f32
    if chunk_shard:
        # The intra-chunk dual form is chunk-parallel: shard the chunk dim
        # over the model axis so the (Q,Q,head) decay tensors divide by it.
        cum = constrain(cum, DATA, MODEL, None, None)
        xdt = constrain(xdt, DATA, MODEL, None, None, None)
        bc = constrain(bc, DATA, MODEL, None, None)
        cc = constrain(cc, DATA, MODEL, None, None)

    if kernel:
        y_h, chunk_states = ops.ssd_chunk_dual(xdt.permute(0, 1, 3, 2, 4),
                                               cum.permute(0, 1, 3, 2), bc, cc)
        y_intra = y_h.permute(0, 1, 3, 2, 4)  # (B,nc,Q,H,P)
    else:
        y_intra, chunk_states = _intra_chunk_plain(xdt, cum, bc, cc, chunk_shard)
    if chunk_shard:
        y_intra = constrain(y_intra, DATA, MODEL, None, None, None)
        chunk_states = constrain(chunk_states, DATA, MODEL, None, None, None)
    if on_mesh:
        # The recurrence over the chunks and its products flatten (B, nc),
        # which a DTensor does only where nc is whole: whole from here on.
        y_intra, chunk_states, cum, cc = (gather_sequence(t)
                                          for t in (y_intra, chunk_states, cum, cc))
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)

    # Inter-chunk recurrence: h_prevs[c] is the state entering chunk c.
    h = (torch.zeros((b, nh, n, p), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + chunk_states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # (B,nc,H,N,P)

    # y_inter[i] = exp(cum_i) * C_i . h_prev, per head.
    y_inter = torch.matmul(cc.float()[:, :, None], h_prev)  # (B,nc,H,Q,P)
    y_inter = y_inter.permute(0, 1, 3, 2, 4) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, nh, p)
    if on_mesh:
        # Back in x's layout, so that the gradient reaches the reshape in
        # the layout it left it.
        y = y.redistribute(x_in.device_mesh, x_in.placements)
    return y.to(x.dtype), h.to(x.dtype)


def mamba_block(params: MambaBlock, x: torch.Tensor, cfg, *, kernel: bool = False,
                ssm_state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                single_step: bool = False, chunk_shard: bool = False,
                layer: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mamba-2 block. x: (B,S,d) -> (y, ssm_state, conv_state).

    ``single_step=True`` runs the O(1) decode recurrence (S must be 1) in
    f32, writes the ssm state in place, rounded once to its dtype (a zero
    state in x's dtype where none is given), and returns that same tensor,
    so the caller stores nothing; otherwise the states are returned in x's
    dtype. ``kernel`` routes the scan, the decode step and the gated norm
    through the kernel-backed ops.
    ``chunk_shard`` keeps the block sequence-sharded over the model axis. The
    scan (or the recurrence's step) is recorded as the ``mamba.ssd`` span,
    with ``layer`` and the groups.
    """
    b, s, _ = x.shape
    di, n, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    groups = cfg.ssm_groups

    proj = gather_sequence(x) @ gathered(params.in_proj)
    if chunk_shard and not single_step:
        proj = constrain(proj, DATA, MODEL, None)
    else:
        proj = constrain(proj, DATA, None, MODEL)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc, conv_state = _causal_conv(xbc, params.conv_w, conv_state,
                                   params.conv_b if cfg.ssm_conv_bias else None)
    xs = xbc[..., :di].reshape(b, s, nh, p)
    Bm = xbc[..., di:di + groups * n].unflatten(-1, (groups, n))
    Cm = xbc[..., di + groups * n:].unflatten(-1, (groups, n))
    # On a mesh on the local shard: DTensor has no rule of its own for
    # softplus's backward.
    dt = on_local_shard(F.softplus, dt_raw.float() + params.dt_bias.float(), (), "softplus")
    if cfg.ssm_dt_min > 0:
        dt = torch.clamp(dt, min=cfg.ssm_dt_min)
    A = -torch.exp(params.A_log.float())

    with span("mamba.ssd", layer=layer, groups=groups):
        if single_step:
            # h = exp(dt A) h + dt B x^T and y = C h in f32, head h reading its
            # group's B and C; h is stored over the state where it lies.
            if ssm_state is None:
                ssm_state = torch.zeros((b, nh, n, p), dtype=x.dtype, device=x.device)
            step = ops.ssm_step if kernel else ssm_step_plain
            y = step(ssm_state, xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])[:, None]  # (B,1,H,P)
        else:
            y, ssm_state = ssd_grouped(xs, dt, A, Bm, Cm, cfg.ssm_chunk, ssm_state,
                                       kernel=kernel, chunk_shard=chunk_shard)

    y = y + params.D.to(x.dtype)[None, None, :, None] * xs
    y = gated_group_norm(y.reshape(b, s, di), z, params.ssm_norm, groups, cfg.norm_eps, kernel)
    # The sequence whole before the rows flatten (it is sharded under
    # ``chunk_shard``).
    y = gather_sequence(y) @ gathered(params.out_proj)
    return constrain(y, DATA, None, None), ssm_state, conv_state
