"""Mamba-2 SSD intra-chunk step: the CUDA kernel and its plain version.

For each (batch, chunk, head), with Q positions in the chunk:

    Y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
    S    = sum_j B_j^T (exp(cum_last - cum_j) xdt_j)

Both take the layouts of ``repro.kernels.ssd_scan.ssd_intra_chunk``: xdt
(B,NC,H,Q,P) and cum (B,NC,H,Q) in f32, B/C (B,NC,Q,N) shared by the heads
in f32 or bf16; they return y (B,NC,H,Q,P) and the chunk states (B,NC,H,N,P)
in f32. The exponent is masked to j <= i before ``exp``, so the upper
triangle cannot overflow into inf * 0. Any Q works: rows and keys past Q
are masked, not padded. The dtype of B and C picks the kernel's path: bf16
runs the products on Hopper's tensor cores (wgmma, fed by TMA), with the
masked scores M, xdt and the state's weighted xdt each entering as two bf16
terms hi + lo; f32 runs them on the CUDA cores in f32. The kernel takes P in
``HEAD_DIMS`` and N up to ``MAX_STATE``; :func:`in_kernel_pieces` runs any
other P and N through it in pieces (P zero-padded or cut in slices of 64, N
cut in slices of 128). On the bf16 path TMA reads xdt, B and C through
tensor maps, which need 16-byte-aligned starts and strides
(:func:`check_tma_layout`, which the launcher runs before anything is
built); :func:`tma_ready` copies an input that misses the rule into one
that meets it, and ``ops.ssd_chunk_dual`` passes its inputs through it.
The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro/kernels/ssd_scan.py:ssd_intra_chunk``; the inter-chunk recurrence
stays with the caller (``models/mamba2.py:ssd_chunked``).
:func:`ssd_intra_chunk_backward` is the gradient of the exact f32 function
above (no hi + lo terms), in PyTorch, for ``ops.SSDChunkDual``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

B_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (32, 64)
MAX_STATE = 128
BLOCK = 64  # keys per key tile, as in the kernel
# Elements of the (B,NC,heads,Q,Q) f32 tensors of one head block of the
# backward (32 MiB each; zamba2's training shape takes 16 heads a block).
BACKWARD_BLOCK = 1 << 23


def _wide(*tensors, like: torch.Tensor):
    """The tensors in f32, or in f64 where ``like`` is f64 (as gradcheck
    gives it)."""
    dtype = torch.float64 if like.dtype == torch.float64 else torch.float32
    return tuple(t.to(dtype) for t in tensors)


def _terms(t: torch.Tensor, split: bool):
    """t as the kernel feeds it to a product: on the bf16 path two bf16 terms,
    hi = bf16(t) and lo = bf16(t - hi), held in f32 (about 16 bits of t);
    else t itself."""
    if not split:
        return (t,)
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _products(eq: str, a, b) -> torch.Tensor:
    """The einsum of two operands given as terms, summed over every pair of
    terms but lo.lo, as the kernel sums its products (Mh.Xh + Ml.Xh + Mh.Xl
    for y, B^T.Wh + B^T.Wl for the state)."""
    out = torch.einsum(eq, a[0], b[0])
    for i, j in ((1, 0), (0, 1)):
        if i < len(a) and j < len(b):
            out = out + torch.einsum(eq, a[i], b[j])
    return out


def ssd_intra_chunk_plain(xdt: torch.Tensor, cum: torch.Tensor, bm: torch.Tensor,
                          cm: torch.Tensor):
    """The kernel's algorithm in PyTorch: y accumulated over key tiles of
    ``BLOCK`` positions, scores from B and C in f32, the decay masked before
    its exponent. For bf16 B and C the f32 operands of the products enter as
    two bf16 terms (:func:`_terms`), as the kernel's tensor-core path feeds
    them; with f32 B and C the products are exact f32."""
    split = bm.dtype == torch.bfloat16
    xdt, cum, bm, cm = _wide(xdt, cum, bm, cm, like=xdt)
    q = xdt.shape[3]
    rows = torch.arange(q, device=xdt.device)
    xs = _terms(xdt, split)
    y = torch.zeros_like(xdt)
    for j0 in range(0, q, BLOCK):
        j1 = min(j0 + BLOCK, q)
        valid = rows[None, j0:j1] <= rows[:, None]  # (Q, keys)
        scores = torch.einsum("bcin,bcjn->bcij", cm, bm[:, :, j0:j1])
        diff = cum[..., :, None] - cum[..., None, j0:j1]  # (B,NC,H,Q,keys)
        decay = torch.exp(torch.where(valid, diff, 0.0))
        m = torch.where(valid, scores[:, :, None] * decay, 0.0)
        y += _products("bchij,bchjp->bchip", _terms(m, split),
                       [t[:, :, :, j0:j1] for t in xs])
    weight = torch.exp(cum[..., -1:] - cum)  # (B,NC,H,Q)
    states = _products("bcjn,bchjp->bchnp", (bm,), _terms(xdt * weight[..., None], split))
    return y, states


def ssd_intra_chunk_backward(xdt: torch.Tensor, cum: torch.Tensor, bm: torch.Tensor,
                             cm: torch.Tensor, dy: torch.Tensor, dstates: torch.Tensor):
    """(dxdt, dcum, dB, dC) of the exact f32 function of the module
    docstring, given dy (B,NC,H,Q,P) and dstates (B,NC,H,N,P).

    With M = (C B^T) * L, L_ij = exp(cum_i - cum_j) on j <= i and 0 above,
    and w_j = exp(cum_last - cum_j): dM = dy xdt^T, dxdt = M^T dy +
    w * (B dS), the score gradient (dM * L) summed over heads gives dC and
    part of dB, the state gives dB its (w xdt) dS^T, and cum collects
    G = dM * M as +row sums and -column sums, then -dw_j w_j and, at the
    last position, their sum (dw = rows of xdt * (B dS)). Heads go in
    blocks whose (B,NC,heads,Q,Q) f32 tensors hold at most
    ``BACKWARD_BLOCK`` elements, so no such tensor of all heads lives. The
    exponent is masked before ``exp``, so the upper triangle contributes an
    exact zero. dB and dC come back in B's and C's dtype, dxdt and dcum in
    f32 (f64 for f64 inputs, as the plain version computes them)."""
    xdt, cum, dy, dstates, b32, c32 = _wide(xdt, cum, dy, dstates, bm, cm, like=xdt)
    b, nc, h, q, _ = xdt.shape
    rows = torch.arange(q, device=xdt.device)
    valid = rows[None, :] <= rows[:, None]  # (Q, Q): j <= i
    scores = torch.einsum("bcin,bcjn->bcij", c32, b32)  # (B,NC,Q,Q)
    dscores = torch.zeros_like(scores)
    db = torch.zeros_like(b32)
    dxdt, dcum = torch.empty_like(xdt), torch.empty_like(cum)
    hb = max(1, min(h, BACKWARD_BLOCK // max(1, b * nc * q * q)))
    for h0 in range(0, h, hb):
        heads = slice(h0, h0 + hb)
        x, c, g, gs = xdt[:, :, heads], cum[:, :, heads], dy[:, :, heads], dstates[:, :, heads]
        diff = c[..., :, None] - c[..., None, :]  # (B,NC,hb,Q,Q)
        decay = torch.where(valid, torch.exp(torch.where(valid, diff, 0.0)), 0.0)
        m = scores[:, :, None] * decay
        dm = torch.einsum("bchip,bchjp->bchij", g, x)
        dscores += (dm * decay).sum(dim=2)
        gm = dm * m  # zero above the diagonal, where m is
        dc = gm.sum(dim=-1) - gm.sum(dim=-2)
        del diff, decay, dm, gm
        weight = torch.exp(c[..., -1:] - c)  # (B,NC,hb,Q)
        bds = torch.einsum("bcjn,bchnp->bchjp", b32, gs)  # B dS
        dxdt[:, :, heads] = (torch.einsum("bchij,bchip->bchjp", m, g)
                             + weight[..., None] * bds)
        dw = (x * bds).sum(dim=-1) * weight
        dc -= dw
        dc[..., -1] += dw.sum(dim=-1)
        dcum[:, :, heads] = dc
        db += torch.einsum("bchjp,bchnp->bcjn", x * weight[..., None], gs)
    dc_out = torch.einsum("bcij,bcjn->bcin", dscores, b32)
    db += torch.einsum("bcij,bcin->bcjn", dscores, c32)
    return dxdt, dcum, db.to(bm.dtype), dc_out.to(cm.dtype)


def in_kernel_pieces(run, xdt: torch.Tensor, cum: torch.Tensor, bm: torch.Tensor,
                     cm: torch.Tensor):
    """``run`` (the kernel's launcher) on pieces whose P is in HEAD_DIMS and
    whose N is at most MAX_STATE, joined into the result for the whole input.

    The P columns of xdt are independent, so P is cut into slices of
    ``max(HEAD_DIMS)`` and each slice zero-padded to the next width the kernel
    takes (into the model's (B,NC,Q,H,P) layout); y and the states are cut
    back. y is linear in the score sum C.B^T over N, so N is cut into slices
    of MAX_STATE: y is the sum of the slices' y and the states are the
    slices' states side by side along N. An input the kernel takes goes
    through in one piece, as it is."""
    p, n = xdt.shape[-1], bm.shape[-1]
    if (p in HEAD_DIMS and n <= MAX_STATE) or p == 0 or n == 0:
        return run(xdt, cum, bm, cm)
    ys, states = [], []
    for p0 in range(0, p, max(HEAD_DIMS)):
        part = xdt[..., p0:p0 + max(HEAD_DIMS)]
        width = part.shape[-1]
        padded = min(w for w in HEAD_DIMS if w >= width)
        if padded != width:
            b, nc, h, q, _ = part.shape
            wide = part.new_zeros((b, nc, q, h, padded)).permute(0, 1, 3, 2, 4)
            wide[..., :width] = part
            part = wide
        y_p, s_p = None, []
        for n0 in range(0, n, MAX_STATE):
            y_n, s_n = run(part, cum, bm[..., n0:n0 + MAX_STATE], cm[..., n0:n0 + MAX_STATE])
            y_p = y_n if y_p is None else y_p + y_n
            s_p.append(s_n)
        ys.append(y_p[..., :width])
        states.append(torch.cat(s_p, dim=-2)[..., :width])
    return torch.cat(ys, dim=-1), torch.cat(states, dim=-1)


def _tma_misses(x: torch.Tensor, unit: int) -> bool:
    """Whether x's start or its strides but the last (unit) one are not whole
    16 bytes: ``unit`` elements."""
    return x.data_ptr() % 16 != 0 or any(st % unit for st in x.stride()[:-1])


def check_tma_layout(xdt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor) -> None:
    """Raise where bf16 B/C's kernel cannot build its tensor maps: xdt, B and
    C must start on 16 bytes and have strides of whole 16 bytes (unit
    stride over P and N). Runs on any device, before anything is built."""
    if bm.dtype != torch.bfloat16:
        return
    for name, x, unit in (("xdt", xdt, 4), ("B", bm, 8), ("C", cm, 8)):
        if x.stride(-1) != 1 or _tma_misses(x, unit):
            raise ValueError(f"ssd kernel (TMA) needs {name} to start on 16 bytes with "
                             f"strides of whole 16 bytes and unit stride last, got address "
                             f"{x.data_ptr():#x}, strides {x.stride()}")


def tma_ready(xdt: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor):
    """xdt, B and C, each copied where it misses :func:`check_tma_layout`'s
    rule: xdt into the model's (B,NC,Q,H,P) layout, B and C into rows of N
    rounded up to 8 (a view of the first N columns)."""
    if _tma_misses(xdt, 4) or xdt.stride(-1) != 1:
        b, nc, h, q, p = xdt.shape
        xdt = xdt.new_empty((b, nc, q, h, p)).permute(0, 1, 3, 2, 4).copy_(xdt)

    def rows(t):
        if not _tma_misses(t, 8) and t.stride(-1) == 1:
            return t
        n = t.shape[-1]
        return t.new_zeros((*t.shape[:-1], -(-n // 8) * 8))[..., :n].copy_(t)

    return xdt, rows(bm), rows(cm)


def _check(xdt, cum, bm, cm) -> None:
    dev = xdt.device
    if not (xdt.is_cuda and all(t.device == dev for t in (cum, bm, cm))):
        raise ValueError(f"ssd kernel needs xdt, cum, B, C on one CUDA device, got "
                         f"{xdt.device}, {cum.device}, {bm.device}, {cm.device}")
    if xdt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError(f"ssd kernel takes f32 xdt and cum, got {xdt.dtype}, {cum.dtype}")
    if bm.dtype not in B_DTYPES or cm.dtype != bm.dtype:
        raise TypeError(f"ssd kernel takes B and C of one of f32/bf16, got "
                        f"{bm.dtype}, {cm.dtype}")
    if xdt.dim() != 5 or cum.dim() != 4 or bm.dim() != 4 or cm.shape != bm.shape:
        raise ValueError(f"ssd kernel needs xdt (B,NC,H,Q,P), cum (B,NC,H,Q) and "
                         f"B/C (B,NC,Q,N), got {tuple(xdt.shape)}, {tuple(cum.shape)}, "
                         f"{tuple(bm.shape)}, {tuple(cm.shape)}")
    b, nc, h, q, p = xdt.shape
    if cum.shape != (b, nc, h, q) or bm.shape[:3] != (b, nc, q):
        raise ValueError(f"ssd kernel: cum {tuple(cum.shape)} or B/C "
                         f"{tuple(bm.shape)} do not match xdt {tuple(xdt.shape)}")
    if p not in HEAD_DIMS or not 0 < bm.shape[3] <= MAX_STATE:
        raise ValueError(f"ssd kernel takes P in {HEAD_DIMS} and N up to "
                         f"{MAX_STATE}, got P={p}, N={bm.shape[3]}")
    if b * nc > 65535 or h > 65535:
        raise ValueError(f"ssd kernel takes B*NC and H up to 65535, got {b * nc}, {h}")
    if xdt.stride(4) != 1 or bm.stride(3) != 1 or cm.stride(3) != 1:
        raise ValueError(f"ssd kernel needs unit stride over P and N, got strides "
                         f"{xdt.stride()}, {bm.stride()}, {cm.stride()}")


def ssd_intra_chunk_cuda(xdt: torch.Tensor, cum: torch.Tensor, bm: torch.Tensor,
                         cm: torch.Tensor):
    """Launch the kernel, in pieces where P or N is outside what it takes
    (:func:`in_kernel_pieces`)."""
    return in_kernel_pieces(_launch, xdt, cum, bm, cm)


def _launch(xdt: torch.Tensor, cum: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor):
    """Launch the kernel on strided inputs (no copies).

    y is returned as a (B,NC,H,Q,P) view of a (B,NC,Q,H,P) tensor, the
    layout the model adds it to; the states are contiguous.
    """
    check_tma_layout(xdt, bm, cm)
    _check(xdt, cum, bm, cm)
    b, nc, h, q, p = xdt.shape
    n = bm.shape[3]
    y = torch.empty((b, nc, q, h, p), dtype=torch.float32,
                    device=xdt.device).permute(0, 1, 3, 2, 4)
    states = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=xdt.device)
    if y.numel() == 0:
        return y, states.zero_()
    strides = (*xdt.stride()[:4], *cum.stride(), *bm.stride()[:3], *cm.stride()[:3],
               *y.stride()[:4])
    P, I = _build.P, _build.I
    fn = _build.entry("ssd_scan", f"repro_ssd_intra_chunk_{B_DTYPES[bm.dtype]}",
                      [P, P, P, P, P, P, I, I, I, I, I, I, P, P])
    _build.check("ssd_scan", fn(
        xdt.data_ptr(), cum.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        y.data_ptr(), states.data_ptr(), b, nc, h, q, p, n,
        (_build.L * len(strides))(*strides), _build.stream()))
    return y, states
