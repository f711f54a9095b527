"""Flash decode: the CUDA kernel and its plain version.

Both take the model's layouts, q (B,1,H,D) against a KV cache k/v (B,T,K,D)
with ``lengths`` (B,) valid positions per row, and compute the G = H/K query
heads of a group against their KV head in place. Row b attends to the keys
``[max(0, len - window), len)`` (all of ``[0, len)`` when ``window`` is 0),
with scores ``scale * q.k`` in f32 (``scale`` None: ``1 / sqrt(D)``) capped
as ``softcap * tanh(s / softcap)`` where ``softcap > 0``,
as ``repro.models.layers.decode_attention`` does; any T works, and a row of
length 0 gives zeros, as the TPU kernel does.

Both split the cache capacity T into :func:`num_splits` splits of
``split_len`` keys (flash-decoding), compute an (m, l, acc) softmax state
per split, and merge the states with weights ``e^(m_s - M)`` over the
splits that saw a key, over ``max(sum, 1e-30)``. The split count depends on
T and the CTA count only, never on ``lengths``, which live on the device,
and is at most ``MAX_CLUSTER``: on bf16 the splits of one (b, KV head,
group of up to ``HEAD_GROUP`` query heads) are one thread block cluster of
the kernel's single launch, which merges them over distributed shared
memory; on f32 a second pass merges them from a scratch. The kernel
(``csrc/decode_attention.cu``) replaces the TPU kernel
``repro/kernels/decode_attention.py:decode_attention_bkgd``. TMA reads the
bf16 cache through tensor maps, so q, k and v must start on 16 bytes and
k/v have batch and sequence strides of whole 16 bytes
(:func:`check_tma_layout`, on either type); the wrapper raises on any
other, and copies nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import softmax_scale

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (32, 64, 80, 96, 128, 224)
NEG_INF = -1e30
BLOCK_K = 64       # keys per tile; a split is a multiple of it
HEAD_GROUP = 16    # query heads per CTA at most; larger groups take more CTAs
SMS = 132          # streaming multiprocessors of an H100 SXM
MIN_WAVES = 1      # CTAs aimed at, in multiples of SMS
MAX_CLUSTER = 16   # splits at most: CTAs of one cluster (Hopper's non-portable size)


def _cut(t: int, n: int) -> Tuple[int, int]:
    """(splits, split_len) that cut ``t`` keys into about ``n`` splits of a
    multiple of BLOCK_K keys (fewer where the rounding covers t sooner)."""
    split_len = -(-(-(-t // max(n, 1))) // BLOCK_K) * BLOCK_K
    return max(1, -(-t // split_len)), split_len


def num_splits(t: int, ctas: int) -> Tuple[int, int]:
    """(splits, split_len) for a cache of capacity ``t`` and ``ctas`` CTAs
    per split (B * K * head groups): at least MIN_WAVES waves of CTAs on the
    card, splits of at least BLOCK_K keys, a multiple of it, and at most
    MAX_CLUSTER of them."""
    most = min(MAX_CLUSTER, max(1, -(-t // BLOCK_K)))
    want = -(-MIN_WAVES * SMS // max(ctas, 1))
    return _cut(t, max(1, min(most, want)))


def head_groups(g: int) -> int:
    return -(-g // HEAD_GROUP)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *, window: int = 0,
                           softcap: float = 0.0, scale: Optional[float] = None,
                           splits: Optional[int] = None) -> torch.Tensor:
    """The kernel's algorithm in PyTorch: a softmax state (m, l, acc) in f32
    per split of the keys, merged as the kernel merges them. ``splits``
    overrides the kernel's split count, cut by the same rounding (1 gives one
    softmax over all keys)."""
    b, _, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    if splits is None:
        n, split_len = num_splits(t, b * n_kv * head_groups(g))
    else:
        n, split_len = _cut(t, splits)
    scale = softmax_scale(d, scale)
    qg = q[:, 0].float().reshape(b, n_kv, g, d)
    pad = n * split_len - t
    kt = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad)).reshape(
        b, n, split_len, n_kv, d)
    vt = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).reshape(
        b, n, split_len, n_kv, d)
    lens = lengths.to(device=q.device, dtype=torch.int64).clamp(0, t)
    lo = (lens - window).clamp(min=0) if window > 0 else torch.zeros_like(lens)
    kpos = torch.arange(n * split_len, device=q.device).reshape(n, split_len)
    valid = (kpos >= lo[:, None, None]) & (kpos < lens[:, None, None])  # (B,n,sl)
    valid = valid[:, None, None]  # (B,1,1,n,sl)
    sc = torch.einsum("bkgd,bnskd->bkgns", qg, kt) * scale
    if softcap > 0:
        sc = softcap * torch.tanh(sc / softcap)
    sc = sc.masked_fill(~valid, NEG_INF)
    m = sc.amax(dim=-1)  # (B,K,G,n); NEG_INF for a split with no visible key
    p = torch.exp(sc - m[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgns,bnskd->bkgnd", p, vt)
    # Combine: weights e^(m_s - M) over the splits with l > 0.
    live = l > 0
    mx = torch.where(live, m, NEG_INF).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - mx), 0.0)
    den = (w * l).sum(dim=-1)
    out = (w[..., None] * acc).sum(dim=-2) / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def check_tma_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q, k and v start on 16 bytes and k/v have unit stride
    over D, heads D apart and batch and sequence strides of whole 16 bytes:
    the bf16 kernel's tensor maps need that, the f32 kernel's 16-byte loads
    the same. Runs on any device, before anything is built."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash decode kernel (TMA) needs {name} to start on 16 "
                             f"bytes, got address {x.data_ptr():#x}")
    vec = 16 // q.element_size()
    d = q.shape[-1]
    for name, x in (("k", k), ("v", v)):
        if x.dim() != 4 or x.stride(3) != 1 or x.stride(2) != d or x.stride(0) % vec \
                or x.stride(1) % vec:
            raise ValueError(f"flash decode kernel (TMA) needs {name} with unit stride "
                             f"over D, heads D apart and 16-byte aligned rows, "
                             f"got strides {x.stride()}")


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
    if d not in HEAD_DIMS:
        raise ValueError(f"flash decode kernel takes D in {HEAD_DIMS}, got D={d}")
    if not (q.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("flash decode kernel needs contiguous q and lengths")


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, *, window: int = 0,
                          softcap: float = 0.0, scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel (bf16: one clustered launch; f32: two passes through
    a scratch); the output is a new contiguous (B,1,H,D) tensor."""
    check_tma_layout(q, k, v)
    _check(q, k, v, lengths)
    b, _, h, d = q.shape
    t, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    out = torch.empty_like(q)
    if out.numel() == 0 or t == 0:
        return out.zero_()
    n, split_len = num_splits(t, b * n_kv * head_groups(g))
    scratch = (torch.empty((b, h, n, d + 2), dtype=torch.float32, device=q.device)
               if q.dtype == torch.float32 else None)
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    fn = _build.entry("decode_attention", f"repro_decode_attention_{DTYPES[q.dtype]}",
                      [P, P, P, P, P, P, I, I, I, I, I, I, I, L, L, L, L, L, L,
                       I, F, F, P])
    _build.check("decode_attention", fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, n_kv, g, t, d,
        n, split_len,
        q.stride(0), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(0), int(window), softmax_scale(d, scale), float(softcap),
        _build.stream()))
    return out
