"""The port's attention kernels (K2 flash attention, K3 split-KV flash
decode; their plain versions on the CPU) on the options and shapes the
model's attention takes beyond the Pallas kernels' sweeps: a logit softcap,
a query offset, a sliding window at decode, D = 96, G = 64, and the split
and combine of flash-decoding; and K4's wrapper on P and N that the kernel
runs in pieces. The JAX package is the reference, on the same numpy inputs:
``repro.models.layers`` (chunked, naive and decode attention) and
``repro.kernels.ref``.

Tolerances are those of test_kernels.py: f32 2e-5 (summation order), bf16
2e-2 (bf16 roundings of the probabilities and the output), SSD 1e-4; the
split/combine arithmetic against one unsplit softmax is held to 1e-6 in
f32 (the same products, summed in another order)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import ops

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
fa = importlib.import_module("repro_torch.kernels.flash_attention")
da = importlib.import_module("repro_torch.kernels.decode_attention")
ss = importlib.import_module("repro_torch.kernels.ssd_scan")


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(torch_out, jax_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# K2: flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,t,h,kh,d,window,q_offset,softcap", [
    (64, 64, 4, 2, 96, 0, 0, 0.0),        # phi-3-vision's head dim
    (77, 77, 4, 4, 96, 17, 0, 0.0),       # D 96, ragged, windowed
    (100, 100, 4, 2, 64, 0, 0, 30.0),     # logit softcap
    (60, 60, 4, 4, 80, 16, 0, 50.0),      # softcap and window at D 80
    (40, 130, 4, 2, 64, 0, 90, 0.0),      # 40 queries at positions 90..129
    (24, 100, 8, 2, 32, 20, 70, 30.0),    # offset, window and softcap
    (10, 30, 4, 4, 64, 0, 50, 0.0),       # every key visible to every query
])
def test_flash_attention_options_match_layers(dtype, s, t, h, kh, d, window,
                                              q_offset, softcap):
    (jq, jk, jv), (tq, tk, tv) = _inputs(0, dtype, (2, s, h, d), (2, t, kh, d),
                                         (2, t, kh, d))
    want = jax_layers.naive_attention(jq, jk, jv, True, window, q_offset, softcap)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              q_offset=q_offset, softcap=softcap)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("s,h,kh,d,window", [
    (512, 8, 2, 64, 0),      # the tinyllama prefill's GQA and head dim
    (256, 4, 4, 80, 100),    # zamba2's head dim, windowed
    (256, 4, 1, 96, 0),
])
def test_bf16_plain_matches_chunked_attention(s, h, kh, d, window):
    """The bf16 plain version (P carried as hi + lo bf16 terms) against the
    reference's chunked attention (P rounded once), at 2e-2."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, "bfloat16", (2, s, h, d), (2, s, kh, d),
                                         (2, s, kh, d))
    want = jax_layers.chunked_attention(jq, jk, jv, chunk=128, causal=True,
                                        window=window)
    _close(fa.flash_attention_plain(tq, tk, tv, causal=True, window=window), want, 2e-2)


def test_bf16_probabilities_enter_pv_as_two_terms():
    p = torch.rand(1000) * 0.9 + 0.05
    terms = fa._as_terms(p, torch.bfloat16)
    once = p.to(torch.bfloat16).float()
    assert float((terms - p).abs().max()) <= 2.0 ** -16
    assert float((once - p).abs().max()) > 2.0 ** -12
    assert torch.equal(fa._as_terms(p, torch.float32), p)


# ---------------------------------------------------------------------------
# K3: split-KV flash decode
# ---------------------------------------------------------------------------


def _jax_decode(jx, window=0, softcap=0.0):
    jq, jk, jv, jl = jx
    return jax_layers.decode_attention(jq, jk, jv, jl, window, softcap)


def _decode_inputs(seed, dtype, t, h, kh, d, lengths):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed, dtype, (len(lengths), 1, h, d),
                                         (len(lengths), t, kh, d),
                                         (len(lengths), t, kh, d))
    lens = np.asarray(lengths, np.int32)
    return (jq, jk, jv, jnp.asarray(lens)), (tq, tk, tv, torch.from_numpy(lens))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,h,kh,d,lengths,window,softcap", [
    (130, 8, 2, 96, [1, 65, 130], 0, 0.0),         # phi-3-vision's head dim
    (200, 8, 2, 64, [1, 16, 17, 150, 200], 16, 0.0),  # window edges
    (576, 8, 2, 64, [544, 400, 130, 65], 100, 0.0),   # window across split edges
    (100, 4, 4, 80, [1, 37, 99], 0, 30.0),         # softcap, zamba2's head dim
    (90, 8, 2, 32, [5, 90], 16, 30.0),             # window and softcap
    (130, 64, 1, 64, [1, 64, 130], 0, 0.0),        # G = 64: two head groups
    (70, 40, 1, 32, [70, 33], 8, 0.0),             # G = 40, the second group of 8
])
def test_flash_decode_options_match_layers(dtype, t, h, kh, d, lengths, window,
                                           softcap):
    jx, tx = _decode_inputs(2, dtype, t, h, kh, d, lengths)
    want = _jax_decode(jx, window, softcap)
    got = ops.flash_decode(*tx, window=window, softcap=softcap)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("t,ctas,want", [
    (576, 16, (9, 64)),      # tinyllama's decode: B 4 x 4 KV heads, 144 CTAs
    (576, 128, (3, 192)),    # zamba2's: B 4 x 32 KV heads, 384 CTAs
    (576, 512, (1, 576)),    # enough CTAs without a split
    (64, 1, (1, 64)),        # one split of one tile
    (65, 1, (2, 64)),
    (5, 3, (1, 64)),
    (32768, 16, (17, 1984)),
])
def test_split_count_depends_on_capacity_and_ctas(t, ctas, want):
    n, split_len = da.num_splits(t, ctas)
    assert (n, split_len) == want
    assert split_len % da.BLOCK_K == 0 and n * split_len >= t > (n - 1) * split_len


def test_split_count_ignores_lengths():
    """The wrapper's split count is a function of shapes only: lengths live
    on the device and reading them would sync the host every step."""
    (_, (tq, tk, tv, _)) = _decode_inputs(3, "float32", 576, 32, 4, 64, [1] * 4)
    outs = [da.decode_attention_plain(tq, tk, tv, torch.full((4,), n, dtype=torch.int32))
            for n in (1, 544)]
    assert all(torch.isfinite(o).all() for o in outs)
    assert da.num_splits(576, 4 * 4 * da.head_groups(8)) == (9, 64)
    assert da.head_groups(32) == 1 and da.head_groups(33) == 2 and da.head_groups(64) == 2


@pytest.mark.parametrize("t,kh,lengths,window", [
    (576, 4, [0, 1, 64, 65, 576], 0),    # 9 splits of 64
    (576, 32, [0, 1, 64, 65, 576], 0),   # 3 splits of 192
    (576, 4, [0, 1, 64, 65, 576], 100),  # the window's edge inside a split
    (130, 2, [0, 1, 64, 65, 130], 0),    # a ragged last split
])
def test_split_combine_matches_one_softmax(t, kh, lengths, window):
    """The splits' (m, l, acc) merged as the combine pass does equal one
    online softmax over all keys (f32, 1e-6); a zero length gives zeros."""
    _, (tq, tk, tv, tl) = _decode_inputs(4, "float32", t, 8 * kh, kh, 64, lengths)
    n, _ = da.num_splits(t, len(lengths) * kh)
    assert n > 1
    split = da.decode_attention_plain(tq, tk, tv, tl, window=window)
    whole = da.decode_attention_plain(tq, tk, tv, tl, window=window, splits=1)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    assert float(split[0].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K4: the wrapper's pieces
# ---------------------------------------------------------------------------


def _kernel_shapes_only(*args):
    """The plain version, refusing what the kernel itself refuses."""
    xdt, _, bm, _ = args
    assert xdt.shape[-1] in ss.HEAD_DIMS and bm.shape[-1] <= ss.MAX_STATE
    return ss.ssd_intra_chunk_plain(*args)


@pytest.mark.parametrize("q,p,n", [(8, 16, 64), (64, 96, 64), (64, 160, 32),
                                   (64, 64, 320), (77, 160, 300)])
def test_ssd_pieces_match_ref(q, p, n):
    """P is zero-padded (16 -> 32, 96 -> 128) or cut (160 = 128 + 32) and N
    cut in slices of 256; the joined result equals the reference's."""
    rng = np.random.default_rng(5)
    xdt = (rng.standard_normal((1, 2, 2, q, p)) * 0.1).astype(np.float32)
    cum = -np.cumsum(rng.uniform(0, 1, (1, 2, 2, q)), axis=-1).astype(np.float32)
    bm = (rng.standard_normal((1, 2, q, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((1, 2, q, n)) * 0.3).astype(np.float32)
    want_y, want_st = jax_ref.ssd_intra_chunk_ref(*map(jnp.asarray, (xdt, cum, bm, cm)))
    y, st = ss.in_kernel_pieces(_kernel_shapes_only,
                                *map(torch.from_numpy, (xdt, cum, bm, cm)))
    assert y.shape == (1, 2, 2, q, p) and st.shape == (1, 2, 2, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_st), rtol=1e-4, atol=1e-4)


def test_ssd_kernel_shapes_go_through_whole():
    rng = np.random.default_rng(6)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((1, 1, 2, 8, 64), (1, 1, 2, 8), (1, 1, 8, 256), (1, 1, 8, 256))]
    calls = []
    ss.in_kernel_pieces(lambda *a: calls.append(a) or ss.ssd_intra_chunk_plain(*a), *args)
    assert len(calls) == 1 and all(c is a for c, a in zip(calls[0], args))
