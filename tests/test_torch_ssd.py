"""The port's SSD intra-chunk step (K4) and ``ssd_chunked`` against the JAX
package on the same numpy inputs: the plain version against the Pallas
kernel in interpret mode over the sweep of test_kernels.py, against
``repro.kernels.ref`` on ragged chunks, and the port's chunked scan on its
kernel route (the plain version on the CPU) and its plain route against
``repro.models.mamba2.ssd_chunked``.

Tolerance 1e-4, that of test_kernels.py's SSD tests: f32 sums over Q keys
and N state dims in another order."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels import ssd_chunk_dual as jax_ssd_chunk_dual
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ref as torch_ref
from repro_torch.models.mamba2 import ssd_chunked

TOL = 1e-4
ss = importlib.import_module("repro_torch.kernels.ssd_scan")


def _chunk_inputs(seed, b, nc, h, q, p, n, *, span=1.0):
    """xdt, cum (a decreasing cumulative log-decay, steps up to ``span``),
    B and C, as numpy arrays in the kernel's layouts."""
    rng = np.random.default_rng(seed)
    xdt = (rng.standard_normal((b, nc, h, q, p)) * 0.1).astype(np.float32)
    cum = -np.cumsum(rng.uniform(0, span, (b, nc, h, q)), axis=-1).astype(np.float32)
    bm = (rng.standard_normal((b, nc, q, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, nc, q, n)) * 0.3).astype(np.float32)
    return xdt, cum, bm, cm


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("q,p,n,h", [(32, 32, 16, 2), (64, 64, 32, 3),
                                     (128, 32, 64, 1)])
def test_plain_matches_pallas(q, p, n, h):
    arrays = _chunk_inputs(3, 2, 2, h, q, p, n)
    want_y, want_st = jax_ssd_chunk_dual(*map(jnp.asarray, arrays), interpret=True)
    y, st = ss.ssd_intra_chunk_plain(*map(torch.from_numpy, arrays))
    _close(y, want_y)
    _close(st, want_st)


@pytest.mark.parametrize("q,p,n,h", [(77, 64, 64, 2), (5, 32, 16, 3), (130, 32, 128, 1)])
def test_plain_matches_ref_on_ragged_chunks(q, p, n, h):
    """Q is not a multiple of the key tile (77, 130) or is below it (5)."""
    arrays = _chunk_inputs(4, 2, 1, h, q, p, n)
    want_y, want_st = jax_ref.ssd_intra_chunk_ref(*map(jnp.asarray, arrays))
    y, st = ops.ssd_chunk_dual(*map(torch.from_numpy, arrays))
    _close(y, want_y)
    _close(st, want_st)


def test_plain_takes_bf16_b_and_c():
    """B and C in bf16, as the model holds them: the same values as f32."""
    xdt, cum, bm, cm = _chunk_inputs(5, 1, 2, 2, 40, 32, 16)
    tb, tc = (torch.from_numpy(a).to(torch.bfloat16) for a in (bm, cm))
    want_y, want_st = jax_ssd_chunk_dual(
        jnp.asarray(xdt), jnp.asarray(cum), jnp.asarray(tb.float().numpy(), jnp.bfloat16),
        jnp.asarray(tc.float().numpy(), jnp.bfloat16), interpret=True)
    y, st = ss.ssd_intra_chunk_plain(torch.from_numpy(xdt), torch.from_numpy(cum), tb, tc)
    _close(y, want_y)
    _close(st, want_st)


def _bf16_chunk(seed, n, span):
    """The serve shape of one chunk (Q 256, P 64) with bf16 B and C, as numpy
    (B and C holding bf16 values) for both packages, and as torch tensors."""
    xdt, cum, bm, cm = _chunk_inputs(seed, 1, 1, 2, 256, 64, n, span=span)
    tb, tc = (torch.from_numpy(a).to(torch.bfloat16) for a in (bm, cm))
    jax_args = (jnp.asarray(xdt), jnp.asarray(cum),
                jnp.asarray(tb.float().numpy(), jnp.bfloat16),
                jnp.asarray(tc.float().numpy(), jnp.bfloat16))
    return jax_args, (torch.from_numpy(xdt), torch.from_numpy(cum), tb, tc)


@pytest.mark.parametrize("span", [1.0, 40.0])
@pytest.mark.parametrize("n", [64, 128])
def test_bf16_split_terms_match_pallas(n, span):
    """With bf16 B and C the kernel feeds the masked scores M, xdt and the
    state's weighted xdt to the tensor cores as two bf16 terms each (hi +
    lo, dropping lo.lo); the plain version mirrors that split, and holds the
    Pallas kernel's f32 result at the serve shape within 1e-4."""
    jax_args, args = _bf16_chunk(13, n, span)
    want_y, want_st = jax_ssd_chunk_dual(*jax_args, interpret=True)
    y, st = ss.ssd_intra_chunk_plain(*args)
    _close(y, want_y)
    _close(st, want_st)
    exact_y, _ = ss.ssd_intra_chunk_plain(args[0], args[1], args[2].float(), args[3].float())
    assert 0 < float((y - exact_y).abs().max()) < TOL / 2  # the split is used, and cheap


@pytest.mark.parametrize("span", [1.0, 40.0])
@pytest.mark.parametrize("n", [64, 128])
def test_bf16_scores_rounded_once_break_the_tolerance(n, span):
    """M rounded once to bf16 (xdt exact), the arithmetic the split replaces,
    misses the Pallas kernel by more than 1e-4 at the same shape."""
    jax_args, (xdt, cum, bm, cm) = _bf16_chunk(13, n, span)
    want_y, _ = jax_ssd_chunk_dual(*jax_args, interpret=True)
    q = xdt.shape[3]
    rows = torch.arange(q)
    valid = rows[None, :] <= rows[:, None]
    scores = torch.einsum("bcin,bcjn->bcij", cm.float(), bm.float())
    diff = cum[..., :, None] - cum[..., None, :]
    m = torch.where(valid, scores[:, :, None] * torch.exp(torch.where(valid, diff, 0.0)), 0.0)
    y_once = torch.einsum("bchij,bchjp->bchip", m.to(torch.bfloat16).float(), xdt)
    want = torch.from_numpy(np.array(want_y, np.float32))
    excess = (y_once - want).abs() - (TOL + TOL * want.abs())
    assert float(excess.max()) > 0


def test_masked_exponent_does_not_overflow():
    """cum falls by up to 40 a step: exp of the unmasked upper triangle is inf
    in f32, and inf * 0 would be NaN."""
    arrays = _chunk_inputs(6, 1, 1, 2, 96, 32, 16, span=40.0)
    cum = arrays[1]
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cum[..., :, None] - cum[..., None, :])).any()
    y, st = ss.ssd_intra_chunk_plain(*map(torch.from_numpy, arrays))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    want_y, want_st = jax_ref.ssd_intra_chunk_ref(*map(jnp.asarray, arrays))
    _close(y, want_y)
    _close(st, want_st)


def test_strided_views_give_the_contiguous_result():
    """The model passes (B,NC,Q,H,.) tensors as permuted views and B/C as
    slices of one projection."""
    b, nc, q, h, p, n = 2, 2, 24, 3, 32, 16
    rng = np.random.default_rng(7)
    xdt = torch.from_numpy(rng.standard_normal((b, nc, q, h, p)).astype(np.float32))
    cum = torch.from_numpy(-np.cumsum(rng.uniform(0, 1, (b, nc, q, h)), axis=2)
                           .astype(np.float32))
    proj = torch.from_numpy(rng.standard_normal((b, nc, q, 2 * n + 5)).astype(np.float32))
    views = (xdt.permute(0, 1, 3, 2, 4), cum.permute(0, 1, 3, 2), proj[..., 5:5 + n],
             proj[..., 5 + n:])
    got = ss.ssd_intra_chunk_plain(*views)
    want = ss.ssd_intra_chunk_plain(*(v.contiguous() for v in views))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_torch_ref_matches_jax_ref():
    arrays = _chunk_inputs(8, 2, 2, 2, 33, 32, 16)
    for got, want in zip(torch_ref.ssd_intra_chunk_ref(*map(torch.from_numpy, arrays)),
                         jax_ref.ssd_intra_chunk_ref(*map(jnp.asarray, arrays))):
        _close(got, want, 2e-5)


def _scan_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.2).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    a = (-np.exp(rng.standard_normal(h) * 0.2)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel_route", "chunked_route"])
@pytest.mark.parametrize("s,chunk,with_h0", [
    (128, 32, False),  # S a multiple of the chunk
    (100, 32, False),  # right-padded to a chunk multiple
    (20, 32, False),   # S < chunk: one chunk of Q = S
    (70, 32, True),    # an initial state
])
def test_ssd_chunked_matches_reference(kernel, s, chunk, with_h0):
    b, h, p, n = 2, 3, 32, 16
    arrays = _scan_inputs(9, b, s, h, p, n)
    h0 = (np.random.default_rng(10).standard_normal((b, h, n, p)) * 0.1).astype(np.float32)
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a) for a in arrays]
    want_y, want_h = jax_ssd_chunked(*jargs, chunk, jnp.asarray(h0) if with_h0 else None)
    ops.reset_launches()
    y, h_last = ssd_chunked(*targs, chunk, torch.from_numpy(h0) if with_h0 else None,
                            kernel=kernel)
    assert ops.LAUNCHES["ssd_chunk_dual"] == 0  # the CPU runs the plain version
    assert y.shape == (b, s, h, p) and h_last.shape == (b, h, n, p)
    _close(y, want_y)
    _close(h_last, want_h)


def test_ssd_chunked_returns_the_input_dtype():
    arrays = _scan_inputs(11, 1, 40, 2, 32, 16)
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrays)
    y, h_last = ssd_chunked(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(), 16,
                            kernel=True)
    assert y.dtype == h_last.dtype == torch.bfloat16
    want_y, want_h = jax_ssd_chunked(
        jnp.asarray(x.bfloat16().float().numpy(), jnp.bfloat16), jnp.asarray(arrays[1]),
        jnp.asarray(arrays[2]), jnp.asarray(bm.bfloat16().float().numpy(), jnp.bfloat16),
        jnp.asarray(cm.bfloat16().float().numpy(), jnp.bfloat16), 16)
    _close(y, want_y, 2e-2)
    _close(h_last, want_h, 2e-2)


def test_cuda_wrapper_refuses_cpu_tensors():
    arrays = [torch.from_numpy(a) for a in _chunk_inputs(12, 1, 1, 1, 8, 32, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_intra_chunk_cuda(*arrays)
