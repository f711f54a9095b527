"""The port's kernels (plain versions, on the CPU) against the JAX package:
the Pallas kernels in interpret mode over the sweeps of test_kernels.py, and
``repro.kernels.ref`` on ragged shapes the Pallas kernels cannot take.

Tolerances are those of test_kernels.py: f32 2e-5 (summation order), bf16
2e-2 (one bf16 rounding of the output)."""

import importlib
import inspect
import pathlib

import hypothesis
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import flash_decode as jax_decode
from repro.kernels import fused_rmsnorm as jax_rmsnorm
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as torch_ref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
fa = importlib.import_module("repro_torch.kernels.flash_attention")
jax_flash_module = importlib.import_module("repro.kernels.flash_attention")
da = importlib.import_module("repro_torch.kernels.decode_attention")
rms = importlib.import_module("repro_torch.kernels.rmsnorm")


def _inputs(seed, dtype, *shapes):
    """The same values for both packages (bf16 rounds the same way in both)."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(torch_out, jax_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32), rtol=tol, atol=tol)


def _flat_ref(q, k, v, causal, window=0):
    """repro.kernels.ref.flash_attention_ref in the model layout (B,S,H,D)."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    kq = jnp.repeat(k, g, axis=2).transpose(0, 2, 1, 3).reshape(b * h, -1, d)
    vq = jnp.repeat(v, g, axis=2).transpose(0, 2, 1, 3).reshape(b * h, -1, d)
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, s, d)
    out = jax_ref.flash_attention_ref(qf, kq, vq, causal=causal, window=window)
    return out.reshape(b, h, s, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,h,kh,d,bq,bk", [
    (128, 4, 4, 64, 64, 64),    # MHA
    (256, 4, 2, 64, 128, 128),  # GQA 2:1
    (256, 8, 1, 128, 128, 64),  # MQA, D=128
])
def test_flash_attention_matches_pallas(dtype, s, h, kh, d, bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _inputs(0, dtype, (2, s, h, d), (2, s, kh, d),
                                         (2, s, kh, d))
    want = jax_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk, interpret=True)
    _close(ops.flash_attention(tq, tk, tv, causal=True), want, DTYPES[dtype][2])


@pytest.mark.parametrize("kwargs", [dict(causal=False), dict(causal=True, window=64)])
def test_flash_attention_non_causal_and_windowed(kwargs):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, "float32", *[(1, 256, 2, 64)] * 3)
    want = jax_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True, **kwargs)
    _close(ops.flash_attention(tq, tk, tv, **kwargs), want, 2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,t,h,kh,d,causal,window", [
    (5, 5, 4, 2, 32, True, 0),       # the serve tests' left-padded prompts
    (77, 77, 8, 2, 64, True, 0),     # S, T not multiples of any block
    (40, 130, 4, 1, 128, False, 0),  # S != T
    (100, 100, 4, 4, 64, True, 17),  # ragged sliding window
    (77, 77, 4, 4, 80, True, 0),     # zamba2's head dim
    (60, 60, 4, 4, 80, True, 16),    # zamba2's head dim, windowed
])
def test_flash_attention_ragged_matches_ref(dtype, s, t, h, kh, d, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, dtype, (2, s, h, d), (2, t, kh, d),
                                         (2, t, kh, d))
    want = _flat_ref(jq, jk, jv, causal, window)
    _close(ops.flash_attention(tq, tk, tv, causal=causal, window=window), want,
           DTYPES[dtype][2])


def _bhsd(x, g):
    """(B,S,K,D) -> (B*K*G, S, D), each KV head repeated for its G query
    heads (the reference wrapper's layout)."""
    b, s, k, d = x.shape
    return jnp.repeat(x, g, axis=2).transpose(0, 2, 1, 3).reshape(b * k * g, s, d)


# (mask, S, T, window) for the plain version at the kernel's tile: causal
# over two KV tiles, a window smaller than one tile, and unmasked S != T.
_TILE_MASKS = {"causal": (128, 256, True, 0), "window": (128, 256, True, 48),
               "unmasked": (128, 384, False, 0)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("extra", ["q_offset", "softcap"])
@pytest.mark.parametrize("mask", list(_TILE_MASKS))
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_plain_at_kernel_tile_matches_pallas(dtype, extra, mask, d):
    """flash_attention_plain, which walks KV tiles of the bf16 kernel's
    BLOCK_K keys, against the Pallas kernel (interpret mode, block_k =
    BLOCK_K) at every head dim. Pallas puts query i at position i, so a
    query offset is given to it as S queries in rows q_offset.. of a zero
    query block as long as the keys, and only those rows are compared; it
    has no softcap, so the capped cases hold to the reference model's
    naive_attention instead."""
    s, t, causal, window = _TILE_MASKS[mask]
    (jq, jk, jv), (tq, tk, tv) = _inputs(12, dtype, (1, s, 2, d), (1, t, 1, d), (1, t, 1, d))
    q_offset = t - s if extra == "q_offset" else 0
    softcap = 30.0 if extra == "softcap" else 0.0
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                   q_offset=q_offset, softcap=softcap)
    if extra == "softcap":
        from repro.models import layers as jax_layers

        want = jax_layers.naive_attention(jq, jk, jv, causal, window, q_offset, softcap)
    else:
        rows = t if causal else s  # queries at positions 0 .. rows - 1
        qpad = jnp.zeros((1, rows, 2, d), jq.dtype).at[:, rows - s:].set(jq)
        out = jax_flash_module.flash_attention_bhsd(
            _bhsd(qpad, 1), _bhsd(jk, 2), _bhsd(jv, 2), causal=causal, window=window,
            block_q=128, block_k=fa.BLOCK_K, interpret=True)
        want = out.reshape(1, 2, rows, d).transpose(0, 2, 1, 3)[:, rows - s:]
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("layout", ["misaligned", "odd_stride", "fused_split"])
def test_tma_layout_check_runs_before_any_build(layout, monkeypatch):
    """The wrapper refuses, on CPU tensors and before anything is built, a
    q whose address or sequence stride is not a whole 16 bytes (TMA's
    rule); a head slice of a fused projection, as a fused QKV split would
    make it, meets the rule and goes on to the device check."""
    from repro_torch.kernels import _build

    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(_build, "entry", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    kv = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
    if layout == "misaligned":
        q = torch.zeros(2 * 16 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 4, 64)
    elif layout == "odd_stride":  # rows 520 bytes apart
        q = torch.zeros(2, 16, 260, dtype=torch.bfloat16)[..., :256].view(2, 16, 4, 64)
    else:
        q = torch.zeros(2, 16, 3 * 256, dtype=torch.bfloat16)[..., :256].view(2, 16, 4, 64)
    if layout == "fused_split":
        fa.check_tma_layout(q, kv, kv)
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_cuda(q, kv, kv)
    else:
        with pytest.raises(ValueError, match="TMA"):
            fa.flash_attention_cuda(q, kv, kv)


def _decode_inputs(seed, dtype, b, t, h, kh, d, lengths):
    (jq, jk, jv), (tq, tk, tv) = _inputs(seed, dtype, (b, 1, h, d), (b, t, kh, d),
                                         (b, t, kh, d))
    lens = np.asarray(lengths, np.int32)
    return (jq, jk, jv, jnp.asarray(lens)), (tq, tk, tv, torch.from_numpy(lens))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,h,kh,d,bk", [
    (512, 4, 4, 64, 128),
    (1024, 8, 2, 128, 256),
    (512, 4, 1, 64, 512),
])
def test_flash_decode_matches_pallas(dtype, t, h, kh, d, bk):
    jx, tx = _decode_inputs(3, dtype, 2, t, h, kh, d, [t // 3, t])
    want = jax_decode(*jx, block_k=bk, interpret=True)
    _close(ops.flash_decode(*tx), want, DTYPES[dtype][2])

# The served split counts of K3: (T, CTAs a split of the served shape, Pallas
# block). tinyllama-1.1b's and zamba2-2.7b's caches of 576 slots (9 splits
# of 64 and 2 of 320), phi-3-vision-4.2b's 1088 (2 of 576) and whisper-base's
# cross cache of 1500 frames (5 splits of 320, the last ragged).
SERVED_SPLITS = [(576, 16, 64), (576, 128, 64), (1088, 128, 64), (1500, 32, 300)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,ctas,bk", SERVED_SPLITS)
def test_decode_plain_at_served_splits_matches_pallas(dtype, t, ctas, bk):
    """The plain version cut into the splits the kernel takes at a served
    shape (T kept, so each split keeps its count of 64-key tiles; widths
    small) against the Pallas kernel in interpret mode, lengths 0, inside a
    split and T."""
    n, split_len = da.num_splits(t, ctas)
    assert n > 1 and n <= da.MAX_CLUSTER and split_len % da.BLOCK_K == 0
    jx, tx = _decode_inputs(6, dtype, 3, t, 4, 2, 32, [0, t // 2 + 5, t])
    want = jax_decode(*jx, block_k=bk, interpret=True)
    got = da.decode_attention_plain(*tx, splits=n)
    _close(got, want, DTYPES[dtype][2])
    assert float(got[0].abs().max()) == 0.0


@hypothesis.settings(max_examples=200, deadline=None, database=None)
@hypothesis.given(t=hypothesis.strategies.integers(1, 1 << 17),
                  ctas=hypothesis.strategies.integers(1, 1 << 14))
def test_num_splits_covers_the_cache_within_one_cluster(t, ctas):
    """Any capacity and CTA count: the splits cover T with the last one
    non-empty, each a whole number of 64-key tiles, at most one cluster's
    worth, and the plain version's override cuts a count the same way. The
    rule takes shapes only: ``lengths`` live on the device."""
    n, split_len = da.num_splits(t, ctas)
    assert split_len % da.BLOCK_K == 0 and split_len >= da.BLOCK_K
    assert n * split_len >= t > (n - 1) * split_len
    assert 1 <= n <= da.MAX_CLUSTER
    assert da._cut(t, n) == (n, split_len)
    assert list(inspect.signature(da.num_splits).parameters) == ["t", "ctas"]


@pytest.mark.parametrize("layout", ["misaligned_k", "odd_stride_v", "misaligned_q"])
def test_decode_layout_check_runs_before_any_build(layout, monkeypatch):
    """The decode wrapper refuses, on CPU tensors and before anything is
    built, a cache or query that TMA cannot read: an address off 16 bytes,
    or a sequence stride (here 520 bytes) that is not a whole 16 bytes."""
    from repro_torch.kernels import _build

    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(_build, "entry", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    q = torch.zeros(2, 1, 4, 64, dtype=torch.bfloat16)
    k = v = torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16)
    lengths = torch.full((2,), 16, dtype=torch.int32)
    if layout == "misaligned_k":
        k = torch.zeros(2 * 16 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 2, 64)
    elif layout == "odd_stride_v":
        v = torch.zeros(2, 16, 260, dtype=torch.bfloat16)[..., :128].view(2, 16, 2, 64)
    else:
        q = torch.zeros(2 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 1, 4, 64)
    with pytest.raises(ValueError, match="TMA"):
        da.decode_attention_cuda(q, k, v, lengths)
    da.check_tma_layout(torch.zeros(2, 1, 4, 64, dtype=torch.bfloat16),
                        torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16),
                        torch.zeros(2, 16, 2, 64, dtype=torch.bfloat16))



@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,h,kh,d,lengths", [
    (576, 32, 4, 64, [513, 1, 65, 576]),  # the serve shape: T = plen + new tokens
    (100, 8, 2, 128, [1, 37, 99]),
    (70, 4, 4, 32, [70, 33]),
    (90, 4, 4, 80, [1, 45, 90]),     # zamba2's head dim
])
def test_flash_decode_ragged_matches_ref(dtype, t, h, kh, d, lengths):
    (jq, jk, jv, jl), tx = _decode_inputs(4, dtype, len(lengths), t, h, kh, d, lengths)
    b, g = len(lengths), h // kh
    want = jax_ref.decode_attention_ref(
        jq[:, 0].reshape(b * kh, g, d),
        jk.transpose(0, 2, 1, 3).reshape(b * kh, t, d),
        jv.transpose(0, 2, 1, 3).reshape(b * kh, t, d),
        jnp.repeat(jl, kh)).reshape(b, h, d)[:, None]
    _close(ops.flash_decode(*tx), want, DTYPES[dtype][2])


def test_flash_decode_zero_length_gives_zeros_like_pallas():
    jx, tx = _decode_inputs(5, "float32", 2, 128, 4, 2, 64, [0, 128])
    want = jax_decode(*jx, block_k=64, interpret=True)
    out = ops.flash_decode(*tx)
    assert float(np.abs(np.asarray(want[0])).max()) == 0.0
    assert float(out[0].abs().max()) == 0.0
    _close(out, want, 2e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(8, 128), (4, 32, 256), (3, 5, 64), (7, 2048),
                                   (3, 8200),   # wider than the kernel holds in registers
                                   (7, 2050)])  # not in 16-byte vectors
def test_rmsnorm_matches_pallas(dtype, shape):
    (jx,), (tx,) = _inputs(6, dtype, shape)
    rng = np.random.default_rng(7)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jax_rmsnorm(jx, jnp.asarray(w), interpret=True)
    _close(ops.fused_rmsnorm(tx, torch.from_numpy(w)), want, DTYPES[dtype][2])


def test_torch_ref_matches_jax_ref():
    (jq, jk, jv), (tq, tk, tv) = _inputs(8, "float32", (4, 50, 32), (4, 70, 32),
                                         (4, 70, 32))
    for kwargs in (dict(causal=True), dict(causal=False), dict(causal=True, window=9)):
        _close(torch_ref.flash_attention_ref(tq, tk, tv, **kwargs),
               jax_ref.flash_attention_ref(jq, jk, jv, **kwargs), 2e-5)
    lens = np.asarray([1, 0, 50, 70], np.int32)
    _close(torch_ref.decode_attention_ref(tq[:, :3], tk, tv, torch.from_numpy(lens)),
           jax_ref.decode_attention_ref(jq[:, :3], jk, jv, jnp.asarray(lens)), 2e-5)
    (jx,), (tx,) = _inputs(9, "float32", (6, 40))
    _close(torch_ref.rmsnorm_ref(tx, tx[0]), jax_ref.rmsnorm_ref(jx, jx[0]), 2e-5)


def test_cpu_tensors_never_count_launches():
    ops.reset_launches()
    (_, (tq, tk, tv)) = _inputs(10, "float32", (1, 8, 2, 32), (1, 8, 1, 32), (1, 8, 1, 32))
    ops.flash_attention(tq, tk, tv)
    ops.flash_decode(tq[:, :1], tk, tv, torch.tensor([8], dtype=torch.int32))
    ops.fused_rmsnorm(tq, tq[0, 0, 0])
    ops.ssd_chunk_dual(tq[:, None].permute(0, 1, 3, 2, 4), tq[:, None, :, :, 0].mT,
                       tq[:, None, :, 0], tq[:, None, :, 0])
    assert ops.LAUNCHES == {"fused_rmsnorm": 0, "flash_attention": 0, "flash_decode": 0,
                            "ssd_chunk_dual": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rms.rmsnorm_rows_cuda(x, x[0])
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q[:, :1], q, q, torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("call,kwargs", [
    ("flash_attention", dict(softcap=30.0)),
    ("flash_attention", dict(q_offset=24)),
    ("flash_attention", dict(softcap=30.0, q_offset=24, window=16)),
    ("flash_decode", dict(window=16)),
    ("flash_decode", dict(softcap=30.0)),
    ("flash_decode", dict(window=16, softcap=30.0)),
])
def test_former_gaps_match_reference(call, kwargs):
    """The options the kernels once refused (softcap and q_offset for
    flash_attention, window and softcap for flash_decode) give the reference
    model's attention (repro.models.layers)."""
    from repro.models import layers as jax_layers

    (jq, jk, jv), (tq, tk, tv) = _inputs(11, "float32", (2, 40, 8, 64),
                                         (2, 64, 2, 64), (2, 64, 2, 64))
    if call == "flash_attention":
        want = jax_layers.naive_attention(
            jq, jk, jv, True, kwargs.get("window", 0), kwargs.get("q_offset", 0),
            kwargs.get("softcap", 0.0))
        got = ops.flash_attention(tq, tk, tv, causal=True, **kwargs)
    else:
        lens = np.asarray([5, 64], np.int32)
        want = jax_layers.decode_attention(jq[:, :1], jk, jv, jnp.asarray(lens),
                                           kwargs.get("window", 0), kwargs.get("softcap", 0.0))
        got = ops.flash_decode(tq[:, :1], tk, tv, torch.from_numpy(lens), **kwargs)
    _close(got, want, 2e-5)


def test_build_names_libraries_by_source_and_headers(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = _build._target("k")[1]
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build._target("k")[1]
    assert first != second and second.parent == tmp_path / "build"
    second.parent.mkdir()
    second.write_bytes(b"")
    assert _build.build(["k"]) == {}  # built already: no compiler run


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if pathlib.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["rmsnorm"])
