"""The published Zamba2 layout (the hybrid family with ``hybrid_layer_ids``)
against the benchmark's plain float32 reference
(``perfbench/reference/families/hybrid.py``) at the small configuration of
``perfbench/tests/tiny_hybrid.py``, on seeded random weights; and the pieces
it forced: K2 and K3's plain paths at D 224 and with a softmax scale of the
model's own, K4's grouped B/C, the cache and the device position.

Tolerances: the program and the reference both compute in float32, and
differ only in summation order (chunks of 8 against 64 in the scan, tiles of
64 keys in attention), so their logits agree to 2e-5 of the logits' largest
magnitude; the same program in bfloat16 misses that by orders of magnitude
(``test_the_tolerance_rejects_bfloat16``). Attention pieces are held to
their formula in float64 at 1e-5 (float32 sums over 224 dims)."""

import importlib.util
import math
import pathlib
from dataclasses import replace

import pytest
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers, mamba2, transformer
from perfbench.drivers import common
from perfbench.reference import ops as ref_ops
from perfbench.reference.families import hybrid as ref
from perfbench.reference.weights import Weights

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("perfbench_tiny_hybrid",
                                               ROOT / "perfbench" / "tests" / "tiny_hybrid.py")
tiny = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tiny)

M = tiny.HYBRID
SEED = 2 ** 31 + 29
TOL = 2e-5  # of the logits' largest magnitude: f32 against f32, summation order only
RUNS = {"flash": RunConfig(attention_impl="flash", attention_chunk=8, remat="none", zero=False),
        "chunked": RunConfig(attention_impl="chunked", attention_chunk=8, remat="none",
                             zero=False)}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def program(m=M, dtype=None):
    m = dict(m, dtype=dtype or m["dtype"])
    spec = ref.param_spec(m)
    return ModelConfig(**m), common.build_model(m, spec, SEED, torch.device("cpu"))


def tokens(b=3, s=21, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, M["vocab"], (b, s), generator=g)


def reference_logits(toks):
    w = Weights(ref.param_spec(M), SEED, torch.device("cpu"), torch.float32)
    with torch.no_grad():
        return ref.serve_logits(M, w.get, toks, 1, ref_ops.exact)


def close(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("impl", sorted(RUNS))
def test_forward_matches_the_reference(impl):
    cfg, model = program()
    toks = tokens()
    with torch.no_grad():
        hidden, _ = transformer.forward_hidden(model, cfg, RUNS[impl], toks)
        got = transformer.lm_logits(model, cfg, hidden)[..., :M["vocab"]]
    assert close(got, reference_logits(toks)) < TOL


@pytest.mark.parametrize("impl", sorted(RUNS))
@pytest.mark.parametrize("pos", ["int", "device-pos"])
def test_prefill_then_decode_matches_the_reference(impl, pos):
    """Prefill on 13 positions (a chunk and a part), then 8 decode steps
    through the cache, each against the reference's full forward."""
    cfg, model = program()
    toks, p = tokens(), 13
    want = reference_logits(toks)
    run = RUNS[impl]
    with torch.no_grad():
        logits, cache = transformer.prefill(model, cfg, run, toks[:, :p], max_len=toks.shape[1])
        got = [logits[:, 0]]
        if pos == "device-pos":
            assert transformer.position_on_device(cfg, model.embed)
            cache = dict(cache, pos=torch.tensor(cache["pos"]))
        for i in range(p, toks.shape[1]):
            logits, cache = transformer.decode_step(model, cfg, run, cache, toks[:, i:i + 1])
            got.append(logits[:, 0])
    got = torch.stack(got, dim=1)[..., :M["vocab"]]
    assert close(got, want[:, p - 1:]) < TOL
    assert int(cache["pos"]) == toks.shape[1]


def test_the_tolerance_rejects_bfloat16():
    """The same weights in bfloat16 (the served dtype) miss TOL."""
    cfg, model = program(dtype="bfloat16")
    toks = tokens()
    with torch.no_grad():
        hidden, _ = transformer.forward_hidden(model, cfg, RUNS["chunked"], toks)
        got = transformer.lm_logits(model, cfg, hidden)[..., :M["vocab"]]
    assert close(got, reference_logits(toks)) > 10 * TOL


def test_cache_and_parameters_of_the_published_layout():
    cfg, model = program()
    names = dict(model.named_parameters())
    assert set(names) == set(ref.param_spec(M))
    # param_count leaves out the final norm and the vocabulary's padding rows
    extra = M["d_model"] * (1 + cfg.padded_vocab - cfg.vocab)
    assert cfg.param_count() + extra == sum(p.numel() for p in names.values())
    cache = transformer.init_cache(cfg, 2, 30, device="cpu")
    di, nh = 2 * M["d_model"], 2 * M["d_model"] // M["ssm_head_dim"]
    assert cache["ssm"].shape == (7, 2, nh, M["ssm_state"], M["ssm_head_dim"])
    assert cache["conv"].shape == (7, 2, M["ssm_conv"] - 1, di + 2 * 2 * M["ssm_state"])
    assert cache["k"].shape == cache["v"].shape == (2, 2, 30, M["n_kv_heads"], M["d_head"])
    with pytest.raises(ValueError, match="no window"):
        transformer.init_cache(replace(cfg, window=16), 2, 30, device="cpu")
    assert not transformer.position_on_device(replace(cfg, window=16), model.embed)


def test_a_full_cache_raises():
    cfg, model = program()
    toks = tokens(s=9)
    with torch.no_grad():
        _, cache = transformer.prefill(model, cfg, RUNS["chunked"], toks)
        with pytest.raises(ValueError, match="is full"):
            transformer.decode_step(model, cfg, RUNS["chunked"], cache, toks[:, :1])


def test_training_raises():
    """The layout serves only: it has no training forward."""
    cfg, model = program()
    with pytest.raises(NotImplementedError, match="training"):
        transformer.forward_train(model, cfg, RUNS["chunked"], tokens(s=9))


@pytest.mark.parametrize("step", ["forward", "prefill", "decode"])
def test_a_mesh_raises(step, monkeypatch):
    """On a mesh (parameters as DTensors, here feigned) every serving step
    of the layout raises before it runs."""
    cfg, model = program()
    toks = tokens(s=9)
    run = RUNS["chunked"]
    with torch.no_grad():
        _, cache = transformer.prefill(model, cfg, run, toks)
        monkeypatch.setattr(transformer, "is_distributed", lambda t: True)
        with pytest.raises(NotImplementedError, match="mesh"):
            if step == "forward":
                transformer.forward_hidden(model, cfg, run, toks)
            elif step == "prefill":
                transformer._prefill(model, cfg, run, toks, None, None)
            else:
                transformer._decode_step(model, cfg, run, cache, toks[:, :1])


# -- the kernels' plain paths at D 224 and with the model's scale --------------------------


def attention64(q, k, v, scale, causal=True):
    """softmax(scale q k^T) v in float64, grouped query heads."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    kk = k.double().repeat_interleave(h // kv, dim=2)
    vv = v.double().repeat_interleave(h // kv, dim=2)
    sc = torch.einsum("bshd,bthd->bhst", q.double(), kk) * scale
    if causal:
        mask = torch.arange(t)[None, :] <= torch.arange(s)[:, None] + (t - s)
        sc = sc.masked_fill(~mask, -math.inf)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(sc, dim=-1), vv)


def qkv(b, s, t, h, kv, d, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, s, h, d, generator=g), torch.randn(b, t, kv, d, generator=g),
            torch.randn(b, t, kv, d, generator=g))


@pytest.mark.parametrize("scale", [None, (224 / 2) ** -0.5])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)])
def test_k2_plain_at_d224(scale, h, kv):
    q, k, v = qkv(2, 70, 70, h, kv, 224)
    want = attention64(q, k, v, 1 / math.sqrt(224) if scale is None else scale)
    for got in (flash_attention_plain(q, k, v, scale=scale),
                layers.chunked_attention(q, k, v, chunk=64, scale=scale),
                layers.naive_attention(q, k, v, scale=scale)):
        assert float((got.double() - want).abs().max()) < 1e-5


def test_k2_plain_scale_is_not_the_default():
    q, k, v = qkv(1, 33, 33, 2, 2, 224)
    a = flash_attention_plain(q, k, v)
    b = flash_attention_plain(q, k, v, scale=(224 / 2) ** -0.5)
    assert float((a - b).abs().max()) > 1e-2


@pytest.mark.parametrize("scale", [None, (224 / 2) ** -0.5])
def test_k3_plain_at_d224(scale):
    b, t, h, kv = 3, 200, 4, 4
    q, k, v = qkv(b, 1, t, h, kv, 224)
    lengths = torch.tensor([200, 77, 1], dtype=torch.int32)
    s = 1 / math.sqrt(224) if scale is None else scale
    for splits in (None, 1, 3):
        got = decode_attention_plain(q, k, v, lengths, scale=scale, splits=splits)
        for i, n in enumerate(lengths.tolist()):
            want = attention64(q[i:i + 1], k[i:i + 1, :n], v[i:i + 1, :n], s, causal=False)
            assert float((got[i:i + 1].double() - want).abs().max()) < 1e-5
    dec = layers.decode_attention(q, k, v, lengths, scale=scale)
    assert float((dec - got).abs().max()) < 1e-5


# -- K4 with B and C in groups ------------------------------------------------------------


def scan_inputs(b=2, s=40, nh=6, p=16, g=3, n=8, seed=4):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, nh, p, generator=gen)
    dt = torch.rand(b, s, nh, generator=gen) * 0.1 + 1e-3
    a = -torch.rand(nh, generator=gen) * 4 - 1
    bm = torch.randn(b, s, g, n, generator=gen)
    cm = torch.randn(b, s, g, n, generator=gen)
    h0 = torch.randn(b, nh, n, p, generator=gen)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("kernel", [False, True])
def test_k4_grouped_against_ungrouped_calls(kernel):
    """Each group's heads scanned with that group's B/C as an ungrouped call
    (one head at a time) give the grouped scan's y and state."""
    x, dt, a, bm, cm, h0 = scan_inputs()
    y, h = mamba2.ssd_grouped(x, dt, a, bm, cm, 16, h0, kernel=kernel)
    per = x.shape[2] // bm.shape[2]
    for head in range(x.shape[2]):
        grp, one = head // per, slice(head, head + 1)
        y1, h1 = mamba2.ssd_chunked(x[:, :, one], dt[:, :, one], a[one], bm[:, :, grp],
                                    cm[:, :, grp], 16, h0[:, one], kernel=kernel)
        assert torch.allclose(y[:, :, one], y1, atol=1e-5, rtol=1e-5)
        assert torch.allclose(h[:, one], h1, atol=1e-5, rtol=1e-5)


def test_k4_one_group_is_the_shared_scan():
    x, dt, a, bm, cm, h0 = scan_inputs(g=1)
    y, h = mamba2.ssd_grouped(x, dt, a, bm, cm, 16, h0)
    y1, h1 = mamba2.ssd_chunked(x, dt, a, bm[:, :, 0], cm[:, :, 0], 16, h0)
    assert torch.equal(y, y1) and torch.equal(h, h1)


def test_grouped_decode_step_matches_the_scan():
    """The O(1) recurrence with grouped B/C, step by step, equals the
    chunked scan over the same positions."""
    cfg, model = program()
    lp = model.layers[1].mamba
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 11, M["d_model"], generator=g)
    with torch.no_grad():
        full, ssm_f, conv_f = mamba2.mamba_block(lp, x, cfg)
        _, ssm, conv = mamba2.mamba_block(lp, x[:, :6], cfg)
        steps = []
        for i in range(6, 11):
            y, ssm, conv = mamba2.mamba_block(lp, x[:, i:i + 1], cfg, ssm_state=ssm,
                                              conv_state=conv, single_step=True)
            steps.append(y)
    assert torch.allclose(torch.cat(steps, dim=1), full[:, 6:], atol=1e-5, rtol=1e-4)
    # the input products of 1 and 11 rows round alike only to f32's last bits
    assert close(ssm, ssm_f) < 1e-5 and close(conv, conv_f) < 1e-6
