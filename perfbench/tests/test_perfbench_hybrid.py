"""The zamba2-7b configuration and the zamba2-serve-chat cell on the CPU:
the reference's parameter spec against the program's parameters, the
reference against transformers' Zamba2ForCausalLM at the same small size
(weights mapped one for one), a served run of the small configuration
through the harness, the traffic's lengths, the yardstick's counts by hand,
and each new reader on a made-up trace (and on a program that records no
spans)."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness
from perfbench.drivers import common, serve_waves
from perfbench.reference import ops as ref_ops
from perfbench.reference.families import hybrid as ref
from perfbench.tests import tiny_hybrid
from perfbench.yardstick import flops, hybrid_flops
from perfbench.yardstick import spans as yard
from perfbench.yardstick.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
CHAT = json.loads((ROOT / "perfbench" / "traffic" / "chat-long-answer.json").read_text())
ZAMBA = json.loads((ROOT / "perfbench" / "configs" / "zamba2-7b.json").read_text())
M = tiny_hybrid.HYBRID


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def cell(model=M, mix=tiny_hybrid.CHAT, seed=2 ** 31 + 7):
    import copy

    return serve_waves.Cell({"model": copy.deepcopy(model)}, copy.deepcopy(mix), seed,
                            torch.device("cpu"))


# -- the configuration -------------------------------------------------------------------


def test_param_spec_is_the_programs():
    spec = ref.param_spec(M)
    model = common.build_model(M, spec, 3, torch.device("cpu"))  # raises on any mismatch
    got = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert got == {k: tuple(shape) for k, (shape, _) in spec.items()}
    assert "lm_head" not in got  # tied


def test_published_sizes():
    """7,356,746,064 parameters from the published config.json (hand count),
    plus the final norm: 81 Mamba layers of in_proj (3,584 x 14,704),
    conv 4 x 7,424 and its bias, A, D, dt_bias, the gated norm, out_proj
    (7,168 x 3,584) and a norm; 2 shared blocks (attention on 7,168 inputs,
    MLP 3,584 -> 2 x 14,336 -> 3,584, two norms); 13 linears and adapters;
    the tied embedding."""
    m = ZAMBA["model"]
    spec = ref.param_spec(m)
    total = sum(math.prod(shape) for shape, _ in spec.values())
    d, di, conv, nh, ff = 3584, 7168, 7424, 112, 14336
    mamba = d * (di + conv + nh) + 4 * conv + conv + 3 * nh + di + di * d + d
    block = 3 * (2 * d) * di + di * d + 3 * d * ff + 2 * d + d
    want = 81 * mamba + 2 * block + 13 * (d * d + 128 * (d + 2 * ff)) + 32000 * d + d
    assert total == want == 7_356_746_064 + d
    assert ZAMBA["hidden_size"] == m["d_model"] and ZAMBA["num_hidden_layers"] == m["n_layers"]
    assert ZAMBA["attention_head_dim"] == m["d_head"] and ZAMBA["mamba_ngroups"] == m["ssm_groups"]
    assert ZAMBA["hybrid_layer_ids"] == m["hybrid_layer_ids"] and ZAMBA["reduced"] == []
    assert m["attn_scale"] == (m["d_head"] / 2) ** -0.5


# -- the reference against transformers' Zamba2 --------------------------------------------


def hf_model(m):
    transformers = pytest.importorskip("transformers")
    ids = set(m["hybrid_layer_ids"])
    config = transformers.Zamba2Config(
        vocab_size=m["vocab"], hidden_size=m["d_model"], num_hidden_layers=m["n_layers"],
        layers_block_type=["hybrid" if i in ids else "mamba" for i in range(m["n_layers"])],
        mamba_d_state=m["ssm_state"], mamba_d_conv=m["ssm_conv"], mamba_expand=m["ssm_expand"],
        mamba_ngroups=m["ssm_groups"], n_mamba_heads=2 * m["d_model"] // m["ssm_head_dim"],
        time_step_min=m["ssm_dt_min"], use_conv_bias=True, chunk_size=m["ssm_chunk"],
        intermediate_size=m["d_ff"], hidden_act="gelu", num_attention_heads=m["n_heads"],
        num_key_value_heads=m["n_kv_heads"], num_mem_blocks=m["hybrid_blocks"],
        use_shared_attention_adapter=False, use_shared_mlp_adapter=True,
        adapter_rank=m["adapter_rank"], use_mem_rope=True, rope_theta=m["rope_theta"],
        rms_norm_eps=m["norm_eps"], tie_word_embeddings=True, pad_token_id=0)
    config._attn_implementation = "eager"
    torch.manual_seed(11)
    return transformers.Zamba2ForCausalLM(config).float().eval()


def hf_weights(hf, m) -> dict:
    """The reference's weights, named as its spec, from the transformers
    model: (out, in) linears transposed to (in, out), the conv (C, 1, K) to
    (K, C)."""
    sd = {k: v.detach().float() for k, v in hf.state_dict().items()}
    w = {"embed": sd["model.embed_tokens.weight"], "final_norm": sd["model.final_layernorm.weight"]}
    calls = {layer: j for j, layer in enumerate(m["hybrid_layer_ids"])}
    for i in range(m["n_layers"]):
        p = f"model.layers.{i}." + ("mamba_decoder." if i in calls else "")
        q = f"layers.{i}"
        w[f"{q}.norm1"] = sd[p + "input_layernorm.weight"]
        for ours, theirs in (("in_proj", "in_proj.weight"), ("out_proj", "out_proj.weight")):
            w[f"{q}.mamba.{ours}"] = sd[p + "mamba." + theirs].T
        w[f"{q}.mamba.conv_w"] = sd[p + "mamba.conv1d.weight"][:, 0, :].T
        w[f"{q}.mamba.conv_b"] = sd[p + "mamba.conv1d.bias"]
        for name in ("A_log", "D", "dt_bias"):
            w[f"{q}.mamba.{name}"] = sd[p + "mamba." + name]
        w[f"{q}.mamba.ssm_norm"] = sd[p + "mamba.norm.weight"]
        if i in calls:
            j = calls[i]
            t = f"model.layers.{i}.shared_transformer."
            w[f"{q}.linear"] = sd[f"model.layers.{i}.linear.weight"].T
            ad = t + f"feed_forward.gate_up_proj_adapter_list.{j}."
            w[f"{q}.adapter_in"] = sd[ad + "0.weight"].T
            w[f"{q}.adapter_out"] = sd[ad + "1.weight"].T
            b = f"blocks.{j % m['hybrid_blocks']}"
            for ours, theirs in (("attn.wq", "self_attn.q_proj"), ("attn.wk", "self_attn.k_proj"),
                                 ("attn.wv", "self_attn.v_proj"), ("attn.wo", "self_attn.o_proj"),
                                 ("mlp.wi", "feed_forward.gate_up_proj"),
                                 ("mlp.wo", "feed_forward.down_proj")):
                w[f"{b}.{ours}"] = sd[t + theirs + ".weight"].T
            w[f"{b}.norm1"] = sd[t + "input_layernorm.weight"]
            w[f"{b}.norm2"] = sd[t + "pre_ff_layernorm.weight"]
    return w


def test_the_reference_is_transformers_zamba2():
    """Logits at every position of 2 rows of 21 tokens (left padding aside:
    no mask in either) agree to 1e-5 of their largest magnitude; the two
    scan in chunks of 8 (transformers) and 64 (the reference). TF32 is not
    in play on the CPU."""
    m = dict(M, vocab=256)  # transformers' vocabulary is unpadded: take one of 16
    hf = hf_model(m)
    w = hf_weights(hf, m)
    assert set(w) == set(ref.param_spec(m))
    toks = torch.randint(0, m["vocab"], (2, 21), generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        want = hf(input_ids=toks).logits
        got = ref.serve_logits(m, w.__getitem__, toks, 1, ref_ops.exact)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err < 1e-5
    # The weights were mapped where they matter: a changed adapter moves it.
    w["layers.5.adapter_out"] = w["layers.5.adapter_out"] * 2
    with torch.no_grad():
        moved = ref.serve_logits(m, w.__getitem__, toks, 1, ref_ops.exact)
    assert float((moved - want).abs().max()) / float(want.abs().max()) > 100 * err


# -- a served run of the small configuration ---------------------------------------------


def test_float32_program_serves_the_references_tokens():
    c = cell()
    c.setup()
    records = [c.call(i) for i in range(tiny_hybrid.CHAT["sample_from"])]
    c.release()
    got, low = c.readings(records, control=True)
    assert got["served_gap"] <= 1e-5 and got["logit_error"] <= 1e-5
    assert got["own_gap"] == 0 and low["own_gap"] == 0
    assert low["logit_error"] > 100 * max(got["logit_error"], 1e-7)  # float8 products move it


def test_the_cell_runs_through_the_harness():
    spec = harness.CellSpec("zamba2-serve-chat")
    assert spec.config["model"]["name"] == "zamba2-7b" and spec.mix == CHAT
    result = harness.run(spec, cell(), 0.0, False, 0.0)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"own_gap", "logit_error"}
    assert set(result["metrics"]) == {"serve_tok_s", "latency_p95_ms", "peak_mem_gib", "setup_s"}


# -- the traffic ---------------------------------------------------------------------------


def test_chat_lengths():
    lengths = serve_waves.lengths(CHAT)
    assert len(lengths) == CHAT["batch_size"] == 64 and lengths == sorted(lengths)
    assert min(lengths) >= CHAT["prompt_min"] and max(lengths) == CHAT["prompt_max"] == 1024
    assert lengths[31] <= CHAT["prompt_median"] <= lengths[32]
    assert CHAT["new_tokens"] == 256 and CHAT["eos_id"] is None
    assert max(lengths) + CHAT["new_tokens"] <= ZAMBA["max_position_embeddings"]
    wave = serve_waves.wave(CHAT, 2 ** 33 + 5, 0, 32000)
    assert sorted(len(p) for p in wave) == lengths  # every wave pads to 1,024
    assert 0.65 < 1 - sum(lengths) / (64 * 1024) < 0.75  # about 70 % padding


# -- the yardstick's counts ------------------------------------------------------------------


def test_hybrid_counts_by_hand():
    m = M
    d, di, g, n, nh, p, ff, r = 64, 128, 2, 16, 8, 16, 96, 8
    mamba = d * (di + di + 2 * g * n + nh) + di * d
    shared = 2 * d * 128 + 2 * (2 * d) * 128 + 128 * d + 3 * d * ff + r * (d + 2 * ff) + d * d
    assert hybrid_flops.mamba_weights(m) == mamba and hybrid_flops.shared_weights(m) == shared
    assert hybrid_flops.token_weights(m) == 7 * mamba + 2 * shared
    positions = 10 + 4 - 1
    want = (2 * (7 * mamba + 2 * shared) * positions + 2 * d * 250 * 4
            + 4 * nh * n * p * 7 * positions + 4 * 4 * 32 * 2 * positions * (positions + 1) // 2)
    assert hybrid_flops.served_request(m, 10, 4) == want
    # K3: b2, 5 keys, h4 kv2 d8: 4 flops a key and dim a head; q, out, k, v
    assert hybrid_flops.k3(2, 5, 4, 2, 8) == (4 * 2 * 4 * 8 * 5,
                                              2 * (2 * 2 * 4 * 8 + 2 * 2 * 5 * 2 * 8))
    # K4: b1 nc1 h2 q3 p2 n4: 6 causal pairs
    ops, nbytes = hybrid_flops.k4(1, 1, 2, 3, 2, 4)
    assert ops == 2 * 6 * 4 + 2 * (2 * 6 * 2 + 2 * 3 * 4 * 2)
    assert nbytes == 4 * 2 * (3 * 2 + 3 + 3 * 2 + 4 * 2) + 2 * 2 * 3 * 4


def made_trace(launches, device, prompts=((1,) * 1000, (1,) * 1024), new=256):
    calls = [{"prompts": [list(p) for p in prompts]}]
    return Trace(device=device, host=[], window=None, window_s=2.0, calls=calls,
                 launches=launches, cell=SimpleNamespace(m=ZAMBA["model"],
                                                         mix={"new_tokens": new}))


def read(name, trace):
    return harness.CellSpec("zamba2-serve-chat").reader(name).read(trace)


def kernels(symbol, count, seconds):
    return [(f"void {symbol}<224>", i * 1.0, i * 1.0 + seconds) for i in range(count)]


def test_roofline_readers_on_a_made_up_trace():
    m, b, s = ZAMBA["model"], 2, 1024
    k2 = flops.k2(b, s, s, 32, 32, 224, True)
    device = kernels("flash_attention_bf16_kernel", 13, 1e-3)
    got = read("k2_roofline.hybrid", made_trace({"flash_attention": 13}, device))
    assert got == pytest.approx(100 * flops.least_s(*k2) / 1e-3)
    steps = [hybrid_flops.k3(b, s + i + 1, 32, 32, 224) for i in range(255)]
    device = kernels("decode_cluster_kernel", 13 * 255, 1e-4)
    got = read("k3_roofline.hybrid", made_trace({"flash_decode": 13 * 255}, device))
    assert got == pytest.approx(100 * 13 * sum(flops.least_s(*x) for x in steps) / (13 * 255e-4))
    k4 = hybrid_flops.k4(b, 4, 56, 256, 64, 64)
    device = kernels("ssd_bf16_kernel", 162, 2e-3)
    got = read("k4_roofline.hybrid", made_trace({"ssd_chunk_dual": 162}, device))
    assert got == pytest.approx(100 * flops.least_s(*k4) / 2e-3)
    assert 0 < got < 100
    with pytest.raises(RuntimeError, match="reckoned"):  # a launch missing from the trace
        read("k4_roofline.hybrid", made_trace({"ssd_chunk_dual": 162}, device[:-1]))
    assert len(hybrid_flops.k4_launches(made_trace({}, []))) == m["n_layers"] * m["ssm_groups"]


def test_mfu_reader_on_a_made_up_trace():
    trace = made_trace({}, kernels("x", 1, 1.0), prompts=((1,) * 300, (1,) * 40))
    m = ZAMBA["model"]
    useful = hybrid_flops.served_request(m, 300, 256) + hybrid_flops.served_request(m, 40, 256)
    assert read("mfu.hybrid", trace) == pytest.approx(100 * useful / 2.0 / 989e12)


BASE = 1_800_000_000 * 10 ** 9


def test_mamba_share_on_made_up_spans(monkeypatch):
    made = []

    def add(name, parent, device_ms, wave=0):
        s = SimpleNamespace(id=len(made), name=name, start_ns=BASE + len(made),
                            end_ns=BASE + len(made) + 1, parent=parent, fields={}, wave=wave,
                            device_s=None if device_ms is None else device_ms / 1e3)
        made.append(s)
        return s

    root = add("serve.wave", None, None)
    pre = add("serve.prefill", root.id, 100.0)
    for layer in range(3):
        add("mamba", pre.id, 20.0)
        add("mamba.ssd", made[-1].id, 5.0)
    add("shared", pre.id, 15.0)
    add("serve.tokens", root.id, None)
    add("mamba", root.id, None)  # a decode step's: untimed, outside prefill
    trace = made_trace({}, [("op", BASE / 1e9, BASE / 1e9 + 1)])
    monkeypatch.setattr(yard, "recorded", lambda: made)
    assert read("mamba_share.hybrid", trace) == pytest.approx(60.0)
    monkeypatch.setattr(yard, "recorded", lambda: [])  # a program without spans
    assert read("mamba_share.hybrid", trace) is None
