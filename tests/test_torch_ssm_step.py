"""The Mamba-2 decode step's state update and readout (``ops.ssm_step``).

On the CPU, at the shapes of the families that decode through it
(mamba2-130m: H 24, N 128, G 1; the simplified zamba2-2.7b: H 80, N 64, G
1; Zamba2-7B: H 112, N 64, G 2; P 64) and of their small test variants (H
8, N 16, G 1, P 32), in bf16 and in f32: the plain
version equals the single-step formula the Mamba block ran before it, bit
for bit, writes the state in place and returns y in the activations'
dtype. On the card (marked ``card``): the kernel against its plain version
at those shapes and at Zamba2-7B's served batch of 64, its launches counted
as a profiler trace holds them, and a CUDA graph's replays of it.
"""

import gc

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssm_step as k5

# heads, state size N, groups, head dim P
FAMILIES = {"mamba2-130m": (24, 128, 1, 64), "zamba2-2.7b": (80, 64, 1, 64),
            "zamba2-7b": (112, 64, 2, 64), "tiny": (8, 16, 1, 32)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def inputs(b, heads, n, groups, P, dtype, device="cpu", seed=0):
    """A state (B,H,N,P) and the step's inputs as the Mamba block makes them:
    x, B and C strided views of one conv output (B, H P + 2 G N), dt a
    softplus (B,H) and A negative, in f32."""
    g = torch.Generator().manual_seed(seed)
    state = torch.randn(b, heads, n, P, generator=g).to(dtype)
    conv = (torch.randn(b, heads * P + 2 * groups * n, generator=g) * 0.5).to(dtype)
    x = conv[:, :heads * P].unflatten(-1, (heads, P))
    bm = conv[:, heads * P:heads * P + groups * n].unflatten(-1, (groups, n))
    cm = conv[:, heads * P + groups * n:].unflatten(-1, (groups, n))
    dt = torch.nn.functional.softplus(torch.randn(b, heads, generator=g) - 1.0)
    A = -torch.exp(torch.randn(heads, generator=g) * 0.5)
    return tuple(t.to(device) for t in (state, x, dt, A, bm, cm))


def former_step(state, x, dt, A, bm, cm):
    """The Mamba block's single step before the kernel: the f32 state and y
    (B,H,P) in x's dtype."""
    heads, groups = x.shape[1], bm.shape[1]
    bh, ch = (t.float().repeat_interleave(heads // groups, dim=1) for t in (bm, cm))
    h = torch.einsum("bhn,bhp->bhnp", bh, x.float() * dt[..., None])
    h.addcmul_(state, torch.exp(dt * A)[..., None, None])
    return h, torch.einsum("bhn,bhnp->bhp", ch, h).to(x.dtype)


CASES = [(f, d) for f in FAMILIES for d in DTYPES]


@pytest.mark.parametrize("family,dtype", CASES)
def test_cpu_step_is_the_former_formula_bit_for_bit(family, dtype):
    heads, n, groups, P = FAMILIES[family]
    state, *rest = inputs(2, heads, n, groups, P, DTYPES[dtype])
    h, want_y = former_step(state, *rest)
    ops.reset_launches()
    y = ops.ssm_step(state, *rest)
    assert y.dtype == DTYPES[dtype] and y.shape == (2, heads, P)
    assert torch.equal(y, want_y)
    assert state.dtype == DTYPES[dtype] and torch.equal(state, h.to(state.dtype))
    assert ops.LAUNCHES["ssm_step"] == 0  # the CPU ran the plain version


@pytest.mark.parametrize("family,dtype", CASES)
def test_cpu_step_updates_its_slice_of_the_cache_in_place(family, dtype):
    """A layer's state as the decode step gets it, a view into the cache of
    every layer: that view's storage is written, its neighbours are not."""
    heads, n, groups, P = FAMILIES[family]
    state, *rest = inputs(2, heads, n, groups, P, DTYPES[dtype])
    cache = torch.stack([state * 2, state, state * 3])
    before = cache.clone()
    layer = cache[1]
    ptr = layer.data_ptr()
    h, _ = former_step(state, *rest)
    ops.ssm_step(layer, *rest)
    assert layer.data_ptr() == ptr and torch.equal(cache[1], h.to(cache.dtype))
    assert torch.equal(cache[0], before[0]) and torch.equal(cache[2], before[2])


def test_kernel_wrapper_checks_before_it_builds():
    state, x, dt, A, bm, cm = inputs(2, 8, 48, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="N in"):
        k5.ssm_step_cuda(state, x, dt, A, bm, cm)
    state, x, dt, A, bm, cm = inputs(2, 8, 64, 2, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="P in"):
        k5.ssm_step_cuda(state, x, dt, A, bm, cm)
    state, x, dt, A, bm, cm = inputs(2, 8, 64, 2, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="G dividing H"):
        k5.ssm_step_cuda(state, x, dt, A, bm[:, :1].expand(2, 3, 64), cm[:, :1].expand(2, 3, 64))
    with pytest.raises(TypeError, match="f32 dt"):
        k5.ssm_step_cuda(state, x, dt.double(), A, bm, cm)
    with pytest.raises(TypeError, match="one dtype"):
        k5.ssm_step_cuda(state.float(), x, dt, A, bm, cm)
    with pytest.raises(ValueError, match="CUDA"):
        k5.ssm_step_cuda(state, x, dt, A, bm, cm)


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # f32 summation order; one bf16 rounding
CARD_CASES = [(f, 4) for f in FAMILIES] + [("zamba2-7b", 64)]


def traced(fn):
    """Kernels of ``ops.KERNELS["ssm_step"]`` that a profiler trace of
    ``fn`` holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)  # a fresh session may drop its first launches
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return sum(any(s in e.name() for s in ops.KERNELS["ssm_step"])
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("family,b", CARD_CASES)
def test_kernel_matches_its_plain_version_on_the_card(card, family, b, dtype):
    heads, n, groups, P = FAMILIES[family]
    state, *rest = inputs(b, heads, n, groups, P, DTYPES[dtype], device=card)
    want_state = state.clone()
    want_y = k5.ssm_step_plain(want_state, *rest)
    ptr = state.data_ptr()
    ops.reset_launches()
    y = ops.ssm_step(state, *rest)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssm_step"] == 1 and state.data_ptr() == ptr
    assert y.dtype == DTYPES[dtype] and y.shape == (b, heads, P)
    tol = TOL[DTYPES[dtype]]
    torch.testing.assert_close(state.float(), want_state.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)


@pytest.mark.card
def test_launch_count_on_the_card(card):
    """Three launches counted, three in a profiler trace."""
    state, *rest = inputs(4, 24, 128, 1, 64, torch.bfloat16, device=card)
    ops.reset_launches()
    in_trace = traced(lambda: [ops.ssm_step(state, *rest) for _ in range(3)])
    assert ops.LAUNCHES["ssm_step"] == in_trace == 3


@pytest.mark.card
def test_graph_replays_step_the_state_on_the_card(card):
    """A CUDA graph captured around the step runs nothing at capture; each
    replay steps the state once more, as the plain version does."""
    state, *rest = inputs(8, 112, 64, 2, 64, torch.bfloat16, device=card)
    want = state.clone()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        y = ops.ssm_step(state, *rest)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    tol = TOL[torch.bfloat16]
    for _ in range(2):
        graph.replay()
        want_y = k5.ssm_step_plain(want, *rest)
        torch.cuda.synchronize()
        torch.testing.assert_close(state.float(), want.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
