"""The Mamba-2 decode step's kernel (``csrc/ssm_step.cu``) in the traced
waves' replayed decode: percent of its roofline, one launch per Mamba layer
and decode step, each launch's least time (its bytes at 3.35 TB/s: the
state read and written in the cache's dtype, x, B, C and y in the
activations', dt in f32; or its operations, a multiply-add of the update
and one of the readout per state element, at 989 TFLOP/s, the larger) over
the device time of the kernel's symbols. The count must equal the
wrapper's (a replay adds its capture's) and the trace's. A program without
the kernel counts no launches of it: nothing to read."""

from perfbench.yardstick import readers

KERNEL = ("ssm_step", ("ssm_step_kernel",))


def launch(m: dict, b: int, elem: int):
    """(ops, bytes) of one launch over a batch of b rows."""
    p, n, groups = m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]
    heads = m["ssm_expand"] * m["d_model"] // p
    state = b * heads * n * p
    return 4 * state, elem * (2 * state + 2 * b * heads * p + 2 * b * groups * n) + 4 * b * heads


def launches(trace):
    m, new = readers.model(trace), trace.cell.mix["new_tokens"]
    elem, _ = readers.dtype(m)
    return [launch(m, b, elem) for b, _ in readers.serve_waves(trace)
            for _ in range(new - 1) for _ in range(m["n_layers"])]


def read(trace):
    if KERNEL[0] not in trace.launches:
        return None
    return readers.roofline(trace, KERNEL, launches(trace))
