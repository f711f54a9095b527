"""What the per-layer readers share: the kernel launches a traced window
must hold, reckoned from the configuration and the traced calls, and a
kernel's share of its roofline over them."""

from __future__ import annotations

from typing import List, Optional, Tuple

from perfbench.yardstick import flops, peaks

K2 = ("flash_attention", ("flash_attention_bf16_kernel", "flash_attention_f32_kernel"))


def model(trace) -> dict:
    return trace.cell.m


def dtype(m: dict) -> Tuple[int, float]:
    """(bytes an element, peak FLOP/s) of the kernels' path: bf16 on the
    tensor cores, float32 on the CUDA cores."""
    return (2, peaks.BF16_FLOPS) if m["dtype"] == "bfloat16" else (4, peaks.F32_FLOPS)


def serve_waves(trace) -> List[Tuple[int, int]]:
    """(batch, padded prompt length) of each traced wave."""
    return [(len(r["prompts"]), max(len(p) for p in r["prompts"])) for r in trace.calls]


def k2_launches(trace) -> List[Tuple[int, int]]:
    """(ops, bytes) of each K2 launch of the traced calls: one per
    attention layer and prompt pass (decode steps run K3)."""
    m = model(trace)
    elem, _ = dtype(m)

    def shape(b, s):
        return flops.k2(b, s, s, m["n_heads"], m["n_kv_heads"], m["d_head"], True,
                        m.get("window", 0), elem)

    return [shape(b, s) for b, s in serve_waves(trace) for _ in range(m["n_layers"])]


def roofline(trace, kernel, launches) -> Optional[float]:
    """Percent of its roofline that the kernel reached: the least time of
    every reckoned launch over the device time of the kernel's symbols. The
    reckoned count must equal the wrapper's launches and the kernels the
    trace holds; none launched, nothing to read."""
    counter, symbols = kernel
    events = trace.kernels(*symbols)
    if not launches and not events and not trace.launches.get(counter):
        return None
    if not (len(launches) == trace.launches[counter] == len(events)):
        raise RuntimeError(f"{counter}: reckoned {len(launches)} launches, the wrapper counted "
                           f"{trace.launches[counter]}, the trace holds {len(events)}")
    peak = dtype(model(trace))[1]
    least = sum(flops.least_s(ops, nbytes, peak) for ops, nbytes in launches)
    return 100.0 * least / sum(e - s for _, s, e in events)


def mfu(trace, useful_flops: float) -> float:
    return 100.0 * useful_flops / trace.window_s / peaks.BF16_FLOPS


def idle(trace) -> float:
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
