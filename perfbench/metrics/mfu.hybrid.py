"""The model step's share of the card's bf16 peak while serving the
published Zamba2 layout: useful FLOPs of the traced waves' requests (2 per
matrix weight and unpadded position of prompt and fed-back tokens, each
shared block at every invocation with its adapter and linear, the SSD's
state update and readout, the causal attention pairs, the output head at
the new positions; ``yardstick/hybrid_flops.py``) over the traced window at
989 TFLOP/s."""

from perfbench.yardstick import hybrid_flops, readers


def read(trace):
    m, new = readers.model(trace), trace.cell.mix["new_tokens"]
    useful = sum(hybrid_flops.served_request(m, len(p), new)
                 for r in trace.calls for p in r["prompts"])
    return readers.mfu(trace, useful)
