"""The model step's share of the card's bf16 peak while serving: useful
FLOPs of the traced waves' requests (2 per active matrix weight and
position of each prompt and fed-back token, the output head at the new
positions, and the causal attention pairs, padding left out) over the
traced window at 989 TFLOP/s."""

from perfbench.yardstick import flops, readers


def read(trace):
    m, new = readers.model(trace), trace.cell.mix["new_tokens"]
    useful = sum(flops.served_request(m, len(p), new) for r in trace.calls for p in r["prompts"])
    return readers.mfu(trace, useful)
