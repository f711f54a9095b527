"""K3 (``csrc/decode_attention.cu``) at the shared blocks' head dim, in the
traced waves' replayed decode: percent of its roofline, each launch's least
time (one per invocation and step, the step attending the prompt's padded
length plus the steps so far; its bytes at 3.35 TB/s or operations at 989
TFLOP/s, the larger) over the device time of the kernel's symbols. The
count must equal the wrapper's (a replay adds its capture's) and the
trace's."""

from perfbench.yardstick import hybrid_flops, readers


def read(trace):
    return readers.roofline(trace, hybrid_flops.K3, hybrid_flops.k3_launches(trace))
