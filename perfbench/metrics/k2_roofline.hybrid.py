"""K2 (``csrc/flash_attention.cu``) at the shared blocks' head dim, in the
traced waves' prompt passes: percent of its roofline, each launch's least
time (its operations at 989 TFLOP/s or its bytes at 3.35 TB/s, the larger;
one launch per shared-block invocation) over the device time of the
kernel's symbols. The count must equal the wrapper's and the trace's."""

from perfbench.yardstick import hybrid_flops, readers


def read(trace):
    return readers.roofline(trace, readers.K2, hybrid_flops.k2_launches(trace))
