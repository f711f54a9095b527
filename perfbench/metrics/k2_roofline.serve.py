"""K2 (``csrc/flash_attention.cu``, the prompt pass's attention) in the
traced waves: percent of its roofline, each launch's least time (its
operations at 989 TFLOP/s or its bytes at 3.35 TB/s, the larger) over the
device time of the kernel's symbols."""

from perfbench.yardstick import readers


def read(trace):
    return readers.roofline(trace, readers.K2, readers.k2_launches(trace))
