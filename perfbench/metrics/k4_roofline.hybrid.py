"""K4 (``csrc/ssd_scan.cu``) in the traced waves' prompt passes, one
launch per Mamba layer and group of B/C over the group's heads: percent of
its roofline, each launch's least time (its bytes at 3.35 TB/s or its
operations at 989 TFLOP/s, the larger) over the device time of the
kernel's symbols. The count must equal the wrapper's and the trace's."""

from perfbench.yardstick import hybrid_flops, readers


def read(trace):
    return readers.roofline(trace, hybrid_flops.K4, hybrid_flops.k4_launches(trace))
