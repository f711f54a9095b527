"""Percent of the traced serving window in which no operation ran on the
card: 1 - (union of the device's kernel, copy and set intervals) / window."""

from perfbench.yardstick import readers


def read(trace):
    return readers.idle(trace)
