"""Milliseconds per AV step in which the card runs the motion net's
forward and backward kernels: the union of the intervals of the kernels
whose launching op opened inside the program's ``train.motion`` span, or
runs under the backward function of a forward op that did, over an eager
stretch of AV steps profiled with the span recorder on
(``benchmark/trace/motion.py``).  Nothing without a card, in a cell
without clips, or from a program without the span."""

from benchmark.trace import motion


def read(reading):
    r = motion.readings(reading)
    return r.get("device_ms") if r else None
