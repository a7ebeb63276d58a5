"""Milliseconds per AV step in which the card runs the slow pathway's forward
and backward kernels (its stem and its stages, the span ``motion.slow``),
over an eager stretch of AV steps profiled with the span recorder on
(``benchmark/trace/slowfast.py``).  Nothing without a card, in a cell whose
motion net has no slow pathway, or from a program without the span."""

from benchmark.trace import slowfast


def read(reading):
    r = slowfast.readings(reading)
    return r.get("slow_ms") if r else None
