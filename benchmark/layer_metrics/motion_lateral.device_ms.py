"""Milliseconds per AV step in which the card runs the lateral convolutions,
their concatenations and their backward (the span ``motion.lateral``), over
an eager stretch of AV steps profiled with the span recorder on
(``benchmark/trace/slowfast.py``).  Nothing without a card, in a cell whose
motion net has no slow pathway, or from a program without the span."""

from benchmark.trace import slowfast


def read(reading):
    r = slowfast.readings(reading)
    return r.get("lateral_ms") if r else None
