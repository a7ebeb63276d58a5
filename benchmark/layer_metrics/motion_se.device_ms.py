"""Milliseconds per AV step in which the card runs X3D's squeeze-excitation
gates with the swish after each (the swish alone in a block without a
gate), forward and backward (the span ``motion.se``), over an eager
stretch of AV steps profiled with the span recorder on
(``benchmark/trace/x3d.py``).  Nothing without a card, in a cell whose
motion net is no X3D, or from a program without the span."""

from benchmark.trace import x3d


def read(reading):
    r = x3d.readings(reading)
    return r.get("se_ms") if r else None
