"""The slow pathway's share of the card's peak in the configuration's dtype:
its trained FLOPs per AV step (``counts.slowfast.slow_pathway`` per clip,
the stem without an input gradient, times the clips that the
``motion.slow_frames`` counted per AV step give) over
``motion_slow.device_ms``, over an eager stretch of AV steps profiled with
the span recorder on (``benchmark/trace/slowfast.py``).  Nothing without a
card, in a cell whose motion net has no slow pathway, or from a program
without the span."""

from benchmark.trace import slowfast


def read(reading):
    r = slowfast.readings(reading)
    return r.get("mfu") if r else None
